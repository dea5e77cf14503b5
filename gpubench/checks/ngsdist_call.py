"""The semantics of an ngsDist job on called genotypes (--probs
--call_geno, which forces independent genotypes), and the comparison
that decides `correct`: the phylip files the timed runs wrote against
the plain reference (gpubench/reference/call_indep.py), on pairs drawn
from the seed in which every individual takes part.  Imports nothing of
the program.

Numbers compared, each against its limit (gpubench/limits/<cell>.json),
as checks/ngsdist_em.py compares them: d_err, the largest |distance
written - reference distance| over the sampled pairs of every matrix of
every run judged, and bad_matrices (limit 0).  The harness adds
failed_runs (limit 0).  `control` puts the reference, with its sums
over sites held in a lower precision, in the program's place.
"""

from __future__ import annotations

import sys
from typing import Callable, Sequence

import torch

from gpubench import roofline_indep
# the work of an output and the file's format are those of any ngsDist job
from gpubench.checks.ngsdist_em import (_arg, judge_file, outputs_in_prefix,  # noqa: F401
                                        work_per_output)
from gpubench.reference import call_indep as ref
from gpubench.reference.ngsdist import sample_pairs

PAIRS_PER_INDIVIDUAL = 2

# The ngsDist options a traffic file may give; any other flag is refused
# rather than judged by a reference that ignores it.
_FLAGS = {"--probs": None, "--call_geno": None, "--pairwise_del": None, "--n_boot_rep": int,
          "--boot_block_size": int, "--evol_model": int}


def options(args: Sequence[str]) -> dict:
    """{probs, call_geno, pairwise_del, n_boot_rep, boot_block_size,
    evol_model} of a traffic file's ngsDist arguments, with ngsDist's
    defaults."""
    opts = {"probs": False, "call_geno": False, "pairwise_del": False, "n_boot_rep": 0,
            "boot_block_size": 1, "evol_model": 1}
    k = 0
    while k < len(args):
        flag = args[k]
        if flag not in _FLAGS:
            raise ValueError(f"traffic argument {flag!r}: the reference implements only "
                             f"{sorted(_FLAGS)}")
        if _FLAGS[flag] is None:
            opts[flag[2:]] = True
            k += 1
        else:
            opts[flag[2:]] = _FLAGS[flag](args[k + 1])
            k += 2
    if not (opts["probs"] and opts["call_geno"]):
        raise ValueError("the reference calls genotype posteriors (--probs --call_geno)")
    if opts["evol_model"] not in (0, 1, 2):
        raise ValueError("the reference implements --evol_model 0, 1 and 2")
    return opts


def reference_state(path: str, config: dict, seed: int, device: torch.device) -> dict:
    """{"I", "J": the sampled pairs, "terms", "called" [S, n]: their
    score and whether both are called at every site}."""
    N, S = config["n_ind"], config["n_sites"]
    I, J = sample_pairs(N, PAIRS_PER_INDIVIDUAL, seed)
    return {"I": I, "J": J, **ref.state(path, N, S, I, J, device)}


def bound_s(state, config: dict, opts: dict) -> dict:
    """{kernel name: the least time of a run's work in that kernel on the
    card}: the indep kernel's, the contraction over the data once."""
    bound = roofline_indep.indep_bound_s(config["n_sites"], config["n_ind"],
                                         1 + opts["n_boot_rep"], opts["pairwise_del"])
    print(f"indep bound per run: {bound}", file=sys.stderr)
    return {roofline_indep.KERNEL: bound["seconds"]}


def _expected(state, boot_seed: int, opts: dict, sum_dtype=torch.float64):
    return ref.distances(state["terms"], state["called"], opts["pairwise_del"], boot_seed,
                         opts["n_boot_rep"], opts["boot_block_size"], opts["evol_model"],
                         sum_dtype)


def judge(outputs, state, opts: dict, config: dict) -> dict:
    """{"d_err", "bad_matrices", "runs_judged"} of the runs' outputs
    [(path, boot_seed)] against the reference."""
    worst, bad = 0.0, 0
    for path, boot_seed in outputs:
        d_err, b, faults = judge_file(path, _expected(state, boot_seed, opts), state["I"],
                                      state["J"], config["n_ind"])
        worst, bad = max(worst, d_err), bad + b
        for f in faults[:5]:
            print(f"check: {path}: {f}", file=sys.stderr)
    return {"d_err": worst, "bad_matrices": bad, "runs_judged": len(outputs)}


def control(config: dict, opts: dict, seed: int, dtype: torch.dtype,
            device: torch.device) -> Callable[[Sequence[str]], int]:
    """The control, an entry that takes the program's command line: the
    reference with its sums over sites (each matrix's numerators and
    denominators) held in `dtype` writes each run's matrices.  The calls
    and their scores are exact in any precision (0, 1/2, 1), so the
    sums are where a lower precision shows.  It writes its distances at
    the pairs the check samples from `seed`, the only ones compared, and
    0 elsewhere."""
    N = config["n_ind"]
    states = {}

    def entry(args: Sequence[str]) -> int:
        path = _arg(args, "--geno")
        if path not in states:
            states[path] = reference_state(path, config, seed, device)
        st = states[path]
        dist = _expected(st, int(_arg(args, "--seed")), opts, dtype)
        zero = f"{0.0:.10f}"
        with open(_arg(args, "--out"), "w") as fh:
            for d in dist:
                rows = [[zero] * N for _ in range(N)]
                for i, j, v in zip(st["I"].tolist(), st["J"].tolist(), d.tolist()):
                    rows[i][j] = rows[j][i] = f"{v:.10f}"
                fh.write(f"\n{N}\n")
                fh.writelines(f"Ind_{i}\t" + "\t".join(r) + "\n" for i, r in enumerate(rows))
        return 0

    return entry
