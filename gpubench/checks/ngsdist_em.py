"""The semantics of an ngsDist job on genotype posteriors with the
default EM distance, and the comparison that decides `correct`: the
phylip files the timed runs wrote against the plain reference
(gpubench/reference/ngsdist.py), on pairs drawn from the seed in which
every individual takes part.  Imports nothing of the program.

Numbers compared, each against its limit (gpubench/limits/<cell>.json):

- d_err: the largest |distance written - reference distance| over the
  sampled pairs of every matrix of every run judged (a value the
  reference finds finite and the file does not counts as infinite);
- bad_matrices: matrices missing from a run's file, or breaking the
  format, the labels, the symmetry, the zero diagonal or finiteness
  anywhere in the matrix (limit 0).

The harness adds failed_runs (limit 0).  `control` puts the reference,
computed in a lower precision, in the program's place.
"""

from __future__ import annotations

import sys
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from gpubench import roofline
from gpubench.reference import ngsdist as ref

PAIRS_PER_INDIVIDUAL = 2

# The ngsDist options a traffic file may give.  The reference implements
# exactly these; any other flag is refused rather than judged by a
# reference that ignores it.
_FLAGS = {"--probs": None, "--n_boot_rep": int, "--boot_block_size": int,
          "--evol_model": int, "--x64": None}


def options(args: Sequence[str]) -> dict:
    """{probs, n_boot_rep, boot_block_size, evol_model, x64} of a traffic
    file's ngsDist arguments, with ngsDist's defaults."""
    opts = {"probs": False, "n_boot_rep": 0, "boot_block_size": 1, "evol_model": 1,
            "x64": False}
    k = 0
    while k < len(args):
        flag = args[k]
        if flag not in _FLAGS:
            raise ValueError(f"traffic argument {flag!r}: the reference implements only "
                             f"{sorted(_FLAGS)}")
        kind = _FLAGS[flag]
        if kind is None:
            opts[flag[2:]] = True
            k += 1
        else:
            opts[flag[2:]] = kind(args[k + 1])
            k += 2
    if not opts["probs"]:
        raise ValueError("the reference reads genotype posteriors only (--probs)")
    if opts["evol_model"] not in (0, 1, 2):
        raise ValueError("the reference implements --evol_model 0, 1 and 2")
    return opts


def work_per_output(config: dict, opts: dict) -> List[int]:
    """Pair-site updates of each matrix of a run, in the order written:
    the full data's (every site), then each replicate's (the genome
    truncated to whole blocks)."""
    N, S, R = config["n_ind"], config["n_sites"], opts["n_boot_rep"]
    n_pairs = N * (N - 1) // 2
    n_trunc = S - S % opts["boot_block_size"] if R else S
    return [n_pairs * S] + [n_pairs * n_trunc] * R


def outputs_in_prefix(path: str, nbytes: int, config: dict) -> int:
    """Whole matrices in the first nbytes of a phylip file (each is a
    blank line, the count line and n_ind rows)."""
    with open(path, "rb") as fh:
        return fh.read(nbytes).count(b"\n") // (config["n_ind"] + 2)


def reference_state(path: str, config: dict, seed: int, device: torch.device,
                    dtype: torch.dtype = torch.float64):
    """{"I", "J": the sampled pairs, "contrib", "steps" [S, n]: the
    reference EM's lanes over every site, in `dtype`, "live_rows": the
    (site, individual) rows that are not all zero}."""
    P = ref.read_binary_gp(path, config["n_ind"], config["n_sites"], device)
    I, J = ref.sample_pairs(config["n_ind"], PAIRS_PER_INDIVIDUAL, seed)
    contrib, steps = ref.pair_site_em(P, I, J, dtype)
    live_rows = int((P.amax(-1) > 0).sum())
    del P
    return {"I": I, "J": J, "contrib": contrib, "steps": steps, "live_rows": live_rows}


def bound_s(state, config: dict, opts: dict) -> dict:
    """{kernel name: the least time of a run's work in that kernel on the
    card}: the EM's, every live lane of the data once."""
    N, S = config["n_ind"], config["n_sites"]
    work = roofline.em_work(state["steps"].cpu().numpy(), N * (N - 1) // 2,
                            state["live_rows"])
    bound = roofline.em_bound_s(work, S, N, 8 if opts["x64"] else 4, 1 + opts["n_boot_rep"])
    print(f"em bound per run: {bound}", file=sys.stderr)
    return {"em_kernel": bound["seconds"]}


def judge_file(path: str, expected: np.ndarray, I: np.ndarray, J: np.ndarray,
               n_ind: int) -> Tuple[float, int, List[str]]:
    """(d_err, bad matrices, faults) of one run's output against the
    reference distances expected [matrices, sampled pairs]."""
    mats, labels, faults = ref.read_phylip(path, n_ind)
    bad = len(faults) + max(0, len(expected) - len(mats))
    if labels and labels != [f"Ind_{i}" for i in range(n_ind)]:
        faults.append("labels are not Ind_0 .. Ind_N-1")
        bad += 1
    if len(mats) < len(expected):
        faults.append(f"{len(mats)} matrices, expected {len(expected)}")
    worst = 0.0
    for k, (m, r) in enumerate(zip(mats, expected)):
        if not (np.isfinite(m).all() and (m == m.T).all() and (np.diag(m) == 0).all()):
            faults.append(f"matrix {k}: not finite, not symmetric or a nonzero diagonal")
            bad += 1
        got = m[I, J]
        err = np.where(np.isfinite(got), np.abs(got - r), np.inf)
        err = np.where(np.isnan(r) & np.isnan(got), 0.0, err)
        worst = max(worst, float(err.max(initial=0.0)))
    return worst, bad, faults


def judge(outputs, state, opts: dict, config: dict) -> dict:
    """{"d_err", "bad_matrices", "runs_judged"} of the runs' outputs
    [(path, boot_seed)] against the reference."""
    worst, bad = 0.0, 0
    for path, boot_seed in outputs:
        expected = ref.distances(state["contrib"], boot_seed, opts["n_boot_rep"],
                                 opts["boot_block_size"], opts["evol_model"])
        d_err, b, faults = judge_file(path, expected, state["I"], state["J"],
                                      config["n_ind"])
        worst, bad = max(worst, d_err), bad + b
        for f in faults[:5]:
            print(f"check: {path}: {f}", file=sys.stderr)
    return {"d_err": worst, "bad_matrices": bad, "runs_judged": len(outputs)}


def _arg(args: Sequence[str], flag: str) -> str:
    return args[list(args).index(flag) + 1]


def control(config: dict, opts: dict, seed: int, dtype: torch.dtype,
            device: torch.device) -> Callable[[Sequence[str]], int]:
    """The control, an entry that takes the program's command line: the
    reference with its inputs and EM in `dtype` (sums over sites in
    float64) writes each run's matrices.  It writes its distances at the
    pairs the check samples from `seed`, the only ones compared, and 0
    elsewhere."""
    N = config["n_ind"]
    states = {}

    def entry(args: Sequence[str]) -> int:
        path = _arg(args, "--geno")
        if path not in states:
            states[path] = reference_state(path, config, seed, device, dtype)
        st = states[path]
        dist = ref.distances(st["contrib"], int(_arg(args, "--seed")), opts["n_boot_rep"],
                             opts["boot_block_size"], opts["evol_model"])
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
