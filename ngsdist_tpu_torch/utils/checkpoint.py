"""Checkpoint / resume of the replicate stream.

The reference is one-shot: its only durability is that each replicate's
matrix is appended to the output file as it completes
(reference ngsDist.cpp:282-287).  For long bootstrap runs this
module adds real resume: a sidecar state file records the run
fingerprint and how many matrices are already durable in the output, so
a restarted run re-opens the output in append mode and continues with
the next replicate.  Replicate results are deterministic given the seed
(the bootstrap index table is a pure function of seed/reps/blocks), so
resuming mid-stream reproduces exactly the matrices an uninterrupted
run would have written.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import asdict
from typing import Optional

from ..config import Params

_FIELDS = [
    "in_geno", "in_bin", "in_probs", "in_logscale", "n_ind", "n_sites",
    "tot_sites", "call_geno", "N_thresh", "call_thresh", "pairwise_del",
    "avg_nuc_dist", "evol_model", "indep_geno", "n_boot_rep",
    "boot_block_size", "seed",
]


def _numeric_env(engine: Optional[str]) -> Optional[list]:
    """The numeric environment a matrix was computed under: the engine
    name the caller passes (core/distance.py engine_name: device type
    and dtype).

    Bytes in the output depend on it — CUDA float32 and CPU float64
    differ in precision and reduction order — so a resume must refuse to
    append matrices from a different environment to the same file."""
    return None if engine is None else [engine]


def run_fingerprint(pars: Params, engine: Optional[str] = None) -> str:
    """Hash of every parameter that affects the output stream, plus the
    input file's (for evolutionary models 3-6 also the POS file's) size
    and mtime — resuming after the genotype file
    changed must not silently append matrices computed from different
    data to the old output.  engine: the engine name of the run; folds
    the numeric environment into the hash."""
    d = asdict(pars)
    fields = {k: d[k] for k in _FIELDS}
    fields["_numeric_env"] = _numeric_env(engine)
    try:
        st = os.stat(pars.in_geno)
        fields["_geno_stat"] = [st.st_size, st.st_mtime_ns]
    except (OSError, TypeError):  # stdin ("-") or vanished file
        fields["_geno_stat"] = None
    if pars.evol_model >= 3:
        # models 3-6 take their site classes from the POS file's alleles
        try:
            st = os.stat(pars.in_pos)
            fields["_pos_stat"] = [pars.in_pos, pars.in_pos_header, st.st_size,
                                   st.st_mtime_ns]
        except (OSError, TypeError):
            fields["_pos_stat"] = [pars.in_pos, pars.in_pos_header]
    payload = json.dumps(fields, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def state_path(out: str) -> str:
    return out + ".ckpt.json"


def save(out: str, pars: Params, n_done: int,
         engine: Optional[str] = None) -> None:
    tmp = state_path(out) + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"fingerprint": run_fingerprint(pars, engine),
                   "n_done": n_done}, fh)
    os.replace(tmp, state_path(out))


def load(out: str, pars: Params, engine: Optional[str] = None) -> Optional[int]:
    """Number of matrices already written by a matching interrupted run,
    or None when there is nothing (or something incompatible) to resume."""
    path = state_path(out)
    if not os.path.exists(path) or not os.path.exists(out):
        return None
    try:
        with open(path) as fh:
            st = json.load(fh)
    except (OSError, ValueError):
        return None
    if st.get("fingerprint") != run_fingerprint(pars, engine):
        return None
    n_done = int(st.get("n_done", 0))
    return n_done if 0 < n_done <= pars.n_boot_rep + 1 else None


def clear(out: str) -> None:
    try:
        os.remove(state_path(out))
    except OSError:
        pass
    clear_rounds(out)


# ------------------------------------------------------------------ #
# Intra-replicate round checkpoints (streaming long-genome runs)      #
# ------------------------------------------------------------------ #
#
# When a genome streams as site chunks, a single replicate can take
# hours; the replicate-level sidecar above would lose all of it on
# interruption.  These helpers persist the ACCUMULATED sufficient
# statistics after each completed chunk ("round"), so a resumed run
# re-enters the replicate at the first unfinished round.  The statistics
# are exact partial sums of a deterministic computation, so resumed
# output is byte-identical to an uninterrupted run.


def rounds_path(out: str) -> str:
    return out + ".rounds.npz"


_META_KEY = "__ngsdist_meta__"


def save_rounds(out: str, pars: Params, rep: int, next_round: int,
                arrays: dict, engine: Optional[str] = None,
                chunk: Optional[int] = None) -> None:
    """Crash-atomic: metadata (fingerprint/rep/next_round/chunk) travels
    INSIDE the npz so the commit is one os.replace — a kill can only
    leave the previous complete checkpoint or the new complete one,
    never a meta file one round ahead of its arrays.  chunk: the sites
    per round; on a card it follows from the free memory, which varies,
    so it is recorded and a file of another chunk length is not
    resumed."""
    import numpy as np

    meta = {"fingerprint": run_fingerprint(pars, engine), "rep": rep,
            "next_round": next_round, "chunk": chunk}
    base = rounds_path(out)
    tmp = base + ".tmp.npz"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays,
                 **{_META_KEY: np.frombuffer(
                     json.dumps(meta).encode(), dtype=np.uint8)})
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, base)


def load_rounds(out: str, pars: Params, rep: int,
                engine: Optional[str] = None, chunk: Optional[int] = None):
    """(next_round, arrays) for a matching interrupted replicate, else
    None."""
    import numpy as np

    path = rounds_path(out)
    if not os.path.exists(path):
        return None
    import zipfile

    try:
        with np.load(path) as z:
            if _META_KEY not in z.files:
                return None  # unknown format: recompute
            meta = json.loads(bytes(z[_META_KEY]).decode())
            arrays = {k: z[k] for k in z.files if k != _META_KEY}
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        # a torn partial file (kill mid-write) must read as "no
        # checkpoint", not crash the resume
        return None
    if (meta.get("fingerprint") != run_fingerprint(pars, engine)
            or meta.get("rep") != rep or meta.get("chunk") != chunk):
        return None
    return int(meta["next_round"]), arrays


def clear_rounds(out: str) -> None:
    try:
        os.remove(rounds_path(out))
    except OSError:
        pass
