"""The H100's peaks and the least time the EM's work needs on them.

The arithmetic of the EM kernel's bound (the program's chip smoke,
`em_bound`, and its count `em_work`), frozen here: per live row (site,
individual) the 49 steps of its power and ratio tables once (9
operations a step), per ratio test a multiply and a compare, per live
lane (site, pair) the nine-cell contraction, the sums' product, the
division and the weighted accumulation (32); all float64 outside the
tensor cores.  Bytes: the input read once in the kernel's type and each
matrix's raw and count written once in float64.

The work is that of a whole run: every live lane of the data once.  A
run's matrices all sum the same lanes (the bootstrap only weights
them), so no route needs more; the route the program takes today runs
the lanes of every site again for every matrix.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM5 (data sheet, dense, at 700 W): HBM3 bandwidth and the
# float64 rate outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F64 = 33.5e12

EM_TESTS_MAX = 49


def em_work(steps: np.ndarray, n_pairs: int, n_rows_live: int) -> dict:
    """The EM's work on the whole data, from the steps the reference's EM
    ran on a sample of lanes (steps [sites, sampled pairs]; 0 for a dead
    lane): ratio tests min(steps, 49) and live lanes, scaled from the
    sampled pairs to all n_pairs."""
    steps = np.asarray(steps)
    scale = n_pairs / steps.shape[1]
    live = steps > 0
    return {"live_rows": int(n_rows_live),
            "live_lanes": float(live.sum()) * scale,
            "tests": float(np.minimum(steps[live], EM_TESTS_MAX).sum()) * scale}


def em_bound_s(work: dict, n_sites: int, n_ind: int, itemsize: int, n_matrices: int) -> dict:
    """{"seconds", "binds", "flop", "bytes"}: the least time of the EM's
    work on one H100, the larger of its bytes at PEAK_BYTES and its
    operations at PEAK_F64."""
    n_pairs = n_ind * (n_ind - 1) // 2
    nbytes = 3 * itemsize * n_sites * n_ind + n_matrices * n_pairs * 16
    flop = (EM_TESTS_MAX * 9 * work["live_rows"] + 2 * work["tests"]
            + 32 * work["live_lanes"])
    t_b, t_o = nbytes / PEAK_BYTES, flop / PEAK_F64
    return {"seconds": max(t_b, t_o), "binds": "bytes" if t_b > t_o else "operations",
            "flop": flop, "bytes": nbytes}
