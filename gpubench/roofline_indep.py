"""The least time of the independent-genotypes statistics' work on the
H100 (the program's indep kernel, whose device kernels are named
`indep_*`).

The work of a whole run, counted from its shape: the contraction over
the data once, for every pair a < b and every site three products (the
score-folded genotypes) and, under --pairwise_del, one more (the count),
each a multiply and an add, at the TF32 tensor cores' peak; bytes: the
data read once as float32 triples and each matrix's raw and, under
--pairwise_del, count written once as float32, at the HBM3 peak.  A
run's matrices all sum the same sites (the bootstrap only weights them),
so no route needs more; the route the program takes runs the
contraction again for every matrix.
"""

from __future__ import annotations

from gpubench.roofline import PEAK_BYTES

# NVIDIA H100 SXM5 (data sheet, dense, at 700 W): TF32 on the tensor cores
PEAK_TF32 = 495e12

KERNEL = "indep_"


def indep_bound_s(n_sites: int, n_ind: int, n_matrices: int, pairwise_del: bool) -> dict:
    """{"seconds", "binds", "flop", "bytes"}: the least time of a run's
    indep work on one H100, the larger of its bytes at PEAK_BYTES and its
    operations at PEAK_TF32."""
    n_pairs = n_ind * (n_ind - 1) // 2
    outputs = 2 if pairwise_del else 1
    flop = 2 * (3 + (1 if pairwise_del else 0)) * n_sites * n_pairs
    nbytes = 3 * 4 * n_sites * n_ind + n_matrices * outputs * 4 * n_pairs
    t_b, t_o = nbytes / PEAK_BYTES, flop / PEAK_TF32
    return {"seconds": max(t_b, t_o), "binds": "bytes" if t_b > t_o else "operations",
            "flop": flop, "bytes": nbytes}
