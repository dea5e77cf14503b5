"""Block-bootstrap site resampling.

The reference draws, per replicate, one uniform per destination block
from a single global taus stream and aliases site pointers
(reference ngsDist.cpp:217-237,416-437).  Here the same stream
produces an index table host-side; replicates become site-index gathers
(exact path) or weighted resummations of per-block partial pair sums
(fast path, see core/distance.py).

Truncation rule: before the first resampled replicate, n_sites is
truncated to a multiple of the block size (ngsDist.cpp:235-237);
replicate 0 (the full data) uses the untruncated count.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..utils import native as _native
from ..utils.rng import boot_block_indices as _py_boot_block_indices


def truncated_n_sites(n_sites: int, block_size: int) -> int:
    return n_sites - n_sites % block_size


def block_index_table(seed: int, n_reps: int, n_blocks: int, native: bool = True) -> np.ndarray:
    """[n_reps, n_blocks] source-block table (row r = replicate r+1)."""
    if n_reps == 0 or n_blocks == 0:
        return np.zeros((n_reps, n_blocks), dtype=np.uint64)
    if native and _native.have_native():
        lib = _native.get_lib()
        out = np.empty((n_reps, n_blocks), dtype=np.uint64)
        lib.nd_boot_block_indices(seed & 0xFFFFFFFF, n_reps, n_blocks, _native.as_u64_ptr(out))
        return out
    return _py_boot_block_indices(seed, n_reps, n_blocks)


def site_maps(
    seed: int, n_reps: int, n_sites: int, block_size: int, native: bool = True
) -> Tuple[int, List[np.ndarray]]:
    """Per-replicate source-site index arrays.

    Returns (n_sites_resampled, [map_1, ..., map_n_reps]) where each map
    has length n_sites_resampled and maps destination site -> source site.
    """
    n_trunc = truncated_n_sites(n_sites, block_size)
    n_blocks = n_trunc // block_size
    table = block_index_table(seed, n_reps, n_blocks, native=native)
    offs = np.arange(block_size, dtype=np.int64)
    maps = [
        (table[r].astype(np.int64)[:, None] * block_size + offs[None, :]).reshape(-1)
        for r in range(n_reps)
    ]
    return n_trunc, maps


def block_multiplicity(table: np.ndarray, n_blocks: int) -> np.ndarray:
    """[n_reps, n_blocks] float64 multiplicity matrix M where M[r, b] is
    how many times source block b is drawn in replicate r — the weights
    for the partial-sum resummation fast path."""
    n_reps = table.shape[0]
    out = np.zeros((n_reps, n_blocks), dtype=np.float64)
    for r in range(n_reps):
        np.add.at(out[r], table[r].astype(np.int64), 1.0)
    return out
