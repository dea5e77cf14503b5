"""The bootstrap's random stream, frozen here for the reference.

ngsDist draws one uniform per (replicate, destination block) from one
global Tausworthe generator (L'Ecuyer 1996; ngsDist.cpp:217-237,416-437,
shared/gen_func.cpp:117-119) seeded with --seed, replicate 1 first;
destination block b of a replicate takes source block
floor(u * n_blocks).  Plain Python, independent of the program's copy.
"""

from __future__ import annotations

import numpy as np

_M32 = 0xFFFFFFFF


def block_table(seed: int, n_reps: int, n_blocks: int) -> np.ndarray:
    """[n_reps, n_blocks] int64: the source block of every destination
    block, row r for replicate r + 1."""
    s = int(seed) & _M32
    if s == 0:
        s = 1
    s1 = (69069 * s) & _M32
    if s1 < 2:
        s1 += 2
    s2 = (69069 * s1) & _M32
    if s2 < 8:
        s2 += 8
    s3 = (69069 * s2) & _M32
    if s3 < 16:
        s3 += 16
    out = np.empty(n_reps * n_blocks, dtype=np.int64)
    for i in range(6 + n_reps * n_blocks):
        s1 = (((s1 & 4294967294) << 12) & _M32) ^ ((((s1 << 13) & _M32) ^ s1) >> 19)
        s2 = (((s2 & 4294967288) << 4) & _M32) ^ ((((s2 << 2) & _M32) ^ s2) >> 25)
        s3 = (((s3 & 4294967280) << 17) & _M32) ^ ((((s3 << 3) & _M32) ^ s3) >> 11)
        if i >= 6:  # the first six draws warm the generator up
            out[i - 6] = s1 ^ s2 ^ s3
    # u = x / 2^32 exactly in float64; floor(u * n_blocks)
    return np.floor(out.astype(np.float64) / 4294967296.0 * n_blocks).astype(np.int64).reshape(
        n_reps, n_blocks)


def site_weights(seed: int, n_reps: int, n_sites: int, block_size: int):
    """(n_trunc, [n_reps, n_trunc] float64): how often each replicate
    draws each site of the genome truncated to whole blocks."""
    n_trunc = n_sites - n_sites % block_size
    n_blocks = n_trunc // block_size
    table = block_table(seed, n_reps, n_blocks)
    w = np.zeros((n_reps, n_blocks), dtype=np.float64)
    for r in range(n_reps):
        np.add.at(w[r], table[r], 1.0)
    return n_trunc, np.repeat(w, block_size, axis=1)
