"""Genotype-probability preprocessing.

Mirrors the reference main()'s per-(individual, site) loop after reading
(reference ngsDist.cpp:165-174): optional genotype calling in log
space (call_geno, shared/gen_func.cpp:886-914), then conversion to
normal space — everything downstream works on normal-space probabilities.
"""

from __future__ import annotations

import numpy as np

from ..config import NgsDistError
from ..utils import native as _native

BIGNEG = 1.0e15


def call_geno_inplace(
    geno_log: np.ndarray, N_thresh: float, call_thresh: float, native: bool = True
) -> None:
    """Hard-call / missing-threshold log-space triples in place.

    First-max/first-min positions; an exactly-equal triple is missing
    (max_pp := -1); max below N_thresh resets to uniform; max at or
    above call_thresh one-hots (miss_mode=0 semantics).
    """
    if N_thresh > call_thresh:
        raise NgsDistError(
            "call_geno", "missing data threshold must be smaller than calling genotype threshold!"
        )
    if native and _native.have_native():
        lib = _native.get_lib()
        flat = geno_log.reshape(-1)
        rc = lib.nd_call_geno3(
            _native.as_double_ptr(flat), flat.size // 3, N_thresh, call_thresh
        )
        if rc:
            raise NgsDistError(
                "call_geno",
                "missing data threshold must be smaller than calling genotype threshold!",
            )
        return

    tri = geno_log.reshape(-1, 3)
    max_pos = np.argmax(tri, axis=1)
    min_pos = np.argmin(tri, axis=1)
    rows = np.arange(tri.shape[0])
    max_pp = np.exp(tri[rows, max_pos])
    all_equal = tri[rows, min_pos] == tri[rows, max_pos]
    max_pp = np.where(all_equal, -1.0, max_pp)

    below_n = max_pp < N_thresh
    tri[below_n] = np.log(1.0 / 3.0)
    called = max_pp >= call_thresh
    tri[called] = -BIGNEG
    tri[rows[called], max_pos[called]] = 0.0


def to_normal_space(geno_log: np.ndarray, native: bool = True) -> np.ndarray:
    """exp() each entry in place (conv_space with exp, gen_func.cpp:123-130)."""
    if native and _native.have_native():
        lib = _native.get_lib()
        flat = geno_log.reshape(-1)
        lib.nd_exp_array(_native.as_double_ptr(flat), flat.size)
        return geno_log
    np.exp(geno_log, out=geno_log)
    return geno_log


def preprocess(
    geno_log: np.ndarray,
    call_geno: bool,
    N_thresh: float,
    call_thresh: float,
    native: bool = True,
) -> np.ndarray:
    """call_geno (optional) then exp; returns the normal-space array
    [n_sites, n_ind, 3] (mutates its input)."""
    if call_geno:
        call_geno_inplace(geno_log, N_thresh, call_thresh, native=native)
    return to_normal_space(geno_log, native=native)


class ZeroRows:
    """Where the all-zero triples of a normal-space [S, N, 3] array lie
    (empty text lines parse to them): `sites` [n] the sites that hold
    one, ascending, and `rows` [n, N] bool the individuals there.  The
    EM poisons every pair of such an individual without pairwise
    deletion (core/distance.py); the record is taken once per run so
    that no pass of the engine scans the tensor for them.  A run that
    reads its rows from disk round by round has no tensor to take it
    from: it starts empty and `add` records each round's rows as they
    are read, before the engine asks about them."""

    def __init__(self, sites: np.ndarray, rows: np.ndarray) -> None:
        # one tuple, replaced whole: a reader thread may add while the
        # engine reads
        self._rec = (sites, rows)

    @classmethod
    def empty(cls, n_ind: int) -> "ZeroRows":
        return cls(np.zeros(0, np.int64), np.zeros((0, n_ind), bool))

    @property
    def sites(self) -> np.ndarray:
        return self._rec[0]

    @property
    def rows(self) -> np.ndarray:
        return self._rec[1]

    def add(self, lo: int, P: np.ndarray) -> None:
        """Record the all-zero triples of P [n, N, 3], the sites [lo,
        lo + n); sites recorded before are kept once."""
        got = find_zero_rows(P)
        if got is None:
            return
        sites, rows = self._rec
        sites = np.concatenate([sites, got.sites + lo])
        rows = np.concatenate([rows, got.rows])
        sites, first = np.unique(sites, return_index=True)
        self._rec = (sites, rows[first])

    def individuals(self, lo: int, hi: int, weights=None) -> np.ndarray:
        """[N] bool: individuals with an all-zero triple among the sites
        [lo, hi) — with weights [hi - lo], among those of weight > 0."""
        sites, rows = self._rec
        a, b = np.searchsorted(sites, (lo, hi))
        rows = rows[a:b]
        if weights is not None:
            rows = rows[np.asarray(weights)[sites[a:b] - lo] > 0]
        return rows.any(0)

    def per_block(self, n_blocks: int, block_size: int) -> np.ndarray:
        """[n_blocks, N] bool: individuals with an all-zero triple in
        each bootstrap block of the first n_blocks · block_size sites."""
        sites, rows = self._rec
        out = np.zeros((n_blocks, rows.shape[1]), dtype=bool)
        k = np.searchsorted(sites, n_blocks * block_size)
        np.logical_or.at(out, sites[:k] // block_size, rows[:k])
        return out


def find_zero_rows(P, slab_sites: int = 4096):
    """The ZeroRows record of P [S, N, 3], an array or a code plane
    (utils/hostmem.CodedProbs: the codes of its table's all-zero rows),
    or None when no triple is all zero.  One pass, in slabs of sites."""
    lut = getattr(P, "lut", None)
    zero_codes = None if lut is None else np.flatnonzero(~lut.any(-1))
    if zero_codes is not None and not zero_codes.size:
        return None
    sites, rows = [], []
    for lo in range(0, P.shape[0], slab_sites):
        if zero_codes is None:
            zero = ~P[lo:lo + slab_sites].any(-1)   # NaN counts as nonzero
        else:
            zero = np.isin(P.codes[lo:lo + slab_sites], zero_codes)
        hit = np.flatnonzero(zero.any(1))
        if hit.size:
            sites.append(hit + lo)
            rows.append(zero[hit])
    if not sites:
        return None
    return ZeroRows(np.concatenate(sites), np.concatenate(rows))
