"""The code plane: one byte per (site, individual) instead of a triple.

Port of the uint8 lane of ngsdist_tpu/utils/hostmem.py.  Hard-genotype
inputs (the reference's -1/0/1/2 files, read_data.cpp:87-95) and
default-threshold --call_geno runs (gen_func.cpp:886-914) give tensors
whose every triple is one-hot or one of a few all-equal (uniform) values.
Such a tensor is its uint8 code plane plus a table of at most
3 + _CODED_MAX_UNIFORM rows: the engine uploads the codes and expands
them through the table on the device (core/distance.py expand_codes).
The table's rows are the float64 triples themselves, so the expansion is
the cast of the staged tensor to the device's dtype, bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def coded_upload_enabled(dtype) -> bool:
    """Whether fully coded tensors go to the device as their code plane
    (NGSDIST_CODED_UPLOAD, the JAX package's switch): "auto" (the
    default) on float32, that is on a card; "1" also on the CPU's
    float64 path, where the table holds float64 rows and the expansion
    is exact; "0" never.  dtype: the device's torch dtype."""
    mode = os.environ.get("NGSDIST_CODED_UPLOAD", "auto")
    if mode == "0":
        return False
    if mode == "1":
        return True
    return dtype == torch.float32


# Codes 0-2 are the one-hot genotypes; 3 and up the uniform triples, one
# code per distinct value (the reader's exp(log(1/3)) and a text input's
# all-zero empty line can both occur in one genome).
_CODED_MAX_UNIFORM = 4


def derive_codes(P3: np.ndarray, chunk_rows: int = 1 << 21):
    """(codes uint8 [S, N], lut float64 [3 + u, 3]) when every triple of
    the normal-space [S, N, 3] tensor is an exact one-hot or one of at
    most _CODED_MAX_UNIFORM all-equal values; None otherwise (the scan
    stops at the first chunk that is not).  Chunked, so that its boolean
    temporaries stay bounded on a tensor of several GB."""
    S, N = P3.shape[0], P3.shape[1]
    flat = P3.reshape(-1, 3)
    # Two probes of spread-out rows before the full pass: a large tensor
    # of soft triples whose first chunks happen to be coded would
    # otherwise pay a long scan for nothing.
    probe = 1 << 12
    if flat.shape[0] > 4 * chunk_rows:
        for frac in (0.5, 0.99):
            lo = int(flat.shape[0] * frac) // N * N
            b = flat[lo:lo + probe]
            miss = (b[:, 0] == b[:, 1]) & (b[:, 1] == b[:, 2])
            hot = (np.max(b, axis=1) == 1.0) & ((b != 0).sum(axis=1) == 1)
            if not np.all(miss | hot):
                return None
    codes = np.empty(flat.shape[0], np.uint8)
    uniform_vals: list = []
    for lo in range(0, flat.shape[0], chunk_rows):
        b = flat[lo:lo + chunk_rows]
        p0, p1, p2 = b[:, 0], b[:, 1], b[:, 2]
        miss = (p0 == p1) & (p1 == p2)
        am = np.argmax(b, axis=1).astype(np.uint8)
        # one-hot exactly: the largest component is 1, the others 0
        rows = np.arange(b.shape[0])
        hot = (b[rows, am] == 1.0) & ((b != 0).sum(axis=1) == 1)
        if not np.all(miss | hot):
            return None
        c = am
        if miss.any():
            mv = p0[miss]
            for v in np.unique(mv):
                if v not in uniform_vals:
                    uniform_vals.append(float(v))
                    if len(uniform_vals) > _CODED_MAX_UNIFORM:
                        return None
            idx = np.empty(mv.shape[0], np.uint8)
            for k, v in enumerate(uniform_vals):
                idx[mv == v] = 3 + k
            c = c.copy()
            c[miss] = idx
        codes[lo:lo + chunk_rows] = c
    # float64 rows: the upload casts the table to the device's dtype, so
    # the expansion is the cast of the float64 triple
    lut = np.zeros((3 + max(1, len(uniform_vals)), 3), np.float64)
    lut[0, 0] = lut[1, 1] = lut[2, 2] = 1.0
    for k, v in enumerate(uniform_vals):
        lut[3 + k, :] = v
    return codes.reshape(S, N), lut


def coded_call_lut(any_missing: bool) -> np.ndarray:
    """The table of default-threshold --call_geno codes
    (readers.read_geno_codes): rows 0-2 one-hot (exp(0) = 1,
    exp(-BIGNEG) = 0), row 3 the uniform exp(log(1/3)) of a missing
    triple, zero when none occurred, so that the table is derive_codes'
    on the staged tensor bit for bit (its table holds only the uniform
    values that occur; the placeholder row is zero)."""
    lut = np.zeros((4, 3), np.float64)
    lut[0, 0] = lut[1, 1] = lut[2, 2] = 1.0
    if any_missing:
        lut[3, :] = np.exp(np.log(1.0 / 3.0))
    return lut


def coded_pad_lut(lut: np.ndarray):
    """(lut, pad_code) for an upload padded with rows of its own: a pad
    row expands to the all-zero triple, which adds nothing to a sum
    without weights.  An all-zero row of the table (an empty text line)
    is reused, else one is appended.  The port's shards carry their data
    ranges and pad no host rows (parallel/mesh.py shard_ranges); this is
    the JAX package's function for a caller that does."""
    zero = np.where(~lut.any(axis=1))[0]
    if zero.size:
        return lut, int(zero[0])
    return np.vstack([lut, np.zeros((1, 3), lut.dtype)]), int(lut.shape[0])


class CodedSlab:
    """The host half of a coded upload (core/distance.py _host_pack): a
    uint8 [n, N] slice of the code plane and the table, in the device's
    dtype, that expands it."""

    __slots__ = ("codes", "lut")

    def __init__(self, codes: np.ndarray, lut: np.ndarray) -> None:
        self.codes = codes
        self.lut = lut


class CodedProbs:
    """A [S, N, 3] probability tensor whose triples are all one-hot or
    uniform, held as its uint8 code plane and table (derive_codes, or the
    fused codes reader).  It answers the engine's questions of a host
    tensor (shape, len, site slices); core/distance.py uploads its codes.
    P may be None (the fused reader never builds the float64 tensor):
    `.P` then rebuilds it from codes and table, bit for bit, at 24 bytes
    a triple, for a caller that needs the tensor itself."""

    def __init__(self, P, codes: np.ndarray, lut: np.ndarray) -> None:
        self._P = P
        self.codes = codes
        self.lut = lut

    @property
    def P(self) -> np.ndarray:
        if self._P is None:
            self._P = np.take(self.lut, self.codes.reshape(-1), axis=0
                              ).reshape(self.codes.shape + (3,))
        return self._P

    @property
    def shape(self):
        return self.codes.shape + (3,)

    @property
    def dtype(self):
        return self.lut.dtype

    def __len__(self):
        return len(self.codes)

    def __array__(self, dtype=None, copy=None):
        # a copy must not be the cached tensor, which later callers share
        if copy:
            return np.array(self.P, dtype=dtype, copy=True)
        return np.asarray(self.P, dtype)

    def __getitem__(self, key):
        # a slice of sites stays coded (the engine's chunks and shards);
        # any other index is one of the tensor
        if isinstance(key, slice):
            return CodedProbs(None if self._P is None else self._P[key],
                              self.codes[key], self.lut)
        return self.P[key]
