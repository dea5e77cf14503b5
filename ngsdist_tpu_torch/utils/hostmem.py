"""The host halves of the upload lanes: what crosses to the device per
triple.

Port of ngsdist_tpu/utils/hostmem.py.  Three lanes besides the staged
cast of all three components:

- two components (`upload23_enabled`, `pack23`): a normalized triple
  sums to 1, so the device restores p2 = 1 - p0 - p1
  (core/distance.py expand23) from p0 and p1 in the engine's dtype;
- uint16 fixed point (`upload16_enabled`, `pack16`): p0 and p1 as
  q = rint(p · 65534), 4 bytes a triple, with missingness decided on the
  host (the U16_ONE note);
- the code plane (`coded_upload_enabled`, `CodedProbs`): hard-genotype
  inputs (the reference's -1/0/1/2 files, read_data.cpp:87-95) and
  default-threshold --call_geno runs (gen_func.cpp:886-914) give tensors
  whose every triple is one-hot or one of a few all-equal (uniform)
  values; such a tensor is its uint8 code plane plus a table of at most
  3 + _CODED_MAX_UNIFORM rows, which the device expands (core/distance.py
  expand_codes).  The table's rows are the float64 triples themselves, so
  the expansion is the cast of the staged tensor to the device's dtype,
  bit for bit.

Every switch takes the engine's dtype and, where the JAX package asks
its backend, the device, as plain arguments: no global is read but the
environment variables of the JAX package's names.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

_MIN_PARALLEL_BYTES = 1 << 25  # 32 MB: below this, starting threads costs more


def _threaded(block, rows: int, nbytes: int, max_threads: int) -> None:
    """block(lo, hi) over [0, rows) in contiguous parts, one thread each,
    or in one call below _MIN_PARALLEL_BYTES: numpy releases the GIL for
    large casts, and the first touch of fresh pages runs in parallel."""
    nt = min(max_threads, os.cpu_count() or 1, max(1, rows))
    if nbytes < _MIN_PARALLEL_BYTES or nt == 1:
        block(0, rows)
        return
    bounds = [(w * rows) // nt for w in range(nt + 1)]
    ts = [threading.Thread(target=block, args=(bounds[w], bounds[w + 1]))
          for w in range(nt)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


def parallel_astype(a: np.ndarray, dtype, max_threads: int = 16) -> np.ndarray:
    """`a.astype(dtype)` with the cast and the first touch of the new
    array in threads; `a` itself when it has the dtype already (callers
    must not mutate the result)."""
    dtype = np.dtype(dtype)
    if a.dtype == dtype:
        return a
    if a.ndim == 0:
        return a.astype(dtype)
    out = np.empty(a.shape, dtype)

    def block(lo: int, hi: int) -> None:
        out[lo:hi] = a[lo:hi]

    _threaded(block, a.shape[0], a.nbytes, max_threads)
    return out


def upload23_enabled(dtype: torch.dtype) -> bool:
    """Whether uploads of probability triples send two components, p2
    restored on the device as 1 - p0 - p1 (NGSDIST_UPLOAD23, the JAX
    package's switch).  Every triple the readers give sums to 1
    (read_data.cpp:40,98; one-hot and uniform triples exactly), so the
    restored p2 lies within ~1e-7 relative in float32, for a third fewer
    bytes.  "auto" (the default): float32 engines only, as the float64
    path keeps the reference's bits; "0" never; "1" also in float64.
    dtype: the engine's torch dtype."""
    mode = os.environ.get("NGSDIST_UPLOAD23", "auto")
    if mode == "0":
        return False
    if mode == "1":
        return True
    return dtype == torch.float32


# The p0 of a packed float32 (or float64) pair marks a row that expands to
# the all-zero triple (a probability never exceeds 1): padding rows, and
# the all-zero triples of data (a text input's empty lines), which would
# otherwise read as a confident (0, 0, 1) once p2 is dropped.  Both count
# as missing on the device and add nothing to a sum without weights.
PAD23 = 2.0

# The uint16 fixed-point lane (NGSDIST_UPLOAD16): a probability goes as
# q = rint(p · U16_ONE), and q = PAD16 (65535) is the row sentinel.  The
# scale is 65534, not 65535, for two reasons: it frees the sentinel code,
# and it makes the device's missing test (|p0 - p1| < 1e-5 and |p1 - p2| <
# 1e-5, EPSILON, gen_func.hpp:16) exact on the grid.  One step, 1/65534 =
# 1.526e-5, exceeds EPSILON, so |r0 - r1| < eps iff q0 == q1, and |r1 -
# (1 - r0 - r1)| < eps iff q0 + 2 q1 == 65534; together 3 q0 == 65534,
# which has no integer solution (65534 = 2 mod 3).  No quantized data
# triple tests missing on the device: missingness is decided on the host
# at the source's precision and carried by the sentinel alone.
#
# The sentinel keeps the row's value: (PAD16, q) expands to the uniform
# triple (v, v, v), v = q / 65534, q the quantized mean of the three
# components.  Without --pairwise_del the reference uses a missing
# triple's values (its soft probabilities, ngsDist.cpp:333-364), so a
# sentinel that zeroed them would move distances (by ~3e-3 at 5% missing
# in the JAX package's measurement).  q = 0 gives the all-zero triple (pad
# tails and empty text lines); q = PAD16 the all-NaN triple (a text
# input's literal nan keeps poisoning).  An expanded sentinel row is
# all-equal, so the device classifies it missing: the host's decision.
U16_ONE = 65534
PAD16 = 65535
_MISS_EPS = 1e-5  # EPSILON (ops/indep.py, gen_func.hpp:16)


def upload16_enabled(dtype: torch.dtype, device: torch.device) -> bool:
    """Whether the two components go as uint16 fixed point (pack16), 4
    bytes a triple instead of pack23's 8 in float32.  A component is off
    by at most half a step, 0.5/65534, before the float32 rounding (PERF.md
    section 2 carries that into raw).  float32 engines only, even when
    forced: the float64 path (the CPU, --x64) keeps the reference's bits.
    NGSDIST_UPLOAD23=0 turns it off with the two-component lane it
    narrows.  "auto" (NGSDIST_UPLOAD16 unset): on for a CUDA device, where
    the host link is what the lane halves, off on the CPU (the JAX
    package's rule on its backend); "0" off, "1" on.  device: the
    engine's device (a plain argument: this reads no global)."""
    if dtype != torch.float32 or not upload23_enabled(dtype):
        return False
    mode = os.environ.get("NGSDIST_UPLOAD16", "auto")
    if mode == "0":
        return False
    if mode == "1":
        return True
    return device.type == "cuda"


def _out_slab(P3: np.ndarray, rows: int, dtype, out: np.ndarray | None) -> np.ndarray:
    """The [rows, ..., 2] slab a packer writes: `out` (pinned memory),
    checked, or a new array."""
    shape = (rows,) + P3.shape[1:-1] + (2,)
    if out is None:
        return np.empty(shape, dtype)
    if out.shape != shape or out.dtype != dtype:
        raise ValueError(f"out is {out.dtype} {out.shape}, the slab {np.dtype(dtype)} {shape}")
    return out


def pack16(P3: np.ndarray, n_rows: int | None = None, max_threads: int = 16,
           out: np.ndarray | None = None) -> np.ndarray:
    """A [S, ..., 3] normal-space probability tensor as the uint16
    two-component slab [n_rows, ..., 2] (default n_rows = S), in one
    threaded pass: quantize, the missing scan at the source's precision,
    the pad tail (PAD16, 0), written into `out` when given.  See the
    U16_ONE note for the sentinels."""
    S = P3.shape[0]
    rows = S if n_rows is None else n_rows
    out = _out_slab(P3, rows, np.uint16, out)

    def block(lo: int, hi: int) -> None:
        cp = min(hi, S)
        if lo < cp:
            b = P3[lo:cp]
            blk = out[lo:cp]
            with np.errstate(invalid="ignore"):  # NaN rows: the sentinel below
                np.copyto(blk, np.rint(b[..., :2] * U16_ONE), casting="unsafe")
            # the host's missing test (gen_func.cpp:862-868) at the
            # source's precision: such rows carry their quantized mean
            miss = ((np.abs(b[..., 0] - b[..., 1]) < _MISS_EPS)
                    & (np.abs(b[..., 1] - b[..., 2]) < _MISS_EPS))
            if miss.any():
                m = (b[..., 0] + b[..., 1] + b[..., 2])[miss] / 3.0
                blk[..., 0][miss] = PAD16
                blk[..., 1][miss] = np.rint(m * U16_ONE).astype(np.uint16)
            nan = np.isnan(b[..., 0]) | np.isnan(b[..., 1]) | np.isnan(b[..., 2])
            if nan.any():
                blk[..., 0][nan] = PAD16
                blk[..., 1][nan] = PAD16
        if cp < hi:
            pad = out[max(lo, S):hi]
            pad[...] = 0
            pad[..., 0] = PAD16

    _threaded(block, rows, P3.nbytes, max_threads)
    return out


def pack23(P3: np.ndarray, dtype: torch.dtype, device: torch.device,
           n_rows: int | None = None, max_threads: int = 16,
           out: np.ndarray | None = None) -> np.ndarray:
    """A [S, ..., 3] normal-space probability tensor as the two-component
    slab [n_rows, ..., 2] of the engine's dtype (default n_rows = S), in
    one threaded pass: the cast of p0 and p1, PAD23 on the pad tail and
    on the all-zero triples of the data, written into `out` when given.
    When upload16_enabled(dtype, device) the slab is pack16's instead:
    the lane is the slab's dtype, and the device's expand23 reads it from
    there.  The zero scan always runs (the JAX package skips it for
    binary inputs, which hold no all-zero triple: the same slab)."""
    if upload16_enabled(dtype, device):
        return pack16(P3, n_rows, max_threads, out)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    S = P3.shape[0]
    rows = S if n_rows is None else n_rows
    out = _out_slab(P3, rows, np_dtype, out)

    def block(lo: int, hi: int) -> None:
        cp = min(hi, S)
        if lo < cp:
            blk = out[lo:cp]
            blk[...] = P3[lo:cp, ..., :2]
            # the candidates on the source's values, not the cast: a
            # float64 p0 below float32's denormals casts to 0.0
            zz = (P3[lo:cp, ..., 0] == 0) & (P3[lo:cp, ..., 1] == 0)
            if zz.any():
                np.logical_and(zz, P3[lo:cp, ..., 2] == 0, out=zz)
                blk[..., 0][zz] = PAD23
        if cp < hi:
            pad = out[max(lo, S):hi]
            pad[...] = 0
            pad[..., 0] = PAD23

    _threaded(block, rows, P3.nbytes, max_threads)
    return out


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
