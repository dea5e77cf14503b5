"""Single-device distance engine (PyTorch).

Port of the single-device path of ngsdist_tpu/core/distance.py.  When
the probability tensor [S, N, 3] fits the device budget it is moved to
the device once (resident), and the full-data matrix is one call of the
independent-genotypes kernel (ops/indep.py) or the pairwise-EM kernel
(ops/em.py), chosen by `pars.indep_geno`.  Bootstrap replicates then
take one of the JAX engine's two routes over the resident tensor, by
its rule (`use_partials`):

- partial sums: one block-mode kernel call gives every bootstrap
  block's sums, and replicate r is M[r] @ B, M the block multiplicities
  of the reference's taus stream (ngsDist.cpp:416-437);
- weighted recompute: one kernel call per replicate, its per-site
  multiplicities passed as the kernel's site weights.

A longer genome streams (`stream_plan`): site chunks go through the
same kernels one after another, their sums are added in float64 in
chunk order, and a replicate is the weighted recompute chunk by chunk.
With `round_ckpt` the sums are saved after every chunk, so a killed
replicate resumes at its first unfinished chunk.

Evolutionary models 3-6 (`_iter_replicates_extended`) take the same
sums three times per matrix, over the sites of each substitution class,
and per-pair base frequencies (`pair_pi_counts`); core/submodels.py
holds the distance formulas.  On a card a class's launch runs on the
class's sites only (`class_compaction`).

Uploads run through `ChunkPipe`: one thread prepares the next host slab
(a fused read of a raw binary file through a readers.PackedBinInput
handle, or the cast of a slice of the host tensor) while, on a card,
the last one is copied from pinned memory on a copy stream.  A tensor of
hard genotypes or called genotypes travels as its uint8 code plane
(utils/hostmem.py CodedProbs, readers.CodedBinInput), one byte a triple,
and is expanded on the device through its table (`expand_codes`) into
the same tensor the staged upload gives.

Dtype policy (`default_dtype`): float64 on the CPU; on CUDA float32, or
float64 when the run asks for it (--x64, the JAX package's md5 mode; the
`x64` argument every entry point takes and hands down, never a switch of
the module or the environment).  On the CPU the kernels' plain versions
run; on CUDA the hand-written kernels do, each dtype through entries of
its own.  Every planner reckons in the run's itemsize, and a function
that holds the tensor takes its dtype.  Under x64 the fused pack23 read,
the code plane and the count split (`_exact_count_parts`) are off, as
under the JAX package's x64 rules: the tensor is read staged and
uploaded in float64.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..config import NgsDistError, Params
from ..ops.em import em_block_partials, em_raw_cnt
from ..ops.indep import (EPSILON, block_partials_shape, indep_block_partials,
                         indep_raw_cnt, scratch_shape)
from ..utils import checkpoint as ckpt
from ..utils import profiling
from ..utils.hostmem import (PAD16, U16_ONE, CodedProbs, CodedSlab, pack23, parallel_astype,
                              upload16_enabled, upload23_enabled)
from . import bootstrap as bt
from . import models
from . import submodels as sm
from .preprocess import find_zero_rows

# The partial-sum route is taken when the block partials, reckoned in the
# device's dtype, fit here: the value of
# ngsdist_tpu.core.distance.PARTIALS_BUDGET_BYTES, so that both engines
# take the same route at the same shape.
PARTIALS_BUDGET_BYTES = 1 << 30

# A streamed run holds two chunks at once (the next one is uploaded while
# the current one computes), so the planner keeps KEEP/DEN of the
# per-chunk budget for the current chunk and leaves the rest to the
# prefetched one.  Tests derive expected chunk sizes from these.
PREFETCH_KEEP_NUM = 3
PREFETCH_KEEP_DEN = 4

# Streamed chunks must be small enough to PIPELINE, not merely to fit:
# the first chunk's read has nothing to overlap with.  The planner
# therefore aims at STREAM_MIN_CHUNKS chunks at least, none shorter than
# STREAM_MIN_CHUNK_SITES, so that the work per chunk (launches, the
# fetch of the sums, a round checkpoint) stays small beside the chunk;
# the budget remains the hard upper bound.  The JAX engine's values, so
# that one NGSDIST_DEVICE_BUDGET gives both engines the same chunk
# edges; on an H100 they lie on the plateau of wall time against chunk
# length (flat from 8,192 sites up at 1024 individuals, slower below:
# PERF.md section 7).
STREAM_MIN_CHUNKS = 16
STREAM_MIN_CHUNK_SITES = 16384

# Under the JAX engine's rule the resident tensor may take a third of
# the budget (the other two thirds stood for that engine's layout
# copies).  It holds wherever the budget is NGSDIST_DEVICE_BUDGET or its
# 12 GiB default (the CPU), so that no run changes its route between
# the two engines.
_WORKING_SET_FACTOR = 3
_DEFAULT_BUDGET = 12 << 30

# A card planned from its free memory: a resident run holds the tensor
# and the kernels' working set (`working_set_bytes`); a streamed run a
# ring of two chunks and one packed staging slab (2 + 2/3 chunks), which
# at KEEP/DEN of the per-chunk budget fills the memory when the budget
# is half of it.  One sixteenth of the free memory stays unplanned.  A
# chunk is held to _CUDA_MAX_CHUNK_BYTES besides: two pinned slabs of
# two thirds of it are page-locked host memory, and no chunk above a
# tenth of this was any faster.
_CUDA_STREAM_FACTOR = 2
_CUDA_RESERVE_DEN = 16
_CUDA_MAX_CHUNK_BYTES = 1 << 30

# The float32 entries return float32 counts: exact while one call's
# weighted count stays below 2^24 (PERF.md section 2).
_EXACT_COUNT = (1 << 24) - 1

# Resident upload of a fused-read source: bytes of the packed slabs that
# are read, copied and expanded one after another (NGSDIST_PIPE_UPLOAD_BYTES
# overrides).  Smaller slabs expose less of the first read, the only one
# no copy overlaps.
PIPE_UPLOAD_BYTES = 32 << 20

# A packed or coded slab crosses to a card through a device stage of at
# most this many bytes, in parts, each expanded before the next is
# copied: the stage adds a bounded amount to a stream's two chunks,
# whatever their length.
_STAGE_BYTES = 8 << 20


def default_dtype(device: torch.device, x64: bool) -> torch.dtype:
    """The engine's dtype on `device` for a run that asks (x64) or does
    not ask for float64: float64 on the CPU either way (its path has
    always been float64), on a card float32 unless x64."""
    return torch.float64 if device.type == "cpu" or x64 else torch.float32


def itemsize(device: torch.device, x64: bool) -> int:
    """Bytes of one value of the engine's dtype, as the planners reckon."""
    return torch.finfo(default_dtype(device, x64)).bits // 8


def engine_name(device: torch.device, x64: bool) -> str:
    """Numeric environment of a run, for the checkpoint fingerprint: a
    resume must not append CUDA float32 matrices to a float64 file (CPU
    or --x64), nor the other way round."""
    return f"torch-{device.type}-{str(default_dtype(device, x64)).split('.')[-1]}"


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def expand23(P2: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[..., 2] -> [..., 3] with p2 = 1 - p0 - p1, the device half of the
    two-component upload (ngsdist_tpu.core.distance.expand23), written
    into `out` when given, with no temporary of the tensor's size.

    A float slab: a triple whose p0 is above 1.5 (PAD23: padding and
    all-zero triples) expands to all zero.  A uint16 slab (hostmem.pack16)
    expands to float32 r = q · float32(1/65534), one multiply as in the
    JAX function, p2 = 1 - q0 · float32(1/65534) rounded once, minus r1
    (_expand16); a sentinel row (p0 == PAD16) to the uniform triple
    (r1, r1, r1) of its quantized mean, all NaN where p1 is PAD16 too.
    The JAX package keeps this endpoint form (1/65534 · 65534 is 1 within
    an ulp) rather than a select of 1.0 at q == 65534: its docstring says
    why; the port keeps its bits."""
    if P2.dtype == torch.uint16:
        return _expand16(P2, out)
    if out is None:
        out = torch.empty(P2.shape[:-1] + (3,), dtype=P2.dtype, device=P2.device)
    out[..., :2] = P2
    # (1 - p0) - p1: -p0 + 1 is 1 - p0 exactly
    out[..., 2].copy_(P2[..., 0]).neg_().add_(1.0).sub_(P2[..., 1])
    out.masked_fill_(P2[..., 0:1] > 1.5, 0.0)
    return out


# float32(1/65534): the one factor of the dequantization
_U16_STEP = float(np.float32(1.0 / U16_ONE))
# Rows of a uint16 slab whose p2 goes through one float64 scratch block
# (_expand16): 32 MiB of it at most, whatever the slab's size.
_U16_BLOCK = 1 << 22


def _expand16(Q: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    """expand23 of a uint16 slab, in place in `out` (float32, contiguous):
    the codes are exact in float32, so the sentinel tests read them there
    before the multiply.  p2 is float32(1 - q0 x step) - r1, with 1 - q0 x
    step exact in float64 (q0 x step has at most 40 significant bits) and
    rounded once, as the JAX function's compiler computes it on the CPU
    (the multiply fused into the subtraction); a float64 scratch block of
    at most _U16_BLOCK rows at a time."""
    if out is None:
        out = torch.empty(Q.shape[:-1] + (3,), dtype=torch.float32, device=Q.device)
    o, q = out.view(-1, 3), Q.reshape(-1, 2)
    o[:, :2] = q
    pad = o[:, 0] == PAD16
    nan_row = (pad & (o[:, 1] == PAD16)).unsqueeze(-1)
    for lo in range(0, o.shape[0], _U16_BLOCK):
        blk = o[lo:lo + _U16_BLOCK]
        blk[:, 2].copy_(blk[:, 0].double().mul_(-_U16_STEP).add_(1.0))
    o[:, :2].mul_(_U16_STEP)
    o[:, 2].sub_(o[:, 1])
    # sentinel rows: (r1, r1, r1); where() writes its own input in place
    for g in (0, 2):
        torch.where(pad, o[:, 1], o[:, g], out=o[:, g])
    o.masked_fill_(nan_row, float("nan"))
    return out


def expand_codes(codes: torch.Tensor, lut: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 codes [..., N] and a [K, 3] table -> [..., N, 3]: the device
    half of the coded upload (ngsdist_tpu.core.distance.expand_codes, an
    XLA gather there), a gather of the table's rows by the codes (through
    an int32 index, 4 bytes a code), written into `out` (contiguous) when
    given.  The JAX package gathers each component as a plane of its own
    because a TPU pads a trailing dimension of 3 to 128 lanes; a card
    does not."""
    idx = codes.reshape(-1).int()
    if out is None:
        return lut.index_select(0, idx).reshape(codes.shape + (3,))
    torch.index_select(lut, 0, idx, out=out.view(-1, 3))
    return out


def _host_pack(src, lo: int, hi: int, dtype: torch.dtype, device: torch.device,
               out: Optional[np.ndarray] = None):
    """Host half of an upload: the upload-ready slab of sites [lo, hi)
    in the lane of slab_layout(src, dtype, device), written into `out`
    (pinned memory of that layout) when given — a CodedSlab (uint8
    [hi-lo, N] codes and the table in the device's dtype) from a coded
    source; a handle's own slab (readers.PackedBinInput, DiskRows); from
    a host array the two-component slab of hostmem.pack23 (uint16 or the
    engine's dtype) where that lane is on, else the cast of the slice (no
    copy where the dtype already fits).  The one place that decides a
    host array's lane; no device traffic, so the ChunkPipe runs it on its
    reader thread."""
    with profiling.host_span("read"):
        if isinstance(src, CodedProbs):
            codes = src.codes[lo:hi]
            if out is None:
                codes = np.ascontiguousarray(codes)
            else:
                np.copyto(out, codes)
                codes = out
            return CodedSlab(codes, src.lut.astype(_np_dtype(dtype)))
        if hasattr(src, "read_packed"):
            got = src.read_packed(lo, hi, out=out)
            if getattr(src, "width", 2) == 1:
                return CodedSlab(got, src.lut.astype(_np_dtype(dtype)))
            return got
        if upload23_enabled(dtype):
            return pack23(src[lo:hi], dtype, device, out=out)
        if out is None:
            return parallel_astype(src[lo:hi], _np_dtype(dtype))
        np.copyto(out, src[lo:hi], casting="same_kind")
        return out


def slab_layout(src, dtype: torch.dtype, device: torch.device):
    """(values a triple, torch dtype) of the host slabs _host_pack gives
    for a source on an engine of this dtype and device: (1, uint8) for a
    code plane (a CodedProbs, or a handle of `width` 1 with its `lut`);
    for a handle of `width` 2 (the default) (2, uint16) or (2, float32) by
    its `u16` lane, of width 3 (3, dtype); for a host array (2, uint16)
    on the uint16 lane, (2, dtype) on the two-component lane, else
    (3, dtype).  p2 of a pair is restored on the device (expand23)."""
    if isinstance(src, CodedProbs):
        return 1, torch.uint8
    if hasattr(src, "read_packed"):
        width = getattr(src, "width", 2)
        pair = torch.uint16 if getattr(src, "u16", False) else torch.float32
    else:
        width = 2 if upload23_enabled(dtype) else 3
        pair = torch.uint16 if upload16_enabled(dtype, device) else dtype
    return {1: (1, torch.uint8), 2: (2, pair)}.get(width, (width, dtype))


def put_probs(P_slice, device: torch.device, x64: bool) -> torch.Tensor:
    """Upload a host probability slab ([S, N, 3] array, a CodedProbs or a
    fused-read handle) in one piece, in the run's dtype and lane (packed
    or cast on the host, so only the bytes of the lane cross to a card);
    a two-component slab or a code plane is expanded on the device."""
    arr = _host_pack(P_slice, 0, P_slice.shape[0], default_dtype(device, x64), device)
    if isinstance(arr, CodedSlab):
        profiling.count_upload(arr.codes.nbytes + arr.lut.nbytes)
        return expand_codes(torch.from_numpy(arr.codes).to(device),
                            torch.from_numpy(arr.lut).to(device))
    profiling.count_upload(arr.nbytes)
    t = torch.from_numpy(arr).to(device)
    return expand23(t) if t.shape[-1] == 2 else t


def _upload_small(arr: np.ndarray, device: torch.device,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A small host array (site weights, a site list) on the device, cast
    on the host.  On a card it goes through pinned memory without
    blocking: a copy from pageable memory makes the host wait for the
    kernels queued before it, which would undo the engine's lookahead."""
    t = torch.from_numpy(arr)
    if dtype is not None:
        t = t.to(dtype)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _pipe_upload_bytes() -> int:
    """Slab size of the resident pipelined upload; a value of
    NGSDIST_PIPE_UPLOAD_BYTES that is no integer is ignored."""
    try:
        return max(1 << 20, int(os.environ["NGSDIST_PIPE_UPLOAD_BYTES"]))
    except (KeyError, ValueError):
        return PIPE_UPLOAD_BYTES


class ChunkPipe:
    """Site ranges of a source (a host [S, N, 3] array, a CodedProbs, a
    fused-read handle, or any handle with its read protocol: `shape`,
    `read_packed`, a slab `width`, its `u16` lane and, coded, a `lut`),
    prepared on the host by one reader thread (_host_pack) and brought to
    the device in order (ngsdist_tpu.core.distance._pipelined_chunks).

    On a card the reader fills a ring of two pinned slabs of the source's
    slab_layout; each slab is copied on a copy stream (`non_blocking`)
    and, packed or coded, through a device stage of _STAGE_BYTES in parts
    expanded there, into `dest[lo:hi]` (a resident upload) or into a ring
    of two chunk buffers (a stream).  A coded
    source's table goes to the device once, with the pipe.  A pinned slab
    is refilled only after the event behind its copy, a chunk buffer only
    after the event behind the work the consumer queued on it, and the
    consumer's stream waits for the event behind each chunk's expansion.
    All buffers are allocated once, for ranges of at most `rows` sites,
    whatever the lane: a uint8 slab of `rows` sites is a twelfth of a
    float32 one, a uint16 pair slab a sixth.  On the CPU the same
    generator yields the chunks in order with no stream and no ring."""

    def __init__(self, src, device: torch.device, dtype: torch.dtype, rows: int,
                 dest: Optional[torch.Tensor] = None) -> None:
        self.src, self.device, self.dtype, self.dest = src, device, dtype, dest
        width, slab_dtype = slab_layout(src, dtype, device)
        self.packed, self.coded = width == 2, width == 1
        if self.packed and dtype != torch.float32 and slab_dtype != dtype:
            raise ValueError("a fused-read source holds float32 slabs")
        self.cuda = device.type == "cuda"
        if self.coded:
            self.lut = _upload_small(np.ascontiguousarray(src.lut), device, dtype)
        if not self.cuda:
            return
        N = src.shape[1]
        slab = (rows, N) if self.coded else (rows, N, width)
        self.host = [torch.empty(slab, dtype=slab_dtype, pin_memory=True) for _ in range(2)]
        self.copied = [None, None]       # events: a pinned slab's copy is done
        self.stream = torch.cuda.Stream(device)
        self.stage = None
        if width < 3:  # a packed or coded slab goes up in parts of the stage's rows
            self.stage_rows = max(1, min(rows, _STAGE_BYTES // (N * width * slab_dtype.itemsize)))
            self.stage = torch.empty((self.stage_rows,) + slab[1:], dtype=slab_dtype,
                                     device=device)
        if dest is None:
            self.ring = [torch.empty((rows, N, 3), dtype=dtype, device=device)
                         for _ in range(2)]
            self.consumed = [None, None]  # events: the consumer is done with a buffer

    def _read(self, k: int, lo: int, hi: int):
        out = None
        if self.cuda:
            if self.copied[k % 2] is not None:
                self.copied[k % 2].synchronize()
            out = self.host[k % 2][:hi - lo].numpy()
        return _host_pack(self.src, lo, hi, self.dtype, self.device, out=out)

    def _expand(self, t: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
        """A packed or coded slab on the device as its [n, N, 3] triples."""
        if self.coded:
            return expand_codes(t, self.lut, out=out)
        return expand23(t, out=out)

    def _send(self, k: int, lo: int, hi: int, arr) -> torch.Tensor:
        if not self.cuda:
            with profiling.host_span("upload"):
                if self.coded:
                    arr = arr.codes
                profiling.count_upload(arr.nbytes)
                t = torch.from_numpy(arr)
                out = None if self.dest is None else self.dest[lo:hi]
                if self.packed or self.coded:
                    return self._expand(t, out)
                return t if out is None else out.copy_(t)
        slot, n = k % 2, hi - lo
        if self.dest is not None:
            out = self.dest[lo:hi]
        else:
            out = self.ring[slot][:n]
            if self.consumed[slot] is not None:
                self.stream.wait_event(self.consumed[slot])
        with torch.cuda.stream(self.stream), profiling.device_span("upload", self.stream):
            src = self.host[slot][:n]
            profiling.count_upload(src.numel() * src.element_size())
            if self.stage is None:
                out.copy_(src, non_blocking=True)
            else:
                for a in range(0, n, self.stage_rows):
                    b = min(n, a + self.stage_rows)
                    self.stage[:b - a].copy_(src[a:b], non_blocking=True)
                    self._expand(self.stage[:b - a], out[a:b])
            self.copied[slot] = torch.cuda.Event()
            self.copied[slot].record(self.stream)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        torch.cuda.current_stream(self.device).wait_event(ready)
        return out

    def chunks(self, ranges):
        """Yield (chunk [hi-lo, N, 3] on the device, lo, hi) for each
        (lo, hi) of ranges, in order.  A chunk of a stream is valid
        until the next one is asked for."""
        if not ranges:
            return
        if self.cuda:  # after whatever used this memory before
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with ThreadPoolExecutor(1) as reader:
            fut = reader.submit(self._read, 0, *ranges[0])
            for k, (lo, hi) in enumerate(ranges):
                arr = fut.result()
                # the next read goes into the other slab, whose copy was
                # queued a chunk ago: start it before this chunk's upload
                # is queued, so that the upload runs under it
                if k + 1 < len(ranges):
                    fut = reader.submit(self._read, k + 1, *ranges[k + 1])
                Pc = self._send(k, lo, hi, arr)
                yield Pc, lo, hi
                if self.cuda and self.dest is None:
                    self.consumed[k % 2] = torch.cuda.Event()
                    self.consumed[k % 2].record(torch.cuda.current_stream(self.device))


def upload_resident(src, device: torch.device, x64: bool) -> torch.Tensor:
    """The whole source as the resident tensor.  A host tensor or code
    plane on the CPU takes one step (no copy where the dtype fits).  On a
    card, and for a fused-read handle, slabs of _pipe_upload_bytes() go
    through a ChunkPipe into the tensor one after another: one pass over
    a handle's file, no float64 host tensor, each slab's copy under the
    next one's read (ngsdist_tpu.core.distance._upload_packed_pipelined).
    A slab holds _pipe_upload_bytes() of its lane's bytes; a coded one
    the sites of a staged slab (its rows fill _pipe_upload_bytes() of the
    tensor)."""
    if device.type != "cuda" and not hasattr(src, "read_packed"):
        return put_probs(src, device, x64)
    dtype = default_dtype(device, x64)
    S, N = src.shape[:2]
    width, slab_dtype = slab_layout(src, dtype, device)
    slab_site_bytes = N * (3 * dtype.itemsize if width == 1 else width * slab_dtype.itemsize)
    step = max(1, _pipe_upload_bytes() // max(1, slab_site_bytes))
    P = torch.empty((S, N, 3), dtype=dtype, device=device)
    pipe = ChunkPipe(src, device, dtype, max(1, min(step, S)), dest=P)
    for _ in pipe.chunks([(lo, min(lo + step, S)) for lo in range(0, S, step)]):
        pass
    return P


def working_set_bytes(rows: int, N: int, device: torch.device, indep: bool,
                      x64: bool) -> int:
    """Device bytes the engine holds beside a [rows, N, 3] tensor: the
    kernels' [N, N] outputs and the pair vectors taken from them, the
    float64 sums of a stream, the site weights and (indep) the kernel's
    float64 chunk partials."""
    need = (4 * N * N + rows) * itemsize(device, x64) + 4 * 8 * (N * (N - 1) // 2)
    shape = scratch_shape(N, rows) if indep else None
    if shape is not None:
        need += 8 * int(np.prod(shape))
    return need


def check_fits(S: int, N: int, device: torch.device, indep: bool, x64: bool):
    """The bytes of the card's free memory left beside the resident
    tensor and its working set — negative when they do not fit and the
    run must stream — or None on the CPU."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    free -= free // _CUDA_RESERVE_DEN
    return (free - S * N * 3 * itemsize(device, x64)
            - working_set_bytes(S, N, device, indep, x64))


def _stream_chunk_sites(S: int, N: int, itemsize: int, budget: int,
                        min_chunks: int = STREAM_MIN_CHUNKS,
                        min_chunk_sites: int = STREAM_MIN_CHUNK_SITES) -> int:
    """Site-chunk length of a streamed run (the JAX engine's rule)."""
    cap = max(1, (budget * PREFETCH_KEEP_NUM // PREFETCH_KEEP_DEN)
              // max(1, N * 3 * itemsize))
    depth = -(-S // min_chunks)
    return max(1, min(cap, max(depth, min_chunk_sites)))


def _env_budget() -> Optional[int]:
    """NGSDIST_DEVICE_BUDGET in bytes, the name the JAX engine reads, or
    None when it is not set."""
    raw = os.environ.get("NGSDIST_DEVICE_BUDGET")
    return None if raw is None else int(raw)


def stream_plan(S: int, N: int, device: torch.device, left: Optional[int], x64: bool):
    """(chunked, chunk sites): whether the [S, N, 3] tensor streams, and
    in chunks of how many sites.  On the CPU, and on a card under
    NGSDIST_DEVICE_BUDGET, by the JAX engine's rule: the tensor streams
    when it exceeds a third of the budget (12 GiB by default).  A card
    left to itself streams what does not fit its free memory (`left`,
    check_fits) and sizes the chunks so that the stream's ring fits it,
    none above _CUDA_MAX_CHUNK_BYTES."""
    size = itemsize(device, x64)
    tensor = S * N * 3 * size
    env = _env_budget()
    if device.type != "cuda" or env is not None:
        budget = max(1, (_DEFAULT_BUDGET if env is None else env) // _WORKING_SET_FACTOR)
        chunked = tensor > budget
        chunk = (_stream_chunk_sites(S, N, size, budget, STREAM_MIN_CHUNKS,
                                     STREAM_MIN_CHUNK_SITES) if chunked else S)
        return chunked, chunk
    if left >= 0:
        return False, S
    budget = min((left + tensor) // _CUDA_STREAM_FACTOR,
                 _CUDA_MAX_CHUNK_BYTES * PREFETCH_KEEP_DEN // PREFETCH_KEEP_NUM)
    return True, _stream_chunk_sites(S, N, size, max(1, budget), STREAM_MIN_CHUNKS,
                                     STREAM_MIN_CHUNK_SITES)


def _exact_count_parts(n: int, weights: Optional[np.ndarray], limit: int = _EXACT_COUNT):
    """Split n sites into consecutive (a, b) parts whose weighted count
    (weights None: their length) stays within limit, as few as a walk
    from the left gives."""
    if weights is None:
        return [(a, min(a + limit, n)) for a in range(0, n, limit)] or [(0, 0)]
    cum = np.cumsum(weights)
    if n == 0 or cum[-1] <= limit:
        return [(0, n)]
    parts, a, base = [], 0, 0.0
    while a < n:
        b = max(a + 1, int(np.searchsorted(cum, base + limit, side="right")))
        parts.append((a, b))
        a, base = b, cum[b - 1]
    return parts


def use_partials(n_blocks: int, N: int, pairwise_del: bool,
                 device: torch.device, x64: bool) -> bool:
    """The JAX engine's rule for the partial-sum bootstrap route
    (ngsdist_tpu/core/distance.py:851-852), in the run's dtype."""
    partial_bytes = n_blocks * N * N * itemsize(device, x64) * (2 if pairwise_del else 1)
    return partial_bytes <= PARTIALS_BUDGET_BYTES


def partials_bytes(n_blocks: int, N: int, indep: bool, pairwise_del: bool) -> int:
    """Device bytes of the block partials, float64: B and C per pair and,
    indep, the kernel's tiles they are gathered from.  On a card they
    can reach about twice what use_partials reckons."""
    per_block = N * (N - 1) // 2 * (2 if pairwise_del or not indep else 1)
    if indep:
        per_block += int(np.prod(block_partials_shape(N, 1)))
    return 8 * n_blocks * per_block


def bootstrap_site_maps(seed: int, n_boot_rep: int, n_sites: int,
                        block_size: int):
    """(n_trunc, maps): each bootstrap replicate's map from the sites of
    the block-truncated genome to the sites it draws, from the
    reference's taus stream (ngsDist.cpp:416-437)."""
    return bt.site_maps(seed, n_boot_rep, n_sites, block_size)


def replicate_weights(site_map: np.ndarray, n_trunc: int) -> np.ndarray:
    """[n_trunc] float64: how often one replicate draws each site, the
    kernels' site weights for that replicate."""
    return np.bincount(site_map, minlength=n_trunc).astype(np.float64)


def _pair_indices(n_ind: int):
    iu = np.triu_indices(n_ind, k=1)
    return iu[0].astype(np.int32), iu[1].astype(np.int32)


def _scatter_pairs(vals: np.ndarray, I: np.ndarray, J: np.ndarray, n_ind: int) -> np.ndarray:
    out = np.zeros(vals.shape[:-1] + (n_ind, n_ind), dtype=np.float64)
    out[..., I, J] = vals
    out[..., J, I] = vals
    return out


def _em_poison_pairs(raw_v: torch.Tensor, z: torch.Tensor, I, J) -> torch.Tensor:
    """NaN the pair entries whose either member z [N] flags: without
    pairwise deletion the reference runs its EM on an all-zero triple and
    gets NaN for every pair touching the individual; the kernels exclude
    zero rows, so the poison is re-applied after."""
    return torch.where(z[I] | z[J], torch.full_like(raw_v, float("nan")), raw_v)


def _finalize(raw: np.ndarray, cnt, pars: Params, on_stats=None) -> np.ndarray:
    """raw/cnt -> averaged, model-corrected float64 matrix with zero diag.

    on_stats(raw, cnt): pre-correction sufficient statistics hook with
    the TRUE valid-site count — the reference's verbose>=3 report prints
    cnt before the --tot_sites override (ngsDist.cpp:366-373), and the
    throughput meter counts the updates the hot loop actually executed."""
    raw = np.asarray(raw, dtype=np.float64)
    true_cnt = None if cnt is None else (
        np.asarray(cnt, dtype=np.float64) if isinstance(cnt, np.ndarray) else float(cnt)
    )
    if pars.tot_sites > 0:
        denom = float(pars.tot_sites)
    elif cnt is None:
        raise ValueError("cnt required when tot_sites is not set")
    else:
        denom = true_cnt
    if on_stats is not None:
        on_stats(raw, true_cnt if true_cnt is not None else denom)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = raw / denom
        d = models.apply_evol_model(d, pars.evol_model, xp=np)
    if d.ndim == 2:
        np.fill_diagonal(d, 0.0)
    return d


def _make_exact_stats(indep: bool, pairwise_del: bool, score, device: torch.device,
                      It, Jt, zero, tiles=None):
    """The engine's call into the kernels, for one run (or one mesh
    entry): returns exact_stats(Psub, weights=None, lo=0, index=None) ->
    (raw, cnt or None), pair vectors at (It, Jt) on the device.  score:
    the 3 x 3 scores on the host (the wrappers pass them to their kernels
    by value: from a device tensor every launch would wait for the card to
    fetch them).  zero: the run's record of all-zero triples where the EM
    must poison for them, else None.  tiles: the kernel's tile list (a
    pairs-axis shard, parallel/mesh.py), else None.  The dtype is the
    tensor's: the weights go up in it, and its kernels' entries run."""
    score = torch.as_tensor(score, dtype=torch.float64).reshape(3, 3)

    def full_stats(Psub, weights, lo, index=None):
        """(raw, cnt or None) pair vectors on the device for the sites
        Psub = [lo, lo + len) of the data; weights: their multiplicities
        on the host, or None.  index [n] int64 on the device: run on these
        sites of Psub only, weights [n] theirs.  The EM kernel reads the
        list itself; for the indep kernel, which stages slabs of
        consecutive sites, they are gathered first."""
        w = None if weights is None else _upload_small(weights, device, Psub.dtype)
        with profiling.device_span("kernel"):
            if indep:
                if index is not None:
                    Psub = Psub.index_select(0, index)
                raw_m, cnt_m = indep_raw_cnt(Psub, score, pairwise_del, w, tiles=tiles)
                return raw_m[It, Jt], (cnt_m[It, Jt] if pairwise_del else None)
            raw_m, cnt_m = em_raw_cnt(Psub, score.reshape(-1), pairwise_del, w,
                                      site_index=index, tiles=tiles)
            raw_v = raw_m[It, Jt]
            if zero is not None:
                z = zero.individuals(lo, lo + Psub.shape[0], weights)
                if z.any():
                    raw_v = _em_poison_pairs(raw_v, torch.from_numpy(z).to(device), It, Jt)
            return raw_v, cnt_m[It, Jt]

    def exact_stats(Psub, weights=None, lo=0, index=None):
        """full_stats, in float32 over parts of the sites whose counts
        stay exact, the parts added in float64; float64 (the CPU, --x64)
        in one call, whose counts are float64 throughout."""
        n = Psub.shape[0] if index is None else index.shape[0]
        parts = [(0, n)] if Psub.dtype == torch.float64 else _exact_count_parts(n, weights)
        if len(parts) == 1:
            return full_stats(Psub, weights, lo, index)
        raw = cnt = None
        for a, b in parts:
            wp = None if weights is None else weights[a:b]
            if index is None:
                r, c = full_stats(Psub[a:b], wp, lo + a)
            else:
                r, c = full_stats(Psub, wp, lo, index[a:b])
            raw = r.double() if raw is None else raw + r.double()
            if c is not None:
                cnt = c.double() if cnt is None else cnt + c.double()
        return raw, cnt

    return exact_stats


def iter_replicates(
    pars: Params,
    P_host,
    maps: List[np.ndarray],
    n_trunc: int,
    device: torch.device,
    on_stats=None,
    start_rep: int = 0,
    round_ckpt: bool = False,
    alleles=None,
    mesh=None,
    x64: bool = False,
) -> Iterator[np.ndarray]:
    """Yield the full-data matrix, then one matrix per bootstrap
    replicate, for replicates start_rep..n_boot_rep.

    P_host: the host [S, N, 3] float64 array, or a fused-read handle
    (readers.PackedBinInput) whose float32 slabs come from disk as the
    engine asks for them.

    round_ckpt: save the accumulated sums after every chunk of a
    streamed replicate (utils/checkpoint.save_rounds), so that an
    interruption loses at most one chunk; the runner asks for it when
    it owns the output file.

    alleles: (a1, a2) int8 allele codes of the sites (core/submodels.py),
    which evolutionary models 3-6 need.

    mesh: a parallel.mesh.Mesh (device is then its first device): the
    sites, and along a pairs axis the pairs, are sharded over its devices
    (_iter_replicates_sharded; models 3-6: _mesh_class_stats); P_host is
    then the host array or a parallel.multihost.SiteStream (built with
    the same x64).

    x64: the run computes in float64 on a card (--x64; the CPU always
    does): the upload, every planner and the kernels' entries follow."""
    if pars.evol_model >= 3:
        yield from _iter_replicates_extended(pars, P_host, maps, n_trunc, alleles, device,
                                             on_stats, start_rep, round_ckpt, mesh, x64)
        return
    if mesh is not None:
        yield from _iter_replicates_sharded(pars, P_host, maps, n_trunc, mesh, on_stats,
                                            start_rep, round_ckpt, x64)
        return
    N, S = pars.n_ind, pars.n_sites
    dtype = default_dtype(device, x64)
    score = torch.as_tensor(pars.score, dtype=dtype)
    I, J = _pair_indices(N)
    It = torch.from_numpy(I).long().to(device)
    Jt = torch.from_numpy(J).long().to(device)
    n_blocks = n_trunc // pars.boot_block_size
    left = check_fits(S, N, device, pars.indep_geno, x64)
    chunked, chunk = stream_plan(S, N, device, left, x64)
    partials = (not chunked) and use_partials(n_blocks, N, pars.pairwise_del, device, x64) and (
        left is None
        or partials_bytes(n_blocks, N, pars.indep_geno, pars.pairwise_del) <= left)
    # The EM's zero-row poison needs the all-zero triples of the data.
    # Binary inputs cannot hold one (every parsed row normalises to sum
    # 1); for the others they are recorded here, once per run.
    zero = None
    if not (pars.indep_geno or pars.pairwise_del or pars.in_bin):
        zero = find_zero_rows(P_host)
    if chunked:
        pipe = ChunkPipe(P_host, device, dtype, chunk)
    else:
        P = upload_resident(P_host, device, x64)

    exact_stats = _make_exact_stats(pars.indep_geno, pars.pairwise_del, score, device, It, Jt,
                                    zero)

    def stats_stream(weights=None, n_used=S, rep=0):
        """(raw, cnt or None) of the first n_used sites.  Streamed: the
        chunks' float64 sums in chunk order, which are exact partial sums
        of a deterministic computation, so a replicate resumed from its
        rounds file gives the bytes of an uninterrupted one."""
        if not chunked:
            return exact_stats(P if n_used == S else P[:n_used], weights)
        rounds, chunk_of = _pipe_rounds(
            pipe, [(lo, min(lo + chunk, n_used)) for lo in range(0, n_used, chunk)])

        def step(r):
            Pc, lo, hi = chunk_of(r)
            raw, cnt = exact_stats(Pc, None if weights is None else weights[lo:hi], lo)
            return {"raw": raw, "cnt": cnt}

        acc = _round_sums(pars, rep, round_ckpt, device, x64, chunk, rounds, step)
        return acc["raw"], acc.get("cnt")

    def to_matrix(rep, raw_v, cnt_v, n_used):
        """Replicate rep's corrected matrix from its pair vectors."""
        with profiling.replicate(rep):
            with profiling.host_span("fetch"):
                raw = raw_v.cpu().double().numpy()
                cnt = None if cnt_v is None else cnt_v.cpu().double().numpy()
            with profiling.host_span("matrix"):
                raw_m = _scatter_pairs(raw, I, J, N)
                cnt_m = None if cnt is None else _scatter_pairs(cnt, I, J, N)
                denom = cnt_m if pars.pairwise_del else float(n_used)
                return _finalize(raw_m, denom, pars, on_stats)

    if start_rep == 0:
        with profiling.replicate(0):
            full = stats_stream()
        yield to_matrix(0, *full, S)

    reps = [r for r in range(pars.n_boot_rep) if r + 1 >= start_rep]
    if not reps:
        return

    if partials:
        for r, (raw_v, cnt_v) in zip(reps, _resum_blocks(pars, P[:n_trunc], score, n_blocks,
                                                         reps, It, Jt, zero)):
            yield to_matrix(r + 1, raw_v, cnt_v, n_trunc)
        return

    def dispatch(r):
        with profiling.replicate(r + 1):
            return stats_stream(replicate_weights(maps[r], n_trunc), n_trunc, r + 1)

    # Resident runs launch replicate r+1 before fetching replicate r, so
    # the device computes the next replicate while the host corrects and
    # writes.  A streamed replicate fetches as it goes, so looking ahead
    # would only compute a whole replicate early.
    lookahead = not chunked
    pending = dispatch(reps[0]) if lookahead else None
    for k, r in enumerate(reps):
        if lookahead:
            raw_v, cnt_v = pending
            if k + 1 < len(reps):
                pending = dispatch(reps[k + 1])
        else:
            raw_v, cnt_v = dispatch(r)
        yield to_matrix(r + 1, raw_v, cnt_v, n_trunc)


def _resum_blocks(pars: Params, Ptrunc: torch.Tensor, score: torch.Tensor,
                  n_blocks: int, reps: List[int], It, Jt, zero=None):
    """The partial-sum route (ngsdist_tpu/core/distance.py:856-890): one
    block-mode kernel call, then for each replicate r in reps its
    (raw, cnt or None) pair vectors M[r] @ B and M[r] @ C in float64,
    M[r] the multiplicity of each block in replicate r.  zero: the run's
    record of all-zero triples (preprocess.ZeroRows) where the EM must
    poison for them, else None."""
    bs = pars.boot_block_size
    if pars.indep_geno:
        B, C = indep_block_partials(Ptrunc, score, pars.pairwise_del, n_blocks, bs)
    else:
        B, C = em_block_partials(Ptrunc, score.reshape(-1), pars.pairwise_del,
                                 n_blocks, bs)
        C = C if pars.pairwise_del else None  # the denominator is n_trunc
    # float64 already, from the kernels and from the CPU's float64 policy
    B, C = B.double(), None if C is None else C.double()
    table = bt.block_index_table(pars.seed, pars.n_boot_rep, n_blocks)
    M = torch.from_numpy(bt.block_multiplicity(table, n_blocks)).to(B.device)
    # A NaN partial makes the pair NaN whatever its block's multiplicity,
    # as in the JAX product (a BLAS may skip zero multipliers).
    nan_pairs = torch.isnan(B).any(0)
    nan = torch.tensor(float("nan"), dtype=B.dtype, device=B.device)
    zB = None
    if zero is not None:
        # The EM's zero-row poison, per block: a replicate is poisoned
        # where it samples a block in which either member of the pair has
        # an all-zero row.  The partials stay clean, so an unsampled
        # block cannot poison.
        zB = torch.from_numpy(zero.per_block(n_blocks, bs)).to(B.device).double()
    for r in reps:
        raw_v = torch.where(nan_pairs, nan, M[r] @ B)
        if zB is not None:
            raw_v = _em_poison_pairs(raw_v, ((M[r] > 0).double() @ zB) > 0, It, Jt)
        yield raw_v, None if C is None else M[r] @ C


# ------------------------------------------------------------------ #
# Evolutionary models 3-6 (K80, F81, F84, TN93)                       #
# ------------------------------------------------------------------ #

CLASSES = ("ag", "ct", "tv")  # substitution classes of a site (core/submodels.py)

# pair_pi_counts walks the sites in slabs whose [sites, N] float64 planes
# (dosages, validity, one base's expected counts: about seven at a time)
# take this many bytes each; in a streamed run 1/32 of a chunk's bytes,
# so that they stay a fifth of a chunk under a small budget.
PI_PLANE_BYTES = 64 << 20

# Resident runs of models 3-6 queue replicate r+1 before replicate r is
# corrected and written; profile_torch.py --lookahead times both.
EXTENDED_LOOKAHEAD = True


class _Fetch:
    """Device tensors on their way to the host.  On a card each is copied
    into pinned memory without blocking and an event is recorded behind
    the copies, so `numpy()` waits for these copies only and not, as a
    plain `.cpu()` would, for whatever was queued after them: the next
    replicate's kernels."""

    def __init__(self, tensors: dict) -> None:
        self.event = None
        self.host = tensors
        if any(t.device.type == "cuda" for t in tensors.values()):
            self.host = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         .copy_(t, non_blocking=True) for k, t in tensors.items()}
            self.event = torch.cuda.Event()
            self.event.record()

    def numpy(self) -> dict:
        if self.event is not None:
            self.event.synchronize()
        return {k: t.numpy() for k, t in self.host.items()}


def class_compaction(device: torch.device) -> bool:
    """Whether the statistics of a substitution class run on that class's
    sites only (a site list on the device) and not on the whole tensor with
    the other classes' weights at 0.  A site of weight 0 adds 0 to every
    sum, so both forms give the same sums; the EM kernel, which adds a
    lane's sites in site order, the same bytes.  On a card only: on the
    CPU the weighted form is the JAX engine's, and the plain versions
    gain nothing from the other."""
    return device.type == "cuda"


def nonfinite_sites(P: torch.Tensor) -> torch.Tensor:
    """[S] bool: the sites of P [S, N, 3] that hold a NaN or an infinite
    value.  At weight 0 they still make their pairs NaN (0 x NaN), so a
    compacted call keeps them, at weight 0."""
    return ~torch.isfinite(P.sum((1, 2)))


def class_sites(weights: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """The sites a compacted call runs on: those of weight other than 0
    and those of `keep` (nonfinite_sites), in site order."""
    return np.flatnonzero((weights != 0) | keep)


def _nonmissing(P: torch.Tensor) -> torch.Tensor:
    """[S, N] bool: the triple is not missing (miss_data).  On the CPU
    the JAX engine's expression; on a card the kernels' (csrc/common.cuh
    ngsd::nonmissing), on the float32 values they see, so that cnt and
    the base frequencies describe the same sites.  The two differ for a
    NaN triple only."""
    d01 = (P[..., 0] - P[..., 1]).abs()
    d12 = (P[..., 1] - P[..., 2]).abs()
    if P.device.type == "cpu":
        return ~((d01 < EPSILON) & (d12 < EPSILON))
    return (d01 >= EPSILON) | (d12 >= EPSILON)


def pair_pi_counts(P: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
                   w_ok: torch.Tensor, pairwise_del: bool,
                   plane_bytes: int = PI_PLANE_BYTES, rows: Optional[slice] = None) -> torch.Tensor:
    """Expected base counts behind the per-pair base frequencies of models
    4-6 (ngsdist_tpu.parallel.mesh.pair_pi_counts), in float64 on P's
    device.  P [S, N, 3]; a1, a2 [S] int8 allele codes; w_ok [S] float64,
    the site weights with the unclassifiable sites at 0.

    An individual carries d2 = p1 + 2 p2 expected copies of allele 2 and
    d1 = 2 - d2 of allele 1, so site s gives individual i the count
    bc_x = d1 [a1 = x] + d2 [a2 = x] of base x (nothing where an allele
    code is invalid).  Without pairwise deletion the result is c [4, N],
    c[x, i] = sum_s w_s bc_x[s, i], and a pair's counts are c[:, i] +
    c[:, j].  With it U [4, N, N], U[x, i, j] = sum_s bc_x[s, i] v[s, i]
    w_s v[s, j] with v the not-missing flags: four [N, S] x [S, N]
    products; a pair's counts are U[:, i, j] + U[:, j, i].  The sites go
    in slabs, one [sites, N] float64 plane per base at a time, never
    [S, N, 4].  rows (pairwise deletion): U's rows i of this slice only,
    [4, len, N] (a pairs-axis shard of parallel/mesh.py)."""
    S, N, _ = P.shape
    rows = slice(0, N) if rows is None else rows
    n_rows = len(range(N)[rows])
    out = torch.zeros((4, n_rows, N) if pairwise_del else (4, N), dtype=torch.float64,
                      device=P.device)
    ok = (a1 >= 0) & (a2 >= 0)
    zero = torch.zeros((), dtype=torch.float64, device=P.device)
    step = max(1, plane_bytes // (8 * N))
    for lo in range(0, S, step):
        Ps = P[lo:lo + step]
        d2 = Ps[..., 1].double() + 2.0 * Ps[..., 2].double()
        d1 = 2.0 - d2
        w = w_ok[lo:lo + step]
        if pairwise_del:
            valid = _nonmissing(Ps).double()
            vw = valid * w[:, None]
        for x in range(4):
            m1 = (ok & (a1 == x))[lo:lo + step, None]
            m2 = (ok & (a2 == x))[lo:lo + step, None]
            bc = torch.where(m1, d1, zero) + torch.where(m2, d2, zero)
            if pairwise_del:
                out[x] += (bc * vw)[:, rows].T @ valid
            else:
                out[x] += w @ bc
    return out


def _iter_replicates_extended(pars: Params, P_host, maps: List[np.ndarray],
                              n_trunc: int, alleles, device: torch.device, on_stats=None,
                              start_rep: int = 0, round_ckpt: bool = False,
                              mesh=None, x64: bool = False) -> Iterator[np.ndarray]:
    """The replicate stream of evolutionary models 3-6
    (ngsdist_tpu.core.distance._iter_replicates_extended).

    The expected-mismatch statistics are taken three times, over the
    sites of each substitution class (A<->G, C<->T, transversions; sites
    that cannot be classified belong to none), with the class masks
    folded into the site weights.  A bootstrap replicate is the weighted
    recompute: there is no partial-sum route here.  Models 4-6 also take
    per-pair base frequencies from expected allele dosages
    (pair_pi_counts, on the device).  One device: _device_class_stats;
    a mesh (ngsdist_tpu.core.distance._extended_mesh): _mesh_class_stats,
    the same sums per shard."""
    if alleles is None:
        raise ValueError("extended evolutionary models need allele codes")
    a1, a2 = alleles
    masks = sm.classify_sites(a1, a2)
    need_pi = pars.evol_model >= 4
    N, S = pars.n_ind, pars.n_sites
    I, J = _pair_indices(N)
    # An all-zero triple (an empty line of a text input): on one device
    # the JAX engine does not poison its pairs as models 0-2 do.  Its EM
    # leaves a lane whose nine weights are all zero at the uniform start
    # (ngsdist_tpu/core/em.py em_converged_weights), so without pairwise
    # deletion the lane adds the mean score.  The kernels leave such
    # lanes out; zero_lane_sums adds them on the host.  Its mesh engine
    # poisons them per shard (ngsdist_tpu/parallel/mesh.py:342-353), and
    # so does _mesh_class_stats.
    zero = None
    if mesh is None:
        all_stats, streamed = _device_class_stats(pars, P_host, a1, a2, device, round_ckpt,
                                                  x64)
        if not (pars.indep_geno or pars.pairwise_del or pars.in_bin):
            zero = find_zero_rows(P_host)
    else:
        all_stats, streamed = _mesh_class_stats(pars, P_host, a1, a2, mesh, round_ckpt, x64)
    uniform = float(np.sum(np.asarray(pars.score, np.float64).reshape(-1) * (1.0 / 9.0)))

    def zero_lane_sums(wm):
        """[3, n_pairs]: per class, the weighted number of sites at which
        a member of the pair has an all-zero triple, times the mean
        score; None without such triples."""
        if zero is None:
            return None
        rows = zero.rows.astype(np.float64)
        out = []
        for cl in CLASSES:
            wz = wm[cl][zero.sites]
            one = wz @ rows                       # [N]: sites where i is zero
            both = (rows * wz[:, None]).T @ rows  # [N, N]: where i and j both are
            out.append(uniform * (one[I] + one[J] - both[I, J]))
        return np.stack(out)

    def to_matrix(rep: int, fetch: _Fetch, denom_sites: float, zero_sums) -> np.ndarray:
        """Replicate rep's fetched sums corrected on the host, in float64."""
        with profiling.replicate(rep):
            with profiling.host_span("fetch"):
                got = fetch.numpy()
            with profiling.host_span("matrix"):
                return correct(got, denom_sites, zero_sums)

    def correct(got: dict, denom_sites: float, zero_sums) -> np.ndarray:
        raws = got["raw"]
        if zero_sums is not None:
            raws = raws + zero_sums
        if pars.pairwise_del:
            true_cnt = got["cnt"][0] + got["cnt"][1] + got["cnt"][2]
        else:
            true_cnt = denom_sites
        cnt = float(pars.tot_sites) if pars.tot_sites > 0 else true_cnt
        pi = None
        if need_pi:
            # the pairs' counts are taken on the host: on the device they
            # would be three [4, n_pairs] float64 temporaries
            c = got["pi"]
            tot = (c[:, I, J] + c[:, J, I]) if pars.pairwise_del else (c[:, I] + c[:, J])
            tot = np.ascontiguousarray(tot.T)                      # [n_pairs, 4]
            with np.errstate(divide="ignore", invalid="ignore"):
                pi = tot / np.sum(tot, axis=-1, keepdims=True)
        if on_stats is not None:
            on_stats(_scatter_pairs(raws[0] + raws[1] + raws[2], I, J, N),
                     _scatter_pairs(true_cnt, I, J, N) if pars.pairwise_del else true_cnt)
        d = _scatter_pairs(
            sm.apply_extended_model(pars.evol_model, raws[0], raws[1], raws[2], cnt, pi),
            I, J, N)
        np.fill_diagonal(d, 0.0)
        return d

    def site_weights(rep: int) -> np.ndarray:
        if rep == 0:
            return np.ones((S,), np.float64)
        w = np.zeros((S,), np.float64)
        w[:n_trunc] = replicate_weights(maps[rep - 1], n_trunc)
        return w

    def dispatch(rep: int):
        """Queue replicate rep's sums and their copies to the host."""
        w = site_weights(rep)
        wm = {cl: w * masks[cl] for cl in CLASSES}
        w_ok = w * masks["ok"]
        with profiling.replicate(rep):
            stats, pi_c = all_stats(wm, w_ok, rep)
        out = {"raw": torch.stack([stats[cl][0].double() for cl in CLASSES])}
        if pars.pairwise_del:
            out["cnt"] = torch.stack([stats[cl][1].double() for cl in CLASSES])
        if need_pi:
            out["pi"] = pi_c
        return _Fetch(out), float(np.sum(w_ok)), zero_lane_sums(wm)

    reps = [r for r in range(pars.n_boot_rep + 1) if r >= start_rep]
    # Resident runs queue replicate r+1 before replicate r is corrected and
    # written, so the card computes under the host's work.  A streamed
    # replicate fetches as it goes: nothing to look ahead to.
    lookahead = EXTENDED_LOOKAHEAD and not streamed
    pending = dispatch(reps[0]) if lookahead and reps else None
    for k, rep in enumerate(reps):
        if lookahead:
            now = pending
            if k + 1 < len(reps):
                pending = dispatch(reps[k + 1])
        else:
            now = dispatch(rep)
        yield to_matrix(rep, *now)


def _round_sums(pars: Params, rep: int, round_ckpt: bool, device, x64: bool, layout, rounds,
                step):
    """The sums of a streamed replicate: step(r) -> {name: tensor or
    None} of round r (a chunk of one device, or a round of a mesh's
    shards), added in float64 in round order over the rounds that
    rounds(skip) yields; under round_ckpt the sums are saved after every
    round and a replicate resumes at its first unfinished round (the
    rounds file keyed by `layout`, what a round index means, and by the
    engine of device and x64).  The sums
    are exact partial sums of a deterministic computation, so a resumed
    replicate gives the bytes of an uninterrupted one.  Over several
    processes (which all hold the same sums) process 0 keeps the file:
    it loads it and sends the round count and the float64 sums to every
    process (ngsdist_tpu/core/distance.py:934-963), and it alone saves."""
    from ..parallel.multihost import broadcast_object, process_index

    acc, skip = {}, 0
    eng = engine_name(device, x64)
    writer = process_index() == 0
    if round_ckpt:
        got = ckpt.load_rounds(pars.out, pars, rep, engine=eng, chunk=layout) if writer else None
        got = broadcast_object(got)
        if got is not None:
            skip = got[0]
            acc = {k: torch.from_numpy(v).to(device) for k, v in got[1].items()}
    for r in rounds(skip):
        for name, t in step(r).items():
            if t is not None:
                acc[name] = t.double() if name not in acc else acc[name] + t.double()
        if round_ckpt and writer:
            ckpt.save_rounds(pars.out, pars, rep, r + 1,
                             {k: v.cpu().numpy() for k, v in acc.items()}, engine=eng,
                             chunk=layout)
    return acc


def _held_rounds(walk):
    """(rounds, data_of) for _round_sums over walk(skip), an iterator of
    (r, data) from round skip on: rounds(skip) yields each r; data_of(r)
    is its data, valid until the next index is asked for."""
    held = {}

    def rounds(skip):
        for r, data in walk(skip):
            held.clear()
            held[r] = data
            yield r

    return rounds, held.__getitem__


def _pipe_rounds(pipe: ChunkPipe, ranges):
    """_held_rounds of a ChunkPipe over site ranges: data_of(r) is the
    (chunk, lo, hi) of ranges[r]."""
    return _held_rounds(lambda skip: enumerate(pipe.chunks(ranges[skip:]), start=skip))


def _stream_rounds(stream):
    """_held_rounds of a parallel.multihost.SiteStream: data_of(r) is round
    r's pm.Sharded."""
    return _held_rounds(lambda skip: stream.rounds(range(skip, stream.n_rounds)))


def _class_sums(stats, pi) -> dict:
    """{class: (raw, cnt or None)} and base counts -> the named sums of
    _round_sums (and of a rounds file)."""
    out = {"pi": pi}
    for cl, (raw, cnt) in stats.items():
        out[f"raw_{cl}"], out[f"cnt_{cl}"] = raw, cnt
    return out


def _class_stats_of(acc: dict):
    """The inverse of _class_sums."""
    return {cl: (acc[f"raw_{cl}"], acc.get(f"cnt_{cl}")) for cl in CLASSES}, acc.get("pi")


def _device_class_stats(pars: Params, P_host, a1, a2, device: torch.device,
                        round_ckpt: bool, x64: bool):
    """(all_stats, streamed) of models 3-6 on one device: all_stats(wm,
    w_ok, rep) -> ({class: (raw, cnt or None)}, base counts or None) on
    the device for class weights wm and classifiable-site weights w_ok.
    A streamed run uploads each chunk once and reduces it against all
    three masks and the base counts; its round checkpoint holds all of
    those sums."""
    N, S = pars.n_ind, pars.n_sites
    need_pi = pars.evol_model >= 4
    dtype = default_dtype(device, x64)
    size = itemsize(device, x64)
    I, J = _pair_indices(N)
    It = torch.from_numpy(I).long().to(device)
    Jt = torch.from_numpy(J).long().to(device)
    exact_stats = _make_exact_stats(pars.indep_geno, pars.pairwise_del, pars.score, device,
                                    It, Jt, None)
    compact = class_compaction(device)
    a1_t = torch.from_numpy(np.ascontiguousarray(a1, dtype=np.int8)).to(device)
    a2_t = torch.from_numpy(np.ascontiguousarray(a2, dtype=np.int8)).to(device)

    left = check_fits(S, N, device, pars.indep_geno, x64)
    if left is not None:
        # beside the tensor: one class's gathered sites (all of them at
        # most) and the base counts with their slabs' planes
        left -= (S * N * 3 * size if compact else 0) + 8 * 4 * N * N + 8 * PI_PLANE_BYTES
    chunked, chunk = stream_plan(S, N, device, left, x64)
    plane_bytes = PI_PLANE_BYTES
    if chunked:
        plane_bytes = max(1 << 20, min(PI_PLANE_BYTES, chunk * N * 3 * size // 32))
    # keep[s]: site s holds a non-finite value and stays in every
    # compacted call; known up to site `scanned`
    keep = np.zeros(S, dtype=bool)
    scanned = 0
    if chunked:
        pipe = ChunkPipe(P_host, device, dtype, chunk)
    else:
        P = upload_resident(P_host, device, x64)
        if compact:
            keep = nonfinite_sites(P).cpu().numpy()
        scanned = S

    def class_stats(Pc, wm, lo, hi):
        """{class: (raw, cnt or None)} pair vectors on the device for the
        sites Pc = [lo, hi) of the data under the class weights wm."""
        out = {}
        for cl in CLASSES:
            wc, index = wm[cl][lo:hi], None
            if compact:
                sel = class_sites(wc, keep[lo:hi])
                if sel.size == 0:
                    zeros = torch.zeros(I.size, dtype=dtype, device=device)
                    out[cl] = (zeros, zeros if pars.pairwise_del else None)
                    continue
                if sel.size < hi - lo:
                    wc, index = wc[sel], _upload_small(sel, device)
            raw, cnt = exact_stats(Pc, np.ascontiguousarray(wc), lo, index)
            out[cl] = (raw, cnt if pars.pairwise_del else None)
        return out

    def pi_counts(Pc, w_ok, lo, hi):
        if not need_pi:
            return None
        return pair_pi_counts(Pc, a1_t[lo:hi], a2_t[lo:hi],
                              _upload_small(np.ascontiguousarray(w_ok[lo:hi]), device),
                              pars.pairwise_del, plane_bytes)

    def all_stats(wm, w_ok: np.ndarray, rep: int):
        if not chunked:
            return class_stats(P, wm, 0, S), pi_counts(P, w_ok, 0, S)
        rounds, chunk_of = _pipe_rounds(pipe, [(lo, min(lo + chunk, S))
                                               for lo in range(0, S, chunk)])

        def step(r):
            nonlocal scanned
            Pc, lo, hi = chunk_of(r)
            if compact and hi > scanned:
                keep[lo:hi] = nonfinite_sites(Pc).cpu().numpy()
                scanned = hi
            return _class_sums(class_stats(Pc, wm, lo, hi), pi_counts(Pc, w_ok, lo, hi))

        return _class_stats_of(_round_sums(pars, rep, round_ckpt, device, x64, chunk, rounds,
                                           step))

    return all_stats, chunked


def _mesh_class_stats(pars: Params, P_src, a1, a2, mesh, round_ckpt: bool, x64: bool):
    """(all_stats, streamed) of models 3-6 over a mesh
    (ngsdist_tpu.core.distance._extended_mesh): the class sums through
    parallel.mesh.ShardStats, per shard on each class's sites only where
    _device_class_stats does so (a card), and the base counts through
    parallel.mesh.pair_pi_counts, all summed over the shards in fixed
    order on the mesh's first device.  A SiteStream over the budget runs
    in rounds, each round's shards uploaded once for the three classes
    and the base counts, with round checkpoints."""
    from ..parallel import mesh as pm

    N = pars.n_ind
    need_pi = pars.evol_model >= 4
    stream = _as_stream(pars, P_src, mesh, x64)
    dev0 = mesh.first
    compact = class_compaction(dev0)
    zero = None
    if not (pars.indep_geno or pars.pairwise_del or pars.in_bin):
        zero = stream.zero_rows()
    stats = pm.ShardStats(mesh, N, pars.score, pars.indep_geno, pars.pairwise_del, zero)
    plane_bytes = PI_PLANE_BYTES
    if not stream.resident:
        plane_bytes = max(1 << 20, min(PI_PLANE_BYTES,
                                       stream.chunk * N * 3 * itemsize(dev0, x64) // 32))

    def keep_of(data):
        """Compaction: per sites shard, its non-finite sites, which stay in
        every list (the host waits for the card here, so once per upload:
        resident once, streamed once per round)."""
        if not compact:
            return None
        return [np.zeros(0, bool) if t is None else nonfinite_sites(t).cpu().numpy()
                for t in data.parts[::pm.pairs_size(mesh)]]

    def over(data, keep, wm, w_ok):
        out = {}
        for cl in CLASSES:
            raw, cnt = stats(data, data.cols(wm[cl]), keep)
            out[cl] = (raw, cnt if pars.pairwise_del else None)
        pi = (pm.pair_pi_counts(data, a1, a2, data.cols(w_ok), mesh, pars.pairwise_del,
                                plane_bytes) if need_pi else None)
        return out, pi

    if stream.resident:
        data = stream.global_array()
        keep = keep_of(data)
        return (lambda wm, w_ok, rep: over(data, keep, wm, w_ok)), False

    keeps = {}  # round -> keep_of its data, kept across replicates
    rounds, data_of = _stream_rounds(stream)

    def step(r, wm, w_ok):
        data = data_of(r)
        if r not in keeps:
            keeps[r] = keep_of(data)
        return _class_sums(*over(data, keeps[r], wm, w_ok))

    def all_stats(wm, w_ok, rep):
        return _class_stats_of(_round_sums(
            pars, rep, round_ckpt, dev0, x64, stream.layout(), rounds,
            lambda r: step(r, wm, w_ok)))

    return all_stats, True


# ------------------------------------------------------------------ #
# The mesh engine of models 0-2                                       #
# ------------------------------------------------------------------ #


def _stream_block_rows(n_rows: int, n_rounds: int, chunk: int, s_loc: int,
                       n_dev: int, bs: int, n_blocks: int) -> np.ndarray:
    """row -> TRUE global block id for pm.concat_block_rounds' layout
    (device-major, rounds concatenated per device, per-round pad rows
    in place); -1 marks pad rows and blocks >= n_blocks (truncation
    tail / global padding).  Requires bs | chunk and bs | s_loc, which
    the SiteStream planner guarantees (chunk and s_loc are block-size
    multiples whenever bootstrap runs).  The JAX engine's function
    (ngsdist_tpu/core/distance.py:497), copied as it is: its layout hid
    the 5e-2 errors of round-5 trial 507."""
    assert chunk % bs == 0 and s_loc % bs == 0, (chunk, s_loc, bs)
    rows_per_dev = n_rows // n_dev
    bpc = chunk // bs
    lpb = s_loc // bs
    out = np.full((n_rows,), -1, np.int64)
    for d in range(n_dev):
        for r in range(n_rounds):
            for j in range(bpc):
                lo = r * chunk + j * bs
                if lo >= s_loc:
                    continue
                g = d * lpb + lo // bs
                if g < n_blocks:
                    out[d * rows_per_dev + r * bpc + j] = g
    return out


def _as_stream(pars: Params, P_src, mesh, x64: bool):
    """The sharded engine's input as a parallel.multihost.SiteStream of
    the run's dtype."""
    from ..parallel.multihost import SiteStream

    if isinstance(P_src, SiteStream):
        if P_src.x64 != x64:
            raise ValueError(f"a SiteStream of x64={P_src.x64} handed to a run of x64={x64}")
        return P_src
    return SiteStream.from_array(P_src, pars, mesh, x64=x64)


def _iter_replicates_sharded(pars: Params, P_src, maps: List[np.ndarray], n_trunc: int,
                             mesh, on_stats=None, start_rep: int = 0,
                             round_ckpt: bool = False, x64: bool = False) -> Iterator[np.ndarray]:
    """The replicate stream of models 0-2 over a mesh
    (ngsdist_tpu/core/distance.py _iter_replicates_sharded).

    P_src: the host [S, N, 3] array or a SiteStream.  Resident (every
    shard fits its device's budget): the full data, then the bootstrap
    on the partial-sum route (a 1-D mesh whose partials fit the JAX
    engine's budget: one block-mode call per shard, then M[r] @ B per
    shard and the fixed-order sum) or the weighted recompute.  Streamed:
    every matrix is the float64 sum of its rounds in round order, saved
    after every round under round_ckpt; an indep bootstrap on a 1-D mesh
    whose partials fit takes one pass of block partials over the rounds
    instead, resummed through _stream_block_rows."""
    from ..parallel import mesh as pm

    N, S = pars.n_ind, pars.n_sites
    dev0 = mesh.first
    size = itemsize(dev0, x64)
    I, J = _pair_indices(N)
    n_reps = pars.n_boot_rep
    p = pm.pairs_size(mesh)
    stream = _as_stream(pars, P_src, mesh, x64)
    zero = None
    if not (pars.indep_geno or pars.pairwise_del or pars.in_bin):
        zero = stream.zero_rows()
    stats = pm.ShardStats(mesh, N, pars.score, pars.indep_geno, pars.pairwise_del, zero)
    reps = [r for r in range(n_reps) if r + 1 >= start_rep]

    def matrix(rep, sums, denom_sites, poison=None):
        """Replicate rep's corrected matrix; sums() queues its (raw, cnt or
        None) pair vectors on the device."""
        with profiling.replicate(rep):
            raw_v, cnt_v = sums()
            with profiling.host_span("fetch"):
                raw = raw_v.cpu().numpy()
                cnt = None if cnt_v is None else cnt_v.cpu().numpy()
            with profiling.host_span("matrix"):
                if poison is not None and poison.any():
                    raw = np.where(poison[I] | poison[J], np.nan, raw)
                raw_m = _scatter_pairs(raw, I, J, N)
                cnt_m = None if cnt is None else _scatter_pairs(cnt, I, J, N)
                return _finalize(raw_m, cnt_m if pars.pairwise_del else float(denom_sites),
                                 pars, on_stats)

    def weights(r):
        w = np.zeros((S,), np.float64)
        w[:n_trunc] = replicate_weights(maps[r], n_trunc)
        return w

    bs = pars.boot_block_size
    if not stream.resident:
        n_blocks_s = n_trunc // bs if n_reps else 0
        partial_bytes_s = n_blocks_s * N * N * size * (2 if pars.pairwise_del else 1)
        if (pars.indep_geno and n_reps > 0 and p == 1
                and 0 < partial_bytes_s <= PARTIALS_BUDGET_BYTES):
            yield from _sharded_stream_partials(pars, stream, stats, mesh, n_trunc, start_rep,
                                                matrix)
            return
        rounds, data_of = _stream_rounds(stream)

        def stats_rounds(w_full, rep):
            def step(r):
                data = data_of(r)
                raw, cnt = stats(data, data.cols(w_full))
                return {"raw": raw, "cnt": cnt}

            acc = _round_sums(pars, rep, round_ckpt, dev0, x64, stream.layout(), rounds, step)
            return acc["raw"], acc.get("cnt")

        if start_rep == 0:
            yield matrix(0, lambda: stats_rounds(np.ones((S,), np.float64), 0), S)
        for r in reps:
            yield matrix(r + 1, lambda: stats_rounds(weights(r), r + 1), n_trunc)
        return

    data = stream.global_array()
    n_blocks = n_trunc // bs if n_reps else 0
    cells = N * N if pars.indep_geno else (N * N - N) // 2
    partial_bytes = n_blocks * cells * size * (2 if pars.pairwise_del else 1)
    # block partials are 1-D-mesh only: a pairs axis takes the weighted route
    partials = n_reps > 0 and partial_bytes <= PARTIALS_BUDGET_BYTES and p == 1
    if start_rep == 0:
        yield matrix(0, lambda: stats(data), S)
    if not reps:
        return
    if not partials:
        for r in reps:
            yield matrix(r + 1, lambda: stats(data, data.cols(weights(r))), n_trunc)
        return
    table = bt.block_index_table(pars.seed, n_reps, n_blocks)
    raw_r, cnt_r = pm.bootstrap_replicates(table, stats.blocks(data, bs), n_blocks, mesh)
    # the EM's zero-row poison, per replicate: where it samples a block in
    # which a member of the pair has an all-zero triple (each process
    # records its own sites; the flags are ORed over the processes)
    zb = None
    if zero is not None:
        from ..parallel.multihost import union_over_processes

        zb = union_over_processes(zero.per_block(n_blocks, bs))
    mult = bt.block_multiplicity(table, n_blocks)
    for r in reps:
        z = None if zb is None else zb[mult[r] > 0].any(0)
        yield matrix(r + 1, lambda: (raw_r[r], None if cnt_r is None else cnt_r[r]), n_trunc, z)


def _sharded_stream_partials(pars: Params, stream, stats, mesh, n_trunc: int, start_rep: int,
                             matrix):
    """The streamed indep bootstrap on a 1-D mesh in one pass over the
    rounds (ngsdist_tpu/core/distance.py:1089-1174): each round's block
    partials per shard, joined per shard (device-major, each round's
    padding rows in place), the true row -> block map of
    _stream_block_rows permuting the resummation weights; the full data
    is the sum of the real blocks plus the truncation tail, whose sites
    lie in at most two rounds, run again under tail weights.  A kill
    recomputes the pass (no round checkpoints on this route)."""
    from ..parallel import mesh as pm

    S, bs, n_reps = pars.n_sites, pars.boot_block_size, pars.n_boot_rep
    n_blocks = n_trunc // bs
    rb = stream.chunk // bs
    B = pm.concat_block_rounds(
        [stats.blocks(data, bs, rows=rb) for _, data in stream.rounds(range(stream.n_rounds))],
        mesh)
    row2block = _stream_block_rows(B.n_rows, stream.n_rounds, stream.chunk, stream.s_loc,
                                   pm.sites_size(mesh), bs, n_blocks)
    valid = row2block >= 0

    def resum(M_true):
        """(raw, cnt or None) [R, n_pairs] for weights over the true blocks."""
        M = np.zeros((M_true.shape[0], B.n_rows), np.float64)
        M[:, valid] = M_true[:, row2block[valid]]
        has_c = any(C is not None for _, _, C, _ in B.parts)
        return pm.resum_blocks(M, B, mesh, 0), pm.resum_blocks(M, B, mesh, 1) if has_c else None

    if start_rep == 0:
        raw0, cnt0 = resum(np.ones((1, n_blocks), np.float64))
        raw0, cnt0 = raw0[0], None if cnt0 is None else cnt0[0]
        if S > n_trunc:
            tail = np.zeros((S,), np.float64)
            tail[n_trunc:] = 1.0
            for r in sorted({(t % stream.s_loc) // stream.chunk for t in (n_trunc, S - 1)}):
                data = stream.round_data(r)
                raw_t, cnt_t = stats(data, data.cols(tail))
                raw0 = raw0 + raw_t
                if cnt0 is not None:
                    cnt0 = cnt0 + cnt_t
        yield matrix(0, lambda: (raw0, cnt0), S)
    table = bt.block_index_table(pars.seed, n_reps, n_blocks)
    raw_r, cnt_r = resum(bt.block_multiplicity(table, n_blocks))
    for r in range(n_reps):
        if r + 1 >= start_rep:
            yield matrix(r + 1, lambda: (raw_r[r], None if cnt_r is None else cnt_r[r]),
                         n_trunc)
