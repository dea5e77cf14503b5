"""Tracing, throughput and stage-time observability.

The reference has no timers or perf counters anywhere; this module
supplies a torch.profiler trace of a run's compute section (`trace`,
`--trace_dir`; the JAX package's jax.profiler trace), a pair-site
throughput meter for the updates/sec metric (`--throughput`) and the
intervals of a run's stages on one clock (`StageTimes`), which the
benchmark (gpubench/programs/ngsdist_cli.py, gpubench/metrics/) and the
scripts that ask (chip_smoke.py, profile_torch.py) read.  While `trace`
records, every span is also a torch.profiler range named
`ngsdist.<span>`, with `[r]` for a span of replicate r (0: the full
data; `replicate`), beside the kernels and copies of the same trace.
"""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field
from typing import Optional


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """Record a torch.profiler trace of the enclosed section (CPU
    activity, and the CUDA activity of every kernel and copy where a card
    is visible) and write it into trace_dir in TensorBoard's format
    (torch.profiler.tensorboard_trace_handler: a
    <host>_<pid>.<time>.pt.trace.json file, which TensorBoard's profile
    plugin and chrome://tracing read), the program's spans in it as
    `ngsdist.<span>[r]` ranges; nothing when trace_dir is empty."""
    global _TRACING
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir)):
        _TRACING = True
        try:
            yield
        finally:
            _TRACING = False


@dataclass
class Throughput:
    """Pair-site updates/sec meter.

    One `update`/`add_updates` per completed replicate, counting the
    pair-site distance updates the reference hot loop would execute
    (reference ngsDist.cpp:333-353): bootstrap replicates run over
    the block-truncated site count and pairwise deletion skips missing
    sites entirely, so the caller passes the actual per-replicate
    valid-update total, not n_pairs * n_sites.
    """

    n_pairs: int
    t0: float = field(default_factory=time.perf_counter)
    updates: float = 0.0
    replicates: int = 0

    def update(self, n_sites: int) -> None:
        self.add_updates(float(self.n_pairs) * float(n_sites))

    def add_updates(self, updates: float) -> None:
        self.updates += float(updates)
        self.replicates += 1

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def rate(self) -> float:
        e = self.elapsed
        return self.updates / e if e > 0 else 0.0

    def report(self, fh=None) -> None:
        print(
            f"==> Throughput: {self.updates:.3e} pair-site updates over "
            f"{self.replicates} matrices in {self.elapsed:.2f}s "
            f"({self.rate:.3e} updates/s)",
            file=fh if fh is not None else sys.stderr,
        )


# Stage times: off unless a script sets ACTIVE = StageTimes(device); the
# engine and the runner then wrap their reads, fetches, matrices and
# writes (host clock), uploads and kernel calls (CUDA events on their
# stream) in the spans below.
ACTIVE: Optional["StageTimes"] = None

# True while `trace` records: every span is then a torch.profiler range
# too, and `replicate` sets the index that the spans of REPLICATED carry.
_TRACING = False
_REPLICATE: Optional[int] = None
REPLICATED = ("kernel", "upload", "fetch", "matrix", "write")


class StageTimes:
    """Intervals, in seconds since its creation, of a run's stages:
    "read" (host work that prepares a slab: the staged read, the fused
    chunk read, the float32 cast), "scan" (the runner's search of a
    staged tensor for its code plane, utils/hostmem.derive_codes),
    "upload" (copies to the card and the expansion there) and "kernel"
    (the statistics of a chunk or of the resident tensor), "gather"
    (a multi-process run's all-gather of the shards' sums and their
    addition on the host, parallel/mesh.py; it includes the wait for the
    slowest process), "fetch" (a replicate's pair vectors brought to the
    host: the host's wait for the card, whatever was queued before the
    copy included), "matrix" (the host work that turns them into the
    corrected matrix: the pair scatter, the division, the distance
    model, the stats hook) and "write" (a matrix formatted and written,
    the flush and the checkpoint sidecar); and the bytes of the host
    slabs sent to the device (`upload_bytes`: the probability tensor's
    lane, float32 triples, packed pairs or uint8 codes).  Host spans are
    taken on the host clock, device
    spans by CUDA events on the stream that runs them and mapped onto
    the host clock through one event recorded at creation, on an idle
    card, so that the card stamps it as the host's clock is read (on the
    CPU they are host spans too)."""

    def __init__(self, device) -> None:
        self.device = device
        self.cuda = device.type == "cuda"
        self.host = {name: [] for name in ("read", "scan", "upload", "kernel", "gather",
                                           "fetch", "matrix", "write")}
        self.events = {"upload": [], "kernel": []}
        self.upload_bytes = 0
        if self.cuda:
            import torch

            torch.cuda.synchronize(device)
            self.base = torch.cuda.Event(enable_timing=True)
        self.t0 = time.perf_counter()
        if self.cuda:
            self.base.record(torch.cuda.current_stream(device))

    def intervals(self) -> dict:
        """name -> sorted [(start, end)] in seconds; waits for the card."""
        out = {k: list(v) for k, v in self.host.items()}
        if self.cuda:
            import torch

            torch.cuda.synchronize(self.device)
            for name, pairs in self.events.items():
                out[name] += [(self.base.elapsed_time(a) / 1e3,
                               self.base.elapsed_time(b) / 1e3) for a, b in pairs]
        return {k: sorted(v) for k, v in out.items()}

    def summary(self) -> dict:
        """Seconds in which a read, a scan, an upload, a kernel or a
        gather ran (each the union of its intervals), the number of
        gathers, the bytes uploaded, and the share of the upload time
        that ran while a kernel or a read did (None without uploads)."""
        raw = self.intervals()
        iv = {k: _merge(v) for k, v in raw.items()}
        up = _length(iv["upload"])
        under = _merge(sorted(iv["kernel"] + iv["read"]))
        return {"read_s": _length(iv["read"]), "scan_s": _length(iv["scan"]),
                "upload_s": up, "upload_bytes": self.upload_bytes,
                "kernel_s": _length(iv["kernel"]), "gather_s": _length(iv["gather"]),
                "gathers": len(raw["gather"]),
                "upload_hidden": _overlap(iv["upload"], under) / up if up > 0 else None}


def _merge(intervals):
    """Sorted (start, end) intervals -> their union as disjoint ones."""
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _length(disjoint) -> float:
    return sum(e - s for s, e in disjoint)


def _overlap(a, b) -> float:
    """Length of the intersection of two lists of disjoint intervals."""
    total, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += min(e, b[k][1]) - max(s, b[k][0])
            k += 1
    return total


def count_upload(nbytes: int) -> None:
    """Add the bytes of a host slab sent to the device when times are
    taken."""
    if ACTIVE is not None:
        ACTIVE.upload_bytes += int(nbytes)


@contextlib.contextmanager
def replicate(index: int):
    """While `trace` records, the enclosed spans of REPLICATED carry
    replicate `index` (0: the full data) in their range's name."""
    global _REPLICATE
    if not _TRACING:
        yield
        return
    outer, _REPLICATE = _REPLICATE, index
    try:
        yield
    finally:
        _REPLICATE = outer


def _range(name: str):
    """The torch.profiler range of a span while `trace` records."""
    if not _TRACING:
        return contextlib.nullcontext()
    import torch

    if _REPLICATE is not None and name in REPLICATED:
        name = f"{name}[{_REPLICATE}]"
    return torch.profiler.record_function(f"ngsdist.{name}")


@contextlib.contextmanager
def host_span(name: str):
    """Record the enclosed host work under `name` when times are taken
    or a trace records."""
    times = ACTIVE
    if times is None and not _TRACING:
        yield
        return
    with _range(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if times is not None:
                times.host[name].append((t0 - times.t0, time.perf_counter() - times.t0))


@contextlib.contextmanager
def device_span(name: str, stream=None):
    """Record what the enclosed code enqueues on `stream` (default: the
    current one) under `name` when times are taken or a trace records."""
    times = ACTIVE
    if times is None and not _TRACING:
        yield
        return
    if times is None or not times.cuda:
        with host_span(name):
            yield
        return
    import torch

    stream = stream or torch.cuda.current_stream(times.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with _range(name):
        start.record(stream)
        try:
            yield
        finally:
            end.record(stream)
            times.events[name].append((start, end))
