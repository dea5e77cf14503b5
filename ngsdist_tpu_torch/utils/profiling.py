"""Throughput and stage-time observability.

The reference has no timers or perf counters anywhere; this module
supplies a pair-site throughput meter for the updates/sec metric
(`--throughput`) and, for scripts that ask (chip_smoke.py,
profile_torch.py), the intervals of a run's reads, uploads and kernels
on one clock (`StageTimes`).  Device tracing is not ported yet
(profile_torch.py profiles the CLI from outside).
"""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field
from typing import Optional


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
# engine and the runner then wrap their reads (host clock), uploads and
# kernel calls (CUDA events on their stream) in the spans below.
ACTIVE: Optional["StageTimes"] = None


class StageTimes:
    """Intervals, in seconds since its creation, of a run's stages:
    "read" (host work that prepares a slab: the staged read, the fused
    chunk read, the float32 cast), "upload" (copies to the card and the
    expansion there) and "kernel" (the statistics of a chunk or of the
    resident tensor), and "gather" (a multi-process run's all-gather of
    the shards' sums and their addition on the host, parallel/mesh.py;
    it includes the wait for the slowest process).  Host spans are taken
    on the host clock, device
    spans by CUDA events on the stream that runs them and mapped onto
    the host clock through one event recorded at creation, on an idle
    card, so that the card stamps it as the host's clock is read (on the
    CPU they are host spans too)."""

    def __init__(self, device) -> None:
        self.device = device
        self.cuda = device.type == "cuda"
        self.host = {"read": [], "upload": [], "kernel": [], "gather": []}
        self.events = {"upload": [], "kernel": []}
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
        """Seconds in which a read, an upload, a kernel or a gather ran
        (each the union of its intervals), the number of gathers, and the
        share of the upload time that ran while a kernel or a read did
        (None without uploads)."""
        raw = self.intervals()
        iv = {k: _merge(v) for k, v in raw.items()}
        up = _length(iv["upload"])
        under = _merge(sorted(iv["kernel"] + iv["read"]))
        return {"read_s": _length(iv["read"]), "upload_s": up,
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


@contextlib.contextmanager
def host_span(name: str):
    """Record the enclosed host work under `name` when times are taken."""
    times = ACTIVE
    if times is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        times.host[name].append((t0 - times.t0, time.perf_counter() - times.t0))


@contextlib.contextmanager
def device_span(name: str, stream=None):
    """Record what the enclosed code enqueues on `stream` (default: the
    current one) under `name` when times are taken."""
    times = ACTIVE
    if times is None:
        yield
        return
    if not times.cuda:
        with host_span(name):
            yield
        return
    import torch

    stream = stream or torch.cuda.current_stream(times.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    try:
        yield
    finally:
        end.record(stream)
        times.events[name].append((start, end))
