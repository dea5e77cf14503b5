"""Site x pair shards over one or more devices, in one process.

Port of ngsdist_tpu/parallel/mesh.py.  There a single controller drives
every local device of a `jax.sharding.Mesh` through `shard_map`, and the
shards' sufficient statistics meet in a `psum`.  Here a `Mesh` is a
[sites, pairs] grid of `torch.device`s, which may repeat: several shards
on one card, or eight `cpu` entries standing for the JAX package's
virtual 8-device CPU mesh.  The process queues each shard's uploads and
kernel launches on its device, on a stream of the shard's own (a card),
and the psum becomes a fixed-order float64 sum of the shards' results on
the mesh's first device (`Mesh.gather` orders each copy after the
shard's stream), so a rerun and a resumed run repeat their bytes.

The site axis is split as the JAX package splits it (`_plan_padding`):
shard s of the sites axis holds the contiguous sites [s·s_loc,
(s+1)·s_loc) of the data, and every device of its row of the grid holds
a copy.  A pairs axis of p > 1 splits the output instead:
- indep: each pairs-shard runs the kernel on its own list of upper
  64 x 64 tiles (`panel_tables`, the K1p counterpart of the Pallas
  kernel's panel sublists); the lists partition the upper triangle, so
  the sum over all shards holds every tile once;
- EM: the pair list (padded with its last pair to a multiple of p) is cut
  into p contiguous slices, and each pairs-shard runs the kernel on the
  32 x 32 tiles that hold its slice (`pair_block_tables`, K2b) and keeps
  its slice's pairs; the slices, summed over the sites axis, are joined
  in pair order.
An empty list launches nothing and adds zeros: a split with fewer tiles
than shards needs no other form.

Block partials (the partial-sum bootstrap) stay on their shards'
devices (`BlockShards`); a replicate is M[r] @ B per shard in float64,
then the fixed-order sum (`resum_blocks`).

Several processes (parallel/multihost.py `bring_up`, runner.py
`run_distributed`) each drive a mesh of their own entries, on a 1-D
sites axis: the global axis is every process's entries in rank order,
and process i holds the sites shards [i·n, (i+1)·n).  The fixed-order
sum then gathers each process's shard results to every process (a gloo
all-gather of host tensors) and adds all of them in the global order,
so that every process holds the same sums, and P processes of n entries
write the bytes of one process with a mesh of P·n entries that cuts the
same rounds (runner.run_distributed says when it does).
"""

from __future__ import annotations

import contextlib
import functools
from typing import List, Optional

import numpy as np
import torch

from ..config import NgsDistError
from ..core import bootstrap as bt
from ..core import distance as dist
from ..core.preprocess import find_zero_rows
from ..ops.em import EM_TILE, em_block_partials
from ..ops.indep import indep_block_partials, upper_tiles
from ..utils import profiling

AXIS = "sites"
PAIRS = "pairs"
# Elements of the parts that one all-gather of a multi-process sum moves
# (_gathered_sum): 64 MiB of float64 a mesh entry, so that a process's
# host buffers stay within (1 + processes) x entries x 64 MiB however
# large the parts grow (a bootstrap's [R, n_pairs] replicates grow with R).
GATHER_CHUNK = 1 << 23


class Mesh:
    """A [sites, pairs] grid of devices, row-major in `devices`; entries
    may repeat.  Entry k = s · pairs + q holds sites shard s and pairs
    shard q."""

    def __init__(self, devices, pairs: int = 1) -> None:
        self.devices = [_indexed(torch.device(d)) for d in devices]
        n = len(self.devices)
        if n == 0:
            raise ValueError("a mesh needs at least one device")
        if pairs < 1 or n % pairs:
            raise ValueError(f"{n} devices do not factor into pairs={pairs}")
        if len({d.type for d in self.devices}) > 1:
            raise ValueError("a mesh holds devices of one type: no shard of a card's "
                             "mesh goes to the CPU")
        from .multihost import process_count, process_index

        self.rank, self.world = process_index(), process_count()
        if self.world > 1 and pairs > 1:
            raise ValueError("multi-process runs support 1-D 'sites' meshes only (a pairs "
                             "axis would need per-host replica groups)")
        # this process's sites shards, and the first one's place on the
        # global axis
        self.local_sites = n // pairs
        self.shard0 = self.rank * self.local_sites
        self.shape = {AXIS: self.local_sites * self.world, PAIRS: pairs}
        self.first = self.devices[0]
        self._streams = None
        self._gather_bufs = None

    @contextlib.contextmanager
    def on(self, k: int):
        """Run what the block queues on entry k's own stream (a card;
        nothing on the CPU), after all that was queued on its device
        before."""
        dev = self.devices[k]
        if dev.type != "cuda":
            yield
            return
        s = self._stream(k)
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s):
            yield

    def _stream(self, k: int):
        if self._streams is None:
            self._streams = [torch.cuda.Stream(d) for d in self.devices]
        return self._streams[k]

    def copy(self, j: int, t: torch.Tensor, k: int) -> torch.Tensor:
        """Entry j's tensor t on entry k's device, for entry k to read: on
        the CPU t itself (the entries share one memory), on a card a copy
        on entry k's stream after the work queued on entry j's (between
        cards the copy runs on the source's stream and waits for both)."""
        if self.devices[k].type != "cuda":
            return t
        sj, sk = self._stream(j), self._stream(k)
        sk.wait_stream(sj)
        with torch.cuda.stream(sj), torch.cuda.stream(sk):
            return t.to(self.devices[k], copy=True)

    def gather(self, k: int, t: torch.Tensor) -> torch.Tensor:
        """Entry k's tensor t on the first device, for the fixed-order
        sum: the copy (or, on the same device, the first device's
        current stream) waits for the work queued on entry k's stream."""
        if t.device.type != "cuda":
            return t.to(self.first)
        s = self._stream(k)
        if t.device == self.first:
            cur = torch.cuda.current_stream(self.first)
            cur.wait_stream(s)
            t.record_stream(cur)
            return t
        with torch.cuda.stream(s):  # a copy between cards runs on the source's stream
            return t.to(self.first)

    def gather_buffers(self, size: int):
        """(send, [receive] per process): float64 host buffers of at least
        `size` elements for _gathered_sum, kept between its calls (the
        send buffer pinned on a card)."""
        if self._gather_bufs is None or self._gather_bufs[0].numel() < size:
            pin = self.first.type == "cuda"
            self._gather_bufs = (torch.empty(size, dtype=torch.float64, pin_memory=pin),
                                 [torch.empty(size, dtype=torch.float64)
                                  for _ in range(self.world)])
        return self._gather_bufs


def _indexed(dev: torch.device) -> torch.device:
    """A card named without its index is the current one: the mesh
    compares devices to decide whether a shard's result must be copied."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices=None, n_devices: Optional[int] = None, pairs: int = 1) -> Mesh:
    """Mesh over the given devices (default: every visible card; without
    one an NgsDistError: a CPU mesh is asked for by its entries, as
    [torch.device("cpu")]), the first n_devices of them, factored into a
    (sites, pairs) grid.  Asking for more devices than there are is an
    error, never a smaller mesh."""
    if devices is None:
        if not torch.cuda.is_available():
            raise NgsDistError("main", "no CUDA device is available to this process "
                               "(--platform cpu runs the float64 CPU path)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} devices asked for, {len(devices)} available")
        devices = devices[:n_devices]
    return Mesh(devices, pairs)


def sites_size(mesh: Mesh) -> int:
    return mesh.shape[AXIS]


def pairs_size(mesh: Mesh) -> int:
    return mesh.shape[PAIRS]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _plan_padding(S: int, n_dev: int, granule: int) -> int:
    """Padded global site count: per-shard length a multiple of granule."""
    s_loc = _round_up(_round_up(S, n_dev) // n_dev, granule)
    return s_loc * n_dev


def shard_ranges(S: int, s_loc: int, n_dev: int, offset: int = 0, width: Optional[int] = None):
    """[(lo, hi)] per sites shard: the sites [d·s_loc + offset, d·s_loc +
    offset + width) of shard d (width: the rest of the shard), clipped to
    the S sites of the data, so empty past them."""
    width = s_loc - offset if width is None else width
    return [(min(d * s_loc + offset, S), min(d * s_loc + offset + width, S))
            for d in range(n_dev)]


class Sharded:
    """A site-sharded [S, N, 3] tensor: ranges, the data sites of every
    sites shard of the global axis; entry k of this process's mesh holds,
    on its device, those of its shard mesh.shard0 + k // pairs (None where
    the range is empty).  N: the individuals (default: a part's)."""

    def __init__(self, mesh: Mesh, ranges, parts, N: Optional[int] = None) -> None:
        self.mesh, self.ranges, self.parts = mesh, ranges, parts
        self.N = N if N is not None else next(t.shape[1] for t in parts if t is not None)

    @property
    def local_ranges(self):
        """The ranges of this process's sites shards."""
        return self.ranges[self.mesh.shard0:self.mesh.shard0 + self.mesh.local_sites]

    def cols(self, vec: Optional[np.ndarray]):
        """A host site vector (or [S, K] array) of the data cut into this
        process's shards' slices, the form the kernels' wrappers take;
        None stays None."""
        return None if vec is None else [vec[lo:hi] for lo, hi in self.local_ranges]


def shard_sites(P_host, mesh: Mesh, ranges, x64: bool, base: int = 0) -> Sharded:
    """Upload each of this process's shards' site slice of a host array to
    the first device of its row of the grid (core/distance.py
    upload_resident, on the entry's stream), and copy it from there to the
    row's other devices, so the host reads and casts each slice once.
    A code plane's slice (utils/hostmem.CodedProbs) stays coded: each shard
    uploads its uint8 rows and expands them on its own device; a host
    array's slice goes in the device's lane (uint16 or float pairs,
    utils/hostmem.py pack23, expanded on the device; ngsdist_tpu/parallel/
    mesh.py:112-129); the copies along the pairs axis are of the expanded
    tensor.  A shard holds its data sites only, so no pad rows cross:
    rounds past the data are the device's zeros.  ranges: every sites
    shard's data sites; P_host holds the sites from `base` on; x64: the
    run's dtype choice (core/distance.py default_dtype)."""
    p = pairs_size(mesh)
    parts = []
    for k, dev in enumerate(mesh.devices):
        s, q = divmod(k, p)
        lo, hi = ranges[mesh.shard0 + s]
        part = None
        if q:
            if parts[k - q] is not None:
                part = mesh.copy(k - q, parts[k - q], k)
        elif hi > lo:
            with mesh.on(k):
                part = dist.upload_resident(P_host[lo - base:hi - base], dev, x64)
        parts.append(part)
    return Sharded(mesh, ranges, parts, P_host.shape[1])


def put_probs_sharded(P_host, s_pad: int, mesh: Mesh) -> Sharded:
    """The whole host tensor over the mesh, s_pad / sites shards each, in
    the dtype of a run without --x64 (sharded_suffstats and
    sharded_pair_pi, the JAX functions' counterparts, take no x64)."""
    n_dev = sites_size(mesh)
    return shard_sites(P_host, mesh, shard_ranges(P_host.shape[0], s_pad // n_dev, n_dev), False)


# ------------------------------------------------------------------ #
# The tile tables of a pairs axis                                     #
# ------------------------------------------------------------------ #


@functools.lru_cache(maxsize=16)
def panel_tables(N: int, p: int):
    """[p] lists (int32 arrays) of the indep kernel's upper 64 x 64 tiles,
    one per pairs-shard: contiguous runs of the tile enumeration, the
    first T mod p shards one tile more (every tile costs the kernel the
    same, diagonal ones included), so the shares differ by one tile at
    most.  Every upper tile is in exactly one list; a list is empty when
    there are fewer tiles than shards."""
    T = upper_tiles(N)
    out, lo = [], 0
    for d in range(p):
        n = T // p + (d < T % p)
        out.append(np.arange(lo, lo + n, dtype=np.int32))
        lo += n
    return tuple(out)


def padded_pairs(N: int, p: int):
    """The pair list (I, J), triu row-major, padded with its last pair to
    a multiple of p (a padding pair's tile is already in the last slice's
    list, so it adds no tile)."""
    I, J = dist._pair_indices(N)
    n_pad = -(-I.size // p) * p
    if n_pad > I.size:
        I = np.concatenate([I, np.full(n_pad - I.size, I[-1], np.int32)])
        J = np.concatenate([J, np.full(n_pad - J.size, J[-1], np.int32)])
    return I, J


@functools.lru_cache(maxsize=16)
def pair_block_tables(N: int, p: int):
    """[p] lists (int32 arrays, ascending) of the EM kernel's upper 32 x 32
    tiles: list d holds every tile that holds a pair of slice d of the
    padded pair list (padded_pairs); tiles shared by two slices are in
    both lists."""
    I, J = padded_pairs(N, p)
    per = I.size // p
    out = []
    for d in range(p):
        ti, tj = I[d * per:(d + 1) * per] // EM_TILE, J[d * per:(d + 1) * per] // EM_TILE
        out.append(np.unique(tj.astype(np.int64) * (tj + 1) // 2 + ti).astype(np.int32))
    return tuple(out)


# ------------------------------------------------------------------ #
# Per-shard reductions and the fixed-order sum                        #
# ------------------------------------------------------------------ #


def fixed_order_sum(mesh: Mesh, parts, shape=None) -> Optional[torch.Tensor]:
    """sum of (k, tensor) parts in their order, in float64 on the first
    device; None without parts.  Over several processes every process
    calls it, with the parts' shape (its own parts may be none), and gets
    the sum of all processes' parts in the global order
    (_gathered_sum)."""
    if mesh.world > 1:
        return _gathered_sum(mesh, parts, shape)
    acc = None
    for k, t in parts:
        t = mesh.gather(k, t).double()
        acc = t if acc is None else acc + t
    return acc


def _gathered_sum(mesh: Mesh, parts, shape) -> Optional[torch.Tensor]:
    """fixed_order_sum over processes, in slices of at most GATHER_CHUNK
    elements of the parts (flattened): each part's slice is copied, after
    the work queued on its entry's stream, into a row of the mesh's pinned
    send buffer (float64, as the one-process sum adds them; a flag marks
    the rows that hold a part), the rows are all-gathered over gloo into
    the mesh's receive buffers, and the rows that hold a part are added in
    the order of the global sites axis.  A float64 sum is the same on the
    host as on a card, and the same slice by slice, so the result is the
    one-process mesh's, bit for bit."""
    import torch.distributed as tdist

    m = int(np.prod(shape))
    n = len(mesh.devices)
    width = min(m, GATHER_CHUNK)
    send, recv = mesh.gather_buffers(n * (width + 1))
    flat = [(k, t.reshape(-1)) for k, t in parts]
    out = None
    for a in range(0, m, width):
        c = min(width, m - a)
        rows = send[:n * (c + 1)].view(n, c + 1)
        rows[:, c] = 0.0
        done = []
        for k, t in flat:
            if t.device.type == "cuda":
                with torch.cuda.stream(mesh._stream(k)):
                    rows[k, :c].copy_(t[a:a + c].double(), non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record()
                    done.append(ev)
            else:
                rows[k, :c] = t[a:a + c]
            rows[k, c] = 1.0
        for ev in done:
            ev.synchronize()
        with profiling.host_span("gather"):
            got = [buf[:n * (c + 1)].view(n, c + 1) for buf in recv]
            tdist.all_gather(got, rows)
            acc = None
            for blk in got:
                for row in blk:
                    if row[c] == 1.0:
                        acc = row[:c].clone() if acc is None else acc.add_(row[:c])
        if acc is None:
            return None
        if out is None:
            out = torch.empty(m, dtype=torch.float64, device=mesh.first)
        out[a:a + c].copy_(acc)
    return out.reshape(shape)


class BlockShards:
    """Block partials kept on their shards' devices: parts [(k, B, C or
    None, row0)] with B, C [rows, n_pairs] float64, rows row0.. of the
    global row order (the sites shards' rows one after another); counts,
    the rows of every sites shard of the global axis."""

    def __init__(self, parts, counts, n_pairs: int) -> None:
        self.parts, self.counts, self.n_pairs = parts, list(counts), n_pairs
        self.n_rows = sum(self.counts)


class ShardStats:
    """The statistics of a run over a mesh, as the engine asks for them:
    calling it with a `Sharded` tensor gives (raw, cnt or None) float64
    pair vectors on the mesh's first device, summed over the shards in
    fixed order; `blocks` gives the block partials per shard.

    Per entry it holds the pair indices its kernel output is read at and
    its tile list (parallel/mesh.py module docstring), on its device.
    zero: the run's record of all-zero triples
    (preprocess.ZeroRows) where the EM poisons for them: each shard
    poisons the pairs of an individual with such a triple at one of its
    sites of weight > 0 (ngsdist_tpu/parallel/mesh.py:342-353), from the
    host record, and the NaN rides the sum."""

    def __init__(self, mesh: Mesh, N: int, score, indep: bool, pairwise_del: bool,
                 zero=None) -> None:
        self.mesh, self.N, self.indep, self.pairwise_del = mesh, N, indep, pairwise_del
        self.zero = zero
        self.score = torch.as_tensor(np.asarray(score, np.float64).reshape(3, 3))
        p = pairs_size(mesh)
        if indep:
            pairs = [dist._pair_indices(N)] * p
            tables = panel_tables(N, p) if p > 1 else [None]
        else:
            I, J = padded_pairs(N, p)
            per = I.size // p
            pairs = [(I[q * per:(q + 1) * per], J[q * per:(q + 1) * per]) for q in range(p)]
            tables = pair_block_tables(N, p) if p > 1 else [None]
        self.n_pairs = N * (N - 1) // 2
        self.entries = []
        for k, dev in enumerate(mesh.devices):
            I_q, J_q = pairs[k % p]
            It = torch.from_numpy(I_q.astype(np.int64)).to(dev)
            Jt = torch.from_numpy(J_q.astype(np.int64)).to(dev)
            tiles = tables[k % p]
            tiles = None if tiles is None else torch.from_numpy(tiles).to(dev)
            self.entries.append((It, Jt, dist._make_exact_stats(
                indep, pairwise_del, self.score, dev, It, Jt, None, tiles)))

    def _entry(self, k, Pk, w, lo, keep):
        """Entry k's (raw, cnt or None) pair vectors on its device, for the
        sites Pk = [lo, lo + len) of the data under weights w (host, or
        None); keep (compaction: the shard's non-finite sites, which stay
        in every list) runs each launch on the sites of weight other than
        0 only; None when no site is left."""
        It, Jt, exact_stats = self.entries[k]
        index, wk = None, w
        if keep is not None:
            sel = dist.class_sites(w, keep)
            if sel.size == 0:
                return None
            if sel.size < Pk.shape[0]:
                index = dist._upload_small(sel, Pk.device)
                wk = np.ascontiguousarray(w[sel])
        raw, cnt = exact_stats(Pk, wk, lo, index)
        if self.zero is not None:
            z = self.zero.individuals(lo, lo + Pk.shape[0], w)
            if z.any():
                raw = dist._em_poison_pairs(raw, dist._upload_small(z, raw.device), It, Jt)
        return raw, cnt

    def __call__(self, data: Sharded, weights=None, keep=None):
        """(raw, cnt or None) over data; weights, keep: per sites shard,
        as Sharded.cols cuts them, or None."""
        p = pairs_size(self.mesh)
        # indep: every entry adds onto the whole pair vector; EM: pairs
        # shard q onto its slice, and the slices are joined in pair order
        slices = 1 if self.indep else p
        raws = [[] for _ in range(slices)]
        cnts = [[] for _ in range(slices)]
        for k, Pk in enumerate(data.parts):
            s, q = divmod(k, p)
            lo, hi = data.local_ranges[s]
            if hi <= lo:
                continue
            w = None if weights is None else np.ascontiguousarray(weights[s])
            with self.mesh.on(k):
                got = self._entry(k, Pk[:hi - lo], w, lo, None if keep is None else keep[s])
            if got is None:
                continue
            raws[q % slices].append((k, got[0]))
            if got[1] is not None:
                cnts[q % slices].append((k, got[1]))
        raw = self._join(raws)
        return raw, self._join(cnts) if self.pairwise_del or not self.indep else None

    def _join(self, parts):
        """The fixed-order sum of each slice's parts, the slices joined."""
        per = -(-self.n_pairs // len(parts))
        out = []
        for got in parts:
            v = fixed_order_sum(self.mesh, got, (per,))
            out.append(torch.zeros(per, dtype=torch.float64, device=self.mesh.first)
                       if v is None else v)
        return torch.cat(out)[:self.n_pairs] if len(out) > 1 else out[0]

    def blocks(self, data: Sharded, block_size: int, rows: Optional[int] = None) -> BlockShards:
        """The unweighted block partials of every sites shard (a 1-D mesh):
        ceil(len / block_size) blocks per shard, a ragged last block padded
        with all-zero triples, or `rows` blocks (a streamed round of fixed
        shape, whose padding rows the caller maps away).  C None without
        pairwise deletion."""
        if pairs_size(self.mesh) != 1:
            raise ValueError("block partials are 1-D-mesh only; 2-D (pairs) meshes take "
                             "the weighted-recompute bootstrap path")
        fn = indep_block_partials if self.indep else em_block_partials
        counts = [rows if rows is not None else -(-(hi - lo) // block_size)
                  for lo, hi in data.ranges]
        row0s = np.cumsum([0] + counts)
        parts = []
        for k, Pk in enumerate(data.parts):
            s = self.mesh.shard0 + k
            lo, hi = data.ranges[s]
            n = counts[s]
            if n == 0:
                continue
            with self.mesh.on(k):
                if hi > lo:
                    need = n * block_size
                    if Pk.shape[0] < need:
                        Pk = torch.cat([Pk, Pk.new_zeros((need - Pk.shape[0],) + Pk.shape[1:])])
                    with profiling.device_span("kernel"):
                        B, C = fn(Pk[:need], self.score, self.pairwise_del, n, block_size)
                    B = B.double()
                    C = C.double() if self.pairwise_del else None
                else:  # a round past the data: its padding rows
                    dev = self.mesh.devices[k]
                    B = torch.zeros((n, self.N * (self.N - 1) // 2), dtype=torch.float64,
                                    device=dev)
                    C = torch.zeros_like(B) if self.pairwise_del else None
            parts.append((k, B, C, int(row0s[s])))
        return BlockShards(parts, counts, self.n_pairs)


def resum_blocks(M, B: BlockShards, mesh: Mesh, which: int = 0) -> torch.Tensor:
    """[R, n_pairs] float64 on the first device: M [R, B.n_rows] @ the
    partials (which 0: B, 1: C), per shard on its device, then the
    fixed-order sum.  A NaN partial makes its pair NaN whatever its
    block's multiplicity, as the JAX product does (0 x NaN)."""
    M = torch.as_tensor(np.asarray(M, np.float64))
    out = []
    for k, Bk, Ck, row0 in B.parts:
        X = Bk if which == 0 else Ck
        with mesh.on(k):
            Mk = M[:, row0:row0 + X.shape[0]].to(X.device)
            r = Mk @ X
            r = torch.where(torch.isnan(X).any(0), torch.full_like(r, float("nan")), r)
        out.append((k, r))
    return fixed_order_sum(mesh, out, (M.shape[0], B.n_pairs))


def concat_block_rounds(parts: List[BlockShards], mesh: Mesh) -> BlockShards:
    """Per-round block partials joined PER SHARD along the block axis:
    the rows of shard d are its rounds' rows in round order, and the
    shards follow one another (device-major), with each round's padding
    rows in place — the layout core/distance.py _stream_block_rows maps
    to global blocks (ngsdist_tpu/parallel/mesh.py:932)."""
    if len(parts) == 1:
        return parts[0]
    by_k = {}
    for bs in parts:
        for k, B, C, _ in bs.parts:
            got = by_k.setdefault(k, ([], []))
            got[0].append(B)
            if C is not None:
                got[1].append(C)
    counts = np.sum([bs.counts for bs in parts], axis=0).tolist()
    row0s = np.cumsum([0] + counts)
    out = []
    for k in sorted(by_k):
        Bs, Cs = by_k[k]
        with mesh.on(k):
            B = torch.cat(Bs)
            C = torch.cat(Cs) if Cs else None
        out.append((k, B, C, int(row0s[mesh.shard0 + k])))
    return BlockShards(out, counts, parts[0].n_pairs)


def bootstrap_replicates(table: np.ndarray, B: BlockShards, n_blocks: int, mesh: Mesh):
    """(raw [R, n_pairs], cnt or None) float64 on the first device: each
    replicate's resummation of the partials, table [R, n_blocks] the
    source-block index table; rows past n_blocks (the truncation tail)
    weigh 0."""
    M = bt.block_multiplicity(table, n_blocks)
    if B.n_rows > n_blocks:
        M = np.concatenate([M, np.zeros((M.shape[0], B.n_rows - n_blocks))], axis=1)
    has_c = any(C is not None for _, _, C, _ in B.parts)
    return resum_blocks(M, B, mesh, 0), resum_blocks(M, B, mesh, 1) if has_c else None


def sharded_suffstats(P_host, score, mesh: Mesh, *, indep: bool, pairwise_del: bool,
                      site_weights: Optional[np.ndarray] = None,
                      n_blocks: Optional[int] = None, block_size: int = 1):
    """Sufficient statistics over the mesh (ngsdist_tpu/parallel/mesh.py
    sharded_suffstats), float64 on the first device: (raw, cnt, B, C),
    raw/cnt [n_pairs] pair vectors, triu row-major (indep: cnt None
    without pairwise deletion; the JAX function's [N, N] at those
    pairs).  P_host: a host [S, N, 3] array or a `Sharded` one.  With n_blocks the block partials of the first n_blocks ·
    block_size sites come back as a `BlockShards` in B (C is then None:
    they hold it), and raw, cnt are None for indep and the unpoisoned
    full-data statistics for the EM, as in the JAX function."""
    want_blocks = n_blocks is not None
    if want_blocks and pairs_size(mesh) > 1:
        raise ValueError("block partials are 1-D-mesh only; 2-D (pairs) meshes take the "
                         "weighted-recompute bootstrap path")
    data, zero = P_host, None
    if not isinstance(P_host, Sharded):
        # the EM's zero-row poison, from the host array (the block pass
        # leaves it to the engine, which poisons per sampled replicate)
        if not (indep or pairwise_del or want_blocks):
            zero = find_zero_rows(P_host)
        granule = block_size if want_blocks else 1
        data = put_probs_sharded(P_host, _plan_padding(P_host.shape[0], sites_size(mesh),
                                                       granule), mesh)
    stats = ShardStats(mesh, data.N, score, indep, pairwise_del, zero)
    B = None
    if want_blocks:
        B = stats.blocks(data, block_size)
        if indep:
            return None, None, B, None
    raw, cnt = stats(data, data.cols(site_weights))
    return raw, cnt, B, None


# ------------------------------------------------------------------ #
# Extended evolutionary models: per-pair base frequencies             #
# ------------------------------------------------------------------ #


def pair_pi_counts(data: Sharded, a1: np.ndarray, a2: np.ndarray, w_ok, mesh: Mesh,
                   pairwise_del: bool, plane_bytes: int = dist.PI_PLANE_BYTES):
    """The expected base counts of models 4-6 over the mesh
    (ngsdist_tpu/parallel/mesh.py _pair_pi_sharded, pair_pi_counts), in
    the port's layout: [4, N, N] under pairwise deletion, else [4, N],
    float64 on the first device.  Each entry takes its shard's share
    (core/distance.py pair_pi_counts; additive over sites), a pairs-shard
    q only its rows [q·rows, (q+1)·rows), rows = ceil(N / p), as the JAX
    function does; the shares are summed over the sites axis in fixed
    order and the row slices joined.  a1, a2: the data's [S] allele
    codes; w_ok: per sites shard, the classifiable sites' weights."""
    p = pairs_size(mesh)
    N = data.N
    rows = -(-N // p)
    parts = [[] for _ in range(p)]
    for k, Pk in enumerate(data.parts):
        s, q = divmod(k, p)
        lo, hi = data.local_ranges[s]
        if hi <= lo:
            continue
        r = slice(q * rows, min((q + 1) * rows, N))
        with mesh.on(k):
            dev = mesh.devices[k]
            c = dist.pair_pi_counts(
                Pk[:hi - lo], dist._upload_small(np.ascontiguousarray(a1[lo:hi]), dev),
                dist._upload_small(np.ascontiguousarray(a2[lo:hi]), dev),
                dist._upload_small(np.ascontiguousarray(w_ok[s], np.float64), dev),
                pairwise_del, plane_bytes, rows=r if pairwise_del else None)
            if not pairwise_del and p > 1:
                c = c[:, r]
        parts[q].append((k, c))
    shape = lambda q: ((4, min(rows, N - q * rows)) + ((N,) if pairwise_del else ()))  # noqa: E731
    got = [fixed_order_sum(mesh, parts[q], shape(q)) for q in range(p)]
    got = [torch.zeros(shape(q), dtype=torch.float64, device=mesh.first) if g is None else g
           for q, g in enumerate(got)]
    return torch.cat(got, dim=1)


def normalize_pair_pi(acc: np.ndarray, pairwise_del: bool) -> np.ndarray:
    """[N, N, 4] per-pair base frequencies from the port's accumulated
    counts ([4, N, N] or [4, N], pair_pi_counts)."""
    acc = np.moveaxis(np.asarray(acc, np.float64), 0, -1)
    if pairwise_del:
        tot = acc + np.transpose(acc, (1, 0, 2))
    else:
        tot = acc[:, None, :] + acc[None, :, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        return tot / np.sum(tot, axis=-1, keepdims=True)


def sharded_pair_pi(P_host, a1: np.ndarray, a2: np.ndarray, w_ok: np.ndarray, mesh: Mesh, *,
                    pairwise_del: bool) -> np.ndarray:
    """[N, N, 4] per-pair base frequencies over the mesh (models 4-6;
    ngsdist_tpu/parallel/mesh.py sharded_pair_pi).  P_host: a host [S, N,
    3] array or a `Sharded` one; a1, a2: [S] allele codes; w_ok: [S]
    classifiable-site weights."""
    data = P_host
    if not isinstance(P_host, Sharded):
        data = put_probs_sharded(P_host, _plan_padding(P_host.shape[0], sites_size(mesh), 1),
                                 mesh)
    acc = pair_pi_counts(data, a1, a2, data.cols(w_ok), mesh, pairwise_del)
    return normalize_pair_pi(acc.cpu().numpy(), pairwise_del)
