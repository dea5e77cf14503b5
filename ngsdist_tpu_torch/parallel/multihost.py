"""Site rounds of a mesh run, over one process or several, from host memory
or from disk.

Port of ngsdist_tpu/parallel/multihost.py.  `SiteStream` plans a run's
sites over the global sites axis of a mesh (parallel/mesh.py: every
process's entries in rank order): shards of s_loc sites, resident when a
shard fits its device's budget, else streamed in rounds of chunk sites
per shard, so that a round's statistics add like the resident array's
and the engine sums them over the rounds.  A process holds the sites of
its own shards only (`host_site_range`):

- from host memory: the array the runner read (`from_array`), or the
  process's own range read eagerly (`from_reader`);
- from disk (`from_reader` over the host budget, `wants_lazy`): no host
  array at all; each round reads its rows of every local shard from the
  file (a seekable raw binary file) or from a spill cache written once
  (`_build_spill`: gz, text and stdin inputs), through `DiskRows`, so
  neither host nor device memory bounds the genome's length.

Streamed rounds go through core/distance.py's ChunkPipe, one per local
shard, whose reader thread prepares a shard's next round (a cast of the
host array, or a read from disk) while the current one computes.

Several processes: `bring_up` joins a torch.distributed gloo group, and
`run_distributed` runs the whole pipeline on each process; the shards'
sums meet in parallel/mesh.py's gathered fixed-order sum, and process 0
writes the output.  Everything that decides the plan (the device budget,
the lazy gate and the lazy chunk) is agreed across processes, so that
they cut the same rounds and call the same collectives in the same order.

Default-threshold --call_geno runs (`wants_coded_lazy`) read one uint8
code a triple instead of the triple (ngsdist_tpu/parallel/multihost.py:
358-398, :609-637): a raw or spilled binary source through the fused
codes reader (readers.read_geno_codes), the text spill by classifying its
normalized rows (`_classify_call_rows`), eagerly into a code plane or
lazily round by round; the device expands the codes through one static
table (`_call_lut`), so every process holds the same table without a
broadcast, and the rounds and values are those of the staged read.
"""

from __future__ import annotations

import os
import sys
import weakref
from typing import Optional

import numpy as np
import torch

from ..config import NgsDistError, Params
from ..core import bootstrap as bt
from ..core import distance as dist
from ..core import models
from ..core.preprocess import ZeroRows, find_zero_rows, preprocess
from ..core.submodels import encode_alleles
from ..io import readers, writers
from ..utils import checkpoint as ckpt
from ..utils import native, profiling, signals
from ..utils.hostmem import (CodedProbs, coded_call_lut, coded_upload_enabled, pack23,
                              upload16_enabled, upload23_enabled)
from . import mesh as pm


# ------------------------------------------------------------------ #
# Processes                                                           #
# ------------------------------------------------------------------ #


def bring_up(coordinator_address: Optional[str] = None,
             num_processes: Optional[int] = None,
             process_id: Optional[int] = None) -> bool:
    """Join the run's process group: gloo over TCP at the coordinator's
    HOST:PORT (process 0 listens there).  Nothing without a coordinator.
    Returns whether it joined, so that the caller leaves the group it
    joined."""
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise NgsDistError("main", "--coordinator needs --num_processes and --process_id")
    if not 0 <= process_id < num_processes:
        raise NgsDistError("main", f"--process_id {process_id} is not in [0, "
                           f"{num_processes})")
    import torch.distributed as tdist

    tdist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                             world_size=num_processes, rank=process_id)
    return True


def process_index() -> int:
    """This process's rank (0 outside a process group)."""
    import torch.distributed as tdist

    return tdist.get_rank() if tdist.is_available() and tdist.is_initialized() else 0


def process_count() -> int:
    """The processes of the run (1 outside a process group)."""
    import torch.distributed as tdist

    return tdist.get_world_size() if tdist.is_available() and tdist.is_initialized() else 1


def agreed(value: int, op: str) -> int:
    """An integer agreed across processes, their "min" or "max" (one
    all-reduce over gloo); the value itself in one process."""
    if process_count() == 1:
        return int(value)
    import torch.distributed as tdist

    t = torch.tensor([int(value)], dtype=torch.int64)
    tdist.all_reduce(t, op=tdist.ReduceOp.MIN if op == "min" else tdist.ReduceOp.MAX)
    return int(t)


def union_over_processes(flags: np.ndarray) -> np.ndarray:
    """A bool array ORed across processes: each process holds the flags of
    its own sites (one all-reduce; the EM's zero-row flags per bootstrap
    block, where the JAX engine fetches a global array,
    ngsdist_tpu/core/distance.py:1214)."""
    if process_count() == 1:
        return flags
    import torch.distributed as tdist

    t = torch.from_numpy(np.ascontiguousarray(flags, np.uint8))
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX)
    return t.numpy().astype(bool)


def broadcast_object(obj):
    """Process 0's picklable value on every process (gloo).  Float64 arrays
    arrive bit for bit."""
    if process_count() == 1:
        return obj
    import torch.distributed as tdist

    box = [obj]
    tdist.broadcast_object_list(box, src=0)
    return box[0]


def host_site_range(n_sites_pad: int, mesh) -> tuple:
    """This process's contiguous site range: the sites shards of its own
    entries on the global axis (all of them in one process)."""
    s_loc = n_sites_pad // pm.sites_size(mesh)
    return mesh.shard0 * s_loc, (mesh.shard0 + mesh.local_sites) * s_loc


def device_budget_bytes(mesh) -> int:
    """A shard's budget for its probability tensor.  On the CPU, and on
    a card under NGSDIST_DEVICE_BUDGET, the JAX rule (a third of the
    budget, 12 GiB by default), so that both engines cut the same rounds.
    A card left to itself: the smallest free memory over the mesh's
    distinct cards divided by the shards on that card, less the unplanned
    sixteenth, and half of that (the other half for the kernels' working
    set and the next round's upload); over several processes the smallest
    of theirs, so that all plan the same shards."""
    env = dist._env_budget()
    if mesh.first.type != "cuda" or env is not None:
        return max(1, (dist._DEFAULT_BUDGET if env is None else env)
                   // dist._WORKING_SET_FACTOR)
    per = []
    for dev in set(mesh.devices):
        free, _ = torch.cuda.mem_get_info(dev)
        free -= free // dist._CUDA_RESERVE_DEN
        per.append(free // mesh.devices.count(dev))
    return agreed(max(1, min(per) // dist._CUDA_STREAM_FACTOR), "min")


# ------------------------------------------------------------------ #
# Rows from disk                                                      #
# ------------------------------------------------------------------ #


def _classify_call_rows(rows: np.ndarray) -> np.ndarray:
    """The default-threshold --call_geno codes of log-normalized rows
    [..., 3] (ngsdist_tpu/parallel/multihost.py:50-66): one-hot at the
    first argmax (the strict > scan of nd_call_geno3), 3 where all three
    are equal (the uniform exp(log(1/3)) of _call_lut), 4 where the row is
    NaN (a literal `nan` of a text input makes the whole row NaN).  Taken
    on the stored values as they are: normalizing again could break an
    exact tie of the argmax."""
    am = np.argmax(rows, axis=-1).astype(np.uint8)
    all_eq = (rows[..., 0] == rows[..., 1]) & (rows[..., 1] == rows[..., 2])
    codes = np.where(all_eq, np.uint8(3), am)
    nan_rows = np.isnan(rows[..., 0])
    if nan_rows.any():
        codes = np.where(nan_rows, np.uint8(4), codes)
    return codes


def _call_lut() -> np.ndarray:
    """The static table of every coded stream read by from_reader: the
    one-hot rows, the uniform missing triple and the NaN row of a text
    input's literal `nan`, fixed before any data is read and the same in
    every process (the JAX package's _call_lut_padded without its pad
    row: the port's shards carry their data ranges and pad no rows)."""
    return np.vstack([coded_call_lut(True), np.full((1, 3), np.nan)])


class DiskRows:
    """A lazy stream's sites, read from disk as the engine asks for them,
    with the read protocol of readers.PackedBinInput (`shape`,
    `read_packed`, `width`, `u16`), so that the engine's ChunkPipe reads a
    shard's next round on its reader thread.  The lane is the device's
    (utils/hostmem.py upload23_enabled, upload16_enabled): on the
    two-component lanes a slab is [n, N, 2] (`width` 2; p2 = 1 - p0 - p1
    is restored on the device), uint16 where `u16`, else the engine's
    float dtype.  A raw binary source without --call_geno goes through
    the fused native reader on those lanes (readers.read_geno_pack16 or
    read_geno_pack23), the values of the one-device run's fused read.
    Every other read is the staged one (rows, preprocess, then
    hostmem.pack23 on those lanes or the cast to the device's dtype:
    [n, N, 3] slabs), the values of the eager read of the same input.
    Coded
    (SiteStream.wants_coded_lazy): uint8 [n, N] codes (`width` 1) of the
    static table `lut` (_call_lut), from the fused codes reader or the
    text spill's classified rows, which the card expands into the staged
    read's values.  The sources: the input itself (seekable binary), a
    verbatim copy of this process's rows of a gz or stdin binary input,
    or the text spill's normalized rows.  zero: the run's record of
    all-zero triples, filled as rows are read (text spills only: no
    binary row is all zero, and --call_geno, the coded lane, calls an
    empty line missing)."""

    def __init__(self, pars: Params, dtype: torch.dtype, device: torch.device, stop: int,
                 spill_path: Optional[str] = None, spill_norm: bool = False,
                 spill_base: int = 0, coded: bool = False) -> None:
        self.pars, self.dtype, self.device = pars, dtype, device
        self.N, self.S = pars.n_ind, pars.n_sites
        self.shape = (self.S, self.N, 3)
        self.stop = stop
        self.spill_path, self.spill_norm, self.spill_base = spill_path, spill_norm, spill_base
        self.zero = ZeroRows.empty(self.N) if spill_norm else None
        self.lut = _call_lut() if coded else None
        # float32 pairs or uint16 (a float64 engine reads its rows whole,
        # whatever NGSDIST_UPLOAD23 forces)
        packed = dtype == torch.float32 and upload23_enabled(dtype)
        self.u16 = not coded and upload16_enabled(dtype, device)
        self.fused = (packed and not pars.call_geno and not spill_norm and native.have_native()
                      and readers.is_raw_seekable_binary(spill_path or pars.in_geno))
        self.width = 1 if coded else 2 if packed else 3

    def _binary_source(self):
        """(path, sites in it, first site) of a binary source."""
        if self.spill_path is None:
            return self.pars.in_geno, self.S, 0
        return self.spill_path, min(self.stop, self.S) - self.spill_base, self.spill_base

    def _read_rows(self, lo: int, hi: int) -> np.ndarray:
        """Log-space rows [lo, hi): from the original seekable binary,
        the verbatim binary cache (both normalize per read), or the text
        spill cache (already normalized: normalizing again would change
        the bits)."""
        p = self.pars
        if self.spill_norm:
            return readers.read_spill_rows(self.spill_path, self.N, lo, hi,
                                           base=self.spill_base)
        path, rows, base = self._binary_source()
        return readers.read_geno(path, True, p.in_probs, p.in_logscale, self.N, rows,
                                 site_range=(lo - base, hi - base))

    def _read_codes(self, lo: int, hi: int, out: Optional[np.ndarray] = None) -> np.ndarray:
        """The codes of sites [lo, hi) (ngsdist_tpu/parallel/multihost.py:
        609-637): one fused native pass over a binary source, or the text
        spill's stored rows classified as nd_call_geno3 calls them, so
        that their expansion is the staged round's preprocessed rows."""
        if self.spill_norm:
            codes = _classify_call_rows(readers.read_spill_rows(
                self.spill_path, self.N, lo, hi, base=self.spill_base))
            if out is None:
                return codes
            out[...] = codes
            return out
        path, rows, base = self._binary_source()
        got = readers.read_geno_codes(path, self.pars.in_logscale, self.N, rows,
                                      site_range=(lo - base, hi - base), out=out)
        if got is None:  # not raw binary after all (TOCTOU): hard error
            raise NgsDistError("read_geno", "cannot read binary GENO file. Check GENO "
                               "file and number of sites!")
        return got[0]

    def read_packed(self, lo: int, hi: int, out: Optional[np.ndarray] = None) -> np.ndarray:
        """The upload-ready slab of sites [lo, hi), written into `out`
        (pinned memory) when given."""
        if self.lut is not None:
            return self._read_codes(lo, hi, out)
        if self.fused:
            path, rows, base = self._binary_source()
            read = readers.read_geno_pack16 if self.u16 else readers.read_geno_pack23
            got = read(path, self.pars.in_logscale, self.N, rows,
                       site_range=(lo - base, hi - base), out=out)
            if got is None:  # not raw binary after all (TOCTOU): hard error
                raise NgsDistError("read_geno", "cannot read binary GENO file. Check GENO "
                                   "file and number of sites!")
            return got
        p = self.pars
        pre = preprocess(self._read_rows(lo, hi), p.call_geno, p.N_thresh, p.call_thresh)
        if self.zero is not None:
            self.zero.add(lo, pre)
        if self.width == 2:
            return pack23(pre, self.dtype, self.device, out=out)
        if out is None:
            return pre
        np.copyto(out, pre, casting="same_kind")
        return out


# ------------------------------------------------------------------ #
# The stream                                                          #
# ------------------------------------------------------------------ #


class SiteStream:
    """A run's sites planned over a mesh: shards of s_loc sites (the last
    ones short or empty past the data), resident when chunk >= s_loc (a
    host source only), else streamed in rounds of chunk sites per shard.
    src: a host [n, N, 3] array or code plane (utils/hostmem.CodedProbs)
    of the sites from `base` on (this process's own, or all of them), or
    a DiskRows (lazy).  `coded`: the shards travel as uint8 codes; the
    plan is the same in either lane.  `x64`: the run's dtype choice, which
    the plan, the reads and the uploads follow."""

    def __init__(self, src, pars: Params, mesh, s_loc: int, chunk: int, base: int = 0,
                 spill_owned: Optional[str] = None, x64: bool = False) -> None:
        self.src, self.pars, self.mesh, self.base = src, pars, mesh, base
        self.x64 = x64  # the run's dtype choice (core/distance.py default_dtype)
        self.S = pars.n_sites
        self.n_dev = pm.sites_size(mesh)
        self.s_loc = s_loc
        self.s_pad = s_loc * self.n_dev
        self.chunk = int(min(chunk, s_loc))
        self.lazy = isinstance(src, DiskRows)
        dtype = dist.default_dtype(mesh.first, x64)
        self.coded = dist.slab_layout(src, dtype, mesh.first)[0] == 1
        # a lazy stream always runs in rounds: there is no host array to
        # upload whole
        self.resident = not self.lazy and self.chunk >= self.s_loc
        self.start, self.stop = host_site_range(self.s_pad, mesh)
        self._pipes = None
        self._spill_fin = (None if spill_owned is None else
                           weakref.finalize(self, SiteStream._rm_spill, spill_owned))

    @staticmethod
    def _rm_spill(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    def close(self) -> None:
        """Delete an owned spill cache (idempotent; also runs at GC)."""
        if self._spill_fin is not None:
            self._spill_fin()
            self._spill_fin = None

    # -------------------------- planning ----------------------------- #

    @staticmethod
    def _plan(pars: Params, mesh, x64: bool = False):
        """(s_loc, chunk): per-shard length and per-round chunk
        (ngsdist_tpu/parallel/multihost.py:256-294).  The alignment
        granule is the bootstrap block size (the partials need block-
        aligned shards); a resident shard prefers a multiple of lcm(block,
        256) for the EM, as the JAX engine's tile search does, and a
        streamed one rounds down to such multiples where there is room,
        aiming at STREAM_MIN_CHUNKS rounds."""
        n_dev = pm.sites_size(mesh)
        g = pars.boot_block_size if pars.n_boot_rep else 1
        pref = int(np.lcm(g, 256)) if not pars.indep_geno else g
        budget_sites = device_budget_bytes(mesh) // max(
            1, pars.n_ind * 3 * dist.itemsize(mesh.first, x64))
        s_min = pm._round_up(pars.n_sites, n_dev) // n_dev
        s_loc_pref = pm._round_up(s_min, pref)
        if budget_sites >= s_loc_pref:
            return s_loc_pref, s_loc_pref
        s_loc = pm._round_up(s_min, g)
        if budget_sites >= s_loc:
            return s_loc, s_loc
        budget_sites = max(1, budget_sites * dist.PREFETCH_KEEP_NUM // dist.PREFETCH_KEEP_DEN)
        chunk = (budget_sites // pref) * pref or (budget_sites // g) * g or g
        depth = pm._round_up(max(-(-s_loc // dist.STREAM_MIN_CHUNKS),
                                 dist.STREAM_MIN_CHUNK_SITES), pref)
        return s_loc, min(chunk, depth)

    @staticmethod
    def _host_budget_bytes() -> int:
        """Host memory for a process's eagerly read sites.  Above it the
        stream goes lazy: no host array, each round reads its own rows
        from disk.  Default: half of MemAvailable (at least 1 GiB);
        NGSDIST_HOST_BUDGET overrides (bytes)."""
        env = os.environ.get("NGSDIST_HOST_BUDGET")
        if env:
            return max(1, int(env))
        try:
            with open("/proc/meminfo") as fh:
                for ln in fh:
                    if ln.startswith("MemAvailable:"):
                        return max(1 << 30, int(ln.split()[1]) * 1024 // 2)
        except OSError:
            pass
        return 1 << 62

    @staticmethod
    def seekable_binary(pars: Params) -> bool:
        """True when rounds can read the input itself: binary, not stdin,
        not gzip-compressed."""
        return bool(pars.in_geno and pars.in_bin and pars.in_geno != "-"
                    and not pars.in_geno.endswith(".gz"))

    @classmethod
    def coded_call_eligible(cls, pars: Params, dtype: torch.dtype) -> bool:
        """The one gate of every fused-codes route (the eager plane, the
        readers.CodedBinInput handle, the coded rounds;
        ngsdist_tpu/parallel/multihost.py:358-377), which the runner
        shares: default-threshold --call_geno determines each triple from
        a code; models 0-2, no per-site debug replay, the native reader,
        and coded uploads on for the device's dtype.
        NGSDIST_FUSED_READ=0 forces the staged chain."""
        if os.environ.get("NGSDIST_FUSED_READ", "auto") == "0":
            return False
        if not pars.call_geno or pars.N_thresh != 0.0 or pars.call_thresh != 0.0:
            return False
        if pars.evol_model >= 3 or pars.verbose >= 8:
            return False
        return coded_upload_enabled(dtype) and native.have_native()

    @classmethod
    def wants_coded_lazy(cls, pars: Params, dtype: torch.dtype) -> bool:
        """True when from_reader reads codes (ngsdist_tpu/parallel/
        multihost.py:379-398), eagerly or in rounds: a raw seekable binary
        file and a binary spill through the fused codes reader, the text
        spill by classifying its normalized rows.  A file read in place
        must also pass the raw-magic sniff (a gz file behind a name
        without .gz goes through read_geno's gz path)."""
        if not cls.coded_call_eligible(pars, dtype):
            return False
        if cls.seekable_binary(pars):
            return readers.is_raw_seekable_binary(pars.in_geno)
        return True

    @classmethod
    def wants_lazy(cls, pars: Params, dtype: torch.dtype, n_rows: int) -> bool:
        """True when reading n_rows sites eagerly (the float64 read and the
        shard in the device's dtype) would exceed the host budget: the JAX
        estimate, so that both engines take the same route.  Every input
        style can go lazy: seekable binary directly, the others through a
        spill cache."""
        itemsize = torch.finfo(dtype).bits // 8
        need = n_rows * pars.n_ind * 3 * (itemsize + 8)
        return need > cls._host_budget_bytes()

    # -------------------------- constructors ------------------------- #

    @classmethod
    def from_array(cls, P_host, pars: Params, mesh, x64: bool = False) -> "SiteStream":
        """The full tensor already in host memory: an array or a code
        plane (CodedProbs), whose shards and rounds go to the devices as
        codes."""
        s_loc, chunk = cls._plan(pars, mesh, x64)
        return cls(P_host, pars, mesh, s_loc, chunk, x64=x64)

    @classmethod
    def from_reader(cls, pars: Params, mesh, x64: bool = False) -> "SiteStream":
        """Each process reads only its own site range of the genotype
        file: eagerly into host memory, in the device's dtype, or, over
        the host budget on any process, lazily in rounds from disk; under
        wants_coded_lazy as uint8 codes either way (the plan is the
        same).  The lane needs no agreement: both give the same values."""
        s_loc, chunk = cls._plan(pars, mesh, x64)
        start, stop = host_site_range(s_loc * pm.sites_size(mesh), mesh)
        dtype = dist.default_dtype(mesh.first, x64)
        N, S = pars.n_ind, pars.n_sites
        coded = cls.wants_coded_lazy(pars, dtype)
        if agreed(cls.wants_lazy(pars, dtype, stop - start), "max"):
            chunk = cls._lazy_chunk(pars, mesh, dtype, chunk)
            spill = {}
            if not cls.seekable_binary(pars):
                spill = cls._build_spill(pars, start, stop)
            try:
                src = DiskRows(pars, dtype, mesh.first, stop, coded=coded, **spill)
                return cls(src, pars, mesh, s_loc, chunk, spill_owned=spill.get("spill_path"),
                           x64=x64)
            except BaseException:
                if spill:
                    cls._rm_spill(spill["spill_path"])
                raise
        lo, hi = min(start, S), min(stop, S)
        rng = None if (lo, hi) == (0, S) else (lo, hi)
        if coded:
            # the eager code plane (ngsdist_tpu/parallel/multihost.py:
            # 458-481): one fused pass over a raw binary file, else the
            # normalized rows read and classified
            codes = np.zeros((0, N), np.uint8)
            if hi > lo and cls.seekable_binary(pars):
                got = readers.read_geno_codes(pars.in_geno, pars.in_logscale, N, S,
                                              site_range=rng)
                if got is None:  # not raw binary after all (TOCTOU): hard error
                    raise NgsDistError("read_geno", "cannot read binary GENO file. Check "
                                       "GENO file and number of sites!")
                codes = got[0]
            elif hi > lo:
                codes = _classify_call_rows(readers.read_geno(
                    pars.in_geno, pars.in_bin, pars.in_probs, pars.in_logscale, N, S,
                    site_range=rng))
            return cls(CodedProbs(None, codes, _call_lut()), pars, mesh, s_loc, chunk, base=lo,
                       x64=x64)
        if hi > lo:
            geno_log = readers.read_geno(
                pars.in_geno, pars.in_bin, pars.in_probs, pars.in_logscale, N, S,
                site_range=rng)
            pre = preprocess(geno_log, pars.call_geno, pars.N_thresh, pars.call_thresh)
            local = pre   # packed or cast as each shard's rows go up (_host_pack)
        else:
            local = np.zeros((0, N, 3), dist._np_dtype(dtype))
        return cls(local, pars, mesh, s_loc, chunk, base=lo, x64=x64)

    @classmethod
    def _lazy_chunk(cls, pars: Params, mesh, dtype: torch.dtype, chunk: int) -> int:
        """The sites of a lazy round of a shard, at most `chunk` (the
        plan's), agreed across processes (ngsdist_tpu/parallel/
        multihost.py:428-444).  A round is bounded by both budgets: the
        host's staging of every local shard (the float64 read, the slab
        and the next round's, about three times a round) and the device's
        with its prefetch reservation (_plan's resident return skips the
        latter).  The host's share of a shard is its budget over this
        process's shards: where it binds, a process of fewer shards reads
        longer rounds, and the run's bytes follow its split into processes
        (run_distributed)."""
        itemsize = torch.finfo(dtype).bits // 8
        N = pars.n_ind
        g = pars.boot_block_size if pars.n_boot_rep else 1
        pref = g if pars.indep_geno else int(np.lcm(g, 256))
        host_sites = (cls._host_budget_bytes() // 3) // max(
            1, mesh.local_sites * N * 3 * itemsize)
        dev_sites = (device_budget_bytes(mesh) * dist.PREFETCH_KEEP_NUM
                     // dist.PREFETCH_KEEP_DEN) // max(1, N * 3 * itemsize)
        sites = min(host_sites, dev_sites)
        sites = (sites // pref) * pref or (sites // g) * g or g
        return agreed(min(chunk, sites), "min")

    # ------------------------- spill cache --------------------------- #

    @classmethod
    def _build_spill(cls, pars: Params, start: int, stop: int) -> dict:
        """One pass of a gz, text or stdin input into a disk cache of this
        process's rows that rounds then read: text inputs parsed by the
        native reader into normalized rows (readers.spill_text_geno), gz
        and stdin binary inputs copied verbatim (_copy_binary), their
        rounds normalized as they are read, as a seekable binary file's
        are.  Location: NGSDIST_SPILL_DIR (default: the system's temporary
        directory; point it at a large disk for long genomes)."""
        import tempfile

        base = os.environ.get("NGSDIST_SPILL_DIR") or None
        fd, cache = tempfile.mkstemp(prefix="ngsdist_spill_", suffix=".bin", dir=base)
        os.close(fd)
        lo, hi = min(start, pars.n_sites), min(stop, pars.n_sites)
        try:
            if pars.in_bin:
                cls._copy_binary(pars, cache, lo, hi)
                return dict(spill_path=cache, spill_norm=False, spill_base=lo)
            readers.spill_text_geno(pars.in_geno, pars.in_probs, pars.in_logscale,
                                    pars.n_ind, pars.n_sites, cache, site_range=(lo, hi))
            return dict(spill_path=cache, spill_norm=True, spill_base=lo)
        except BaseException:
            cls._rm_spill(cache)
            raise

    @staticmethod
    def _copy_binary(pars: Params, cache: str, start: int, stop: int) -> None:
        """Decompress-copy rows [start, stop) of a gz or stdin binary input
        to `cache`: each process keeps its own rows only (the processes'
        caches add up to one genome), reading past the rest so that the
        reference's read-time size fatals still fire (premature EOF, not
        at EOF; read_data.cpp:29-47, 106-109).  NaN checks come when a
        round reads its rows, as for a seekable binary file."""
        import gzip

        want = pars.n_sites * pars.n_ind * 3 * 8
        row = pars.n_ind * 3 * 8
        keep_lo, keep_hi = start * row, stop * row
        src = sys.stdin.buffer if pars.in_geno == "-" else gzip.open(pars.in_geno, "rb")
        total = 0
        try:
            with open(cache, "wb") as out:
                while True:
                    buf = src.read(16 << 20)
                    if not buf:
                        break
                    new = total + len(buf)
                    if new > want:
                        raise NgsDistError("read_geno", "GENO file not at EOF. Check GENO "
                                           "file and number of sites!")
                    a, b = max(total, keep_lo), min(new, keep_hi)
                    if b > a:
                        out.write(buf[a - total:b - total])
                    total = new
        finally:
            if src is not sys.stdin.buffer:
                src.close()
        if total < want:
            raise NgsDistError("read_geno", "GENO file at premature EOF. Check GENO file "
                               "and number of sites!")

    # --------------------------- the data ---------------------------- #

    def layout(self) -> list:
        """What a round index means: the rounds file of a streamed mesh
        run records it, and a run of another layout does not resume it."""
        return [self.s_loc, self.chunk, self.n_dev]

    def zero_rows(self) -> ZeroRows:
        """The record of all-zero triples (preprocess.ZeroRows) of this
        process's sites, for the EM's poison: a host source's, taken once;
        a lazy stream's, filled as its rounds are read."""
        if self.lazy:
            return self.src.zero if self.src.zero is not None else ZeroRows.empty(self.pars.n_ind)
        got = find_zero_rows(self.src)
        if got is None:
            return ZeroRows.empty(self.pars.n_ind)
        return ZeroRows(got.sites + self.base, got.rows)

    def global_array(self) -> pm.Sharded:
        """Every local shard on its devices (a resident stream)."""
        return pm.shard_sites(self.src, self.mesh,
                              pm.shard_ranges(self.S, self.s_loc, self.n_dev), self.x64,
                              base=self.base)

    @property
    def n_rounds(self) -> int:
        return -(-self.s_loc // self.chunk)

    def round_ranges(self, r: int):
        """[(lo, hi)] per sites shard of the global axis: the data sites of
        round r."""
        return pm.shard_ranges(self.S, self.s_loc, self.n_dev, r * self.chunk,
                               min(self.chunk, self.s_loc - r * self.chunk))

    def rounds(self, todo):
        """Yield (r, data) for each round r of todo, in order: round r's
        sites of every local shard on its devices (a pm.Sharded), each
        shard's through a ChunkPipe of its own whose reader prepares the
        shard's next round while this one computes.  A round's data is
        valid until the next one is asked for."""
        mesh = self.mesh
        p = pm.pairs_size(mesh)
        todo = list(todo)
        if self._pipes is None:
            dtype = dist.default_dtype(mesh.first, self.x64)
            self._pipes = [dist.ChunkPipe(self.src, mesh.devices[s * p], dtype, self.chunk)
                           for s in range(mesh.local_sites)]
        per_round = [self.round_ranges(r) for r in todo]
        walks = []
        for s, pipe in enumerate(self._pipes):
            ranges = [rr[mesh.shard0 + s] for rr in per_round]
            walks.append(pipe.chunks([(lo - self.base, hi - self.base)
                                      for lo, hi in ranges if hi > lo]))
        for r, ranges in zip(todo, per_round):
            parts = []
            for k in range(len(mesh.devices)):
                s, q = divmod(k, p)
                lo, hi = ranges[mesh.shard0 + s]
                part = None
                if q:
                    if parts[k - q] is not None:
                        part = mesh.copy(k - q, parts[k - q], k)
                elif hi > lo:
                    with mesh.on(k):
                        part = next(walks[s])[0]
                parts.append(part)
            yield r, pm.Sharded(mesh, ranges, parts, self.pars.n_ind)
        for s, walk in enumerate(walks):
            with mesh.on(s * p):   # the pipe marks its last chunk consumed here
                next(walk, None)

    def round_data(self, r: int) -> pm.Sharded:
        """Round r's sites on every local shard's devices."""
        for _, data in self.rounds([r]):
            pass
        return data


# ------------------------------------------------------------------ #
# The multi-process pipeline                                          #
# ------------------------------------------------------------------ #


def _process_mesh(device: Optional[torch.device]):
    """This process's entries: every card it sees (a card is the default;
    without one the run stops), or one `cpu` entry; every process must
    have as many, for one global axis of equal parts."""
    if device is None or device.type == "cuda":
        if not torch.cuda.is_available():
            raise NgsDistError("main", "no CUDA device is available to this process "
                               "(--platform cpu runs the float64 CPU path)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [device]
    n = len(devices)
    if agreed(n, "min") != agreed(n, "max"):
        raise NgsDistError("main", "every process of a run must drive as many devices "
                           f"(this one has {n})")
    return pm.make_mesh(devices)


def run_distributed(pars: Params, coordinator: Optional[str] = None,
                    num_processes: Optional[int] = None,
                    process_id: Optional[int] = None, resume: bool = False,
                    device: Optional[torch.device] = None, mesh=None, x64: bool = False):
    """The whole pipeline in each process of a run (BASELINE.json's
    scale-out configuration; ngsdist_tpu/parallel/multihost.py:786): every
    process reads its own site range (SiteStream.from_reader, eager or
    lazy), the shards' sums meet in the gathered fixed-order sum, and
    process 0 writes the phylip matrices to pars.out.  The output is that
    of one process with a mesh of all the processes' entries, bit for bit,
    when both cut the same rounds: the same device budget a shard (the
    same cards, or NGSDIST_DEVICE_BUDGET), and both reading eagerly (the
    whole genome within the one process's host budget) or both lazily in
    rounds that the host budget does not cut (SiteStream._lazy_chunk).
    Otherwise the one process, whose host budget holds more shards, reads
    lazily or in shorter rounds, and its float64 sums add in another
    order.  device: this process's device type (default: its cards); mesh:
    its entries instead (tests repeat a `cpu` entry); x64: float64 on the
    cards (--x64), the same in every process.  Returns the matrices on
    process 0, [] elsewhere.

    resume: process 0 reads the .ckpt.json sidecar and every process
    skips the matrices it counts; within a streamed replicate the rounds
    file (process 0's) is resumed the same way.  Signals are armed: a
    stop request on any process ends every process after the matrix in
    flight, with a resumable sidecar."""
    joined = bring_up(coordinator, num_processes, process_id)
    try:
        signals.arm()
        pars.validate()
        is_writer = process_index() == 0
        try:
            pars.finalize()
        except Exception:
            # banners accumulated before a finalize-time fatal still print
            if is_writer:
                for msg in pars.messages:
                    print(msg, file=sys.stderr)
            raise
        # models 3-6: every process reads the small POS file whole for the
        # allele codes
        alleles = None
        if pars.evol_model >= 3:
            if not pars.in_pos:
                raise NgsDistError("main", "evolutionary models need allele info in the POS "
                                   "file!")
            alleles = encode_alleles(readers.read_pos(pars.in_pos, pars.in_pos_header,
                                                      pars.n_sites))
        else:
            models.check_model_supported(pars.evol_model)
        if is_writer:
            for msg in pars.messages:
                print(msg, file=sys.stderr)
        if mesh is None:
            mesh = _process_mesh(device)
        # the one-process mesh run's engine name: a run resumes across
        # shapes, as runner.run(mesh=) does
        if agreed(int(x64), "min") != agreed(int(x64), "max"):
            raise NgsDistError("main", "every process of a run must take the same --x64")
        engine = dist.engine_name(mesh.first, x64)
        stream = SiteStream.from_reader(pars, mesh, x64)
        try:
            return _write_matrices(pars, stream, mesh, alleles, resume, engine)
        finally:
            stream.close()  # delete an owned spill cache
    finally:
        if joined:
            import torch.distributed as tdist

            tdist.destroy_process_group()


def _write_matrices(pars: Params, stream: SiteStream, mesh, alleles, resume: bool,
                    engine: str):
    """run_distributed's replicate loop: process 0 writes, flushes and
    saves the sidecar after every matrix."""
    is_writer = process_index() == 0
    n_done = 0
    if resume:
        if is_writer:
            n_done = ckpt.load(pars.out, pars, engine=engine) or 0
        n_done = broadcast_object(n_done)
        if is_writer and n_done:
            print(f"==> Resuming: {n_done} matrices already written", file=sys.stderr)
    n_trunc, maps = bt.site_maps(pars.seed, pars.n_boot_rep, pars.n_sites,
                                 pars.boot_block_size)
    labels = out_fh = None
    if is_writer:
        labels = (readers.read_labels(pars.in_labels, pars.in_labels_header, pars.n_ind)
                  if pars.in_labels else readers.default_labels(pars.n_ind))
        try:
            out_fh = open(pars.out, "a" if n_done else "w")
        except OSError as ex:
            raise NgsDistError("main", "cannot open output file!", err=ex.errno or 0)
    matrices = []
    interrupted = False
    try:
        for rep, m in enumerate(dist.iter_replicates(
                pars, stream, maps, n_trunc, mesh.first, start_rep=n_done, round_ckpt=True,
                alleles=alleles, mesh=mesh, x64=stream.x64), start=n_done):
            if is_writer:
                with profiling.replicate(rep), profiling.host_span("write"):
                    writers.write_dist_matrix(out_fh, labels, m)
                    out_fh.flush()
                    ckpt.save(pars.out, pars, rep + 1, engine=engine)
                matrices.append(m)
            # one decision for all: a process that stopped alone would
            # leave the others waiting in the next collective
            if agreed(signals.stop_requested(), "max"):
                interrupted = True
                if is_writer:
                    print("==> Stop requested; output is resumable (--resume)",
                          file=sys.stderr)
                break
    finally:
        if out_fh is not None:
            out_fh.close()
    if is_writer and not interrupted:
        ckpt.clear(pars.out)
    return matrices
