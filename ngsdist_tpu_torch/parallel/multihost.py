"""Site rounds of a mesh run, in one process.

Port of the single-process part of ngsdist_tpu/parallel/multihost.py
`SiteStream`.  The host array stays where the reader left it; the
planner (`_plan`, the JAX rule) decides the shard length s_loc and
whether a shard fits its device's budget.  Resident, `global_array`
uploads each shard once; streamed, round r uploads the sites [r·chunk,
(r+1)·chunk) of every shard (`round_data`), so a round's statistics add
like the resident array's and the engine sums them over the rounds.  A
host site vector goes to the kernels cut per shard (`Sharded.cols` of
the round's data takes the place of the JAX `round_cols`).

Left for the multi-process port (ROADMAP M9): the lazy rounds read from
disk (`from_reader`), the spill readers, the coded (uint8) rounds, and
`bring_up` / `run_distributed`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Params
from ..core import distance as dist
from . import mesh as pm


def host_site_range(n_sites_pad: int, mesh) -> tuple:
    """This process's contiguous site range: the whole padded range (one
    process drives every device of the mesh; several processes are
    ROADMAP M9)."""
    return 0, n_sites_pad


def device_budget_bytes(mesh) -> int:
    """A shard's budget for its probability tensor.  On the CPU, and on
    a card under NGSDIST_DEVICE_BUDGET, the JAX rule (a third of the
    budget, 12 GiB by default), so that both engines cut the same rounds.
    A card left to itself: the smallest free memory over the mesh's
    distinct cards divided by the shards on that card, less the unplanned
    sixteenth, and half of that (the other half for the kernels' working
    set and the next round's upload)."""
    env = dist._env_budget()
    if mesh.first.type != "cuda" or env is not None:
        return max(1, (dist._DEFAULT_BUDGET if env is None else env)
                   // dist._WORKING_SET_FACTOR)
    per = []
    for dev in set(mesh.devices):
        free, _ = torch.cuda.mem_get_info(dev)
        free -= free // dist._CUDA_RESERVE_DEN
        per.append(free // mesh.devices.count(dev))
    return max(1, min(per) // dist._CUDA_STREAM_FACTOR)


class SiteStream:
    """A host [S, N, 3] array planned over a mesh: shards of s_loc sites
    (the last ones short or empty past the data), resident when
    chunk >= s_loc, else streamed in rounds of chunk sites per shard."""

    def __init__(self, P_host, pars: Params, mesh, s_loc: int, chunk: int) -> None:
        self.P, self.pars, self.mesh = P_host, pars, mesh
        self.S = pars.n_sites
        self.n_dev = pm.sites_size(mesh)
        self.s_loc = s_loc
        self.s_pad = s_loc * self.n_dev
        self.chunk = int(min(chunk, s_loc))
        self.resident = self.chunk >= self.s_loc

    @staticmethod
    def _plan(pars: Params, mesh):
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
        itemsize = torch.finfo(dist.default_dtype(mesh.first)).bits // 8
        budget_sites = device_budget_bytes(mesh) // max(1, pars.n_ind * 3 * itemsize)
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

    @classmethod
    def from_array(cls, P_host, pars: Params, mesh) -> "SiteStream":
        """The full tensor already in host memory."""
        s_loc, chunk = cls._plan(pars, mesh)
        return cls(P_host, pars, mesh, s_loc, chunk)

    def layout(self) -> list:
        """What a round index means: the rounds file of a streamed mesh
        run records it, and a run of another layout does not resume it."""
        return [self.s_loc, self.chunk, self.n_dev]

    def global_array(self) -> pm.Sharded:
        """Every shard on its devices."""
        return pm.shard_sites(self.P, self.mesh, pm.shard_ranges(self.S, self.s_loc,
                                                                 self.n_dev))

    @property
    def n_rounds(self) -> int:
        return -(-self.s_loc // self.chunk)

    def round_ranges(self, r: int):
        """[(lo, hi)] per shard: the data sites of round r."""
        return pm.shard_ranges(self.S, self.s_loc, self.n_dev, r * self.chunk,
                               min(self.chunk, self.s_loc - r * self.chunk))

    def round_data(self, r: int, pad: bool = False) -> pm.Sharded:
        """Round r's sites on every shard's devices; pad: each part filled
        with all-zero triples to chunk sites (the fixed shape of the block
        partials' rounds)."""
        return pm.shard_sites(self.P, self.mesh, self.round_ranges(r),
                              rows=self.chunk if pad else None)
