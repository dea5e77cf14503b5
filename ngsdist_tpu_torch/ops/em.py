"""Pairwise-EM sufficient statistics: plain PyTorch version and the CUDA
kernel (csrc/em.cu).

Port of ngsdist_tpu/ops/pallas_em.py.  The reference runs a 9-cell EM
per (pair, site) (emOptim2.cpp, tole 0.001, 50 iterations).  Its weight
matrix W = Pi ⊗ Pj is rank 1, so after k steps the joint weights are
∝ W^k and the convergence test on successive log-likelihoods becomes a
ratio test on per-individual power sums: with p = P / max(P) and
t_k = Σ_g p_g^k, the EM stops at the first step k in 1..49 where
rI_k·rJ_k < exp(0.001), r_k = t_{k+1}·t_{k−1}/t_k², so k* = k (50
when no step converges), and the lane contributes

    Σ_{g,h} score[g,h]·x_g·y_h / (Σx·Σy),   x = pi^{k*}, y = pj^{k*}.

Lanes with an all-zero row are dead and add nothing; under pairwise
deletion missing genotypes mask the lane; the site weight scales both
raw and cnt.  Both versions return [N, N] matrices whose strict upper
triangle is valid.  With `site_index` they run on the listed sites of P
only (the weights then belong to the list): the kernel reads the list
itself, and since it adds a lane's sites in list order, an ascending
list of every site of nonzero weight gives the bytes of the whole run
where both run one site slice.

Site slices: the kernel's grid is one block per upper 32x32 tile (EM_TILE)
times G site slices (em_slice_bounds), and the wrapper picks G from the
tile count, the site count, the card's SMs and the kernel's resident
blocks per SM (em_site_slices), so that a small N still fills the card:
21 tiles at N = 179 take G = 25 on an H100, 528 at N = 1024 G = 1.  With
G > 1 each block leaves its slice's float64 sums in a scratch buffer and
a second launch adds each lane's G sums in slice order: no atomics, so
reruns are byte-identical; G = 1 is the one-pass launch and its bytes.
Only the order of the float64 additions depends on G, within
em_table_bound's summation term (`em_raw_cnt_tables(slices=G)` is that
order in plain PyTorch); G follows the card, so on one card the bytes are
fixed by the shape, and a card of another SM count may group a large
input's sums otherwise.  SLICED_LAUNCHES counts the launches with
G > 1, SITE_SLICES adds up G over every full-mode launch.

Weight rows: site_weights [R', S] (a group of bootstrap replicates over
the same sites) give R' results [R', N, N] from one pass over the lanes.
A lane's stopping step, powers and contribution do not depend on the
weight, so the kernel's em_kernel_rows builds the tables, runs the search
and does the contraction once a lane and site, then adds w[r]·(contrib·m)
into each row's own float64 sum (and w[r]·m into its count under
pairwise deletion), in site order and at the G of the one-row launch,
each operation rounded as written in both kernels: row r holds the bytes
of the one-row launch with weights w[r].  A launch
takes EM_WEIGHT_ROWS rows, half as many under pairwise deletion
(em_weight_rows); the wrapper launches as many as R' needs, and one row
goes to the one-row kernel.  Without pairwise deletion the count, which
the engine then does not read, is not kept: cnt is None.  The plain
versions take the rows too, the lanes' terms computed once a chunk and
each row summed as a one-row call sums it.  ROW_LAUNCHES counts the
launches of more than one row, WEIGHT_ROWS adds up the rows of every
full-mode launch.

Tile list (`tiles=`, a pairs-axis shard of parallel/mesh.py; the
blocks= argument of the Pallas kernel): an int32 vector of upper 32x32
tile indices (k = tj (tj + 1) / 2 + ti).  Only those tiles are computed
and written, each with the bytes of the full launch at the same G, with
or without a site list (G follows the list's length); an empty list
launches nothing.

Block mode (`em_block_partials`, the partial-sum bootstrap) returns the
unweighted sums per bootstrap block instead, B (raw) and C (cnt)
[n_blocks, n_pairs] in float64, pairs a < b in triu row-major order.

A float64 tensor (--x64) goes to the float64 entries (K2d, the same
kernel instantiated for double: inputs and weights in float64, raw and
cnt written in float64), a float32 tensor to the float32 ones; the
tables, the search and the stopping decisions are the same.

The kernel takes r_k and the powers p^k from per-individual tables that
a tile's lanes share (csrc/em.cu): r_k by the plain version's own
expressions, so every lane stops at the plain version's step, and
x = p^{k*} by k* − 1 sequential multiplications where the plain version
takes exp(k*·ln p).  `em_raw_cnt_tables` / `em_block_partials_tables`
are that arithmetic in plain PyTorch (the tests hold them against the
plain versions on the CPU), and EM_TABLE_LANE_BOUND / `em_table_bound`
say how far the two may differ.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .indep import count_launch, valid_mask

EM_TOLE = 0.001
EM_MAX_ITER = 50

# How far a lane's contribution c = Σ score[g,h]·x_g·y_h / (Σx·Σy) by the
# power tables may lie from the plain version's, in units of max|score|,
# u = 2^-53.  c is an average of the scores with weights x_g/Σx · y_h/Σy,
# so relative errors of at most ε in every x_g and every y_h move it by
# at most 4ε·max|score|.  Tables: p^{k*} takes k* − 1 ≤ 49 multiplications,
# each within u, so ε = 49u and the share is 196u.  Plain version: ln and
# exp within 1 ulp (2u) each and the product k*·ln p within u give
# x_g·(k*|ln p_g| + 2)·2u absolute, at most (0.37 + 2·x_g)·2u since
# a·e^-a ≤ 0.37, against Σx ≥ 1: under 8u a side, 32u with the factor 2 of
# an average's weights.  The contraction and the division add under 14u
# in either version.  196 + 32 + 28 = 256.
EM_TABLE_LANE_BOUND = 256 * 2.0 ** -53   # 2^-45 ≈ 2.84e-14


def em_table_bound(n_sites: int) -> float:
    """Bound on |B_tables − B_plain| / (C · max|score|) for a float64 sum
    over n_sites sites: the lanes' bound and both versions' summation
    rounding (n_sites·u each, all terms within max|score|)."""
    return EM_TABLE_LANE_BOUND + 2 * n_sites * 2.0 ** -53


LAUNCHES = 0  # kernel launches since the count was last set to 0
BLOCK_LAUNCHES = 0  # the same, block mode
TILE_LAUNCHES = 0  # the same, with a tile list
SLICED_LAUNCHES = 0  # the same, full mode with more than one site slice
SITE_SLICES = 0  # site slices (G) added up over the full-mode launches
ROW_LAUNCHES = 0  # the same, full mode with more than one weight row
WEIGHT_ROWS = 0  # weight rows added up over the full-mode launches
LAUNCHES_F64 = 0  # the same seven of the float64 entries
BLOCK_LAUNCHES_F64 = 0
TILE_LAUNCHES_F64 = 0
SLICED_LAUNCHES_F64 = 0
SITE_SLICES_F64 = 0
ROW_LAUNCHES_F64 = 0
WEIGHT_ROWS_F64 = 0

EM_TILE = 32  # output tile edge of csrc/em.cu (kTile)
EM_STEP = 2  # sites a step of the kernel's loop (kSites)
EM_SLICE_MIN_SITES = 4096  # a site slice holds at least this many sites
EM_SLICE_MAX_WAVES = 16  # and a sliced launch at most this many waves of blocks
EM_WEIGHT_ROWS = 8  # float64 sums a lane keeps in em_kernel_rows (csrc/em.cu kWeightRows)


def em_weight_rows(pairwise_del: bool) -> int:
    """The weight rows one launch of em_kernel_rows takes: a sum a row, or
    two (raw and cnt) under pairwise deletion."""
    return EM_WEIGHT_ROWS // 2 if pairwise_del else EM_WEIGHT_ROWS


def _slice_cap(n_sites: int) -> int:
    """The most site slices n_sites sites allow (EM_SLICE_MIN_SITES a slice)."""
    return n_sites // EM_SLICE_MIN_SITES


def em_site_slices(n_tiles: int, n_sites: int, sms: int, per_sm: int) -> int:
    """G, the site slices of each tile in a full-mode launch of n_tiles
    tiles over n_sites sites (or list positions), on a card of `sms` SMs
    that holds `per_sm` of the kernel's blocks each: the g that needs the
    fewest waves of the card's sms x per_sm slots a slice, ceil(n_tiles g
    / slots) / g, the smaller g on a tie.  g = 1 is the one-pass launch;
    a g > 1 keeps EM_SLICE_MIN_SITES sites a slice and launches at most
    EM_SLICE_MAX_WAVES waves (its scratch, 16 KiB a block, 64 KiB with
    weight rows, at most 16 x slots of them)."""
    slots = sms * per_sm
    if n_tiles < 1 or slots < 1:
        return 1
    g_max = min(_slice_cap(n_sites), EM_SLICE_MAX_WAVES * slots // n_tiles)
    best, best_waves = 1, -(-n_tiles // slots)
    for g in range(2, g_max + 1):
        waves = -(-n_tiles * g // slots)
        if waves * best < best_waves * g:  # waves / g < best_waves / best
            best, best_waves = g, waves
    return best


def em_slice_bounds(n_sites: int, slices: int) -> list:
    """The G + 1 bounds of the kernel's site slices (csrc/em.cu
    site_slice): the ceil(n_sites / 2) steps split as evenly as whole
    steps allow, slice g the sites [bounds[g], bounds[g + 1])."""
    steps = -(-n_sites // EM_STEP)
    return [min(n_sites, EM_STEP * (g * steps // slices)) for g in range(slices + 1)]


def _lanes_per_chunk(device: torch.device) -> int:
    """(site, pair) lanes the plain version holds at once."""
    return 1 << 20 if device.type == "cpu" else 1 << 24


def _em_sites(Pc, score, I, J, pairwise_del, hi):
    """Converged EM contributions, masks and passed ratio tests (k* − 1)
    for every (site, pair) lane of one site chunk: Pc [sc, N, 3] ->
    (contrib, m, ksum) [sc, n_pairs]."""
    dtype = Pc.dtype
    mx = Pc.amax(-1)                                   # NaN-propagating
    dead = mx <= 0.0
    p = Pc / torch.where(dead, torch.ones_like(mx), mx)[..., None]
    lane_dead = dead[:, I] | dead[:, J]

    # Per-lane k*: walk k = 1..49 over the lanes still running only.
    # Per-individual power sums advance for all individuals (cheap);
    # the ratio test touches the active lanes, which shrink every step.
    ksum = torch.zeros(lane_dead.shape, dtype=dtype, device=Pc.device)
    ls, lp = torch.nonzero(~lane_dead, as_tuple=True)
    Ia, Ja = I[lp], J[lp]
    pk = p
    t_prev = torch.full_like(mx, 3.0)
    t_cur = p[..., 0] + p[..., 1] + p[..., 2]
    for _ in range(EM_MAX_ITER - 1):
        if ls.numel() == 0:
            break
        pk = pk * p
        t_next = pk[..., 0] + pk[..., 1] + pk[..., 2]
        r = t_next * t_prev / (t_cur * t_cur)          # [sc, N]
        keep = (r[ls, Ia] * r[ls, Ja]) >= hi           # NaN stops
        ls, lp, Ia, Ja = ls[keep], lp[keep], Ia[keep], Ja[keep]
        ksum[ls, lp] += 1.0
        t_prev, t_cur = t_cur, t_next
    kstar = (1.0 + ksum)[..., None]

    # x_g = exp(k*·ln pi_g); ln 0 = -inf gives 0, the converged value.
    lnp = torch.log(p)
    x = torch.exp(kstar * lnp[:, I, :])                # [sc, n_pairs, 3]
    y = torch.exp(kstar * lnp[:, J, :])
    num = torch.zeros_like(ksum)
    for g in range(3):
        z = score[g, 0] * y[..., 0] + score[g, 1] * y[..., 1] + score[g, 2] * y[..., 2]
        num = num + x[..., g] * z
    Sf = (x[..., 0] + x[..., 1] + x[..., 2]) * (y[..., 0] + y[..., 1] + y[..., 2])
    contrib = torch.where(lane_dead, torch.zeros_like(num), num / Sf)

    m = (~lane_dead).to(dtype)
    if pairwise_del:
        v = valid_mask(Pc, True)
        m = m * v[:, I] * v[:, J]
    return contrib, m, ksum


def _em_sites_tables(Pc, score, I, J, pairwise_del, hi):
    """_em_sites in the kernel's arithmetic: per-individual tables of r_k
    and of p^k by sequential multiplication, the lanes looking both up."""
    dtype = Pc.dtype
    mx = Pc.amax(-1)                                   # NaN-propagating
    dead = mx <= 0.0
    p = Pc / torch.where(dead, torch.ones_like(mx), mx)[..., None]
    lane_dead = dead[:, I] | dead[:, J]

    powers, ratios = [p], []                           # p^(k+1), r at step k
    t_prev = torch.full_like(mx, 3.0)
    t_cur = p[..., 0] + p[..., 1] + p[..., 2]
    for _ in range(EM_MAX_ITER - 1):
        pk = powers[-1] * p
        t_next = pk[..., 0] + pk[..., 1] + pk[..., 2]
        ratios.append(t_next * t_prev / (t_cur * t_cur))
        powers.append(pk)
        t_prev, t_cur = t_cur, t_next
    powers = torch.stack(powers)                       # [50, sc, N, 3]

    ksum = torch.zeros(lane_dead.shape, dtype=torch.long, device=Pc.device)
    ls, lp = torch.nonzero(~lane_dead, as_tuple=True)
    Ia, Ja = I[lp], J[lp]
    for r in ratios:
        if ls.numel() == 0:
            break
        keep = (r[ls, Ia] * r[ls, Ja]) >= hi           # NaN stops
        ls, lp, Ia, Ja = ls[keep], lp[keep], Ia[keep], Ja[keep]
        ksum[ls, lp] += 1

    sites = torch.arange(Pc.shape[0], device=Pc.device)[:, None]
    x = powers[ksum, sites, I[None, :]]                # p^(k*), [sc, n_pairs, 3]
    y = powers[ksum, sites, J[None, :]]
    num = torch.zeros(lane_dead.shape, dtype=dtype, device=Pc.device)
    for g in range(3):
        z = score[g, 0] * y[..., 0] + score[g, 1] * y[..., 1] + score[g, 2] * y[..., 2]
        num = num + x[..., g] * z
    Sf = (x[..., 0] + x[..., 1] + x[..., 2]) * (y[..., 0] + y[..., 1] + y[..., 2])
    contrib = torch.where(lane_dead, torch.zeros_like(num), num / Sf)

    m = (~lane_dead).to(dtype)
    if pairwise_del:
        v = valid_mask(Pc, True)
        m = m * v[:, I] * v[:, J]
    return contrib, m, ksum


def _raw_cnt(sites_fn, P, score9, pairwise_del, site_weights):
    """(raw, cnt) [N, N], or [R', N, N] for weight rows [R', S]: each
    chunk's lanes once, each row's sums as a one-row call adds them."""
    S, N, _ = P.shape
    dtype, dev = P.dtype, P.device
    score = torch.as_tensor(score9, dtype=dtype, device=dev).reshape(3, 3)
    w = (torch.ones(S, dtype=dtype, device=dev) if site_weights is None
         else torch.as_tensor(site_weights, dtype=dtype, device=dev))
    rows = w.reshape(-1, S)
    hi = torch.tensor(np.exp(EM_TOLE), dtype=dtype, device=dev)
    I, J = torch.triu_indices(N, N, offset=1, device=dev)
    raw_v = torch.zeros((rows.shape[0], I.numel()), dtype=dtype, device=dev)
    cnt_v = torch.zeros_like(raw_v)
    chunk = max(1, _lanes_per_chunk(dev) // max(1, I.numel()))
    for s0 in range(0, S, chunk):
        contrib, m, _ = sites_fn(P[s0:s0 + chunk], score, I, J, pairwise_del, hi)
        for r in range(rows.shape[0]):
            wc = rows[r, s0:s0 + chunk, None]
            raw_v[r] += (wc * (contrib * m)).sum(0)
            cnt_v[r] += (wc * m).sum(0)
    raw = torch.zeros((rows.shape[0], N, N), dtype=dtype, device=dev)
    cnt = torch.zeros_like(raw)
    raw[:, I, J] = raw_v
    cnt[:, I, J] = cnt_v
    return (raw, cnt) if w.ndim == 2 else (raw[0], cnt[0])


def _block_partials(sites_fn, P, score9, pairwise_del, n_blocks, block_size):
    _build.check_blocks(P, n_blocks, block_size)
    S, N, _ = P.shape
    dtype, dev = P.dtype, P.device
    score = torch.as_tensor(score9, dtype=dtype, device=dev).reshape(3, 3)
    hi = torch.tensor(np.exp(EM_TOLE), dtype=dtype, device=dev)
    I, J = torch.triu_indices(N, N, offset=1, device=dev)
    B = torch.zeros((n_blocks, I.numel()), dtype=dtype, device=dev)
    C = torch.zeros_like(B)
    chunk = max(1, _lanes_per_chunk(dev) // max(1, I.numel()))
    for s0 in range(0, S, chunk):
        contrib, m, _ = sites_fn(P[s0:s0 + chunk], score, I, J, pairwise_del, hi)
        blk = torch.arange(s0, s0 + m.shape[0], device=dev) // block_size
        B.index_add_(0, blk, contrib * m)
        C.index_add_(0, blk, m)
    return B, C


def em_raw_cnt_ref(P: torch.Tensor, score9, pairwise_del: bool,
                   site_weights=None, site_index=None, tiles=None):
    """Plain PyTorch version: P [S, N, 3] -> (raw, cnt) [N, N], strict
    upper triangle valid; weight rows [R', S] give [R', N, N] each, row r
    the call with weights [r].  Vectorised over (site, pair) lanes in site
    chunks; converged lanes leave the iteration.  site_index [n] int64:
    the sites of P to run on; the weights are then [n] or [R', n].  tiles: the full
    result with every entry outside the listed upper tiles set to zero,
    as the kernel leaves them."""
    if site_index is not None:
        P = P.index_select(0, site_index)
    raw, cnt = _raw_cnt(_em_sites, P, score9, pairwise_del, site_weights)
    if tiles is not None:
        keep = _build.tile_mask(P.shape[1], tiles, EM_TILE, strict=True).to(P.device)
        raw = torch.where(keep, raw, torch.zeros_like(raw))
        cnt = torch.where(keep, cnt, torch.zeros_like(cnt))
    return raw, cnt


def em_block_partials_ref(P: torch.Tensor, score9, pairwise_del: bool,
                          n_blocks: int, block_size: int):
    """Plain version of the block mode: P [n_blocks · block_size, N, 3]
    -> (B, C) [n_blocks, n_pairs], B[b, p] = Σ_{s∈b} contrib·m and
    C[b, p] = Σ_{s∈b} m (the want_blocks output of
    ngsdist_tpu.core.distance._em_scan, with dead lanes left out of C as
    in em_raw_cnt_ref).  The sites run in chunks as in em_raw_cnt_ref;
    each chunk's lanes are added into their blocks."""
    return _block_partials(_em_sites, P, score9, pairwise_del, n_blocks, block_size)


def em_raw_cnt_tables(P: torch.Tensor, score9, pairwise_del: bool,
                      site_weights=None, slices: int = 1):
    """em_raw_cnt_ref in the kernel's arithmetic (_em_sites_tables).
    slices: the kernel's order at G site slices (em_slice_bounds): each
    slice summed on its own, then the slices' sums added in slice order.
    Weight rows [R', S] as em_raw_cnt_ref's."""
    bounds = em_slice_bounds(P.shape[0], slices)
    raw = cnt = None
    for b, e in zip(bounds[:-1], bounds[1:]):
        w = None if site_weights is None else torch.as_tensor(site_weights)[..., b:e]
        r, c = _raw_cnt(_em_sites_tables, P[b:e], score9, pairwise_del, w)
        raw, cnt = (r, c) if raw is None else (raw + r, cnt + c)
    return raw, cnt


def em_block_partials_tables(P: torch.Tensor, score9, pairwise_del: bool,
                             n_blocks: int, block_size: int):
    """em_block_partials_ref in the kernel's arithmetic."""
    return _block_partials(_em_sites_tables, P, score9, pairwise_del, n_blocks,
                           block_size)


def em_work(P: torch.Tensor) -> dict:
    """What the EM of P [S, N, 3] needs, counted from the data: live
    (site, individual) rows, live (site, pair) lanes and the ratio tests
    those lanes make until they stop."""
    work = {"live_rows": int((~(P.amax(-1) <= 0.0)).sum()), "live_lanes": 0, "tests": 0}

    def count(*args):
        contrib, m, ksum = _em_sites_tables(*args)
        live = m > 0                       # no pairwise deletion: m is the live flag
        work["live_lanes"] += int(live.sum())
        work["tests"] += int((ksum[live] + 1).clamp(max=EM_MAX_ITER - 1).sum())
        return contrib, m, ksum

    _raw_cnt(count, P, np.zeros(9), False, None)
    return work


def em_block_partials(P: torch.Tensor, score9, pairwise_del: bool,
                      n_blocks: int, block_size: int):
    """(B, C) [n_blocks, n_pairs] float64: the CUDA kernel's block mode
    for a CUDA tensor, the plain version for a CPU tensor."""
    if P.device.type == "cpu":
        return em_block_partials_ref(P, score9, pairwise_del, n_blocks, block_size)
    return _em_blocks_cuda(P, score9, pairwise_del, n_blocks, block_size)


def em_raw_cnt(P: torch.Tensor, score9, pairwise_del: bool,
               site_weights=None, site_index=None, tiles=None):
    """(raw, cnt) [N, N]: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor.  site_index [n] int64 on P's device: the
    sites of P to run on, in this order; the weights are then [n].
    tiles: int32 upper-tile indices on P's device, the only tiles
    computed (module docstring).  site_weights [R', S], weight rows over
    every site and tile: raw [R', N, N], and cnt [R', N, N] under
    pairwise deletion, else None (module docstring)."""
    if site_weights is not None and torch.as_tensor(site_weights).ndim == 2:
        if site_index is not None or tiles is not None:
            raise ValueError("weight rows run over every site and every tile")
        if P.device.type == "cpu":
            raw, cnt = em_raw_cnt_ref(P, score9, pairwise_del, site_weights)
        else:
            raw, cnt = _em_rows_cuda(P, score9, pairwise_del, site_weights)
        return raw, (cnt if pairwise_del else None)
    if P.device.type == "cpu":
        return em_raw_cnt_ref(P, score9, pairwise_del, site_weights, site_index, tiles)
    return _em_cuda(P, score9, pairwise_del, site_weights, site_index, tiles)


_SLOTS = {}  # (device index, dtype) -> (SMs, resident blocks per SM)


def _card_slots(P):
    """The current card's SM count and the full-mode kernel's resident
    blocks per SM for P's dtype (the kernel's occupancy query), once a
    card and dtype."""
    key = (torch.cuda.current_device(), P.dtype)
    if key not in _SLOTS:
        per_sm = ctypes.c_int(0)
        _build.check_launch(_build.entry("em_blocks_per_sm", P)(ctypes.byref(per_sm)),
                            "em occupancy")
        sms = torch.cuda.get_device_properties(key[0]).multi_processor_count
        _SLOTS[key] = (sms, per_sm.value)
    return _SLOTS[key]


def _em_cuda(P, score9, pairwise_del, site_weights, site_index, tiles, slices=None):
    """The kernel's launch; slices: G in place of em_site_slices' (tests)."""
    _build.check_probs(P)
    S, N, _ = P.shape
    if site_index is not None:
        if (site_index.device != P.device or site_index.dtype != torch.int64
                or site_index.ndim != 1 or not site_index.is_contiguous()):
            raise ValueError("site_index must be a contiguous int64 vector on P's device")
        S = site_index.shape[0]
    w = _build.weights_of(site_weights, P, S)
    raw = torch.zeros((N, N), dtype=P.dtype, device=P.device)
    cnt = torch.zeros_like(raw)
    if tiles is not None:
        _build.check_tiles(tiles, P)
        if tiles.numel() == 0:
            return raw, cnt
    hi = float(np.exp(EM_TOLE))  # the kernel's ratio test runs in float64
    nt = -(-N // EM_TILE)
    n_tiles = nt * (nt + 1) // 2 if tiles is None else tiles.numel()
    with torch.cuda.device(P.device):
        if slices is None:  # the card is asked only where the sites allow two slices
            slices = 1 if _slice_cap(S) < 2 else em_site_slices(n_tiles, S, *_card_slots(P))
        part = None
        if slices > 1:
            part = torch.empty((slices, n_tiles, 2, EM_TILE * EM_TILE), dtype=torch.float64,
                               device=P.device)
        rc = _build.entry("em_raw_cnt", P)(
            _build.ptr(P), _build.ptr(w), _build.ptr(site_index), _build.ptr(tiles),
            0 if tiles is None else n_tiles, _build.ptr(raw), _build.ptr(cnt), S, N,
            _build.score9(score9, P), hi, int(pairwise_del), slices, _build.ptr(part),
            _build.stream(P.device))
    _build.check_launch(rc, "em")
    _count_full(P, "" if tiles is None else "TILE_", slices, 1)
    return raw, cnt


def _count_full(P, mode, slices, rows):
    """The counters of one full-mode launch of G = slices and `rows`
    weight rows."""
    f64 = "_F64" if P.dtype == torch.float64 else ""
    count_launch(globals(), P, mode)
    if slices > 1:
        count_launch(globals(), P, "SLICED_")
    if rows > 1:
        count_launch(globals(), P, "ROW_")
    globals()["SITE_SLICES" + f64] += slices
    globals()["WEIGHT_ROWS" + f64] += rows


def _em_rows_cuda(P, score9, pairwise_del, site_weights, slices=None):
    """Weight rows [R', S] on the card: em_kernel_rows over groups of
    em_weight_rows rows, a single row through _em_cuda; slices: G in
    place of em_site_slices' (tests).  (raw, cnt) [R', N, N], cnt
    written under pairwise deletion only."""
    _build.check_probs(P)
    S, N, _ = P.shape
    W = torch.as_tensor(site_weights, dtype=P.dtype, device=P.device).contiguous()
    if W.ndim != 2 or W.shape[1] != S or W.shape[0] < 1:
        raise ValueError(f"weight rows must have shape (R', {S}), got {tuple(W.shape)}")
    raw = torch.zeros((W.shape[0], N, N), dtype=P.dtype, device=P.device)
    cnt = torch.zeros_like(raw) if pairwise_del else None
    slots = _build.library().ngsd_em_weight_rows()
    if slots != EM_WEIGHT_ROWS:
        raise RuntimeError(f"the EM kernel keeps {slots} sums a lane, ops/em.py reckons "
                           f"with {EM_WEIGHT_ROWS}")
    step = em_weight_rows(pairwise_del)
    hi = float(np.exp(EM_TOLE))
    nt = -(-N // EM_TILE)
    n_tiles = nt * (nt + 1) // 2
    with torch.cuda.device(P.device):
        if slices is None:  # the one-row launch's G
            slices = 1 if _slice_cap(S) < 2 else em_site_slices(n_tiles, S, *_card_slots(P))
        part = None
        if slices > 1 and W.shape[0] > 1:
            part = torch.empty((slices, n_tiles, EM_WEIGHT_ROWS, EM_TILE * EM_TILE),
                               dtype=torch.float64, device=P.device)
        for r0 in range(0, W.shape[0], step):
            r1 = min(r0 + step, W.shape[0])
            if r1 - r0 == 1:
                got = _em_cuda(P, score9, pairwise_del, W[r0], None, None, slices=slices)
                raw[r0] = got[0]
                if cnt is not None:
                    cnt[r0] = got[1]
                continue
            rc = _build.entry("em_raw_cnt_rows", P)(
                _build.ptr(P), _build.ptr(W[r0:r1]), r1 - r0, _build.ptr(raw[r0:r1]),
                _build.ptr(None if cnt is None else cnt[r0:r1]), S, N,
                _build.score9(score9, P), hi, int(pairwise_del), slices, _build.ptr(part),
                _build.stream(P.device))
            _build.check_launch(rc, "em rows")
            _count_full(P, "", slices, r1 - r0)
    return raw, cnt


def _em_blocks_cuda(P, score9, pairwise_del, n_blocks, block_size):
    _build.check_probs(P)
    _build.check_blocks(P, n_blocks, block_size)
    N = P.shape[1]
    B = torch.empty((n_blocks, N * (N - 1) // 2), dtype=torch.float64, device=P.device)
    C = torch.empty_like(B)
    if B.numel() > 0:
        fn = _build.entry("em_block_partials", P)
        with torch.cuda.device(P.device):
            rc = fn(_build.ptr(P), _build.ptr(B), _build.ptr(C), N, n_blocks, block_size,
                    _build.score9(score9, P), float(np.exp(EM_TOLE)), int(pairwise_del),
                    _build.stream(P.device))
        _build.check_launch(rc, "em block partials")
        count_launch(globals(), P, "BLOCK_")
    return B, C
