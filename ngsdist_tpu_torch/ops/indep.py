"""Independent-genotypes sufficient statistics: plain PyTorch version and
the CUDA kernel (csrc/indep.cu).

Port of ngsdist_tpu/ops/pallas_indep.py.  Per site s and individuals
a, b, with v[s,a] the validity (row nonzero, and under pairwise deletion
also not missing) and w[s] the site weight:

    raw[a,b] = sum_{s,g} P[s,a,g]·v[s,a]·w[s] · sum_h score[g,h]·P[s,b,h]·v[s,b]
    cnt[a,b] = sum_s v[s,a]·w[s] · v[s,b]

The weight scales the i side only.  Both return [N, N] matrices whose
upper triangle, diagonal included, is valid; the kernel leaves the
strict lower triangle zero.

The kernel splits the sites into chunks (`split_plan`, a function of N
and S only), sums each chunk's upper 64x64 output tiles on the tensor
cores and adds the chunks' float64 partials in index order, so reruns
are byte-identical.

Tile list (`tiles=`, a pairs-axis shard of parallel/mesh.py; the
panels= argument of the Pallas kernel): an int32 vector of upper 64x64
tile indices (k = tj (tj + 1) / 2 + ti).  Only those tiles are computed
and written; the rest of raw and cnt stay zero.  A listed tile holds the
bytes of the full launch, and an empty list launches nothing.

Block mode (`indep_block_partials`, the partial-sum bootstrap) runs the
same kernel with one chunk per bootstrap block, unweighted, and returns
the chunks' float64 partials themselves, per block and pair.

A float64 tensor (--x64) goes to the float64 entries (K1d, csrc/indep.cu
indep_f64_kernel): the same split, tile lists and block mode, every sum
in float64, raw and cnt returned in float64; a float32 tensor to the
float32 ones.  K1d runs on Hopper's FP64 tensor cores in the sm_90 shape
mma.sync m16n8k8 .f64 (the full FP64 tensor rate; m8n8k4, the only
shape before sm_90, issues at half of it): a step of STEP_F64 = 8 sites
is one k8 depth per genotype plane and one for cnt.  Raw rows are staged
two steps ahead by cp.async; the fold runs once per block into operand
planes in shared memory, between the previous step's MMAs.  What bounds
it is the FP64 tensor cores and, beside them, the fold's float64
arithmetic (which does not overlap FP64 MMAs) and shared-memory traffic
(csrc/indep.cu, PERF.md).  `indep_raw_cnt_f64_order` is the float64
kernel's order of summation in plain PyTorch, for the tests.
"""

from __future__ import annotations

import torch

from . import _build

EPSILON = 1e-5  # miss_data tolerance (gen_func.hpp:16)

LAUNCHES = 0  # kernel launches since the count was last set to 0
BLOCK_LAUNCHES = 0  # the same, block mode
TILE_LAUNCHES = 0  # the same, with a tile list
LAUNCHES_F64 = 0  # the same three of the float64 entries
BLOCK_LAUNCHES_F64 = 0
TILE_LAUNCHES_F64 = 0

TILE = 64               # output tile edge of csrc/indep.cu (kTile)
STEP = 8                # sites per pipeline step (kSites)
STEP_F64 = 8            # sites per step (one MMA depth) of the float64 kernel (kDSites)
WINDOW = 16             # sites per float32 raw window (kWindow)
TARGET_BLOCKS = 2048    # tiles x chunks to aim for: many waves on any card
MIN_CHUNK_SITES = 1024  # no chunk is split below this
MAX_CHUNK_SITES = 1 << 16  # keeps a chunk's counts (float32) below 2^24


def valid_mask(P: torch.Tensor, pairwise_del: bool) -> torch.Tensor:
    """[S, N] validity in P's dtype: the row is nonzero and, under
    pairwise deletion, not missing.  NaN rows are invalid."""
    P0, P1, P2 = P.unbind(-1)
    v = (P0 + P1 + P2) > 0.0
    if pairwise_del:
        v = v & (((P0 - P1).abs() >= EPSILON) | ((P1 - P2).abs() >= EPSILON))
    return v.to(P.dtype)


def indep_raw_cnt_ref(P: torch.Tensor, score, pairwise_del: bool,
                      site_weights=None, tiles=None):
    """Plain PyTorch version: P [S, N, 3] -> (raw, cnt) [N, N].  Masks
    multiply, so NaN rows propagate into raw exactly as in the kernel.
    tiles: the full result with every entry outside the listed upper
    tiles' upper triangle set to zero, as the kernel leaves them."""
    dtype = P.dtype
    score = torch.as_tensor(score, dtype=dtype, device=P.device).reshape(3, 3)
    v = valid_mask(P, pairwise_del)
    vi = v if site_weights is None else v * torch.as_tensor(
        site_weights, dtype=dtype, device=P.device)[:, None]
    Q = P * v[..., None]
    Qi = P * vi[..., None]
    Y = Q @ score.T                      # Y[s,b,g] = sum_h score[g,h]·Q[s,b,h]
    raw = torch.einsum("sag,sbg->ab", Qi, Y)
    cnt = vi.T @ v
    if tiles is not None:
        keep = _build.tile_mask(P.shape[1], tiles, TILE, strict=False).to(P.device)
        raw = torch.where(keep, raw, torch.zeros_like(raw))
        cnt = torch.where(keep, cnt, torch.zeros_like(cnt))
    return raw, cnt


def indep_block_partials_ref(P: torch.Tensor, score, pairwise_del: bool,
                             n_blocks: int, block_size: int):
    """Plain version of the partial-sum bootstrap's per-block sums
    (ngsdist_tpu.core.distance.indep_block_partials): P [n_blocks ·
    block_size, N, 3] -> (B, C) [n_blocks, N, N], unweighted, C None
    without pairwise deletion.  Masks multiply, as in indep_raw_cnt_ref."""
    _build.check_blocks(P, n_blocks, block_size)
    N = P.shape[1]
    score = torch.as_tensor(score, dtype=P.dtype, device=P.device).reshape(3, 3)
    v = valid_mask(P, pairwise_del).reshape(n_blocks, block_size, N)
    Q = P.reshape(n_blocks, block_size, N, 3) * v[..., None]
    B = torch.einsum("ksag,ksbg->kab", Q, Q @ score.T)
    C = v.transpose(1, 2) @ v if pairwise_del else None
    return B, C


def indep_raw_cnt(P: torch.Tensor, score, pairwise_del: bool,
                  site_weights=None, tiles=None):
    """(raw, cnt) [N, N]: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor.  tiles: int32 upper-tile indices on P's
    device, the only tiles computed (module docstring)."""
    if P.device.type == "cpu":
        return indep_raw_cnt_ref(P, score, pairwise_del, site_weights, tiles)
    return _indep_cuda(P, score, pairwise_del, site_weights, tiles)


def indep_block_partials(P: torch.Tensor, score, pairwise_del: bool,
                         n_blocks: int, block_size: int):
    """(B, C) [n_blocks, n_pairs] float64 per-block sums for the pairs
    a < b in triu row-major order, C None without pairwise deletion:
    the CUDA kernel's block mode for a CUDA tensor, the plain version for
    a CPU tensor."""
    if P.device.type == "cpu":
        B, C = indep_block_partials_ref(P, score, pairwise_del, n_blocks, block_size)
        I, J = torch.triu_indices(P.shape[1], P.shape[1], offset=1)
        return B[:, I, J], None if C is None else C[:, I, J]
    return _indep_blocks_cuda(P, score, pairwise_del, n_blocks, block_size)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def upper_tiles(N: int) -> int:
    """Upper-triangular TILE x TILE output tiles, diagonal tiles included."""
    nt = _ceil_div(N, TILE)
    return nt * (nt + 1) // 2


def tile_offsets(N: int, I: torch.Tensor, J: torch.Tensor) -> torch.Tensor:
    """Offset of each pair (I[p], J[p]), I <= J, in the kernel's partials
    laid out as [upper tile, row, column] (tile k holds the rows of tile
    row ti and the columns of tile column tj, k = tj (tj + 1) / 2 + ti)."""
    ti, tj = I // TILE, J // TILE
    return ((tj * (tj + 1) // 2 + ti) * TILE + I % TILE) * TILE + J % TILE


def split_plan(N: int, S: int):
    """(chunks, chunk_sites): the kernel's split of S sites into chunks of
    chunk_sites (a multiple of WINDOW; the last chunk is ragged, none
    is empty).  A function of (N, S) only, never of the card, so the
    order of every sum is fixed by the shape."""
    want = min(_ceil_div(TARGET_BLOCKS, upper_tiles(N)),
               _ceil_div(S, MIN_CHUNK_SITES))
    want = max(1, want, _ceil_div(S, MAX_CHUNK_SITES))
    chunk_sites = WINDOW * max(1, _ceil_div(_ceil_div(S, want), WINDOW))
    return max(1, _ceil_div(S, chunk_sites)), chunk_sites


def block_partials_shape(N: int, n_blocks: int):
    """Shape of the block mode's float64 partials (raw and cnt)."""
    return (2, n_blocks, upper_tiles(N), TILE, TILE)


def scratch_shape(N: int, S: int):
    """Shape of the kernel's float64 chunk partials (raw and cnt), or None
    when the sites make one chunk and the kernel writes raw, cnt itself."""
    chunks, _ = split_plan(N, S)
    return (2, chunks, upper_tiles(N), TILE, TILE) if chunks > 1 else None


def f64_sum_bound(n_sites: int, chunks: int = 1) -> float:
    """Bound on |raw_kernel - raw_plain| / sum|terms| of the float64
    entries against the plain version (or any other float64 order), u =
    2^-53.  Each version folds the score in 3 products (within 3u) and
    adds the 3 n_sites products of a pair in some order, the float64
    kernel in its sites' order and then its chunks' (n_sites + chunks + 2
    additions at most); a sum of m terms lies within (m - 1) u of the
    exact one times the sum of the terms' magnitudes.  Both versions:
    2 (3 + 3 n_sites + chunks + 2) u.  All terms are >= 0 with a
    nonnegative score, and the bound is then relative to raw itself.
    The kernel's m16n8k8 MMA adds 8 products into an accumulator with at
    most one rounding a product, whatever order it takes inside the
    instruction, so each product still costs at most one rounding and the
    count above holds for it."""
    return 2 * (3 * n_sites + chunks + 5) * 2.0 ** -53


def indep_raw_cnt_f64_order(P: torch.Tensor, score, pairwise_del: bool,
                            site_weights=None, block_size=None):
    """The float64 kernel's order of summation in plain PyTorch (float64
    P [S, N, 3] -> (raw, cnt) [N, N], the full matrices): per chunk of
    split_plan, per step of STEP_F64 sites from the chunk's start (the
    last one ragged), the three genotypes' products (each one m16n8k8
    depth) added one after another into the running sums; the chunks then
    added in index order.  block_size: the block mode's order instead,
    each block of block_size sites a chunk of its own, and its sums
    returned per block ([S / block_size, N, N] each).  For the tests: a
    plain loop over the sites."""
    S, N = P.shape[:2]
    dtype = P.dtype
    score = torch.as_tensor(score, dtype=dtype, device=P.device).reshape(3, 3)
    v = valid_mask(P, pairwise_del)
    vi = v if site_weights is None else v * torch.as_tensor(
        site_weights, dtype=dtype, device=P.device)[:, None]
    Qi = P * vi[..., None]
    Y = (P * v[..., None]) @ score.T
    if block_size is None:
        chunks, chunk_sites = split_plan(N, S)
    else:
        _build.check_blocks(P, S // block_size, block_size)
        chunks, chunk_sites = S // block_size, block_size
    parts = []
    for c in range(chunks):
        r = torch.zeros((N, N), dtype=dtype, device=P.device)
        k = torch.zeros_like(r)
        end = min((c + 1) * chunk_sites, S)
        for s0 in range(c * chunk_sites, end, STEP_F64):
            s1 = min(s0 + STEP_F64, end)
            for g in range(3):
                r = r + Qi[s0:s1, :, g].T @ Y[s0:s1, :, g]
            k = k + vi[s0:s1].T @ v[s0:s1]
        parts.append((r, k))
    if block_size is not None:
        return tuple(torch.stack(x) for x in zip(*parts))
    raw = torch.zeros((N, N), dtype=dtype, device=P.device)
    cnt = torch.zeros_like(raw)
    for r, k in parts:
        raw, cnt = raw + r, cnt + k
    return raw, cnt


def count_launch(counts: dict, P: torch.Tensor, mode: str = "") -> None:
    """Add one to the launch count, in a module's globals `counts`, of the
    entry P's dtype took in mode "" (full), "BLOCK_" or "TILE_"."""
    counts[f"{mode}LAUNCHES{'_F64' if P.dtype == torch.float64 else ''}"] += 1


def _indep_cuda(P, score, pairwise_del, site_weights, tiles):
    _build.check_probs(P)
    S, N, _ = P.shape
    w = _build.weights_of(site_weights, P)
    raw = torch.zeros((N, N), dtype=P.dtype, device=P.device)
    cnt = torch.zeros_like(raw)
    if tiles is not None:
        _build.check_tiles(tiles, P)
        if tiles.numel() == 0:
            return raw, cnt
    chunks, chunk_sites = split_plan(N, S)
    shape = scratch_shape(N, S)
    scratch = None if shape is None else torch.empty(shape, dtype=torch.float64,
                                                     device=P.device)
    fn = _build.entry("indep_raw_cnt", P)
    with torch.cuda.device(P.device):
        rc = fn(_build.ptr(P), _build.ptr(w), _build.ptr(raw), _build.ptr(cnt),
                _build.ptr(scratch), _build.ptr(tiles), 0 if tiles is None else tiles.numel(),
                S, N, chunks, chunk_sites, _build.score9(score, P), int(pairwise_del),
                _build.stream(P.device))
    _build.check_launch(rc, "indep")
    count_launch(globals(), P, "" if tiles is None else "TILE_")
    return raw, cnt


def _indep_blocks_cuda(P, score, pairwise_del, n_blocks, block_size):
    _build.check_probs(P)
    _build.check_blocks(P, n_blocks, block_size)
    N = P.shape[1]
    part = torch.empty(block_partials_shape(N, n_blocks), dtype=torch.float64,
                       device=P.device)
    if n_blocks > 0:
        fn = _build.entry("indep_block_partials", P)
        with torch.cuda.device(P.device):
            rc = fn(_build.ptr(P), _build.ptr(part), N, n_blocks, block_size,
                    _build.score9(score, P), int(pairwise_del), _build.stream(P.device))
        _build.check_launch(rc, "indep block partials")
        count_launch(globals(), P, "BLOCK_")
    I, J = torch.triu_indices(N, N, offset=1, device=P.device)
    planes = 2 if pairwise_del else 1  # cnt is read under pairwise deletion only
    out = part[:planes].reshape(planes, n_blocks, -1)[:, :, tile_offsets(N, I, J)]
    return out[0], out[1] if pairwise_del else None
