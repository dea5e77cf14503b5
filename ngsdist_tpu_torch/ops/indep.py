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
"""

from __future__ import annotations

import torch

from . import _build

EPSILON = 1e-5  # miss_data tolerance (gen_func.hpp:16)

LAUNCHES = 0  # kernel launches since the count was last set to 0

TILE = 64               # output tile edge of csrc/indep.cu (kTile)
STEP = 8                # sites per pipeline step (kSites)
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
                      site_weights=None):
    """Plain PyTorch version: P [S, N, 3] -> (raw, cnt) [N, N].  Masks
    multiply, so NaN rows propagate into raw exactly as in the kernel."""
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
    return raw, cnt


def indep_raw_cnt(P: torch.Tensor, score, pairwise_del: bool,
                  site_weights=None):
    """(raw, cnt) [N, N]: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if P.device.type == "cpu":
        return indep_raw_cnt_ref(P, score, pairwise_del, site_weights)
    return _indep_cuda(P, score, pairwise_del, site_weights)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def upper_tiles(N: int) -> int:
    """Upper-triangular TILE x TILE output tiles, diagonal tiles included."""
    nt = _ceil_div(N, TILE)
    return nt * (nt + 1) // 2


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


def scratch_shape(N: int, S: int):
    """Shape of the kernel's float64 chunk partials (raw and cnt), or None
    when the sites make one chunk and the kernel writes raw, cnt itself."""
    chunks, _ = split_plan(N, S)
    return (2, chunks, upper_tiles(N), TILE, TILE) if chunks > 1 else None


def _indep_cuda(P, score, pairwise_del, site_weights):
    global LAUNCHES
    _build.check_probs(P)
    S, N, _ = P.shape
    w = _build.site_weights_f32(site_weights, P)
    raw = torch.zeros((N, N), dtype=P.dtype, device=P.device)
    cnt = torch.zeros_like(raw)
    chunks, chunk_sites = split_plan(N, S)
    shape = scratch_shape(N, S)
    scratch = None if shape is None else torch.empty(shape, dtype=torch.float64,
                                                     device=P.device)
    lib = _build.library()
    with torch.cuda.device(P.device):
        rc = lib.ngsd_indep_raw_cnt_f32(
            _build.ptr(P), _build.ptr(w), _build.ptr(raw), _build.ptr(cnt),
            _build.ptr(scratch), S, N, chunks, chunk_sites,
            _build.score9_f32(score), int(pairwise_del),
            _build.stream(P.device))
    _build.check_launch(rc, "indep")
    LAUNCHES += 1
    return raw, cnt
