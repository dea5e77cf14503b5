"""Single-device distance engine (PyTorch).

Port of the resident single-device path of ngsdist_tpu/core/distance.py:
the probability tensor [S, N, 3] is moved to the device once, and the
full-data matrix is one call of the independent-genotypes kernel
(ops/indep.py) or the pairwise-EM kernel (ops/em.py), chosen by
`pars.indep_geno`.  Bootstrap replicates take one of the JAX engine's
two routes over the resident tensor, by its rule (`use_partials`):

- partial sums: one block-mode kernel call gives every bootstrap
  block's sums, and replicate r is M[r] @ B, M the block multiplicities
  of the reference's taus stream (ngsDist.cpp:416-437);
- weighted recompute: one kernel call per replicate, its per-site
  multiplicities passed as the kernel's site weights.

Dtype policy: float64 on the CPU, float32 on CUDA.  On the CPU the
kernels' plain versions run; on CUDA the hand-written kernels do.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np
import torch

from ..config import NgsDistError, Params
from ..ops.em import em_block_partials, em_raw_cnt
from ..ops.indep import (block_partials_shape, indep_block_partials,
                         indep_raw_cnt, scratch_shape)
from . import bootstrap as bt
from . import models

# The partial-sum route is taken when the block partials, reckoned in the
# device's dtype, fit here: the value of
# ngsdist_tpu.core.distance.PARTIALS_BUDGET_BYTES, so that both engines
# take the same route at the same shape.
PARTIALS_BUDGET_BYTES = 1 << 30


def default_dtype(device: torch.device) -> torch.dtype:
    return torch.float64 if device.type == "cpu" else torch.float32


def engine_name(device: torch.device) -> str:
    """Numeric environment of a run, for the checkpoint fingerprint: a
    resume must not append CUDA float32 matrices to a CPU float64 file."""
    return f"torch-{device.type}-{str(default_dtype(device)).split('.')[-1]}"


def to_device(P_host: np.ndarray, device: torch.device) -> torch.Tensor:
    """The one conversion from the host [S, N, 3] float64 array to the
    port's tensor, in the device's dtype (cast on the host, so only
    float32 crosses to a card)."""
    np_dtype = np.float64 if default_dtype(device) == torch.float64 else np.float32
    return torch.from_numpy(np.ascontiguousarray(P_host, dtype=np_dtype)).to(device)


def check_fits(S: int, N: int, device: torch.device, indep: bool):
    """Raise when the resident tensor, the kernels' outputs and (indep)
    the kernel's chunk partials do not fit the card's free memory (long
    genomes would need streaming); else return the bytes left free
    beside them (None on the CPU)."""
    if device.type != "cuda":
        return None
    itemsize = torch.finfo(default_dtype(device)).bits // 8
    need = (S * N * 3 + 4 * N * N + S) * itemsize
    shape = scratch_shape(N, S) if indep else None
    if shape is not None:
        need += 8 * int(np.prod(shape))
    free, _ = torch.cuda.mem_get_info(device)
    if need > free:
        raise NgsDistError(
            "main",
            f"the resident [{S}, {N}, 3] tensor and its working set need "
            f"{need} bytes but the card has {free} free; streaming long "
            "genomes is not yet ported to ngsdist_tpu_torch",
        )
    return free - need


def use_partials(n_blocks: int, N: int, pairwise_del: bool,
                 device: torch.device) -> bool:
    """The JAX engine's rule for the partial-sum bootstrap route
    (ngsdist_tpu/core/distance.py:851-852), in the device's dtype."""
    itemsize = torch.finfo(default_dtype(device)).bits // 8
    partial_bytes = n_blocks * N * N * itemsize * (2 if pairwise_del else 1)
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


def _em_zero_rows(P: torch.Tensor, include=None) -> torch.Tensor:
    """[N] bool: individuals with a DATA-BORNE all-zero triple among the
    included sites.  Without pairwise deletion the reference runs its EM
    on such a triple and gets NaN for every pair touching the individual;
    the kernels exclude zero rows, so the poison is re-applied after."""
    Z = (P == 0).all(-1)
    if include is not None:
        Z = Z & include[:, None]
    return Z.any(0)


def _em_poison_pairs(raw_v: torch.Tensor, z: torch.Tensor, I, J) -> torch.Tensor:
    """NaN the pair entries whose either member has a zero row."""
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


def iter_replicates(
    pars: Params,
    P_host: np.ndarray,
    maps: List[np.ndarray],
    n_trunc: int,
    device: torch.device,
    on_stats=None,
    start_rep: int = 0,
) -> Iterator[np.ndarray]:
    """Yield the full-data matrix, then one matrix per bootstrap
    replicate, for replicates start_rep..n_boot_rep."""
    N, S = pars.n_ind, pars.n_sites
    dtype = default_dtype(device)
    score = torch.as_tensor(pars.score, dtype=dtype, device=device)
    I, J = _pair_indices(N)
    It = torch.from_numpy(I).long().to(device)
    Jt = torch.from_numpy(J).long().to(device)
    n_blocks = n_trunc // pars.boot_block_size
    left = check_fits(S, N, device, pars.indep_geno)
    partials = use_partials(n_blocks, N, pars.pairwise_del, device) and (
        left is None
        or partials_bytes(n_blocks, N, pars.indep_geno, pars.pairwise_del) <= left)
    P = to_device(P_host, device)

    def full_stats(Psub, site_weights=None):
        """(raw, cnt or None) pair vectors [n_pairs] on the device."""
        if pars.indep_geno:
            raw_m, cnt_m = indep_raw_cnt(Psub, score, pars.pairwise_del,
                                         site_weights)
            return raw_m[It, Jt], (cnt_m[It, Jt] if pars.pairwise_del else None)
        raw_m, cnt_m = em_raw_cnt(Psub, score.reshape(-1), pars.pairwise_del,
                                  site_weights)
        raw_v = raw_m[It, Jt]
        # binary inputs cannot hold a zero row (every parsed row
        # normalises to sum 1), so they skip the scan
        if not (pars.pairwise_del or pars.in_bin):
            inc = None if site_weights is None else site_weights > 0
            raw_v = _em_poison_pairs(raw_v, _em_zero_rows(Psub, inc), It, Jt)
        return raw_v, cnt_m[It, Jt]

    def to_matrix(raw_v, cnt_v):
        raw_m = _scatter_pairs(raw_v.cpu().double().numpy(), I, J, N)
        cnt_m = (None if cnt_v is None
                 else _scatter_pairs(cnt_v.cpu().double().numpy(), I, J, N))
        return raw_m, cnt_m

    if start_rep == 0:
        raw_m, cnt_m = to_matrix(*full_stats(P))
        denom = cnt_m if pars.pairwise_del else float(S)
        yield _finalize(raw_m, denom, pars, on_stats)

    reps = [r for r in range(pars.n_boot_rep) if r + 1 >= start_rep]
    if not reps:
        return
    Ptrunc = P[:n_trunc]

    if partials:
        for raw_v, cnt_v in _resum_blocks(pars, Ptrunc, score, n_blocks, reps, It, Jt):
            raw_m, cnt_m = to_matrix(raw_v, cnt_v)
            denom = cnt_m if pars.pairwise_del else float(n_trunc)
            yield _finalize(raw_m, denom, pars, on_stats)
        return

    def dispatch(r):
        w = replicate_weights(maps[r], n_trunc)
        return full_stats(Ptrunc, torch.from_numpy(w).to(device=device, dtype=dtype))

    # Launch replicate r+1 before fetching replicate r, so the device
    # computes the next replicate while the host corrects and writes.
    pending = dispatch(reps[0])
    for k in range(len(reps)):
        raw_v, cnt_v = pending
        if k + 1 < len(reps):
            pending = dispatch(reps[k + 1])
        raw_m, cnt_m = to_matrix(raw_v, cnt_v)
        denom = cnt_m if pars.pairwise_del else float(n_trunc)
        yield _finalize(raw_m, denom, pars, on_stats)


def _resum_blocks(pars: Params, Ptrunc: torch.Tensor, score: torch.Tensor,
                  n_blocks: int, reps: List[int], It, Jt):
    """The partial-sum route (ngsdist_tpu/core/distance.py:856-890): one
    block-mode kernel call, then for each replicate r in reps its
    (raw, cnt or None) pair vectors M[r] @ B and M[r] @ C in float64,
    M[r] the multiplicity of each block in replicate r."""
    bs = pars.boot_block_size
    if pars.indep_geno:
        B, C = indep_block_partials(Ptrunc, score, pars.pairwise_del, n_blocks, bs)
    else:
        B, C = em_block_partials(Ptrunc, score.reshape(-1), pars.pairwise_del,
                                 n_blocks, bs)
        C = C if pars.pairwise_del else None  # the denominator is n_trunc
    table = bt.block_index_table(pars.seed, pars.n_boot_rep, n_blocks)
    M = torch.from_numpy(bt.block_multiplicity(table, n_blocks)).to(B.device)
    # A NaN partial makes the pair NaN whatever its block's multiplicity,
    # as in the JAX product (a BLAS may skip zero multipliers).
    nan_pairs = torch.isnan(B).any(0)
    nan = torch.tensor(float("nan"), dtype=B.dtype, device=B.device)
    zB = None
    if not (pars.indep_geno or pars.pairwise_del or pars.in_bin):
        # The EM's zero-row poison (_em_zero_rows), per block: a
        # replicate is poisoned where it samples a block in which either
        # member of the pair has an all-zero row.  The partials stay
        # clean, so an unsampled block cannot poison.
        N = Ptrunc.shape[1]
        zB = (Ptrunc == 0).all(-1).reshape(n_blocks, bs, N).any(1).double()
    for r in reps:
        raw_v = torch.where(nan_pairs, nan, M[r] @ B)
        if zB is not None:
            raw_v = _em_poison_pairs(raw_v, ((M[r] > 0).double() @ zB) > 0, It, Jt)
        yield raw_v, None if C is None else M[r] @ C
