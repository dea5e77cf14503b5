"""Single-device distance engine (PyTorch).

Port of the resident single-device path of ngsdist_tpu/core/distance.py:
the probability tensor [S, N, 3] is moved to the device once, and every
replicate is one call of the independent-genotypes kernel
(ops/indep.py) or the pairwise-EM kernel (ops/em.py), chosen by
`pars.indep_geno`.  Bootstrap replicates reuse the resident tensor:
each one passes its per-site multiplicities as the kernels' site
weights (the reference's site aliasing, ngsDist.cpp:416-437, with no
data movement).

Dtype policy: float64 on the CPU, float32 on CUDA.  On the CPU the
kernels' plain versions run; on CUDA the hand-written kernels do.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np
import torch

from ngsdist_tpu.config import NgsDistError, Params
from ngsdist_tpu.core import bootstrap as bt
from ngsdist_tpu.core import models

from ..ops.em import em_raw_cnt
from ..ops.indep import indep_raw_cnt, scratch_shape


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


def check_fits(S: int, N: int, device: torch.device, indep: bool) -> None:
    """Raise when the resident tensor, the kernels' outputs and (indep)
    the kernel's chunk partials do not fit the card's free memory (long
    genomes would need streaming)."""
    if device.type != "cuda":
        return
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
    check_fits(S, N, device, pars.indep_geno)
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
    Ptrunc = P[:n_trunc]

    def dispatch(r):
        w = replicate_weights(maps[r], n_trunc)
        return full_stats(Ptrunc, torch.from_numpy(w).to(device=device, dtype=dtype))

    # Launch replicate r+1 before fetching replicate r, so the device
    # computes the next replicate while the host corrects and writes.
    pending = dispatch(reps[0]) if reps else None
    for k in range(len(reps)):
        raw_v, cnt_v = pending
        if k + 1 < len(reps):
            pending = dispatch(reps[k + 1])
        raw_m, cnt_m = to_matrix(raw_v, cnt_v)
        denom = cnt_m if pars.pairwise_del else float(n_trunc)
        yield _finalize(raw_m, denom, pars, on_stats)
