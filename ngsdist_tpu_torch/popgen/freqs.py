"""Allele-frequency and haplotype-frequency estimators (batched PyTorch).

Port of ngsdist_tpu/popgen/freqs.py, the reference's unlinked
shared-library estimators (gen_func.cpp:936-1178, used by sibling
ngsTools):

  calc_hwe        gen_func.cpp:938-957  — HWE genotype priors with
                  inbreeding F (het prior clamped at F == 1).
  est_maf_sites   gen_func.cpp:974-1009 — per-site minor-allele-freq EM
                  from log-GLs, with the reference's num/den accumulated
                  across iterations and its |Δfreq| > EPSILON,
                  101-body stop.
  haplo_freq      gen_func.cpp:1027-1119 — two-site haplotype-frequency
                  EM (normal space), max-|Δ| < EPSILON stop, ITER_MAX.

Both EMs run the whole batch of per-site (or per-site-pair) problems as
tensor operations with per-lane convergence freezing, the shape of the
JAX package's vectorised `lax.while_loop`: the loop runs on the host
while any lane is active (one `.item()` a step) and a finished lane keeps
its state.  Every expression keeps the JAX package's order of
operations, so on the CPU in float64 the two agree to the rounding of
their reductions.

Devices: computation runs on the device of the tensor arguments; numpy
arrays and Python numbers go there too.  With no tensor argument it runs
on the card, as JAX puts host arrays on its default device, and raises
where there is none (`on_device`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.hmm import logsumexp

EPSILON = 1e-5   # gen_func.hpp:16
ITER_MAX = 100   # gen_func.hpp:18


def on_device(*args) -> torch.device:
    """The device of the first tensor among args; with none, the card.
    Never the CPU by default: a caller who wants the CPU passes tensors
    that lie there."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no tensor argument and no CUDA device: pass torch tensors on the "
            "device to compute on (CPU tensors compute on the CPU)")
    return torch.device("cuda")


def dtype_of(*args) -> torch.dtype:
    """The promoted type of the tensor and array arguments; with none,
    the default type (Python numbers are JAX's weak types)."""
    dt = None
    for a in args:
        if isinstance(a, torch.Tensor) or isinstance(a, np.ndarray):
            t = torch.as_tensor(a).dtype
            dt = t if dt is None else torch.promote_types(dt, t)
    return torch.get_default_dtype() if dt is None else dt


def calc_hwe(maf, F) -> torch.Tensor:
    """[..., 3] HWE genotype frequencies with inbreeding coefficient F
    (calc_HWE, gen_func.cpp:938-957).  At F == 1 the heterozygote
    frequency is clamped to 1/INF rather than its algebraic 0."""
    dev, dt = on_device(maf, F), dtype_of(maf, F)
    maf = torch.as_tensor(maf, dtype=dt, device=dev)
    F = torch.as_tensor(F, dtype=dt, device=dev)
    om = 1 - maf
    p0 = om * om + om * maf * F
    p1 = 2 * om * maf - 2 * om * maf * F
    p2 = maf * maf + om * maf * F
    p1 = torch.where(F == 1.0, torch.full_like(p1, 1e-15), p1)
    p0, p1, p2 = torch.broadcast_tensors(p0, p1, p2)
    return torch.stack([p0, p1, p2], dim=-1)


def _miss(gl_log: torch.Tensor) -> torch.Tensor:
    d01 = (gl_log[..., 0] - gl_log[..., 1]).abs()
    d12 = (gl_log[..., 1] - gl_log[..., 2]).abs()
    return (d01 < EPSILON) & (d12 < EPSILON)


def _est_maf_iters(
    GL,
    indF=None,
    ignore_miss_data: bool = True,
) -> Tuple[torch.Tensor, int]:
    """est_maf_sites and the number of loop bodies it ran (the batch's
    longest lane, at most ITER_MAX + 1)."""
    dev = on_device(GL, indF)
    GL = torch.as_tensor(GL, dtype=dtype_of(GL), device=dev)
    dtype = GL.dtype
    S, N = GL.shape[0], GL.shape[1]
    use = torch.ones((S, N), dtype=dtype, device=dev)
    if ignore_miss_data:
        use = (~_miss(GL)).to(dtype)
    F = None if indF is None else torch.as_tensor(indF, dtype=dtype, device=dev)[None, :]
    Fe = torch.zeros((1, N), dtype=dtype, device=dev) if F is None else F

    def posteriors(freq):
        if F is None:
            prior = torch.zeros((1, 1, 3), dtype=dtype, device=dev)
        else:
            prior = torch.log(calc_hwe(freq[:, None], F))
        lp = GL + prior
        return torch.exp(lp - logsumexp(lp, -1, keepdim=True))

    def contrib(freq):
        pp = posteriors(freq)
        num = pp[..., 1] + pp[..., 2] * (2 - Fe)
        den = 2 * pp[..., 1] + (pp[..., 0] + pp[..., 2]) * (2 - Fe)
        return (num * use).sum(1), (den * use).sum(1)

    # Reference do-loop: num/den accumulate ACROSS iterations
    # (gen_func.cpp:976-1007 — they are initialized once, outside).  it
    # starts at 0 with an inclusive bound: the reference's post-increment
    # guard (iters++ < 100) allows 101 loop bodies.
    freq = torch.full((S,), 0.01, dtype=dtype, device=dev)
    num = torch.zeros((S,), dtype=dtype, device=dev)
    den = torch.zeros_like(num)
    active = torch.ones((S,), dtype=torch.bool, device=dev)
    it = 0
    while it <= ITER_MAX and bool(active.any()):
        dn, dd = contrib(freq)
        num = num + torch.where(active, dn, torch.zeros_like(dn))
        den = den + torch.where(active, dd, torch.zeros_like(dd))
        new = num / den
        moved = (freq - new).abs() > EPSILON
        freq = torch.where(active, new, freq)
        active = active & moved
        it += 1
    return freq, it


def est_maf_sites(
    GL,
    indF=None,
    ignore_miss_data: bool = True,
) -> torch.Tensor:
    """Per-site minor-allele-frequency EM over a whole batch of sites.

    GL [S, N, 3] log-scale genotype likelihoods; indF None (uniform
    genotype prior, F treated as 0 in the allele-count expectations) or
    [N] per-individual inbreeding coefficients.  Returns [S] MAFs.
    """
    return _est_maf_iters(GL, indF, ignore_miss_data)[0]


def est_maf(gl_log, indF=None, ignore_miss_data: bool = True) -> torch.Tensor:
    """Single-site convenience wrapper (est_maf, gen_func.cpp:974-1009)."""
    dev = on_device(gl_log, indF)
    gl_log = torch.as_tensor(gl_log, dtype=dtype_of(gl_log), device=dev)
    return est_maf_sites(gl_log[None], indF, ignore_miss_data)[0]


# _G1/_G2: genotype of haplotype pair (h, k) at site 1 / site 2
# (gen_func.cpp:1074-1075).
_G1 = [[(h >> 1 & 1) + (k >> 1 & 1) for h in range(4)] for k in range(4)]
_G2 = [[(h & 1) + (k & 1) for h in range(4)] for k in range(4)]


def haplo_freq(
    gl1,
    gl2,
    maf1,
    maf2,
    ignore_miss_data: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-site haplotype-frequency EM (haplo_freq + pair_freq_iter,
    gen_func.cpp:1027-1119), batched over leading dims.

    gl1/gl2 [..., N, 3] NORMAL-space GLs for the two sites; maf1/maf2
    broadcastable to the leading dims.  Returns (hap_freq [..., 4],
    n_iter [...] int32, n_used [...]).
    """
    dev, dtype = on_device(gl1, gl2, maf1, maf2), dtype_of(gl1, gl2)
    gl1 = torch.as_tensor(gl1, dtype=dtype, device=dev)
    gl2 = torch.as_tensor(gl2, dtype=dtype, device=dev)
    batch = gl1.shape[:-2]
    maf1 = torch.as_tensor(maf1, dtype=dtype, device=dev).broadcast_to(batch)
    maf2 = torch.as_tensor(maf2, dtype=dtype, device=dev).broadcast_to(batch)

    def miss_normal(gl):
        d01 = (gl[..., 0] - gl[..., 1]).abs()
        d12 = (gl[..., 1] - gl[..., 2]).abs()
        return (d01 < EPSILON) & (d12 < EPSILON)

    if ignore_miss_data:
        use = (~(miss_normal(gl1) | miss_normal(gl2))).to(dtype)
    else:
        use = torch.ones(gl1.shape[:-1], dtype=dtype, device=dev)
    x = use.sum(-1)  # individuals with data

    f0 = torch.stack([(1 - maf1) * (1 - maf2), (1 - maf1) * maf2,
                      maf1 * (1 - maf2), maf1 * maf2], dim=-1)

    def em_step(f):
        # sum over (k, h) of f_k f_h p1[g1(k,h)] p2[g2(k,h)] per
        # individual, added in the JAX package's order (k outer, h inner)
        # without holding the sixteen terms at once
        fk = [f[..., k, None] for k in range(4)]
        ssum = 0
        for k in range(4):
            for h in range(4):
                ssum = ssum + fk[k] * fk[h] * gl1[..., _G1[k][h]] * gl2[..., _G2[k][h]]
        ff = []
        for k in range(4):
            tmp = 0
            for h in range(4):
                tmp = tmp + fk[k] * fk[h] * (gl1[..., _G1[h][k]] * gl2[..., _G2[h][k]]
                                             + gl1[..., _G1[k][h]] * gl2[..., _G2[k][h]])
            ff.append((use * tmp / ssum).sum(-1))
        ff = torch.stack(ff, dim=-1) / (2 * x[..., None])
        return ff / ff.sum(-1, keepdim=True)

    f = f0
    active = torch.ones(batch, dtype=torch.bool, device=dev)
    n_iter = torch.zeros(batch, dtype=torch.int32, device=dev)
    it = 0
    while it < ITER_MAX and bool(active.any()):
        fn = em_step(f)
        eps = (fn - f).abs().amax(-1)
        f = torch.where(active[..., None], fn, f)
        n_iter = n_iter + active.to(torch.int32)
        active = active & (eps >= EPSILON)
        it += 1
    # Reference returns the 0-based loop index at break (a lane converging
    # on its first step reports 0; a never-converging lane ITER_MAX).
    n_iter = torch.where(active, n_iter, (n_iter - 1).clamp(min=0))
    return f, n_iter, x
