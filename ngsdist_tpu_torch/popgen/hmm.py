"""Batched HMM engine: forward / backward / Viterbi with
distance-dependent transitions and GL-based emissions.

Port of ngsdist_tpu/popgen/hmm.py, the reference HMM (shared/HMM.cpp:
1-236, an unlinked shared-library component used by sibling ngsTools
such as ngsF-HMM).  The JAX package's per-site `lax.scan`s are the
kernel of csrc/hmm.cu on a card and a plain loop over sites on the CPU
(ops/hmm.py); everything else is tensor operations.

Model semantics (calc_trans, HMM.cpp:130-139): between adjacent sites at
distance d the chain stays coancestry-identical with probability
e^{-alpha*d} and otherwise redraws the state from the stationary
proportions q:  T_d[k,l] = (1-e^{-alpha*d})*q[l] + [k==l]*e^{-alpha*d}.

Emissions (calc_emission, HMM.cpp:144-156): log P(GL | state) =
logsumexp_g(gl[g] + log HWE(maf, F_state)[g]).

Array convention (the JAX package's): the chain starts in a *virtual*
start row distributed as q with no emission (Fw[0] = log q, HMM.cpp:
9-10); every observation s = 0..S-1 then gets a transition built from
pos_dist[s] (the distance entering that site, io/readers.read_pos_dist;
inf at chromosome changes -> the transition resets to the stationary
distribution) followed by its emission e_prob[s].

Chains: forward, backward, posterior_decode and viterbi take one chain
as the JAX functions do (q_prop [K], alpha a number, e_prob [S, K],
pos_dist [S]) or a batch, the JAX package's `vmap` written out: e_prob
[B, S, K] with q_prop [K] or [B, K], alpha a number or [B], pos_dist [S]
or [B, S]; the results then carry the leading B.  Inputs are cast to
their promoted floating type on the device of the tensor arguments
(freqs.on_device).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops import hmm as _ops
from ..ops.hmm import logsumexp
from .freqs import calc_hwe, dtype_of, on_device


def transition_matrices(q_prop, alpha, pos_dist) -> torch.Tensor:
    """[S, K, K] log transition matrices for each inter-site distance.

    q_prop [K] stationary state proportions; pos_dist [S] distances
    entering each observation (leading chain dims broadcast)."""
    dev, dt = on_device(q_prop, alpha, pos_dist), dtype_of(q_prop, alpha, pos_dist)
    q, a, d = (torch.as_tensor(x, dtype=dt, device=dev) for x in (q_prop, alpha, pos_dist))
    return _ops.transition_matrices(q, a, d)


def calc_emission(gl, maf, F) -> torch.Tensor:
    """log P(GL | maf, inbreeding F): logsumexp over genotypes of
    log-GL + log HWE prior (calc_emission, HMM.cpp:144-156).  gl is
    log-scale [..., 3]."""
    dev, dt = on_device(gl, maf, F), dtype_of(gl, maf, F)
    maf, F = (torch.as_tensor(x, dtype=dt, device=dev) for x in (maf, F))
    prior = torch.log(calc_hwe(maf, F))
    return logsumexp(torch.as_tensor(gl, dtype=dt, device=dev) + prior, -1)


def calc_emission_two_mafs(gl, maf1, maf2) -> torch.Tensor:
    """Emission with independent allele frequencies per haplotype
    (calc_emission overload, HMM.cpp:158-170)."""
    dev, dt = on_device(gl, maf1, maf2), dtype_of(gl, maf1, maf2)
    maf1, maf2 = (torch.as_tensor(x, dtype=dt, device=dev) for x in (maf1, maf2))
    parts = torch.broadcast_tensors((1 - maf1) * (1 - maf2),
                                    (1 - maf1) * maf2 + maf1 * (1 - maf2), maf1 * maf2)
    prior = torch.log(torch.stack(parts, dim=-1))
    return logsumexp(torch.as_tensor(gl, dtype=dt, device=dev) + prior, -1)


def _chains(q_prop, alpha, e_prob, pos_dist):
    """(q [B, K], alpha [B], e [B, S, K], d [S] or [B, S], batched)."""
    dev = on_device(e_prob, q_prop, alpha, pos_dist)
    dt = dtype_of(e_prob, q_prop, alpha, pos_dist)
    e = torch.as_tensor(e_prob, dtype=dt, device=dev)
    batched = e.ndim == 3
    if not batched:
        e = e[None]
    B, _, K = e.shape
    q = torch.as_tensor(q_prop, dtype=dt, device=dev).expand(B, K)
    a = torch.as_tensor(alpha, dtype=dt, device=dev).expand(B)
    return q, a, e, torch.as_tensor(pos_dist, dtype=dt, device=dev), batched


def _one(batched: bool, *outs):
    return outs if batched else tuple(o[0] for o in outs)


def forward(q_prop, alpha, e_prob, pos_dist) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward recursion.  e_prob [S, K] log emissions, pos_dist [S].

    Returns (Fw [S, K] log forward messages, loglik scalar) — the
    reference's forward() (HMM.cpp:6-27) with its site-0 init folded in.
    """
    q, a, e, d, batched = _chains(q_prop, alpha, e_prob, pos_dist)
    return _one(batched, *_ops.hmm_forward(q, a, e, d))


def backward(q_prop, alpha, e_prob, pos_dist) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward recursion (HMM.cpp:32-60).

    Returns (Bw [S, K] — Bw[s][k] is the log probability of observations
    s+1.. given state k at observation s — and the loglik computed from
    the virtual start row)."""
    q, a, e, d, batched = _chains(q_prop, alpha, e_prob, pos_dist)
    return _one(batched, *_ops.hmm_backward(q, a, e, d))


def posterior_decode(q_prop, alpha, e_prob, pos_dist) -> Tuple[torch.Tensor, torch.Tensor]:
    """[S, K] log posterior state probabilities and the loglik."""
    q, a, e, d, batched = _chains(q_prop, alpha, e_prob, pos_dist)
    Fw, ll = _ops.hmm_forward(q, a, e, d)
    Bw, _ = _ops.hmm_backward(q, a, e, d)
    return _one(batched, Fw + Bw - ll[:, None, None], ll)


def viterbi(q_prop, alpha, e_prob, pos_dist) -> Tuple[torch.Tensor, torch.Tensor]:
    """Most probable state path (HMM.cpp:102-125).

    Returns (path [S] int32, best log score)."""
    q, a, e, d, batched = _chains(q_prop, alpha, e_prob, pos_dist)
    return _one(batched, *_ops.hmm_viterbi(q, a, e, d))


def joint_geno_prob(hap_freq, F: int) -> torch.Tensor:
    """[3, 3] joint genotype probability table P(g_prev, g_cur) from the
    four haplotype frequencies [P_BA, P_Ba, P_bA, P_ba]
    (joint_geno_prob, HMM.cpp:205-236).  F is the shared inbreeding
    level of both positions: 0 = outbred (haplotypes pair independently),
    1 = fully inbred (the two haplotypes are identical, so heterozygous
    combinations are impossible)."""
    hap_freq = torch.as_tensor(hap_freq, dtype=dtype_of(hap_freq), device=on_device(hap_freq))
    f0, f1, f2, f3 = (hap_freq[..., k] for k in range(4))
    if F == 0:
        rows = [
            [f0 * f0, 2 * f0 * f1, f1 * f1],
            [2 * f0 * f2, 2 * (f0 * f3 + f1 * f2), 2 * f1 * f3],
            [f2 * f2, 2 * f2 * f3, f3 * f3],
        ]
    else:
        z = torch.zeros_like(f0)
        rows = [[f0, z, f1], [z, z, z], [f2, z, f3]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def calc_emission_ld(hap_freq, gl_prev, gl_cur, maf_prev, F: int) -> torch.Tensor:
    """LD-aware emission: log P(GL_cur | GL_prev, haplotype freqs, F)
    (calc_emissionLD's live branch, HMM.cpp:175-203: the joint
    probability under the two-site haplotype model divided by the
    previous site's single-site emission).

    gl_prev/gl_cur are log-scale [..., 3]; hap_freq [..., 4]."""
    dev = on_device(hap_freq, gl_prev, gl_cur, maf_prev)
    dt = dtype_of(hap_freq, gl_prev, gl_cur, maf_prev)
    gl_prev, gl_cur = (torch.as_tensor(x, dtype=dt, device=dev) for x in (gl_prev, gl_cur))
    J = joint_geno_prob(torch.as_tensor(hap_freq, dtype=dt, device=dev), F)        # [..., 3, 3]
    joint = torch.einsum("...pc,...p,...c->...", J, torch.exp(gl_prev), torch.exp(gl_cur))
    return torch.log(joint) - calc_emission(gl_prev, maf_prev, F)
