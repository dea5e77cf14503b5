"""Plain reference of an ngsDist run on binary genotype posteriors.

What one run of `ngsDist --geno FILE --probs --n_boot_rep R
--boot_block_size B` computes, written from the reference's semantics in
plain PyTorch and imported from nothing of the program:

- the binary reader: float64 triples, each taken to log space (log 0 is
  -1e15), normalised by its log-sum-exp and taken back (read_data.cpp,
  gen_func.cpp post_prob and conv_space);
- per pair and site the EM on the nine joint-genotype frequencies
  (emOptim2.cpp, tole 0.001, at most 50 steps): start uniform, each step
  reweights by W = Pi ⊗ Pj and normalises twice, and the run stops after
  the first step whose log-likelihood moved by less than tole; the
  lane adds Σ score · frequencies;
- the bootstrap: replicate r draws blocks from the taus stream
  (taus.py) over the genome truncated to whole blocks, so its sum is the
  lanes weighted by how often r draws their site;
- the distance: the sum over the sites used, the transform of
  --evol_model (0: none, 1: -log(1 - d), 2: JC69) and a zero diagonal;
- the phylip text as written: a blank line, the count, one row per
  individual of its label and %.10f values.

Pairs are evaluated on a sample (`sample_pairs`); the EM's lanes run in
chunks with the converged ones left out of later steps.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .taus import site_weights

EM_TOLE = 0.001
EM_MAX_ITER = 50
BIGNEG = 1.0e15
SCORE = ((0.0, 0.5, 1.0), (0.5, 0.0, 0.5), (1.0, 0.5, 0.0))
LANES_PER_CHUNK = 1 << 22


def read_binary_gp(path: str, n_ind: int, n_sites: int, device: torch.device) -> torch.Tensor:
    """[n_sites, n_ind, 3] float64 normal-space posteriors as ngsDist's
    binary reader leaves them."""
    raw = np.fromfile(path, dtype="<f8")
    if raw.size != n_sites * n_ind * 3:
        raise ValueError(f"{path}: {raw.size} values, expected {n_sites * n_ind * 3}")
    P = torch.from_numpy(raw).to(device).view(n_sites, n_ind, 3)
    lg = torch.log(P)
    lg = torch.where(lg == -torch.inf, torch.full_like(lg, -BIGNEG), lg)
    m = lg.amax(-1, keepdim=True)
    norm = torch.log(torch.exp(lg - m).sum(-1, keepdim=True)) + m
    return torch.exp(lg - norm)


def sample_pairs(n_ind: int, per_individual: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pairs (I < J) drawn from `seed` in which every individual takes
    part: individual i meets perm_k[i] for `per_individual` random
    permutations (i + 1 where perm_k[i] is i itself), repeats dropped."""
    rng = np.random.default_rng([int(seed), n_ind, 7])
    pairs = set()
    for _ in range(per_individual):
        perm = rng.permutation(n_ind)
        for i, j in enumerate(perm.tolist()):
            j = (i + 1) % n_ind if j == i else j
            pairs.add((min(i, j), max(i, j)))
    I, J = np.array(sorted(pairs), dtype=np.int64).T
    return I, J


def em_lanes(Pi: torch.Tensor, Pj: torch.Tensor, dtype: torch.dtype = torch.float64):
    """EM of the lanes Pi, Pj [L, 3] in `dtype`: (contribution [L]
    float64, steps run [L] int64)."""
    L = Pi.shape[0]
    W = (Pi.to(dtype)[:, :, None] * Pj.to(dtype)[:, None, :]).reshape(L, 9)
    score = torch.tensor(SCORE, dtype=dtype, device=W.device).reshape(9)
    sfs = torch.full_like(W, 1.0 / 9.0)
    steps = torch.zeros(L, dtype=torch.int64, device=W.device)
    idx = torch.nonzero(W.sum(-1) > 0).squeeze(1)
    Wa, fa = W[idx], sfs[idx]
    lik = torch.log((fa * Wa).sum(-1))
    for _ in range(EM_MAX_ITER):
        if idx.numel() == 0:
            break
        inner = fa * Wa
        inner = inner / inner.sum(-1, keepdim=True)
        new = inner / inner.sum(-1, keepdim=True)
        new_lik = torch.log((new * Wa).sum(-1))
        sfs[idx] = new
        steps[idx] += 1
        keep = ~(torch.abs(new_lik - lik) < EM_TOLE)
        idx, Wa, fa, lik = idx[keep], Wa[keep], new[keep], new_lik[keep]
    return (sfs * score).sum(-1).double(), steps


def pair_site_em(P: torch.Tensor, I: np.ndarray, J: np.ndarray,
                 dtype: torch.dtype = torch.float64):
    """(contrib [S, n], steps [S, n]) of the sampled pairs at every site
    of P [S, N, 3]; the EM in `dtype`."""
    S = P.shape[0]
    It = torch.from_numpy(I).to(P.device)
    Jt = torch.from_numpy(J).to(P.device)
    contrib = torch.empty((S, len(I)), dtype=torch.float64, device=P.device)
    steps = torch.empty((S, len(I)), dtype=torch.int64, device=P.device)
    chunk = max(1, LANES_PER_CHUNK // max(1, len(I)))
    for lo in range(0, S, chunk):
        Pc = P[lo:lo + chunk]
        c, k = em_lanes(Pc[:, It].reshape(-1, 3), Pc[:, Jt].reshape(-1, 3), dtype)
        contrib[lo:lo + chunk] = c.view(Pc.shape[0], -1)
        steps[lo:lo + chunk] = k.view(Pc.shape[0], -1)
    return contrib, steps


def evol_transform(d: np.ndarray, evol_model: int) -> np.ndarray:
    """ngsDist.cpp:378-401 for models 0-2."""
    with np.errstate(divide="ignore", invalid="ignore"):
        if evol_model == 0:
            return d
        if evol_model == 1:
            return -np.log(1 - d)
        if evol_model == 2:
            return -np.log(1 - d * 4 / 3) * 3 / 4
    raise ValueError(f"the reference has no --evol_model {evol_model}")


def distances(contrib: torch.Tensor, boot_seed: int, n_reps: int, block_size: int,
              evol_model: int) -> np.ndarray:
    """[1 + n_reps, n] float64 distances of the sampled pairs: the full
    data, then each bootstrap replicate of seed `boot_seed`."""
    S = contrib.shape[0]
    sums = [contrib.sum(0)]
    used = [S]
    if n_reps:
        n_trunc, w = site_weights(boot_seed, n_reps, S, block_size)
        wt = torch.from_numpy(w).to(contrib.device)
        sums += list(wt @ contrib[:n_trunc])
        used += [n_trunc] * n_reps
    raw = torch.stack(sums).cpu().numpy()
    return evol_transform(raw / np.array(used, dtype=np.float64)[:, None], evol_model)


def read_phylip(path: str, n_ind: int) -> Tuple[List[np.ndarray], List[str], List[str]]:
    """(matrices, labels of the first, faults) of an ngsDist output file:
    one blank line, the count and n_ind rows of a label and n_ind values
    per matrix.  A fault is a text saying what the file breaks."""
    with open(path, "rb") as fh:
        lines = fh.read().decode("ascii", errors="replace").split("\n")
    mats, labels, faults = [], [], []
    k = 0
    while k + 1 < len(lines) and lines[k] == "":
        if lines[k + 1] != str(n_ind):
            faults.append(f"matrix {len(mats)}: count line {lines[k + 1][:20]!r}")
            break
        rows = lines[k + 2:k + 2 + n_ind]
        if len(rows) < n_ind:
            faults.append(f"matrix {len(mats)}: {len(rows)} rows")
            break
        fields = [r.split("\t") for r in rows]
        if any(len(f) != n_ind + 1 for f in fields):
            faults.append(f"matrix {len(mats)}: a row without {n_ind} values")
            break
        if not labels:
            labels = [f[0] for f in fields]
        elif [f[0] for f in fields] != labels:
            faults.append(f"matrix {len(mats)}: labels differ from the first matrix's")
        mats.append(np.array([f[1:] for f in fields], dtype=np.float64))
        k += 2 + n_ind
    if k != len(lines) - 1 or lines[-1] != "":
        faults.append(f"text after matrix {len(mats)} (line {k + 1} of {len(lines)})")
    return mats, labels, faults
