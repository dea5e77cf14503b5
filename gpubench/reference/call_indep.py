"""Plain reference of an ngsDist run on called genotypes.

What one run of `ngsDist --geno FILE --probs --call_geno [--pairwise_del]
--n_boot_rep R --boot_block_size B --evol_model M` computes, written from
the reference's semantics in plain PyTorch, float64, and imported from
nothing of the program:

- the binary reader's normalisation (ngsdist.py read_binary_gp;
  read_data.cpp:29-47);
- the call with N_thresh = call_thresh = 0 (gen_func.cpp:886-914): each
  triple takes its first maximum in log space, which exp keeps, as a
  one-hot; a triple whose three values are equal is missing and stays
  uniform (exp(log(1/3)) each, ngsDist.cpp:165-174);
- --call_geno forces independent genotypes (ngsDist.cpp:44-94): a
  pair's distance at a site is Pa' S Pb, S the 3 x 3 score of
  parse_args.cpp:22-27;
- --pairwise_del: a pair's numerator and denominator run over the sites
  where neither call is missing (ngsDist.cpp:333-353; miss_data,
  gen_func.cpp:862-868); without it every site counts, a missing call
  with its uniform triple;
- the bootstrap: replicate r weights each site of the genome truncated
  to whole blocks by how often r draws it (taus.py site_weights);
- the transform of --evol_model (ngsdist.py evol_transform,
  ngsDist.cpp:378-401).

Pairs are evaluated on a sample (ngsdist.py sample_pairs).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .ngsdist import evol_transform, read_binary_gp
from .taus import site_weights

# parse_args.cpp:22-27: the distance between two genotypes, 0 for the
# same, 1/2 for one allele apart, 1 for opposite homozygotes
SCORE = ((0.0, 0.5, 1.0), (0.5, 0.0, 0.5), (1.0, 0.5, 0.0))
MISSING = 3                               # the code of a missing call
UNIFORM = math.exp(math.log(1.0 / 3.0))   # its value, as the reference leaves it


def call_codes(P: torch.Tensor, log_scale: bool = False) -> torch.Tensor:
    """int64 [...] codes of triples P [..., 3] (normal space, or log
    space with log_scale): 0-2 the first maximum (torch's argmax returns
    the first of equal maxima), MISSING where the three values are equal
    (gen_func.cpp:886-914 with both thresholds 0)."""
    lg = P if log_scale else P.log()
    equal = (lg[..., 0] == lg[..., 1]) & (lg[..., 1] == lg[..., 2])
    return torch.where(equal, MISSING, lg.argmax(-1))


def code_scores(device: torch.device) -> torch.Tensor:
    """[4, 4] float64: Pa' S Pb for the triples of every two codes, a
    missing call's triple uniform."""
    table = torch.zeros((4, 3), dtype=torch.float64, device=device)
    table[0, 0] = table[1, 1] = table[2, 2] = 1.0
    table[MISSING] = UNIFORM
    return table @ torch.tensor(SCORE, dtype=torch.float64, device=device) @ table.T


def pair_site_terms(codes: torch.Tensor, I: np.ndarray,
                    J: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """(terms, called) [S, n] float64: each sampled pair's Pa' S Pb at
    every site, and 1 where neither call is missing (miss_data tells a
    called triple from the uniform one at any tolerance)."""
    ca = codes[:, torch.from_numpy(I).to(codes.device)]
    cb = codes[:, torch.from_numpy(J).to(codes.device)]
    return code_scores(codes.device)[ca, cb], ((ca != MISSING) & (cb != MISSING)).double()


def state(path: str, n_ind: int, n_sites: int, I: np.ndarray, J: np.ndarray,
          device: torch.device) -> dict:
    """{"terms", "called"} [S, n] of the sampled pairs over the input's
    calls."""
    codes = call_codes(read_binary_gp(path, n_ind, n_sites, device))
    terms, called = pair_site_terms(codes, I, J)
    return {"terms": terms, "called": called}


def distances(terms: torch.Tensor, called: torch.Tensor, pairwise_del: bool, boot_seed: int,
              n_reps: int, block_size: int, evol_model: int,
              sum_dtype: torch.dtype = torch.float64) -> np.ndarray:
    """[1 + n_reps, n] float64 distances of the sampled pairs: the full
    data, then each bootstrap replicate of seed `boot_seed`; under
    pairwise_del over the sites where both are called, else over every
    site.  The sums over sites are taken in float64, or held in
    `sum_dtype` (the control)."""
    S = terms.shape[0]
    if pairwise_del:
        t, v = terms * called, called
    else:
        t, v = terms, torch.ones_like(terms)
    t, v = t.to(sum_dtype), v.to(sum_dtype)
    num, den = [t.sum(0)], [v.sum(0)]
    if n_reps:
        n_trunc, w = site_weights(boot_seed, n_reps, S, block_size)
        wt = torch.from_numpy(w).to(terms.device, sum_dtype)
        num += list(wt @ t[:n_trunc])
        den += list(wt @ v[:n_trunc])
    num_h = torch.stack(num).double().cpu().numpy()
    den_h = torch.stack(den).double().cpu().numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        return evol_transform(num_h / den_h, evol_model)
