"""Seeded low-coverage sequencing simulation: binary genotype posteriors.

The kind of data ngsDist's own tests run on (ngsSim, in the reference's
examples/test.sh): per site an allele frequency from the neutral
site-frequency spectrum, genotypes under Hardy-Weinberg equilibrium,
reads at Poisson depth with a per-base error rate (each individual's
mean depth drawn uniformly from the configuration's `depth_range`, as a
low-coverage panel's samples differ in coverage), genotype likelihoods
from the binomial error model and posteriors from the likelihoods times
the HWE prior at the site's frequency.  An individual with no read at a
site is missing: its triple is uniform.

Everything is drawn on `device` from one torch.Generator seeded with the
run's seed, in chunks of CHUNK_SITES sites, so that a seed gives the same
bytes on every run on one kind of device; the chunk is written to the
file as float64 triples, site-major [sites][individuals][3], the binary
format ngsDist sniffs for --geno (ngsDist.cpp:86-94).
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK_SITES = 4096


def _chunk(g: torch.Generator, n_sites: int, n_ind: int, depth: torch.Tensor, error: float,
           harmonic_cdf: torch.Tensor) -> torch.Tensor:
    """[n_sites, n_ind, 3] float64 posteriors for one chunk of sites."""
    dev = harmonic_cdf.device
    f64 = torch.float64
    # derived-allele count k of 2N chromosomes, P(k) ∝ 1/k (neutral SFS)
    u = torch.rand(n_sites, generator=g, device=dev, dtype=f64)
    k = torch.searchsorted(harmonic_cdf, u * harmonic_cdf[-1], right=True) + 1
    freq = (k.to(f64) / (2 * n_ind)).clamp(max=1.0 - 1.0 / (2 * n_ind))[:, None]
    geno = ((torch.rand(n_sites, n_ind, generator=g, device=dev, dtype=f64) < freq).to(f64)
            + (torch.rand(n_sites, n_ind, generator=g, device=dev, dtype=f64) < freq).to(f64))
    reads = torch.poisson(depth.expand(n_sites, n_ind).contiguous(), generator=g)
    p_read = geno / 2 * (1 - error) + (1 - geno / 2) * error
    derived = torch.binomial(reads, p_read, generator=g)
    # binomial error model: P(derived read | genotype h) = h/2 (1 - e) + (1 - h/2) e
    p_h = torch.tensor([error, 0.5, 1 - error], dtype=f64, device=dev)
    loglik = (derived[..., None] * torch.log(p_h)
              + (reads - derived)[..., None] * torch.log1p(-p_h))
    prior = torch.cat([(1 - freq) ** 2, 2 * freq * (1 - freq), freq ** 2], dim=1)
    post = torch.softmax(loglik + torch.log(prior)[:, None, :], dim=-1)
    return torch.where((reads == 0)[..., None], torch.full_like(post, 1.0 / 3.0), post)


def write_gp(path: str, n_sites: int, n_ind: int, depth_range, error: float, seed: int,
             device: torch.device) -> None:
    """Simulate n_sites x n_ind posteriors from `seed` on `device` and
    write them to `path` as raw float64 triples, site-major; each
    individual's mean depth uniform in depth_range = (low, high)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    lo, hi = (float(x) for x in depth_range)
    depth = lo + (hi - lo) * torch.rand(n_ind, generator=g, device=device,
                                        dtype=torch.float64)
    harmonic_cdf = torch.cumsum(
        1.0 / torch.arange(1, 2 * n_ind, dtype=torch.float64, device=device), 0)
    with open(path, "wb") as fh:
        for lo_site in range(0, n_sites, CHUNK_SITES):
            sc = min(CHUNK_SITES, n_sites - lo_site)
            post = _chunk(g, sc, n_ind, depth, error, harmonic_cdf)
            np.ascontiguousarray(post.cpu().numpy()).tofile(fh)


def write(path: str, config: dict, seed: int, device: torch.device) -> None:
    """The input of a configuration (n_sites, n_ind, depth_range,
    error_rate) from `seed`."""
    write_gp(path, config["n_sites"], config["n_ind"], config["depth_range"],
             config["error_rate"], seed, device)
