"""Seeded high-coverage genotype posteriors with missing calls: the input
of a called-genotype job.

The posteriors are gen/lowcov.py's simulation at the configuration's
depths (at 35-50x nearly every triple is all but certain), drawn from
the same seed.  Then a share `missing_rate` of the (site, individual)
triples, each chosen independently from a second stream of the seed, is
set to the uniform triple: a sample whose genotype the pipeline did not
call.  ngsDist's --call_geno reads an all-equal triple as missing
(gen_func.cpp:886-914), so under --pairwise_del those calls drop out of
both sums of every pair they touch.

Written in chunks of lowcov.CHUNK_SITES sites, as lowcov writes them;
the mask is drawn on `device` chunk by chunk, so a seed gives the same
bytes on every run on one kind of device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import lowcov

UNIFORM = 1.0 / 3.0


def write_callset(path: str, n_sites: int, n_ind: int, depth_range, error: float,
                  missing_rate: float, seed: int, device: torch.device) -> None:
    """lowcov.write_gp's posteriors from `seed`, then a seeded share
    missing_rate of the triples uniform, rewritten in place."""
    lowcov.write_gp(path, n_sites, n_ind, depth_range, error, seed, device)
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([int(seed), 2]).generate_state(1)[0]))
    P = np.memmap(path, dtype="<f8", mode="r+", shape=(n_sites, n_ind, 3))
    for lo in range(0, n_sites, lowcov.CHUNK_SITES):
        hi = min(n_sites, lo + lowcov.CHUNK_SITES)
        miss = torch.rand(hi - lo, n_ind, generator=g, device=device,
                          dtype=torch.float64) < missing_rate
        P[lo:hi][miss.cpu().numpy()] = UNIFORM
    P.flush()
    del P


def write(path: str, config: dict, seed: int, device: torch.device) -> None:
    """The input of a configuration (n_sites, n_ind, depth_range,
    error_rate, missing_rate) from `seed`."""
    write_callset(path, config["n_sites"], config["n_ind"], config["depth_range"],
                  config["error_rate"], config["missing_rate"], seed, device)
