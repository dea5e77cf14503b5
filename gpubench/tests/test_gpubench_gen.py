"""The input generator repeats exactly from a seed."""

import numpy as np
import torch

from gpubench.gen import lowcov


def _gen(tmp_path, seed, name, S=2 * lowcov.CHUNK_SITES + 37, N=9, depth=(3.0, 3.0)):
    path = str(tmp_path / name)
    lowcov.write_gp(path, S, N, depth, 0.01, seed, torch.device("cpu"))
    return np.fromfile(path).reshape(S, N, 3)


def test_same_seed_same_bytes(tmp_path):
    seed = 2**31 + 12345  # past 32 signed bits, as the benchmark's seeds are
    a, b = _gen(tmp_path, seed, "a"), _gen(tmp_path, seed, "b")
    assert a.tobytes() == b.tobytes()
    assert not np.array_equal(a, _gen(tmp_path, seed + 1, "c"))


def test_posteriors_are_low_coverage_triples(tmp_path):
    P = _gen(tmp_path, 7, "p", S=20000, N=16)
    assert (P >= 0).all() and np.abs(P.sum(-1) - 1).max() < 1e-12
    missing = (P == 1.0 / 3.0).all(-1).mean()
    assert abs(missing - np.exp(-3.0)) < 0.01          # Poisson depth 0 at 3x
    called = P.max(-1) > 0.99
    assert 0.1 < called.mean() < 0.95                   # informative, not certain


def test_each_individual_has_a_depth_of_its_own(tmp_path):
    """Depths drawn from (2, 6), as the phase 1 panel's: an individual's
    share of missing triples is e^-depth, between e^-6 and e^-2."""
    P = _gen(tmp_path, 2**33 + 1, "d", S=20000, N=40, depth=(2.0, 6.0))
    missing = (P == 1.0 / 3.0).all(-1).mean(0)
    assert (missing < np.exp(-2.0) + 0.01).all() and (missing > np.exp(-6.0) - 0.005).all()
    assert missing.max() - missing.min() > 0.05        # not one depth for all


def test_write_takes_the_configuration(tmp_path):
    from gpubench import cells

    cfg = {**cells.load("n1092.boot8").config, "n_ind": 7, "n_sites": 50}
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    lowcov.write(a, cfg, 5, torch.device("cpu"))
    lowcov.write_gp(b, 50, 7, cfg["depth_range"], cfg["error_rate"], 5, torch.device("cpu"))
    assert open(a, "rb").read() == open(b, "rb").read()
