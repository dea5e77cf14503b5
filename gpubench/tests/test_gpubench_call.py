"""The called-genotype cell (n300.call_boot8) through the harness on the
CPU at a tiny size: its generator, its check against the port, the
faults the check must see, its control, its per-layer readers, and the
routes the two cells of its kind take at their own shapes."""

import time

import numpy as np
import pytest
import torch

from gpubench import cells, control, roofline, roofline_indep, run
from gpubench.gen import callset, lowcov

CPU = torch.device("cpu")
SEED = 2**31 + 5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tensors here are small: one intra-op thread runs them faster
    than a pool that waits on a busy host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def call_cell(monkeypatch):
    """make(n_ind, n_sites, args): n300.call_boot8 at a size the CPU runs
    in a fraction of a second, on the cell's route on the card: read
    through the fused codes reader and the code plane
    (NGSDIST_CODED_UPLOAD=1), replicates by weighted recompute (at this
    size the block partials would fit the budget for partial sums)."""
    from ngsdist_tpu_torch.core import distance

    monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "1")
    monkeypatch.setattr(distance, "PARTIALS_BUDGET_BYTES", 0)
    big = cells.load("n300.call_boot8")

    def make(n_ind=24, n_sites=900, args=None):
        traffic = big.traffic if args is None else {**big.traffic, "args": list(args)}
        return cells.Cell(name="tiny", chips=1,
                          config={**big.config, "n_ind": n_ind, "n_sites": n_sites},
                          traffic=traffic, limits=big.limits, end_to_end=big.end_to_end,
                          per_layer=big.per_layer)

    return make


def _run(cell, seconds=1.0, traced=False, seed=SEED):
    return run.run_cell(cell, seed, seconds, traced, CPU, time.perf_counter())


def test_callset_repeats_and_leaves_its_share_uncalled(tmp_path):
    S, N = lowcov.CHUNK_SITES + 321, 30
    paths = [str(tmp_path / n) for n in "abc"]
    for path, seed in zip(paths, (2**35 + 1, 2**35 + 1, 2**35 + 2)):
        callset.write_callset(path, S, N, (35.0, 50.0), 0.01, 0.02, seed, CPU)
    a, b, c = (np.fromfile(p).reshape(S, N, 3) for p in paths)
    assert a.tobytes() == b.tobytes() and not np.array_equal(a, c)
    missing = (a == callset.UNIFORM).all(-1)
    assert abs(missing.mean() - 0.02) < 0.003
    called = a[~missing].max(-1)
    assert (called > 0.999).mean() > 0.99          # 35-50x: nearly every call certain
    base = str(tmp_path / "base")
    lowcov.write_gp(base, S, N, (35.0, 50.0), 0.01, 2**35 + 1, CPU)
    assert np.array_equal(np.fromfile(base).reshape(S, N, 3)[~missing], a[~missing])


@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(call_cell, traced):
    res = _run(call_cell(), traced=traced)
    assert res["correct"], res["checks"]
    assert res["checks"]["d_err"]["value"] <= 5.0001e-11   # float64: the print alone
    if traced:
        assert {"read_s", "upload_s", "kernel_s", "expand_s"} <= set(res["metrics"])
    else:
        assert set(res["metrics"]) == {"run_s", "updates_per_s", "setup_s"}


def test_one_call_flipped(call_cell, monkeypatch):
    from ngsdist_tpu_torch.io import readers

    real = readers.read_geno_codes

    def flipped(*a, **k):
        codes, any_missing = real(*a, **k)
        if codes.shape[0] > 7:
            codes[7, 3] = (codes[7, 3] + 1) % 3     # a called genotype, one allele off
        return codes, any_missing

    monkeypatch.setattr(readers, "read_geno_codes", flipped)
    res = _run(call_cell())
    assert not res["correct"] and res["checks"]["d_err"]["value"] > 1e-4


def test_a_missing_pair_counted(call_cell, monkeypatch):
    """Pairwise deletion that keeps the sites where a call is missing."""
    from ngsdist_tpu_torch.ops import indep

    real = indep.valid_mask
    monkeypatch.setattr(indep, "valid_mask", lambda P, pairwise_del: real(P, False))
    res = _run(call_cell())
    assert not res["correct"] and res["checks"]["d_err"]["value"] > 1e-4


def test_one_replicate_from_another_seed(call_cell, monkeypatch):
    from ngsdist_tpu_torch.core import distance

    real = distance.bootstrap_site_maps

    def mixed(seed, n_boot_rep, n_sites, block_size):
        n_trunc, maps = real(seed, n_boot_rep, n_sites, block_size)
        _, other = real(seed + 1, n_boot_rep, n_sites, block_size)
        return n_trunc, [*maps[:3], other[3], *maps[4:]]

    monkeypatch.setattr(distance, "bootstrap_site_maps", mixed)
    res = _run(call_cell())
    assert not res["correct"] and res["checks"]["d_err"]["value"] > 1e-4


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_the_limit(call_cell, seed):
    """The control, the reference with its sums over sites in bfloat16,
    in the program's place at 48 individuals over 2,000 sites."""
    cell = call_cell(n_ind=48, n_sites=2000)
    (ctl, entry), = control.controls(cell, seed, CPU).values()
    res = run.run_cell(ctl, seed, 0.01, False, CPU, time.perf_counter(), entry=entry,
                       warm_up=False)
    assert not res["correct"]
    assert res["checks"]["d_err"]["value"] > 100 * cell.limits["d_err"]["limit"]
    assert res["checks"]["bad_matrices"]["value"] == 0


def test_options_refuse_what_the_reference_lacks(call_cell):
    check = call_cell().check
    assert check.options(["--probs", "--call_geno"])["pairwise_del"] is False
    for args in (["--probs"], ["--probs", "--call_geno", "--x64"],
                 ["--probs", "--call_geno", "--evol_model", "3"],
                 ["--probs", "--call_geno", "--N_thresh", "0.3"]):
        with pytest.raises(ValueError):
            check.options(args)


RECORD = {
    "window": (0.0, 10.0),
    "runs": [
        {"start": 0.0, "end": 4.0, "wall_s": 4.0, "bound_s": {"indep_": 0.01},
         "spans": {"upload": [(0.5, 2.0)], "expand": [(0.6, 0.8), (0.7, 1.0), (1.5, 1.75)]}},
        {"start": 4.5, "end": 9.0, "wall_s": 4.5, "bound_s": {"indep_": 0.01},
         "spans": {"upload": [(5.0, 6.0)], "expand": [(5.5, 6.0)]}},
    ],
    "device": [("void indep_mma_kernel(...)", 2.0, 2.3),
               ("void indep_reduce_kernel<float>(...)", 2.3, 2.4),
               ("void em_kernel<float, false>(...)", 2.5, 3.5),
               ("indexSelectLargeIndex", 0.6, 0.8),
               ("void indep_mma_kernel(...)", 7.0, 7.1),
               ("void indep_mma_kernel(...)", 9.5, 11.0)],   # the cut run, past the end
}


def _reader(name):
    return cells.module("metrics", name).read


def test_indep_roofline_and_expand_s_by_hand():
    # indep_: 0.3 + 0.1 in run A, 0.1 in run B; bounds 0.01 each
    assert _reader("indep_roofline")(RECORD) == pytest.approx(100 * 0.02 / 0.5)
    # the union of A's expand spans 0.4 + 0.25, B's 0.5
    assert _reader("expand_s")(RECORD) == pytest.approx((0.65 + 0.5) / 2)
    none = {**RECORD, "device": [d for d in RECORD["device"] if "indep_" not in d[0]],
            "runs": [{**r, "spans": {"upload": r["spans"]["upload"]}} for r in RECORD["runs"]]}
    assert _reader("indep_roofline")(none) is None and _reader("expand_s")(none) is None
    em_only = {**RECORD, "runs": [{**r, "bound_s": {"em_kernel": 0.1}} for r in RECORD["runs"]]}
    assert _reader("indep_roofline")(em_only) is None


def test_indep_bound_counts_the_data_once():
    b = roofline_indep.indep_bound_s(262144, 300, 9, True)
    n_pairs = 300 * 299 // 2
    assert b["flop"] == 8 * 262144 * n_pairs
    assert b["bytes"] == 12 * 262144 * 300 + 9 * 8 * n_pairs
    assert b["seconds"] == max(b["flop"] / roofline_indep.PEAK_TF32,
                               b["bytes"] / roofline.PEAK_BYTES)
    assert roofline_indep.indep_bound_s(1000, 10, 1, False)["flop"] == 6 * 1000 * 45


@pytest.mark.parametrize("name, partials", [("n300.call_boot8", False),
                                            ("n1092.boot24_partials", True)])
def test_each_cell_takes_its_route_on_the_card(name, partials):
    """The port's rule at each cell's own shape on a card (float32): the
    called cell's block partials are too large, so its replicates are
    weighted recomputes; the partials cell's fit."""
    from ngsdist_tpu_torch.core import distance

    cell = cells.load(name)
    opts, cfg = cell.options, cell.config
    n_blocks = cfg["n_sites"] // opts["boot_block_size"]
    assert distance.use_partials(n_blocks, cfg["n_ind"], opts.get("pairwise_del", False),
                                 torch.device("cuda", 0), False) is partials
