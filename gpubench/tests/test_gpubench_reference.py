"""The plain reference against the port run on the CPU (--platform cpu,
the port's float64 path) at a tiny size: every stage the benchmark's
check covers, and the whole run's phylip file.  This test may import
both; the reference imports nothing of the port."""

import numpy as np
import pytest
import torch

from gpubench.checks import ngsdist_em as check
from gpubench.gen import lowcov
from gpubench.programs import ngsdist_cli
from gpubench.reference import ngsdist as ref
from gpubench.reference import taus

N, S = 14, 611


@pytest.fixture(scope="module")
def geno(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gp") / "geno.bin")
    lowcov.write_gp(path, S, N, (2.0, 4.0), 0.01, 2**31 + 99, torch.device("cpu"))
    return path


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 + 77, 2**40 + 3])
def test_taus_stream_is_the_ports(seed):
    from ngsdist_tpu_torch.utils.rng import boot_block_indices

    want = boot_block_indices(seed, 3, 257).astype(np.int64)
    assert np.array_equal(taus.block_table(seed, 3, 257), want)


def test_reader_normalisation_is_the_ports(tmp_path):
    from ngsdist_tpu_torch.core.preprocess import preprocess
    from ngsdist_tpu_torch.io import readers

    rng = np.random.default_rng(3)
    raw = rng.random((50, 6, 3)) * 3       # unnormalised, with zeros and a zero triple
    raw[rng.random((50, 6, 3)) < 0.1] = 0.0
    raw[4, 2] = 0.0
    path = str(tmp_path / "x.bin")
    raw.tofile(path)
    want = preprocess(readers.read_geno(path, True, True, False, 6, 50), False, 0.0, 0.0)
    got = ref.read_binary_gp(path, 6, 50, torch.device("cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=1e-300)


@pytest.mark.parametrize("n_ind", [2, 3, 12, 1024])
def test_sampled_pairs_take_in_every_individual(n_ind):
    for seed in range(20):
        I, J = ref.sample_pairs(n_ind, 2, seed)
        assert (I < J).all() and set(I) | set(J) == set(range(n_ind))
        assert len(set(zip(I, J))) == len(I)


def test_em_is_the_ports_plain_version(geno):
    from ngsdist_tpu_torch.ops.em import em_raw_cnt_ref

    P = ref.read_binary_gp(geno, N, S, torch.device("cpu"))
    I, J = np.triu_indices(N, 1)
    contrib, steps = ref.pair_site_em(P, I, J)
    raw, cnt = em_raw_cnt_ref(P, np.array(ref.SCORE).reshape(-1), False)
    np.testing.assert_allclose(contrib.sum(0).numpy(), raw[I, J].numpy(), rtol=1e-12)
    assert (cnt[I, J] == S).all() and (steps >= 1).all() and (steps <= 50).all()


@pytest.mark.parametrize("args", [
    ["--probs"],
    ["--probs", "--n_boot_rep", "3", "--boot_block_size", "5"],
    ["--probs", "--n_boot_rep", "2", "--boot_block_size", "37", "--evol_model", "2"],
    ["--probs", "--n_boot_rep", "2", "--boot_block_size", "1", "--evol_model", "0"],
], ids=["full", "boot5", "boot37_jc", "boot1_raw"])
def test_whole_run_matches_the_port(geno, tmp_path, args):
    from ngsdist_tpu_torch import cli

    opts = check.options(args)
    out = str(tmp_path / "o.dist")
    boot = 2**32 + 5
    assert cli.main(ngsdist_cli.command({"n_ind": N, "n_sites": S}, {"args": args}, geno,
                                        out, boot, "cpu")) == 0
    I, J = np.triu_indices(N, 1)            # every pair at this size
    P = ref.read_binary_gp(geno, N, S, torch.device("cpu"))
    contrib, _ = ref.pair_site_em(P, I, J)
    expected = ref.distances(contrib, boot, opts["n_boot_rep"], opts["boot_block_size"],
                             opts["evol_model"])
    d_err, bad, faults = check.judge_file(out, expected, I, J, N)
    assert bad == 0 and not faults
    assert d_err <= 5.0001e-11               # %.10f rounding alone


def test_phylip_faults_are_seen(geno, tmp_path):
    from ngsdist_tpu_torch import cli

    args = ["--probs", "--n_boot_rep", "2", "--boot_block_size", "5"]
    out = str(tmp_path / "o.dist")
    assert cli.main(ngsdist_cli.command({"n_ind": N, "n_sites": S}, {"args": args}, geno,
                                        out, 9, "cpu")) == 0
    text = open(out).read()
    blocks = text.split("\n\n")
    for broken in (text[: len(text) // 2],                        # cut short
                   "\n\n".join(blocks[:2]) + "\n",               # a matrix missing
                   text.replace("Ind_3\t", "Ind_x\t"),           # a label
                   text + "junk\n"):                             # trailing text
        path = str(tmp_path / "b.dist")
        open(path, "w").write(broken)
        _, bad, _ = check.judge_file(path, np.zeros((3, 1)), np.array([0]), np.array([1]), N)
        assert bad > 0
