"""`python -m ngsdist_tpu_torch --platform cpu --devices 8 [--pairs K]`
against `python -m ngsdist_tpu --engine jax --devices 8 [--pairs K]` on
the golden fixtures (the JAX side on its virtual 8-device CPU mesh in
x64, tests/conftest.py), and the CLI's mesh options and their errors.

Every model family (EM and indep of models 0-2, hard genotypes, models
3-6 under both kernels) runs on three meshes: 8 x 1, whose bootstrap
takes the partial-sum route, and 4 x 2 and 2 x 4, which take the
weighted recompute (a pairs axis has no block partials); and under a
forced NGSDIST_DEVICE_BUDGET, streamed in site rounds.  The phylip
values agree within 1e-9 (both print %.10f of float64 sums taken in
other orders)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ngsdist_tpu import cli as jax_cli  # noqa: E402
from ngsdist_tpu_torch import cli  # noqa: E402
from ngsdist_tpu_torch.config import NgsDistError  # noqa: E402

from conftest import DATA_DIR  # noqa: E402

torch.set_num_threads(2)

FAMILIES = {
    "em": "--geno gl.beagle.gz --probs --n_boot_rep 3 --boot_block_size 10",
    "em_pdel": "--geno gl.beagle.gz --probs --pairwise_del --n_boot_rep 2 --boot_block_size 50",
    "hard": "--geno gt.geno.gz --n_boot_rep 5 --boot_block_size 7",
    "indep_pdel": "--geno gp.geno.gz --probs --pairwise_del --indep_geno --n_boot_rep 2 "
                  "--boot_block_size 40",
    "tn93_em": "--geno gl.beagle.gz --probs --pos pos.txt --evol_model 6 --n_boot_rep 2 "
               "--boot_block_size 50",
    "f84_indep": "--geno gl.beagle.gz --probs --pos pos.txt --evol_model 5 --indep_geno "
                 "--pairwise_del --n_boot_rep 1 --boot_block_size 50",
}


def _read_matrices(path):
    mats, rows = [], []
    for line in open(path).read().split("\n"):
        parts = line.split("\t")
        if len(parts) > 1:
            rows.append([float(v) for v in parts[1:]])
        elif rows:
            mats.append(np.array(rows))
            rows = []
    if rows:
        mats.append(np.array(rows))
    return mats


def _both(tmp_path, flags, mesh_flags):
    base = flags.split() + ["--n_ind", "20", "--n_sites", "1200", "--seed", "7",
                            "--verbose", "0", *mesh_flags]
    out_j, out_t = str(tmp_path / "jax.dist"), str(tmp_path / "torch.dist")
    assert jax_cli.main(base + ["--out", out_j, "--engine", "jax"]) == 0
    assert cli.main(base + ["--out", out_t, "--platform", "cpu"]) == 0
    want, got = _read_matrices(out_j), _read_matrices(out_t)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.shape == (20, 20)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g[~np.isnan(w)], w[~np.isnan(w)], rtol=0, atol=1e-9)


@pytest.mark.parametrize("pairs", ["1", "2", "4"], ids=["8x1", "4x2", "2x4"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cli_mesh_matches_jax(tmp_path, monkeypatch, family, pairs):
    monkeypatch.chdir(DATA_DIR)
    _both(tmp_path, FAMILIES[family], ["--devices", "8", "--pairs", pairs])


@pytest.mark.parametrize("family", ["em", "hard", "indep_pdel", "tn93_em"])
def test_cli_mesh_streamed_matches_jax(tmp_path, monkeypatch, family):
    """Under a budget of about 40 sites a shard, both engines stream
    the same rounds: indep on 8 x 1 in one pass of block partials, the
    others round by round."""
    monkeypatch.chdir(DATA_DIR)
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(3 * 40 * 20 * 3 * 8))
    _both(tmp_path, FAMILIES[family], ["--devices", "8"])


def test_cli_mesh_trace_dir_writes_a_trace_and_the_same_bytes(tmp_path, monkeypatch):
    """--trace_dir on a 4 x 2 mesh of `cpu` entries: one trace file of the
    compute section, with the indep plain version's einsum in it, and the
    bytes of the same run without it."""
    monkeypatch.chdir(DATA_DIR)
    args = ["--geno", "gp.bin", "--probs", "--indep_geno", "--pairwise_del", "--n_ind", "20",
            "--n_sites", "1200", "--seed", "7", "--n_boot_rep", "2", "--boot_block_size",
            "100", "--verbose", "0", "--platform", "cpu", "--devices", "8", "--pairs", "2"]
    plain, traced = str(tmp_path / "plain.dist"), str(tmp_path / "traced.dist")
    trace_dir = tmp_path / "trace"
    assert cli.main(args + ["--out", plain]) == 0
    assert cli.main(args + ["--out", traced, "--trace_dir", str(trace_dir)]) == 0
    assert open(traced, "rb").read() == open(plain, "rb").read()
    files = list(trace_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert "aten::einsum" in names


@pytest.mark.parametrize("extra,needle", [
    (["--devices", "6", "--pairs", "4"], "6 devices do not factor into pairs=4"),
    # the multi-process flags run under --coordinator (tests/
    # test_torch_distributed.py); alone they are refused
    pytest.param(["--num_processes", "2"], "--num_processes needs --coordinator",
                 id="num_processes-needs-coordinator"),
    pytest.param(["--process_id", "0"], "--process_id needs --coordinator",
                 id="process_id-needs-coordinator"),
])
def test_cli_mesh_errors(extra, needle, tmp_path, monkeypatch, capsys):
    """A device count that --pairs does not divide is the JAX package's
    error; the multi-process flags need a coordinator."""
    monkeypatch.chdir(DATA_DIR)
    args = ["--geno", "gt.geno.gz", "--n_ind", "20", "--n_sites", "1200", "--platform", "cpu",
            "--out", str(tmp_path / "x.dist"), "--verbose", "0", *extra]
    assert cli.main(args) == 255
    assert needle in capsys.readouterr().err


def test_cli_mesh_builds_cpu_shards_and_refuses_missing_cards(monkeypatch):
    """On the CPU --devices N is N `cpu` entries; on cuda, asking for more
    cards than are visible is an error that names both counts, never a
    smaller mesh (the card count is patched: no card here)."""
    cpu = torch.device("cpu")
    mesh = cli._mesh(cpu, "8", "2")
    assert mesh.shape == {"sites": 4, "pairs": 2} and mesh.devices == [cpu] * 8
    assert cli._mesh(cpu, "1", None) is None and cli._mesh(cpu, None, None) is None
    assert cli._mesh(cpu, "all", None).devices == [cpu]   # no card: every device is one
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = torch.device("cuda", 0)
    mesh = cli._mesh(cuda, "2", "2")
    assert mesh.devices == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert mesh.shape == {"sites": 1, "pairs": 2}
    assert cli._mesh(cuda, "all", None).devices == mesh.devices
    with pytest.raises(NgsDistError, match="--devices 4: only 2 CUDA devices are visible"):
        cli._mesh(cuda, "4", None)


def test_runner_declines_the_fused_read_on_a_mesh(tmp_path):
    """A raw binary file goes to a mesh run as the host tensor, which the
    mesh shards (ngsdist_tpu/runner.py:44)."""
    from ngsdist_tpu_torch import runner
    from ngsdist_tpu_torch.config import Params
    from ngsdist_tpu_torch.parallel import make_mesh

    path = tmp_path / "g.bin"
    np.full((10, 4, 3), 1 / 3).tofile(path)
    pars = Params(in_geno=str(path), in_bin=True, in_probs=True, n_ind=4, n_sites=10)
    mesh = make_mesh([torch.device("cpu")] * 2)
    assert not runner._fused_packed_wanted(pars, torch.device("cuda"), mesh)
