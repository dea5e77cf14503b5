"""The port's main path end to end on the CPU: golden md5 parity through
`python -m ngsdist_tpu_torch --platform cpu`, agreement with the JAX
engine on a seeded random input, its error paths, and the rule that
the package never imports jax."""

import ast
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ngsdist_tpu import cli as jax_cli  # noqa: E402
from ngsdist_tpu_torch import cli  # noqa: E402

from conftest import DATA_DIR, FIXTURES, REPO_ROOT  # noqa: E402

torch.set_num_threads(2)

MANIFEST = json.load(open(os.path.join(FIXTURES, "manifest.json")))
PKG = os.path.join(REPO_ROOT, "ngsdist_tpu_torch")


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_port_golden_md5(name, tmp_path, monkeypatch):
    """The bytes the JAX engine writes on CPU x64 (test_golden_jax.py):
    every golden config matches exactly, none needs the final-digit
    allowance of docs/PARITY.md."""
    monkeypatch.chdir(DATA_DIR)
    calls = _spy_routes(monkeypatch)
    out = str(tmp_path / f"{name}.dist")
    args = [a.replace("{OUT}", out) for a in MANIFEST[name]["args"]]
    rc = cli.main(args + ["--platform", "cpu", "--verbose", "0"])
    assert rc == 0
    md5 = hashlib.md5(open(out, "rb").read()).hexdigest()
    assert md5 == MANIFEST[name]["md5"], f"{name}: port output differs from golden"
    # every bootstrap golden fits the partials budget: one block-mode call
    blocks = sum(n for k, n in calls.items() if k.endswith("_block_partials"))
    assert blocks == ("--n_boot_rep" in args), calls


def _read_matrices(path):
    """phylip stream -> list of [N, N] float arrays."""
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


@pytest.fixture(scope="module")
def random_gp(tmp_path_factory):
    """Seeded binary GP input: Dirichlet triples, ~5% missing rows."""
    rng = np.random.default_rng(2024)
    S, N = 600, 40
    P = rng.dirichlet(np.ones(3), size=(S, N))
    P[rng.random((S, N)) < 0.05] = 1.0 / 3.0
    path = tmp_path_factory.mktemp("gp") / "rand.bin"
    P.astype("<f8").tofile(path)
    return str(path), S, N


@pytest.mark.parametrize("indep", [False, True], ids=["em", "indep"])
@pytest.mark.parametrize("flags", [["--pairwise_del"],
                                   ["--n_boot_rep", "3", "--boot_block_size", "50"]],
                         ids=["pdel", "boot"])
def test_port_matches_jax_engine(random_gp, tmp_path, indep, flags):
    path, S, N = random_gp
    base = ["--geno", path, "--probs", "--n_ind", str(N), "--n_sites", str(S),
            "--seed", "7", "--verbose", "0", *flags]
    if indep:
        base.append("--indep_geno")
    out_j, out_t = str(tmp_path / "jax.dist"), str(tmp_path / "torch.dist")
    assert jax_cli.main(base + ["--out", out_j, "--engine", "jax"]) == 0
    assert cli.main(base + ["--out", out_t, "--platform", "cpu"]) == 0
    mj, mt = _read_matrices(out_j), _read_matrices(out_t)
    assert len(mt) == len(mj) == (4 if "--n_boot_rep" in flags else 1)
    for a, b in zip(mt, mj):
        assert a.shape == (N, N)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


@pytest.mark.parametrize("extra,needle", [
    (["--platform", "cuda"], "no CUDA device"),
    # under --coordinator the JAX CLI's refusals
    # (tests/test_torch_distributed.py holds the others and the run)
    pytest.param(["--platform", "cpu", "--coordinator", "localhost:1", "--devices", "2"],
                 "--devices is not supported with --coordinator",
                 id="coordinator-refuses-devices"),
    (["--platform", "cpu", "--engine", "jax"], "unknown engine 'jax'"),
    (["--platform", "cpu", "--engine", "exact"], "python -m ngsdist_tpu)"),
    # models 3-6 are ported: with a POS file that holds alleles the run succeeds
    (["--platform", "cpu", "--evol_model", "3", "--pos", "pos.txt"], None),
])
def test_port_cli_errors(extra, needle, tmp_path, monkeypatch, capsys):
    if "cuda" in extra and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(DATA_DIR)
    out = str(tmp_path / "x.dist")
    args = ["--geno", "gt.geno.gz", "--n_ind", "20", "--n_sites", "1200",
            "--out", out, "--verbose", "0", *extra]
    if needle is None:
        assert cli.main(args) == 0
        assert "not yet ported" not in capsys.readouterr().err
        (mat,) = _read_matrices(out)
        assert mat.shape == (20, 20) and np.isfinite(mat).all() and (mat == mat.T).all()
        return
    assert cli.main(args) == 255
    assert needle in capsys.readouterr().err


def test_trace_dir_writes_a_trace_and_the_same_bytes(tmp_path, monkeypatch):
    """--trace_dir (utils/profiling.py trace, torch.profiler) writes a
    TensorBoard-format trace of the compute section into the directory,
    holding the operations of the EM's plain version, and the run writes
    the bytes of the same run without it."""
    monkeypatch.chdir(DATA_DIR)
    args = ["--geno", "gp.bin", "--probs", "--n_ind", "20", "--n_sites", "1200", "--seed", "3",
            "--n_boot_rep", "2", "--boot_block_size", "100", "--verbose", "0",
            "--platform", "cpu"]
    plain, traced = str(tmp_path / "plain.dist"), str(tmp_path / "traced.dist")
    trace_dir = tmp_path / "trace"
    assert cli.main(args + ["--out", plain]) == 0
    assert cli.main(args + ["--out", traced, "--trace_dir", str(trace_dir)]) == 0
    assert open(traced, "rb").read() == open(plain, "rb").read()
    files = list(trace_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert "aten::exp" in names   # the EM's plain version, inside the section


SPAN_RUN = ["--geno", "gp.bin", "--probs", "--n_ind", "20", "--n_sites", "1200", "--seed", "3",
            "--n_boot_rep", "2", "--boot_block_size", "100", "--verbose", "0", "--platform",
            "cpu"]

# route -> (flags, PARTIALS_BUDGET_BYTES or None for the default, kernel
# calls or None where the route runs them elsewhere)
SPAN_ROUTES = {
    "partials": ([], None, {"em_raw_cnt": 1, "em_block_partials": 1}),
    "weighted": ([], 0, {"em_raw_cnt": 3}),
    "models3_6": (["--pos", "pos.txt", "--evol_model", "4"], None, None),
    "mesh": (["--devices", "8", "--pairs", "2"], None, None),
}


def _span_run(route, out, monkeypatch):
    from ngsdist_tpu_torch.core import distance as tdist

    flags, budget, want = SPAN_ROUTES[route]
    if budget is not None:
        monkeypatch.setattr(tdist, "PARTIALS_BUDGET_BYTES", budget)
    calls = _spy_routes(monkeypatch)
    assert cli.main(SPAN_RUN + flags + ["--out", out]) == 0
    if want is not None:
        assert calls == want


def _trace_names(trace_dir):
    """The names of the events in the one trace file of trace_dir, in the
    order of their start."""
    (path,) = trace_dir.glob("*.pt.trace.json")
    events = [e for e in json.load(open(path))["traceEvents"] if "ts" in e]
    return [e.get("name") for e in sorted(events, key=lambda e: float(e["ts"]))]


def test_trace_dir_names_spans_with_their_replicate(tmp_path, monkeypatch):
    """In a --trace_dir trace every span of a replicate is one range
    `ngsdist.<span>[r]` (r = 0 the full data), here on the weighted route
    (a kernel call a replicate): one kernel, fetch, matrix and write range
    for each of the 3 matrices, in that order within a replicate; the
    spans outside a replicate carry no index."""
    from ngsdist_tpu_torch.core import distance as tdist

    monkeypatch.chdir(DATA_DIR)
    monkeypatch.setattr(tdist, "PARTIALS_BUDGET_BYTES", 0)
    trace_dir = tmp_path / "trace"
    assert cli.main(SPAN_RUN + ["--out", str(tmp_path / "t.dist"),
                                "--trace_dir", str(trace_dir)]) == 0
    names = _trace_names(trace_dir)
    ours = [n for n in names if n.startswith("ngsdist.")]
    spans = ("kernel", "fetch", "matrix", "write")
    for r in range(3):
        got = [n for n in ours if n.endswith(f"[{r}]")]
        assert got == [f"ngsdist.{s}[{r}]" for s in spans], got
    # outside a replicate: the resident tensor's read and upload, no index
    rest = [n for n in ours if not n.endswith("]")]
    assert set(rest) <= {"ngsdist.read", "ngsdist.upload"}
    assert len(ours) - len(rest) == 3 * len(spans), ours


@pytest.mark.parametrize("route", sorted(SPAN_ROUTES))
def test_spans_fetch_matrix_write_per_replicate(route, tmp_path, monkeypatch):
    """With StageTimes on, a bootstrap of 2 replicates records 3 fetch, 3
    matrix and 3 write intervals on every route (main partials and
    weighted, models 3-6, a CPU mesh), each matrix's in the order fetch,
    matrix, write and before the next matrix's, all within the call."""
    from ngsdist_tpu_torch.utils import profiling

    monkeypatch.chdir(DATA_DIR)
    times = profiling.StageTimes(torch.device("cpu"))
    monkeypatch.setattr(profiling, "ACTIVE", times)
    start = time.perf_counter() - times.t0
    _span_run(route, str(tmp_path / "t.dist"), monkeypatch)
    end = time.perf_counter() - times.t0
    iv = times.intervals()
    assert [len(iv[n]) for n in ("fetch", "matrix", "write")] == [3, 3, 3]
    order = [t for k in range(3) for n in ("fetch", "matrix", "write") for t in iv[n][k]]
    assert order == sorted(order) and start <= order[0] and order[-1] <= end


@pytest.mark.parametrize("route", sorted(SPAN_ROUTES))
def test_spans_off_write_the_same_bytes_and_record_nothing(route, tmp_path, monkeypatch):
    """With StageTimes off and no trace, a run opens no profiler range and
    writes the bytes of the same run with StageTimes on."""
    from ngsdist_tpu_torch.utils import profiling

    monkeypatch.chdir(DATA_DIR)
    on, off = str(tmp_path / "on.dist"), str(tmp_path / "off.dist")
    monkeypatch.setattr(profiling, "ACTIVE", profiling.StageTimes(torch.device("cpu")))
    _span_run(route, on, monkeypatch)
    monkeypatch.setattr(profiling, "ACTIVE", None)
    ranges = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: ranges.append(name))
    _span_run(route, off, monkeypatch)
    assert ranges == [] and profiling._REPLICATE is None
    assert open(off, "rb").read() == open(on, "rb").read()


def test_unported_model_is_refused_after_finalize(tmp_path, monkeypatch, capsys):
    """Models 3-6 are no longer refused.  Params.finalize() still comes
    first: its banners and its fatals (here a missing input file) are
    the JAX runner's.  With the file present the model runs, with the
    JAX runner's banners and, within 1e-9, its matrix."""
    from ngsdist_tpu import runner as jax_runner
    from ngsdist_tpu.config import NgsDistError as JaxError
    from ngsdist_tpu.config import Params as JaxParams
    from ngsdist_tpu_torch import runner
    from ngsdist_tpu_torch.config import NgsDistError, Params

    monkeypatch.chdir(DATA_DIR)
    kw = dict(in_geno="absent.bin", in_bin=True, in_probs=True, n_ind=20, n_sites=1200,
              in_pos="pos.txt", evol_model=4, verbose=1)
    with pytest.raises(JaxError) as want:
        jax_runner.run(JaxParams(out=str(tmp_path / "j.dist"), **kw), engine="jax")
    want_err = capsys.readouterr().err
    with pytest.raises(NgsDistError) as got:
        runner.run(Params(out=str(tmp_path / "t.dist"), **kw), torch.device("cpu"))
    got_err = capsys.readouterr().err
    assert str(got.value) == str(want.value) and "not yet ported" not in str(got.value)
    assert got_err == want_err
    # with the file present the banners still come first, then the model runs
    kw["in_geno"] = "gp.bin"
    want = jax_runner.run(JaxParams(out=str(tmp_path / "j.dist"), **kw), engine="jax")
    want_err = capsys.readouterr().err
    got = runner.run(Params(out=str(tmp_path / "t.dist"), **kw), torch.device("cpu"))
    got_err = capsys.readouterr().err
    assert got_err == want_err and "==> Analyzing full dataset..." in got_err
    assert len(got) == len(want) == 1 and np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-9)
    pars = Params(out=str(tmp_path / "t.dist"), **kw)
    pars.validate()
    pars.finalize()
    assert got_err.startswith("".join(m + "\n" for m in pars.messages))


@pytest.mark.parametrize("reps,route", [(0, None), (3, "weighted"), (3, "partials")],
                         ids=["resident", "weighted_boot", "partials_boot"])
def test_no_zero_row_scan_without_zero_rows(tmp_path, monkeypatch, reps, route):
    """A text input without an empty line: the EM run without pairwise
    deletion records once that no triple is all zero and then neither
    scans the tensor nor poisons, on either bootstrap route; binary
    inputs and runs under pairwise deletion do not even take the record."""
    import gzip

    from ngsdist_tpu_torch import runner
    from ngsdist_tpu_torch.config import Params
    from ngsdist_tpu_torch.core import distance as tdist

    if route == "weighted":
        monkeypatch.setattr(tdist, "PARTIALS_BUDGET_BYTES", 0)
    records, poisons = [], []
    monkeypatch.setattr(tdist, "find_zero_rows",
                        lambda P, _fn=tdist.find_zero_rows: records.append(_fn(P)) or records[-1])
    monkeypatch.setattr(tdist, "_em_poison_pairs",
                        lambda *a, _fn=tdist._em_poison_pairs: poisons.append(1) or _fn(*a))
    assert not hasattr(tdist, "_em_zero_rows")  # the scan of the tensor is gone

    rng = np.random.default_rng(9)
    S, N = 60, 5
    gp = rng.dirichlet(np.ones(3), size=(S, N))
    path = str(tmp_path / "z.geno.gz")
    with gzip.open(path, "wt") as fh:
        for s in range(S):
            fh.write("\t".join(f"{x:.8f}" for x in gp[s].reshape(-1)) + "\n")
    base = dict(in_geno=path, in_probs=True, n_ind=N, n_sites=S, seed=7, verbose=0,
                n_boot_rep=reps, boot_block_size=10)
    got = runner.run(Params(out=str(tmp_path / "a.dist"), **base), torch.device("cpu"))
    assert len(got) == 1 + reps and all(np.isfinite(m).all() for m in got)
    assert records == [None] and poisons == []
    runner.run(Params(out=str(tmp_path / "b.dist"), pairwise_del=True, **base),
               torch.device("cpu"))
    assert records == [None] and poisons == []


def test_port_resume_keys_on_device_and_dtype(tmp_path, monkeypatch):
    """A checkpoint of a CPU float64 run is not resumed by a run whose
    numeric environment differs."""
    from ngsdist_tpu.utils import checkpoint as ckpt
    from ngsdist_tpu_torch.core import distance as tdist

    monkeypatch.chdir(DATA_DIR)
    pars, _ = jax_cli.parse_args(["--geno", "gt.geno.gz", "--n_ind", "20",
                                  "--n_sites", "1200", "--out", str(tmp_path / "x")])
    cpu = tdist.engine_name(torch.device("cpu"), False)
    assert cpu == "torch-cpu-float64"
    assert (ckpt.run_fingerprint(pars, cpu)
            != ckpt.run_fingerprint(pars, "torch-cuda-float32"))


def _spy_routes(monkeypatch):
    """Count the calls of the engine's kernel wrappers, by name."""
    from ngsdist_tpu_torch.core import distance as tdist

    calls = {}
    for name in ("indep_raw_cnt", "em_raw_cnt", "indep_block_partials",
                 "em_block_partials"):
        def spy(*a, _name=name, _fn=getattr(tdist, name), **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(tdist, name, spy)
    return calls


def test_partials_budget_matches_jax():
    from ngsdist_tpu.core import distance as dist
    from ngsdist_tpu_torch.core import distance as tdist

    assert tdist.PARTIALS_BUDGET_BYTES == dist.PARTIALS_BUDGET_BYTES == 1 << 30


def test_partials_rule_at_the_smoke_shapes():
    """The JAX engine's rule, n_blocks·N²·itemsize·(2 under pairwise
    deletion) <= 1 GiB, with the port's itemsize per device: chip_smoke.py
    run (a) takes the weighted route on a card, (c) and (d) the partials
    route; on the CPU (float64) the rule is the JAX engine's own."""
    import chip_smoke
    from ngsdist_tpu_torch.core import distance as tdist

    cuda, cpu = torch.device("cuda"), torch.device("cpu")  # no card needed
    n = chip_smoke.N_IND
    assert not tdist.use_partials(chip_smoke.INDEP_SITES // chip_smoke.BOOT_BLOCK, n, True, cuda,
                                  False)
    assert tdist.use_partials(chip_smoke.EM_SITES // chip_smoke.EM_BOOT_BLOCK, n, False, cuda,
                              False)
    assert tdist.use_partials(chip_smoke.INDEP_SITES // chip_smoke.INDEP_BOOT_BLOCK, n, True,
                              cuda, False)
    for n_blocks, pdel in ((64, False), (64, True), (65, True), (256, True), (1, False)):
        jax_rule = n_blocks * n * n * 8 * (2 if pdel else 1) <= (1 << 30)
        assert tdist.use_partials(n_blocks, n, pdel, cpu, False) == jax_rule


@pytest.mark.parametrize("indep", [False, True], ids=["em", "indep"])
@pytest.mark.parametrize("pairwise_del", [False, True], ids=["nopdel", "pdel"])
def test_port_bootstrap_routes(random_gp, tmp_path, monkeypatch, indep, pairwise_del):
    """Where the rule allows, the bootstrap takes the partials route (one
    block-mode call beside the full-data call); with the budget at 0 the
    weighted route (one call per replicate).  The two routes agree within
    1e-9, and both with the JAX engine."""
    from ngsdist_tpu_torch.core import distance as tdist

    path, S, N = random_gp
    reps = 3
    base = ["--geno", path, "--probs", "--n_ind", str(N), "--n_sites", str(S),
            "--seed", "7", "--verbose", "0", "--n_boot_rep", str(reps),
            "--boot_block_size", "50"]
    base += ["--indep_geno"] if indep else []
    base += ["--pairwise_del"] if pairwise_del else []
    kind = "indep" if indep else "em"
    out_j = str(tmp_path / "jax.dist")
    assert jax_cli.main(base + ["--out", out_j, "--engine", "jax"]) == 0
    mats = {}
    for route, budget in (("partials", tdist.PARTIALS_BUDGET_BYTES), ("weighted", 0)):
        monkeypatch.setattr(tdist, "PARTIALS_BUDGET_BYTES", budget)
        calls = _spy_routes(monkeypatch)
        out = str(tmp_path / f"{route}.dist")
        assert cli.main(base + ["--out", out, "--platform", "cpu"]) == 0
        want = ({f"{kind}_raw_cnt": 1, f"{kind}_block_partials": 1} if route == "partials"
                else {f"{kind}_raw_cnt": 1 + reps})
        assert calls == want, route
        mats[route] = _read_matrices(out)
    mj = _read_matrices(out_j)
    assert len(mats["partials"]) == len(mats["weighted"]) == len(mj) == 1 + reps
    for a, b, c in zip(mats["partials"], mats["weighted"], mj):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-9)


def test_port_bootstrap_weighted_when_partials_leave_no_room(random_gp, tmp_path,
                                                             monkeypatch):
    """On a card the float64 partials must also fit the memory that
    check_fits leaves beside the resident tensor; where they do not, the
    replicates take the weighted route."""
    from ngsdist_tpu_torch.core import distance as tdist

    path, S, N = random_gp
    monkeypatch.setattr(tdist, "check_fits", lambda *a: 0)  # no bytes left
    calls = _spy_routes(monkeypatch)
    args = ["--geno", path, "--probs", "--n_ind", str(N), "--n_sites", str(S),
            "--seed", "7", "--verbose", "0", "--n_boot_rep", "2",
            "--boot_block_size", "50", "--out", str(tmp_path / "x.dist")]
    assert cli.main(args + ["--platform", "cpu"]) == 0
    assert calls == {"em_raw_cnt": 3}


def _resume_case(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(DATA_DIR)
    case = MANIFEST["T_b5"]
    out = str(tmp_path / "x.dist")
    args = [a.replace("{OUT}", out) for a in case["args"]]
    args += ["--platform", "cpu", "--verbose", "0"]
    assert cli.main(args) == 0
    full = open(out, "rb").read()
    # keep the first two matrices and a sidecar saying so
    from ngsdist_tpu.utils import checkpoint as ckpt
    from ngsdist_tpu_torch.core import distance as tdist

    blocks = full.split(b"\n20\n")
    open(out, "wb").write(b"\n20\n".join(blocks[:3]))
    pars, _ = jax_cli.parse_args(args)
    pars.finalize()
    ckpt.save(out, pars, 2, engine=tdist.engine_name(torch.device("cpu"), False))
    capsys.readouterr()
    calls = _spy_routes(monkeypatch)
    assert cli.main(args + ["--resume", "--verbose", "1"]) == 0
    assert "Resuming: 2 matrices already written" in capsys.readouterr().err
    assert open(out, "rb").read() == full
    return calls


def test_port_resume_appends_remaining(tmp_path, monkeypatch, capsys):
    """Through the partials route: the resumed run skips the full-data
    call and the replicates already written."""
    calls = _resume_case(tmp_path, monkeypatch, capsys)
    assert calls == {"indep_block_partials": 1}


def test_port_resume_appends_remaining_weighted(tmp_path, monkeypatch, capsys):
    from ngsdist_tpu_torch.core import distance as tdist

    monkeypatch.setattr(tdist, "PARTIALS_BUDGET_BYTES", 0)
    calls = _resume_case(tmp_path, monkeypatch, capsys)
    assert calls == {"indep_raw_cnt": 4}  # replicates 2..5


def test_port_never_imports_jax():
    """No module of the port imports jax: it must run where jax is not
    installed."""
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            tree = ast.parse(open(path).read(), path)
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                if any(n == "jax" or n.startswith("jax.") for n in names):
                    offenders.append(f"{path}:{node.lineno}")
    assert not offenders, offenders


def test_port_cli_runs_without_jax(tmp_path):
    """The whole CPU path, the port's own host layer included, runs in a
    process where jax cannot be imported."""
    out = str(tmp_path / "x.dist")
    args = [a.replace("{OUT}", out) for a in MANIFEST["GL_pdel"]["args"]]
    code = ("import sys; sys.modules['jax'] = None; "
            "from ngsdist_tpu_torch.cli import main; "
            "sys.exit(main(sys.argv[1:]))")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    proc = subprocess.run([sys.executable, "-c", code, *args, "--platform",
                           "cpu", "--verbose", "0"], cwd=DATA_DIR, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    md5 = hashlib.md5(open(out, "rb").read()).hexdigest()
    assert md5 == MANIFEST["GL_pdel"]["md5"]


@pytest.mark.parametrize("pairwise_del", [False, True], ids=["nopdel", "pdel"])
@pytest.mark.parametrize("reps,route", [(0, None), (3, "weighted"), (3, "partials")],
                         ids=["resident", "weighted_boot", "partials_boot"])
def test_em_zero_site_nan_parity(tmp_path, monkeypatch, pairwise_del, reps, route):
    """An empty text line parses to a (0,0,0) site.  Without pairwise
    deletion the reference's EM gets a NaN loglik there and poisons every
    pair at that site (ngsDist.cpp:348-349): the whole matrix.  The
    port's EM path (resident, and the bootstrap on either route, the
    partials route poisoning per block) must give the NaN pattern and
    values of the JAX package's exact oracle, as
    tests/test_jax_engine.py::test_em_zero_site_nan_parity pins for the
    JAX engine."""
    import gzip

    from ngsdist_tpu import runner as jax_runner
    from ngsdist_tpu.config import Params
    from ngsdist_tpu_torch import runner
    from ngsdist_tpu_torch.core import distance as tdist

    if route == "weighted":
        monkeypatch.setattr(tdist, "PARTIALS_BUDGET_BYTES", 0)
    calls = _spy_routes(monkeypatch)

    rng = np.random.default_rng(9)
    S, N = 60, 5
    gp = rng.dirichlet(np.ones(3), size=(S, N))
    path = str(tmp_path / "z.geno.gz")
    with gzip.open(path, "wt") as fh:
        for s in range(S):
            fh.write("" if s == 17 else "\t".join(f"{x:.8f}" for x in gp[s].reshape(-1)))
            fh.write("\n")
    base = dict(in_geno=path, in_probs=True, n_ind=N, n_sites=S, seed=7, verbose=0,
                pairwise_del=pairwise_del, n_boot_rep=reps, boot_block_size=10)
    want = jax_runner.run(Params(out=str(tmp_path / "a.dist"), **base), engine="exact")
    got = runner.run(Params(out=str(tmp_path / "b.dist"), **base), torch.device("cpu"))
    assert len(got) == len(want) == 1 + reps
    assert calls.get("em_block_partials", 0) == (route == "partials")
    for mw, mg in zip(want, got):
        np.testing.assert_array_equal(np.isnan(mg), np.isnan(mw))
        ok = ~np.isnan(mw)
        np.testing.assert_allclose(mg[ok], mw[ok], rtol=0, atol=1e-10)
    if not pairwise_del:
        assert np.isnan(want[0][~np.eye(N, dtype=bool)]).all()
