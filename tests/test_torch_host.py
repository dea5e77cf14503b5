"""The port's own host layer (parser, readers, preprocessing, writer,
bootstrap stream, checkpoints, native runtime) against the JAX package's
modules it was copied from, on the same inputs: equal values, equal
bytes."""

import io
import json
import multiprocessing
import os

import numpy as np
import pytest

from ngsdist_tpu import cli as jcli
from ngsdist_tpu.core import bootstrap as jboot
from ngsdist_tpu.core import models as jmodels
from ngsdist_tpu.core import preprocess as jpre
from ngsdist_tpu.core import submodels as jsub
from ngsdist_tpu.io import readers as jreaders
from ngsdist_tpu.io import writers as jwriters
from ngsdist_tpu.utils import checkpoint as jckpt
from ngsdist_tpu.utils import rng as jrng
from ngsdist_tpu_torch import cli as tcli
from ngsdist_tpu_torch.core import bootstrap as tboot
from ngsdist_tpu_torch.core import models as tmodels
from ngsdist_tpu_torch.core import preprocess as tpre
from ngsdist_tpu_torch.core import submodels as tsub
from ngsdist_tpu_torch.io import readers as treaders
from ngsdist_tpu_torch.io import writers as twriters
from ngsdist_tpu_torch.utils import checkpoint as tckpt
from ngsdist_tpu_torch.utils import native as tnative
from ngsdist_tpu_torch.utils import rng as trng

from conftest import DATA_DIR, FIXTURES

MANIFEST = json.load(open(os.path.join(FIXTURES, "manifest.json")))

# (file, in_bin, in_probs, in_logscale, n_ind, n_sites): every reader format
GENO_FILES = {
    "hard_gz": ("gt.geno.gz", False, False, False, 20, 1200),
    "beagle_gl": ("gl.beagle.gz", False, True, False, 20, 1200),
    "beagle_gl24": ("gl24.beagle.gz", False, True, False, 24, 10000),
    "log_gl": ("gl_log.geno.gz", False, True, True, 20, 1200),
    "text_gp": ("gp.geno.gz", False, True, False, 20, 1200),
    "binary_gp": ("gp.bin", True, True, False, 20, 1200),
}


def _params_dict(pars):
    d = dict(vars(pars))
    d["score"] = None if d.get("score") is None else np.asarray(d["score"]).tolist()
    return d


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_parse_and_echo_match(name, capsys, monkeypatch):
    """parse_args / echo_args / finalize on every golden argument list:
    equal Params, equal extras, equal stderr."""
    monkeypatch.chdir(DATA_DIR)
    args = [a.replace("{OUT}", "x.dist") for a in MANIFEST[name]["args"]]
    args += ["--platform", "cpu", "--resume", "--thr"]
    got = {}
    for key, mod in (("jax", jcli), ("torch", tcli)):
        pars, extras = mod.parse_args(args)
        mod.echo_args(pars)
        pars.validate()
        pars.finalize()
        got[key] = (_params_dict(pars), extras, capsys.readouterr().err)
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][1] == got["jax"][1]
    assert got["torch"][2] == got["jax"][2] and "==> Input Arguments:" in got["jax"][2]


@pytest.mark.parametrize("argv", [
    ["--bogus"], ["--n"], ["--geno"], ["-g", "f", "--pair", "--e", "2", "-x", "4"],
    ["--N_thresh", "inf", "--call_thresh", "0x1.8p3", "-seed", "12abc"],
], ids=["unknown", "ambiguous", "no_arg", "prefixes", "c_numbers"])
def test_parser_corner_cases_match(argv, capsys):
    got = []
    for mod in (jcli, tcli):
        try:
            pars, extras = mod.parse_args(argv)
            res = (_params_dict(pars), extras)
        except SystemExit as ex:
            res = ("exit", ex.code)
        got.append((res, capsys.readouterr().err))
    assert got[0] == got[1]


@pytest.mark.parametrize("fmt", sorted(GENO_FILES))
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_readers_match(fmt, native):
    path, in_bin, in_probs, in_log, n_ind, n_sites = GENO_FILES[fmt]
    path = os.path.join(DATA_DIR, path)
    want = jreaders.read_geno(path, in_bin, in_probs, in_log, n_ind, n_sites, native=native)
    got = treaders.read_geno(path, in_bin, in_probs, in_log, n_ind, n_sites, native=native)
    assert got.shape == (n_sites, n_ind, 3) and got.dtype == np.float64
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("call_geno,N_thresh,call_thresh",
                         [(False, 0.0, 0.0), (True, 0.0, 0.0), (True, 0.4, 0.9)])
def test_preprocess_matches(call_geno, N_thresh, call_thresh):
    path, in_bin, in_probs, in_log, n_ind, n_sites = GENO_FILES["beagle_gl"]
    geno = jreaders.read_geno(os.path.join(DATA_DIR, path), in_bin, in_probs, in_log,
                              n_ind, n_sites)
    want = jpre.preprocess(geno.copy(), call_geno, N_thresh, call_thresh)
    got = tpre.preprocess(geno.copy(), call_geno, N_thresh, call_thresh)
    assert got.tobytes() == want.tobytes()


def test_labels_and_positions_match():
    for name, header in (("labels.txt", False), ("labelsH.txt", True)):
        path = os.path.join(DATA_DIR, name)
        assert (treaders.read_labels(path, header, 20)
                == jreaders.read_labels(path, header, 20))
    for name, header in (("pos.txt", False), ("posH.txt", True)):
        path = os.path.join(DATA_DIR, name)
        assert treaders.read_pos(path, header, 1200) == jreaders.read_pos(path, header, 1200)
    assert treaders.default_labels(3) == jreaders.default_labels(3) == ["Ind_0", "Ind_1", "Ind_2"]


@pytest.mark.parametrize("n", [1, 7, 40])
def test_write_dist_matrix_same_bytes(n):
    rng = np.random.default_rng(n)
    m = rng.random((n, n)) * 10.0 ** rng.integers(-12, 6, size=(n, n))
    m[0, 0] = 0.0
    if n > 1:
        m[0, 1], m[1, 0] = np.nan, np.inf
        m[1, 1] = -np.inf
    labels = [f"ind{i}" for i in range(n)]
    out = []
    for mod in (jwriters, twriters):
        fh = io.StringIO()
        mod.write_dist_matrix(fh, labels, m)
        out.append(fh.getvalue())
    assert out[0] == out[1] and out[0].startswith(f"\n{n}\n")


@pytest.mark.parametrize("seed", [0, 4242, 2**31 + 12345])
def test_bootstrap_site_maps_match(seed):
    """The taus stream: equal maps from the port's native runtime, the
    JAX package's, and both pure-Python streams."""
    n_reps, n_sites, bs = 5, 1203, 10
    want_trunc, want = jboot.site_maps(seed, n_reps, n_sites, bs)
    for native in (True, False):
        got_trunc, got = tboot.site_maps(seed, n_reps, n_sites, bs, native=native)
        assert got_trunc == want_trunc == 1200
        assert len(got) == n_reps
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    table = tboot.block_index_table(seed, n_reps, 120)
    assert np.array_equal(table, jboot.block_index_table(seed, n_reps, 120))
    assert np.array_equal(table, trng.boot_block_indices(seed, n_reps, 120))
    assert np.array_equal(table, jrng.boot_block_indices(seed, n_reps, 120))
    assert np.array_equal(tboot.block_multiplicity(table, 120),
                          jboot.block_multiplicity(table, 120))


@pytest.mark.parametrize("model", [0, 1, 2])
def test_evol_models_match(model):
    d = np.random.default_rng(model).random((6, 6)) * 0.7
    assert (tmodels.apply_evol_model(d, model).tobytes()
            == jmodels.apply_evol_model(d, model).tobytes())


def _submodel_inputs(seed, S=40, N=5):
    rng = np.random.default_rng(seed)
    letters = np.array(list("ACGTacgt0123N-"))
    rows = [["chr1", str(s + 1), *rng.choice(letters, 2)] for s in range(S)]
    rows[3] = ["chr1", "4", " g ", "T\n"]          # stripped and upper-cased
    P = rng.dirichlet(np.ones(3), size=(S, N))
    return rows, P


def test_submodels_alleles_and_counts_match():
    """encode_alleles, classify_sites and expected_base_counts: the bytes
    of the JAX package's module, and its error for a 3-column row."""
    rows, P = _submodel_inputs(0)
    ja, ta = jsub.encode_alleles(rows), tsub.encode_alleles(rows)
    for a, b in zip(ta, ja):
        assert a.dtype == b.dtype == np.int8 and np.array_equal(a, b)
    assert (ta[0] >= 0).any() and (ta[0] < 0).any()
    jm, tm = jsub.classify_sites(*ja), tsub.classify_sites(*ta)
    assert list(tm) == list(jm) == ["ag", "ct", "tv", "ok"]
    assert all(tm[k].tobytes() == jm[k].tobytes() for k in jm)
    assert (tsub.expected_base_counts(P, *ta).tobytes()
            == jsub.expected_base_counts(P, *ja).tobytes())
    errs = []
    for mod in (jsub, tsub):
        with pytest.raises(Exception) as ex:
            mod.encode_alleles(rows[:2] + [["chr1", "3", "A"]])
        errs.append((type(ex.value).__name__, str(ex.value)))
    assert errs[0] == errs[1] and "allele info" in errs[0][1]


@pytest.mark.parametrize("model", [3, 4, 5, 6])
@pytest.mark.parametrize("pi_kind", ["mixed", "equal", "two_bases", "one_base"])
def test_submodels_formulas_match(model, pi_kind):
    """apply_extended_model (k80, f81, f84, tn93 with their _sdiv and
    _safe_log limits) on random class sums, on degenerate base
    compositions and past saturation: equal bytes, NaN included."""
    rng = np.random.default_rng(10 * model + len(pi_kind))
    n = 50
    cnt = rng.integers(1, 60, n).astype(np.float64)
    raws = [rng.random(n) * cnt * f for f in (0.2, 0.2, 0.5)]
    raws[2][:5] = cnt[:5] * 0.6            # saturated: log of a negative number
    cnt[5] = 0.0
    pi = {"mixed": rng.dirichlet(np.ones(4), n),
          "equal": np.full((n, 4), 0.25),
          "two_bases": np.tile([0.6, 0.4, 0.0, 0.0], (n, 1)),
          "one_base": np.tile([1.0, 0.0, 0.0, 0.0], (n, 1))}[pi_kind]
    want = jsub.apply_extended_model(model, *raws, cnt, pi if model >= 4 else None)
    got = tsub.apply_extended_model(model, *raws, cnt, pi if model >= 4 else None)
    assert got.tobytes() == want.tobytes()
    assert np.isfinite(want).any()
    if pi_kind == "mixed":
        assert np.isnan(want).any()


def test_submodels_invalid_model_matches():
    errs = []
    for mod in (jsub, tsub):
        with pytest.raises(Exception) as ex:
            mod.apply_extended_model(7, np.ones(2), np.ones(2), np.ones(2), 4.0, None)
        errs.append((type(ex.value).__name__, str(ex.value)))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("name", ["T_b5", "GL_b3B10", "BIN"])
@pytest.mark.parametrize("engine", ["torch-cpu-float64", "torch-cuda-float32"])
def test_checkpoint_fingerprints_match(name, engine, tmp_path, monkeypatch):
    """The fingerprint of a run did not change with the move: a sidecar
    written through the JAX package's checkpoint module (as the port did
    before it had its own) still resumes, and the other way round."""
    monkeypatch.chdir(DATA_DIR)
    out = str(tmp_path / "x.dist")
    args = [a.replace("{OUT}", out) for a in MANIFEST[name]["args"]]
    jp, _ = jcli.parse_args(args)
    tp, _ = tcli.parse_args(args)
    jp.finalize()
    tp.finalize()
    assert tckpt.run_fingerprint(tp, engine) == jckpt.run_fingerprint(jp, engine)
    assert tckpt.run_fingerprint(tp, engine) != tckpt.run_fingerprint(tp, "other")
    open(out, "w").write("x")
    jckpt.save(out, jp, 1, engine=engine)
    assert tckpt.load(out, tp, engine=engine) == 1
    tckpt.save(out, tp, 1, engine=engine)
    assert jckpt.load(out, jp, engine=engine) == 1
    assert tckpt.state_path(out) == jckpt.state_path(out)
    tckpt.clear(out)
    assert not os.path.exists(tckpt.state_path(out))


def _load_in_fresh_build_dir(build_dir, queue):
    from ngsdist_tpu_torch.utils import buildlib, native

    buildlib.BUILD_DIR = build_dir
    lib = native.get_lib()
    out = np.empty((2, 3), dtype=np.uint64)
    lib.nd_boot_block_indices(4242, 2, 3, native.as_u64_ptr(out))
    queue.put((native.library_path(), out.tolist()))


def test_six_processes_build_the_runtime_at_once(tmp_path):
    """Six processes ask for the native runtime over an empty build
    directory at the same time: each loads a working library."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    build_dir = str(tmp_path / "_build")
    procs = [ctx.Process(target=_load_in_fresh_build_dir, args=(build_dir, queue))
             for _ in range(6)]
    for p in procs:
        p.start()
    got = [queue.get(timeout=240) for _ in procs]
    for p in procs:
        p.join(timeout=60)
        assert p.exitcode == 0
    want = jrng.boot_block_indices(4242, 2, 3).tolist()
    assert all(path.startswith(build_dir) and table == want for path, table in got)
    left = sorted(os.listdir(build_dir))
    assert [f for f in left if f.endswith(".so")] == [os.path.basename(got[0][0])]
    assert not [f for f in left if f.endswith(".tmp")]


def test_runtime_name_is_keyed_by_sources_and_flags():
    path = tnative.library_path()
    assert path == tnative.library_path()
    assert os.path.basename(path).startswith("libngsdist_native_") and path.endswith(".so")
    assert all(os.path.exists(s) for s in tnative.SOURCES)


@pytest.mark.parametrize("zeros", [(), ((17, 2),), ((0, 0), (17, 2), (17, 4), (59, 1))],
                         ids=["none", "one", "several"])
def test_zero_rows_record_matches_the_tensor_scan(zeros):
    """preprocess.find_zero_rows / ZeroRows against the scans of the whole
    tensor they replace (ngsdist_tpu.core.distance._em_zero_rows and the
    per-block flags of its partial-sum route): None when no triple is all
    zero, else the same individuals for any site range and any weights,
    and the same flags per bootstrap block."""
    rng = np.random.default_rng(len(zeros))
    S, N, bs = 60, 5, 7
    P = rng.dirichlet(np.ones(3), size=(S, N))
    P[3, 1] = np.nan                      # NaN is not an all-zero triple
    for s, i in zeros:
        P[s, i] = 0.0
    rec = tpre.find_zero_rows(P, slab_sites=16)
    if not zeros:
        assert rec is None
        return
    Z = (P == 0).all(-1)
    assert rec.sites.tolist() == sorted({s for s, _ in zeros})
    w = rng.integers(0, 3, S).astype(np.float64)
    w[17] = 0.0
    for lo, hi in ((0, S), (0, 17), (17, 18), (18, 60), (5, 5)):
        np.testing.assert_array_equal(rec.individuals(lo, hi), Z[lo:hi].any(0))
        np.testing.assert_array_equal(rec.individuals(lo, hi, w[lo:hi]),
                                      (Z[lo:hi] & (w[lo:hi] > 0)[:, None]).any(0))
    n_blocks = S // bs
    np.testing.assert_array_equal(rec.per_block(n_blocks, bs),
                                  Z[:n_blocks * bs].reshape(n_blocks, bs, N).any(1))
