"""Evolutionary models 3-6 (K80, F81, F84, TN93) in the port, on the CPU
in float64, against the JAX engine (x64) on the same seeded inputs:
class-masked sums through both kernels' plain versions, per-pair base
frequencies, resident and streamed, round checkpoints, the CLI, and the
compacted form of the class sums against the three weighted launches.

Tolerances: both engines correct the same float64 sums with the same
numpy formulas; the sums differ in their order of addition only (and the
two EMs in their last bits per lane), so port against JAX is held to
atol 1e-10, rtol 1e-9, chunked against resident within the port to
1e-12 relative, and the EM's compacted sums to the three-launch form's
bytes (a dropped site adds 0 to a sum kept in site order)."""

import gzip
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ngsdist_tpu import runner as jrunner  # noqa: E402
from ngsdist_tpu.config import NgsDistError as JError  # noqa: E402
from ngsdist_tpu.config import Params as JParams  # noqa: E402
from ngsdist_tpu.core import bootstrap as jboot  # noqa: E402
from ngsdist_tpu.core import distance as jdist  # noqa: E402
from ngsdist_tpu.core import submodels as jsm  # noqa: E402
from ngsdist_tpu_torch import cli, runner  # noqa: E402
from ngsdist_tpu_torch.config import NgsDistError, Params  # noqa: E402
from ngsdist_tpu_torch.core import distance as tdist  # noqa: E402
from ngsdist_tpu_torch.ops import em as tem  # noqa: E402
from ngsdist_tpu_torch.ops import indep as tindep  # noqa: E402
from ngsdist_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
KINDS = {"indep": (True, False), "indep_pdel": (True, True), "em": (False, False),
         "em_pdel": (False, True)}
SCORE9 = np.array([0.0, 0.5, 1.0, 0.5, 0.0, 0.5, 1.0, 0.5, 0.0])


def _inputs(seed, S, N, missing=0.2):
    """Seeded Dirichlet triples with missing rows, and allele codes with
    some unclassifiable sites (a1 = -1)."""
    rng = np.random.default_rng(seed)
    P = rng.dirichlet(np.ones(3) * 5, size=(S, N))
    P[rng.random((S, N)) < missing] = 1 / 3
    a = np.array([rng.choice(4, size=2, replace=False) for _ in range(S)], np.int8)
    a1, a2 = a[:, 0].copy(), a[:, 1].copy()
    a1[::9] = -1
    return P, (a1, a2)


def _pars(cls, tmp_path, S, N, model, kind, **kw):
    indep, pairwise_del = KINDS[kind]
    kw.setdefault("seed", 7)
    return cls(in_geno="x", n_ind=N, n_sites=S, in_probs=True, indep_geno=indep,
               pairwise_del=pairwise_del, evol_model=model, verbose=0,
               out=str(tmp_path / "o.dist"), **kw)


def _budget_for(chunk_sites, N):
    return (tdist._WORKING_SET_FACTOR * tdist.PREFETCH_KEEP_DEN * chunk_sites * N * 3 * 8
            // tdist.PREFETCH_KEEP_NUM)


def _assert_close(got, want, rtol=1e-9, atol=1e-10):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        ok = ~np.isnan(w)
        np.testing.assert_allclose(g[ok], w[ok], rtol=rtol, atol=atol)


@pytest.mark.parametrize("model", [3, 4, 5, 6])
@pytest.mark.parametrize("kind", ["indep", "indep_pdel", "em"])
def test_extended_matches_jax(tmp_path, monkeypatch, model, kind):
    """The grid of tests/test_submodels.py: full data and 2 replicates,
    some sites unclassifiable."""
    monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
    S, N, bs = 61, 5, 6
    P, alleles = _inputs(100 * model + len(kind), S, N)
    n_trunc, maps = jboot.site_maps(7, 2, S, bs)
    kw = dict(n_boot_rep=2, boot_block_size=bs)
    want = list(jdist.iter_replicates(_pars(JParams, tmp_path, S, N, model, kind, **kw), P,
                                      maps, n_trunc, alleles=alleles))
    stats = []
    got = list(tdist.iter_replicates(_pars(Params, tmp_path, S, N, model, kind, **kw), P, maps,
                                     n_trunc, CPU, alleles=alleles,
                                     on_stats=lambda raw, cnt: stats.append((raw, cnt))))
    assert len(got) == 3 and all(np.isfinite(m).all() for m in got)
    _assert_close(got, want)
    # the hook saw the summed raws and the true count of each matrix
    jstats = []
    list(jdist.iter_replicates(_pars(JParams, tmp_path, S, N, model, kind, **kw), P, maps,
                               n_trunc, alleles=alleles,
                               on_stats=lambda raw, cnt: jstats.append((raw, cnt))))
    assert len(stats) == 3
    iu = np.triu_indices(N, 1)     # what the pair report and the meter read
    for (raw, cnt), (jraw, jcnt) in zip(stats, jstats):
        np.testing.assert_allclose(raw[iu], jraw[iu], rtol=1e-9, atol=1e-10)
        assert np.ndim(cnt) == np.ndim(jcnt)
        if np.ndim(cnt):
            cnt, jcnt = cnt[iu], jcnt[iu]
        np.testing.assert_array_equal(cnt, jcnt)


@pytest.mark.parametrize("model,kind", [(3, "em"), (6, "em_pdel"), (5, "indep_pdel"),
                                        (4, "indep")])
def test_extended_tot_sites_and_start_rep(tmp_path, model, kind):
    """--tot_sites overrides the denominator; start_rep skips matrices."""
    S, N, bs = 40, 4, 5
    P, alleles = _inputs(model, S, N)
    n_trunc, maps = jboot.site_maps(7, 2, S, bs)
    kw = dict(n_boot_rep=2, boot_block_size=bs, tot_sites=55)
    want = list(jdist.iter_replicates(_pars(JParams, tmp_path, S, N, model, kind, **kw), P,
                                      maps, n_trunc, alleles=alleles))
    got = list(tdist.iter_replicates(_pars(Params, tmp_path, S, N, model, kind, **kw), P, maps,
                                     n_trunc, CPU, alleles=alleles))
    _assert_close(got, want)
    later = list(tdist.iter_replicates(_pars(Params, tmp_path, S, N, model, kind, **kw), P,
                                       maps, n_trunc, CPU, alleles=alleles, start_rep=2))
    assert len(later) == 1 and later[0].tobytes() == got[2].tobytes()


@pytest.mark.parametrize("model,kind", [(6, "em"), (5, "indep_pdel"), (4, "indep"),
                                        (3, "em_pdel")])
def test_extended_streamed_matches_jax_and_resident(tmp_path, monkeypatch, model, kind):
    """70 sites in 16-site chunks (the last of 6): against the JAX engine
    under the same budget and against the port's resident run; every
    chunk goes through the kernel once per class and matrix."""
    S, N, bs = 70, 4, 7
    P, alleles = _inputs(31 + model, S, N)
    n_trunc, maps = jboot.site_maps(7, 2, S, bs)
    kw = dict(n_boot_rep=2, boot_block_size=bs)
    monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
    resident = list(tdist.iter_replicates(_pars(Params, tmp_path, S, N, model, kind, **kw), P,
                                          maps, n_trunc, CPU, alleles=alleles))
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(_budget_for(16, N)))
    assert tdist.stream_plan(S, N, CPU, None, False) == (True, 16)
    calls = []
    name = "indep_raw_cnt" if KINDS[kind][0] else "em_raw_cnt"

    def spy(Psub, *a, _fn=getattr(tdist, name), **k):
        calls.append(Psub.shape[0])
        return _fn(Psub, *a, **k)

    monkeypatch.setattr(tdist, name, spy)
    streamed = list(tdist.iter_replicates(_pars(Params, tmp_path, S, N, model, kind, **kw), P,
                                          maps, n_trunc, CPU, alleles=alleles))
    assert calls == ([16] * 3 * 4 + [6] * 3) * 3
    want = list(jdist.iter_replicates(_pars(JParams, tmp_path, S, N, model, kind, **kw), P,
                                      maps, n_trunc, alleles=alleles))
    _assert_close(streamed, want)
    _assert_close(streamed, resident, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("model,kind", [(6, "em"), (5, "indep_pdel")])
def test_extended_round_resume_after_a_kill(tmp_path, monkeypatch, model, kind):
    """A streamed replicate killed in its third chunk resumes there: the
    rounds file holds the class sums (and the base counts), the finished
    chunks are not recomputed, the matrix is byte-identical."""
    S, N, bs = 60, 4, 3
    P, alleles = _inputs(42, S, N)
    pars = _pars(Params, tmp_path, S, N, model, kind, n_boot_rep=1, boot_block_size=bs)
    n_trunc, maps = jboot.site_maps(pars.seed, 1, S, bs)
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(_budget_for(12, N)))
    expected = list(tdist.iter_replicates(pars, P, maps, n_trunc, CPU, alleles=alleles))
    assert not os.path.exists(ckpt.rounds_path(pars.out))

    name = "indep_raw_cnt" if KINDS[kind][0] else "em_raw_cnt"
    orig = getattr(tdist, name)
    calls = []

    def spy(*a, **k):
        calls.append(1)
        if spy.armed and len(calls) == 3 * 2 + 2:    # the third chunk's second class
            raise KeyboardInterrupt("simulated kill mid-replicate")
        return orig(*a, **k)

    spy.armed = True
    monkeypatch.setattr(tdist, name, spy)
    with pytest.raises(KeyboardInterrupt):
        list(tdist.iter_replicates(pars, P, maps, n_trunc, CPU, alleles=alleles,
                                   round_ckpt=True, start_rep=1))
    eng = tdist.engine_name(CPU, False)
    assert ckpt.load_rounds(pars.out, pars, 0, engine=eng, chunk=12) is None
    got = ckpt.load_rounds(pars.out, pars, 1, engine=eng, chunk=12)
    keys = {f"raw_{cl}" for cl in tdist.CLASSES} | {"pi"}
    if KINDS[kind][1]:
        keys |= {f"cnt_{cl}" for cl in tdist.CLASSES}
    assert got is not None and got[0] == 2 and set(got[1]) == keys
    spy.armed = False
    calls.clear()
    resumed = list(tdist.iter_replicates(pars, P, maps, n_trunc, CPU, alleles=alleles,
                                         round_ckpt=True, start_rep=1))
    assert len(calls) == 3 * (5 - 2), "finished chunks were recomputed"
    assert resumed[0].tobytes() == expected[1].tobytes()


def test_rounds_fingerprint_holds_the_pos_file(tmp_path):
    """Another allele file gives other masks: for models 3-6 the POS file
    is in the run's fingerprint; models 0-2 do not read it."""
    pos = tmp_path / "pos.txt"
    pos.write_text("chr1\t1\tA\tG\n")
    other = tmp_path / "other.txt"
    other.write_text("chr1\t1\tA\tC\n")
    base = dict(in_geno="x", n_ind=4, n_sites=1, out=str(tmp_path / "o.dist"))
    fp = {(m, p.name): ckpt.run_fingerprint(Params(evol_model=m, in_pos=str(p), **base), "e")
          for m in (1, 5) for p in (pos, other)}
    assert fp[1, "pos.txt"] == fp[1, "other.txt"]
    assert fp[5, "pos.txt"] != fp[5, "other.txt"]
    pos.write_text("chr1\t1\tC\tT\tx\n")   # rewritten: another size
    assert ckpt.run_fingerprint(Params(evol_model=5, in_pos=str(pos), **base),
                                "e") != fp[5, "pos.txt"]


def _write_text_inputs(tmp_path, rng, S, N, pos_cols=4, empty_line=None):
    gp = rng.dirichlet(np.ones(3), size=(S, N))
    geno = str(tmp_path / "gp.geno.gz")
    with gzip.open(geno, "wt") as fh:
        for s in range(S):
            row = gp[s].reshape(-1)
            if s == empty_line:
                row = np.zeros_like(row)
            fh.write("\t".join(f"{x:.6f}" for x in row) + "\n")
    pos = str(tmp_path / "pos.txt")
    with open(pos, "w") as fh:
        for s in range(S):
            b = rng.choice(4, size=2, replace=False)
            fh.write("\t".join([f"chr1\t{s + 1}", *("ACGT"[x] for x in b)][:pos_cols - 1])
                     + "\n")
    return geno, pos


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


@pytest.mark.parametrize("model", [3, 4, 5, 6])
def test_cli_extended_matches_jax_runner(tmp_path, model):
    """python -m ngsdist_tpu_torch --evol_model M --pos FILE on a gz text
    input against runner.run(engine="jax"): the returned matrices and
    the phylip file."""
    rng = np.random.default_rng(11 + model)
    S, N = 30, 4
    geno, pos = _write_text_inputs(tmp_path, rng, S, N)
    kw = dict(in_geno=geno, in_probs=True, n_ind=N, n_sites=S, in_pos=pos, evol_model=model,
              seed=2, verbose=0, n_boot_rep=1, boot_block_size=5,
              pairwise_del=model % 2 == 0)
    want = jrunner.run(JParams(out=str(tmp_path / "j.dist"), **kw), engine="jax")
    out = str(tmp_path / "t.dist")
    args = ["--geno", geno, "--probs", "--n_ind", str(N), "--n_sites", str(S), "--pos", pos,
            "--evol_model", str(model), "--seed", "2", "--verbose", "0", "--n_boot_rep", "1",
            "--boot_block_size", "5", "--out", out, "--platform", "cpu"]
    if model % 2 == 0:
        args.append("--pairwise_del")
    assert cli.main(args) == 0
    got = _read_matrices(out)
    assert len(got) == 2
    _assert_close(got, _read_matrices(str(tmp_path / "j.dist")), atol=2e-10)
    _assert_close(got, want, atol=1e-9)


@pytest.mark.parametrize("what", ["three_columns", "no_alleles"])
def test_extended_errors_match_jax(tmp_path, capsys, what):
    """A POS file without allele columns, and the engine entered without
    alleles: the JAX runner's error, after the same banners."""
    rng = np.random.default_rng(3)
    S, N = 12, 3
    geno, pos = _write_text_inputs(tmp_path, rng, S, N, pos_cols=4 if what == "no_alleles" else 3)
    kw = dict(in_geno=geno, in_probs=True, n_ind=N, n_sites=S, in_pos=pos, evol_model=4,
              seed=2, verbose=2)
    if what == "three_columns":
        with pytest.raises(JError) as want:
            jrunner.run(JParams(out=str(tmp_path / "j.dist"), **kw), engine="jax")
        want_err = capsys.readouterr().err
        with pytest.raises(NgsDistError) as got:
            runner.run(Params(out=str(tmp_path / "t.dist"), **kw), CPU)
        got_err = capsys.readouterr().err
    else:
        P = rng.dirichlet(np.ones(3), size=(S, N))
        with pytest.raises(JError) as want:
            next(jrunner.iter_replicates(JParams(out="j", **kw), P, engine="jax"))
        want_err = capsys.readouterr().err
        with pytest.raises(NgsDistError) as got:
            next(runner.iter_replicates(Params(out="t", **kw), P, CPU))
        got_err = capsys.readouterr().err
    assert str(got.value) == str(want.value)
    assert "evolutionary models need allele info in the POS file!" in str(got.value)
    assert got_err == want_err


@pytest.mark.parametrize("streamed", [False, True], ids=["resident", "streamed"])
@pytest.mark.parametrize("model,kind", [(3, "em"), (6, "em"), (5, "em_pdel"), (4, "indep")])
def test_extended_zero_row_matches_jax(tmp_path, monkeypatch, model, kind, streamed):
    """A text input's all-zero triple (an empty line) under models 3-6:
    the JAX engine does not poison the individual's pairs here; its EM
    leaves the lane at the uniform start, so without pairwise deletion
    it adds the mean score at that site.  The port's kernels leave the
    lane out and the engine adds the same sum on the host."""
    S, N, bs = 61, 5, 6
    P, alleles = _inputs(9, S, N, missing=0.1)
    P[17, 2] = 0.0
    P[40, 0] = P[40, 3] = 0.0
    kw = dict(n_boot_rep=2, boot_block_size=bs)
    n_trunc, maps = jboot.site_maps(7, 2, S, bs)
    if streamed:
        monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(_budget_for(10, N)))
    else:
        monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
    want = list(jdist.iter_replicates(_pars(JParams, tmp_path, S, N, model, kind, **kw), P,
                                      maps, n_trunc, alleles=alleles))
    got = list(tdist.iter_replicates(_pars(Params, tmp_path, S, N, model, kind, **kw), P, maps,
                                     n_trunc, CPU, alleles=alleles))
    _assert_close(got, want)
    assert np.isfinite(want[0][2, 1])     # not poisoned


def test_cli_extended_empty_line_matches_jax_runner(tmp_path):
    """The same through the readers: a gz text input with an empty line."""
    rng = np.random.default_rng(5)
    S, N = 24, 4
    geno, pos = _write_text_inputs(tmp_path, rng, S, N, empty_line=7)
    kw = dict(in_geno=geno, in_probs=True, n_ind=N, n_sites=S, in_pos=pos, evol_model=6,
              seed=2, verbose=0)
    want = jrunner.run(JParams(out=str(tmp_path / "j.dist"), **kw), engine="jax")
    got = runner.run(Params(out=str(tmp_path / "t.dist"), **kw), CPU)
    _assert_close(got, want)


def _class_weights(rng, S, alleles, replicate):
    masks = jsm.classify_sites(*alleles)
    w = rng.integers(0, 4, S).astype(np.float64) if replicate else np.ones(S)
    return {cl: w * masks[cl] for cl in tdist.CLASSES}


def _em_site_order_sums(P, pairwise_del, w):
    """(raw, cnt) pair vectors of the EM as csrc/em.cu adds them: every
    lane's float64 terms w (contrib m) and w m one site after another,
    from the plain version's per-lane values (ops/em.py _em_sites).  The
    plain version itself adds the sites with torch's blocked sum, whose
    grouping follows their number."""
    N = P.shape[1]
    I, J = torch.triu_indices(N, N, offset=1)
    hi = torch.tensor(np.exp(tem.EM_TOLE), dtype=P.dtype)
    contrib, m, _ = tem._em_sites(P, torch.from_numpy(SCORE9).reshape(3, 3), I, J,
                                  pairwise_del, hi)
    raw = torch.zeros(I.numel(), dtype=P.dtype)
    cnt = torch.zeros_like(raw)
    for s in range(P.shape[0]):
        raw += w[s] * (contrib[s] * m[s])
        cnt += w[s] * m[s]
    return raw, cnt


@pytest.mark.parametrize("nan_site", [False, True], ids=["finite", "nan_at_weight_0"])
@pytest.mark.parametrize("replicate", [False, True], ids=["full", "replicate"])
@pytest.mark.parametrize("pairwise_del", [False, True], ids=["nopdel", "pdel"])
def test_compacted_em_sums_equal_three_launches(nan_site, replicate, pairwise_del):
    """Each class on its own sites only against the whole tensor under
    the class's weights, in the kernel's order of addition: the EM's sums
    are equal to the byte, also where a NaN triple sits at a site of
    weight 0 (kept in every class's list at weight 0, it makes its pairs
    NaN in both).  The plain version's own sums agree within 1e-13."""
    rng = np.random.default_rng(77 + replicate)
    S, N = 90, 6
    P, alleles = _inputs(5, S, N)
    wm = _class_weights(rng, S, alleles, replicate)
    if nan_site:
        s = int(np.flatnonzero(wm["ag"] == 0)[3])
        P[s, 2, 1] = np.nan
    Pt = torch.from_numpy(P)
    keep = tdist.nonfinite_sites(Pt).numpy()
    assert keep.sum() == int(nan_site)
    for cl in tdist.CLASSES:
        sel = tdist.class_sites(wm[cl], keep)
        assert 0 < sel.size < S and (not nan_site or s in sel)
        index = torch.from_numpy(sel)
        Psel, wsel = Pt.index_select(0, index), wm[cl][sel]
        full = _em_site_order_sums(Pt, pairwise_del, wm[cl])
        part = _em_site_order_sums(Psel, pairwise_del, wsel)
        for a, b in zip(full, part):
            assert torch.equal(a.view(torch.int64), b.view(torch.int64))
        nan_pairs = int(torch.isnan(full[0]).sum())
        assert nan_pairs == ((N - 1) if nan_site else 0)   # at any weight, 0 too
        listed = tem.em_raw_cnt(Pt, SCORE9, pairwise_del, wsel, site_index=index)
        for a, b in zip(listed, tem.em_raw_cnt_ref(Psel, SCORE9, pairwise_del, wsel)):
            assert torch.equal(a.view(torch.int64), b.view(torch.int64))
        for a, b in zip(tem.em_raw_cnt_ref(Pt, SCORE9, pairwise_del, wm[cl]), listed):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-13, atol=0)


@pytest.mark.parametrize("pairwise_del", [False, True], ids=["nopdel", "pdel"])
def test_compacted_indep_sums_match_three_launches(pairwise_del):
    """The indep sums regroup under compaction: cnt equal, raw within
    1e-13 relative in float64."""
    rng = np.random.default_rng(78)
    S, N = 90, 6
    P, alleles = _inputs(6, S, N)
    wm = _class_weights(rng, S, alleles, True)
    Pt = torch.from_numpy(P)
    keep = np.zeros(S, bool)
    for cl in tdist.CLASSES:
        full = tindep.indep_raw_cnt_ref(Pt, SCORE9, pairwise_del, wm[cl])
        sel = tdist.class_sites(wm[cl], keep)
        part = tindep.indep_raw_cnt_ref(Pt.index_select(0, torch.from_numpy(sel)), SCORE9,
                                        pairwise_del, wm[cl][sel])
        assert torch.equal(full[1], part[1])
        np.testing.assert_allclose(part[0].numpy(), full[0].numpy(), rtol=1e-13, atol=0)


@pytest.mark.parametrize("model", [3, 4, 5, 6])
@pytest.mark.parametrize("kind", ["indep_pdel", "em"])
def test_extended_compacted_route_matches_three_launches(tmp_path, monkeypatch, model, kind):
    """The engine in a card's form (class_compaction patched to True)
    against the three weighted launches (the CPU's form), resident, within
    1e-12 relative (the plain versions regroup their sums with the number
    of sites; the EM kernel's bytes are held on the card); the compacted
    calls saw fewer sites than the tensor has."""
    monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
    S, N, bs = 61, 5, 6
    P, alleles = _inputs(200 + model, S, N)
    P[5, 1, 0] = np.nan
    n_trunc, maps = jboot.site_maps(7, 2, S, bs)
    kw = dict(n_boot_rep=2, boot_block_size=bs)
    assert not tdist.class_compaction(CPU)
    plain = list(tdist.iter_replicates(_pars(Params, tmp_path, S, N, model, kind, **kw), P,
                                       maps, n_trunc, CPU, alleles=alleles))
    monkeypatch.setattr(tdist, "class_compaction", lambda device: True)
    calls = []
    name = "indep_raw_cnt" if KINDS[kind][0] else "em_raw_cnt"

    def spy(Psub, *a, _fn=getattr(tdist, name), **k):
        # the EM is handed the site list, indep the gathered sites
        index = k.get("site_index")
        calls.append(Psub.shape[0] if index is None else len(index))
        assert (index is not None) == (kind == "em")
        return _fn(Psub, *a, **k)

    monkeypatch.setattr(tdist, name, spy)
    compacted = list(tdist.iter_replicates(_pars(Params, tmp_path, S, N, model, kind, **kw), P,
                                           maps, n_trunc, CPU, alleles=alleles))
    assert len(calls) == 9 and max(calls) < S
    # full data: every classifiable site once, and the NaN site in each class
    masks = jsm.classify_sites(*alleles)
    assert sum(calls[:3]) == int(masks["ok"].sum()) + 3 - int(masks["ok"][5])
    assert np.isnan(plain[0][1]).sum() == N - 1
    _assert_close(compacted, plain, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("pairwise_del", [False, True], ids=["nopdel", "pdel"])
@pytest.mark.parametrize("plane_bytes", [1, 8 * 7 * 5, 1 << 20], ids=["1site", "7sites", "all"])
def test_pair_pi_counts_match_the_host_einsum(pairwise_del, plane_bytes):
    """pair_pi_counts in slabs of sites against the JAX engine's host
    form (expected_base_counts and an einsum over [S, N, 4]), with a NaN
    triple at an unclassifiable site and at a classifiable one."""
    rng = np.random.default_rng(13)
    S, N = 33, 5
    P, (a1, a2) = _inputs(13, S, N)
    a2[4] = a1[4]                  # a1 == a2: counted in bc, masked by w_ok
    P[0, 1] = np.nan               # a1[0] = -1: no base counts there
    P[4, 2] = np.nan
    w_ok = rng.integers(0, 3, S) * jsm.classify_sites(a1, a2)["ok"]
    bc = jsm.expected_base_counts(P, a1, a2)
    if pairwise_del:
        valid = (~((np.abs(P[..., 0] - P[..., 1]) < jdist.EPSILON)
                   & (np.abs(P[..., 1] - P[..., 2]) < jdist.EPSILON))).astype(np.float64)
        want = np.einsum("six,sj->xij", bc * (valid * w_ok[:, None])[:, :, None], valid)
    else:
        want = np.einsum("s,six->xi", w_ok, bc)
    got = tdist.pair_pi_counts(torch.from_numpy(P), torch.from_numpy(a1), torch.from_numpy(a2),
                               torch.from_numpy(w_ok), pairwise_del,
                               plane_bytes=plane_bytes).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any() and not np.isnan(want).all()
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-13, atol=1e-13)
