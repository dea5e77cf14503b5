"""The port's disk-read rounds (parallel/multihost.py from_reader, DiskRows,
the spill caches) and its lazy runner route against the JAX package's, on
the CPU.

- The spill caches are the JAX package's byte for byte: the text spill
  (readers.spill_text_geno, the shared native parse) and the verbatim
  copy of a gz or stdin binary input's rows (_copy_binary).
- A lazy stream plans the JAX stream's shards and rounds, and its rounds
  hold the JAX rounds' rows for every input style.  Text rows read from
  the spill are equal; binary rows are normalized here by the native
  reader's calls, where the JAX package's site-range reader uses numpy's
  log and exp, so they are equal to the full native read (the same bits
  whatever the split of the sites) and within 1e-13 relative of the JAX
  rounds (a few ulps of a log, through exp).
- A lazy run of the CLI matches the port's resident run and
  `python -m ngsdist_tpu --engine jax` under the same budget within
  1e-9, for the EM, indep, hard genotypes and models 3-6, including the
  EM's zero-row poison on a text input with empty lines; its spill cache
  is deleted at the end and after an error, and a run killed in a round
  resumes to the bytes of an uninterrupted one.
- runner.run with no device runs on the card, and without one stops
  with an NgsDistError (it raised an AttributeError before).
"""

import gzip
import io
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ngsdist_tpu import cli as jax_cli  # noqa: E402
from ngsdist_tpu.config import Params as JParams  # noqa: E402
from ngsdist_tpu.io import readers as jreaders  # noqa: E402
from ngsdist_tpu.parallel import mesh as jpm  # noqa: E402
from ngsdist_tpu.parallel.multihost import SiteStream as JStream  # noqa: E402
from ngsdist_tpu_torch import cli, runner  # noqa: E402
from ngsdist_tpu_torch.config import NgsDistError, Params  # noqa: E402
from ngsdist_tpu_torch.core import distance as tdist  # noqa: E402
from ngsdist_tpu_torch.core.preprocess import preprocess  # noqa: E402
from ngsdist_tpu_torch.io import readers  # noqa: E402
from ngsdist_tpu_torch.parallel import mesh as pm  # noqa: E402
from ngsdist_tpu_torch.parallel import multihost as pmh  # noqa: E402

from conftest import DATA_DIR  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
S, N = 57, 6


def _genome(seed=13):
    rng = np.random.default_rng(seed)
    gp = rng.dirichlet(np.ones(3), size=(S, N))
    gp[rng.random((S, N)) < 0.15] = 1 / 3
    return gp


def _write(gp, path, style, empty=()):
    """gp in one input style: raw or gz binary, plain or gz text (empty
    lines at the sites of `empty`: each a site of all-zero triples)."""
    if style in ("bin", "bin_gz", "stdin"):
        blob = gp.astype("<f8").tobytes()
        if style == "bin_gz":
            with gzip.open(path, "wb") as fh:
                fh.write(blob)
        else:
            with open(path, "wb") as fh:
                fh.write(blob)
        return
    lines = ["" if s in empty else "\t".join(f"{x:.8f}" for x in gp[s].reshape(-1))
             for s in range(gp.shape[0])]
    text = "\n".join(lines) + "\n"
    if style == "text_gz":
        with gzip.open(path, "wt") as fh:
            fh.write(text)
    else:
        with open(path, "w") as fh:
            fh.write(text)


STYLES = {"bin": "g.bin", "bin_gz": "g.bin.gz", "text": "g.txt", "text_gz": "g.txt.gz",
          "stdin": "-"}


def _stdin(monkeypatch, path):
    """sys.stdin reading the bytes of path (the binary readers read
    sys.stdin.buffer)."""
    data = open(path, "rb").read()
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(data)))


@pytest.mark.parametrize("site_range", [(0, S), (0, 20), (20, 57), (30, 31)])
@pytest.mark.parametrize("style", ["text", "text_gz", "bin_gz", "stdin"])
def test_spill_caches_equal_jax_bytes(tmp_path, monkeypatch, style, site_range):
    """The cache a process writes of its rows is the JAX package's, byte
    for byte: the text spill through the native parse (with an empty
    line), the binary copy through _copy_binary (also from stdin)."""
    gp = _genome()
    src = str(tmp_path / ("g.bin" if style == "stdin" else STYLES[style]))
    _write(gp, src, style, empty=(25,))
    lo, hi = site_range
    got, want = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    if style.startswith("text"):
        readers.spill_text_geno(src, True, False, N, S, got, site_range=site_range)
        jreaders.spill_text_geno(src, True, False, N, S, want, site_range=site_range)
    else:
        geno = "-" if style == "stdin" else src
        if style == "stdin":
            _stdin(monkeypatch, src)
        pmh.SiteStream._copy_binary(Params(in_geno=geno, n_ind=N, n_sites=S), got, lo, hi)
        if style == "stdin":
            _stdin(monkeypatch, src)
        JStream._copy_binary(JParams(in_geno=geno, n_ind=N, n_sites=S), want, lo, hi)
    assert open(got, "rb").read() == open(want, "rb").read()
    assert os.path.getsize(got) == (hi - lo) * N * 3 * 8
    rows = readers.read_spill_rows(got, N, lo, hi, base=lo)
    if style.startswith("text"):
        np.testing.assert_array_equal(rows, jreaders.read_spill_rows(want, N, lo, hi, base=lo))


def test_copy_binary_keeps_the_size_fatals(tmp_path):
    """A process spills its own rows only, and still reads the whole input
    so that a short or a long file is the reference's error."""
    gp = _genome()
    path = str(tmp_path / "g.bin.gz")
    _write(gp, path, "bin_gz")
    for n_sites, needle in ((S + 1, "premature EOF"), (S - 1, "not at EOF")):
        pars = Params(in_geno=path, n_ind=N, n_sites=n_sites)
        with pytest.raises(NgsDistError, match=needle):
            pmh.SiteStream._copy_binary(pars, str(tmp_path / "c.bin"), 0, 10)
        with pytest.raises(Exception, match=needle):
            JStream._copy_binary(JParams(in_geno=path, n_ind=N, n_sites=n_sites),
                                 str(tmp_path / "j.bin"), 0, 10)


def test_site_range_reads_hold_the_full_reads_bits(tmp_path):
    """A site range read natively holds the bits of the same sites of the
    full read, binary and text, so that how the sites are split between
    processes changes no bit of the input."""
    gp = _genome()
    for style in ("bin", "bin_gz", "text_gz"):
        path = str(tmp_path / STYLES[style])
        _write(gp, path, style, empty=(3,))
        in_bin = style.startswith("bin")
        full = readers.read_geno(path, in_bin, True, False, N, S)
        np.testing.assert_array_equal(full, jreaders.read_geno(path, in_bin, True, False, N, S))
        for lo, hi in ((0, 20), (20, 57), (5, 6)):
            got = readers.read_geno(path, in_bin, True, False, N, S, site_range=(lo, hi))
            np.testing.assert_array_equal(got, full[lo:hi])


def _lazy_env(monkeypatch, tmp_path, sites_per_round=12, n_ind=N):
    """A host budget below any input (lazy) and a device budget of about
    sites_per_round sites a shard; the spill caches in a directory of
    their own."""
    monkeypatch.setenv("NGSDIST_HOST_BUDGET", "1000")
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(3 * sites_per_round * n_ind * 3 * 8))
    spill = tmp_path / "spill"
    spill.mkdir(exist_ok=True)
    monkeypatch.setenv("NGSDIST_SPILL_DIR", str(spill))
    return spill


@pytest.mark.parametrize("style", sorted(STYLES))
def test_lazy_rounds_hold_the_jax_rounds(tmp_path, monkeypatch, style):
    """from_reader over the host budget on 4 shards: the JAX plan (shards,
    rounds, lazy), and every round's rows of every shard those of the JAX
    stream's round (module docstring for the tolerance of binary rows);
    both spill caches are deleted on close."""
    gp = _genome()
    path = str(tmp_path / ("g.bin" if style == "stdin" else STYLES[style]))
    _write(gp, path, style, empty=(40,))
    spill = _lazy_env(monkeypatch, tmp_path)
    geno = "-" if style == "stdin" else path
    kw = dict(in_geno=geno, in_bin=style in ("bin", "bin_gz", "stdin"), in_probs=True,
              n_ind=N, n_sites=S, n_boot_rep=2, boot_block_size=4, indep_geno=True)
    if style == "stdin":
        _stdin(monkeypatch, path)
    st = pmh.SiteStream.from_reader(Params(**kw), pm.make_mesh([CPU] * 4))
    if style == "stdin":
        _stdin(monkeypatch, path)
    jst = JStream.from_reader(JParams(**kw), jpm.make_mesh(n_devices=4), np.float64)
    assert st.lazy and jst.lazy
    assert (st.s_loc, st.chunk, st.n_rounds) == (jst.s_loc, jst.chunk, jst.n_rounds)
    assert st.n_rounds >= 2
    assert len(list(spill.iterdir())) == (0 if style == "bin" else 2)
    full = preprocess(readers.read_geno(path, not style.startswith("text"), True, False, N, S),
                      False, 0.0, 0.0)
    seen = 0
    for r, data in st.rounds(range(st.n_rounds)):
        want = np.asarray(jst.round_data(r)).reshape(4, jst.chunk, N, 3)
        for s, (lo, hi) in enumerate(data.ranges):
            if hi <= lo:
                assert data.parts[s] is None
                continue
            got = data.parts[s].numpy()
            np.testing.assert_array_equal(got, full[lo:hi])
            if style.startswith("text"):
                np.testing.assert_array_equal(got, want[s, :hi - lo])
            else:
                np.testing.assert_allclose(got, want[s, :hi - lo], rtol=1e-13, atol=0)
            seen += hi - lo
    assert seen == S
    st.close()
    jst.close()
    assert list(spill.iterdir()) == []


def test_wants_lazy_and_host_budget_are_the_jax_rules(monkeypatch):
    """The runner's and from_reader's gate takes the JAX estimate (the
    float64 read and the shard in the device's dtype against the host
    budget), so both engines choose the same route."""
    pars, jpars = Params(n_ind=100, n_sites=1000), JParams(n_ind=100, n_sites=1000)
    for budget in ("1", "3600000", "3600001", "2400000", "2400001", "999999999"):
        monkeypatch.setenv("NGSDIST_HOST_BUDGET", budget)
        assert pmh.SiteStream._host_budget_bytes() == JStream._host_budget_bytes()
        for dtype, np_dtype in ((torch.float32, np.float32), (torch.float64, np.float64)):
            for rows in (0, 999, 1000):
                assert (pmh.SiteStream.wants_lazy(pars, dtype, rows)
                        == JStream.wants_lazy(jpars, np_dtype, rows))
    monkeypatch.delenv("NGSDIST_HOST_BUDGET")
    assert pmh.SiteStream._host_budget_bytes() == JStream._host_budget_bytes()
    for geno, want in (("a.bin", True), ("a.bin.gz", False), ("-", False)):
        assert pmh.SiteStream.seekable_binary(Params(in_geno=geno, in_bin=True)) is want


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


def _close(got, want, n):
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g[~np.isnan(w)], w[~np.isnan(w)], rtol=0, atol=1e-9)


FAMILIES = {
    "em": "--geno gl.beagle.gz --probs --n_boot_rep 2 --boot_block_size 50",
    "indep_pdel_bin": "--geno gp.bin --probs --pairwise_del --indep_geno --n_boot_rep 2 "
                      "--boot_block_size 40",
    "hard": "--geno gt.geno.gz --n_boot_rep 2 --boot_block_size 7",
    "k80_em": "--geno gl.beagle.gz --probs --pos pos.txt --evol_model 3",
    "f81_indep": "--geno gl.beagle.gz --probs --pos pos.txt --evol_model 4 --indep_geno "
                 "--n_boot_rep 1 --boot_block_size 50",
    "f84_indep_pdel": "--geno gp.bin --probs --pos pos.txt --evol_model 5 --indep_geno "
                      "--pairwise_del --n_boot_rep 1 --boot_block_size 50",
    "tn93_em": "--geno gl.beagle.gz --probs --pos pos.txt --evol_model 6 --n_boot_rep 1 "
               "--boot_block_size 50",
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_lazy_cli_matches_resident_and_jax(tmp_path, monkeypatch, family):
    """The CLI over the host budget reads in rounds from the file or a
    spill cache (on one `cpu` entry), and matches its resident run and the
    JAX package's lazy run (on its 8 virtual devices) within 1e-9; the
    spill cache is gone afterwards."""
    monkeypatch.chdir(DATA_DIR)
    base = FAMILIES[family].split() + ["--n_ind", "20", "--n_sites", "1200", "--seed", "7",
                                       "--verbose", "0"]
    out_r, out_l, out_j = (str(tmp_path / f"{k}.dist") for k in ("res", "lazy", "jax"))
    assert cli.main(base + ["--out", out_r, "--platform", "cpu"]) == 0
    spill = _lazy_env(monkeypatch, tmp_path, sites_per_round=300, n_ind=20)
    streams = []
    monkeypatch.setattr(pmh.SiteStream, "from_reader",
                        classmethod(lambda cls, *a, _f=pmh.SiteStream.from_reader.__func__:
                                    streams.append(_f(cls, *a)) or streams[-1]))
    assert cli.main(base + ["--out", out_l, "--platform", "cpu"]) == 0
    assert len(streams) == 1 and streams[0].lazy and streams[0].n_rounds >= 3
    assert list(spill.iterdir()) == []
    assert jax_cli.main(base + ["--out", out_j, "--engine", "jax"]) == 0
    n = 1 + int(base[base.index("--n_boot_rep") + 1]) if "--n_boot_rep" in base else 1
    lazy = _read_matrices(out_l)
    _close(lazy, _read_matrices(out_r), n)
    _close(lazy, _read_matrices(out_j), n)


@pytest.mark.parametrize("partials", [True, False], ids=["partials", "weighted"])
def test_lazy_em_poisons_zero_rows_of_a_text_input(tmp_path, monkeypatch, partials):
    """An empty line of a gz text input is a site of all-zero triples: the
    EM without pairwise deletion poisons every pair of the full data and
    of each replicate that draws its block.  A lazy run records the site
    as its rounds read the spill, and matches the resident run (which
    records it from the host tensor) and the JAX package's lazy run, NaN
    for NaN."""
    gp = _genome(5)
    path = str(tmp_path / "g.txt.gz")
    _write(gp, path, "text_gz", empty=(9,))
    base = ["--geno", path, "--probs", "--n_ind", str(N), "--n_sites", str(S), "--seed", "3",
            "--n_boot_rep", "3", "--boot_block_size", "5", "--verbose", "0"]
    if not partials:
        monkeypatch.setattr(tdist, "PARTIALS_BUDGET_BYTES", 0)
    out_r, out_l, out_j = (str(tmp_path / f"{k}.dist") for k in ("res", "lazy", "jax"))
    assert cli.main(base + ["--out", out_r, "--platform", "cpu"]) == 0
    _lazy_env(monkeypatch, tmp_path)
    assert cli.main(base + ["--out", out_l, "--platform", "cpu"]) == 0
    assert jax_cli.main(base + ["--out", out_j, "--engine", "jax"]) == 0
    lazy = _read_matrices(out_l)
    assert np.isnan(lazy[0]).sum() == N * (N - 1)
    drawn = [np.isnan(m).any() for m in lazy[1:]]
    assert any(drawn) and not all(drawn)
    _close(lazy, _read_matrices(out_r), 4)
    _close(lazy, _read_matrices(out_j), 4)


def test_spill_cache_is_deleted_after_an_error(tmp_path, monkeypatch):
    """An error in a round (here the EM kernel's plain version) and an
    error while spilling (a short input) both leave no cache behind."""
    gp = _genome()
    path = str(tmp_path / "g.txt.gz")
    _write(gp, path, "text_gz")
    spill = _lazy_env(monkeypatch, tmp_path)
    base = ["--geno", path, "--probs", "--n_ind", str(N), "--verbose", "0", "--platform", "cpu",
            "--out", str(tmp_path / "o.dist")]

    def boom(*a, **k):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(tdist, "em_raw_cnt", boom)
    with pytest.raises(RuntimeError, match="kernel failed"):
        cli.main(base + ["--n_sites", str(S)])
    assert list(spill.iterdir()) == []
    assert cli.main(base + ["--n_sites", str(S + 5)]) == 255   # premature EOF in the spill
    assert list(spill.iterdir()) == []


def test_lazy_run_killed_in_a_round_resumes_to_the_same_bytes(tmp_path, monkeypatch):
    """One process, lazy and streamed: killed in a replicate's third round,
    the run resumes from its rounds file at that round and writes the
    bytes of an uninterrupted run."""
    gp = _genome(9)
    path = str(tmp_path / "g.bin")
    _write(gp, path, "bin")
    _lazy_env(monkeypatch, tmp_path, sites_per_round=8)
    base = ["--geno", path, "--probs", "--n_ind", str(N), "--n_sites", str(S), "--seed", "3",
            "--n_boot_rep", "2", "--boot_block_size", "4", "--pairwise_del", "--verbose", "0",
            "--platform", "cpu"]
    full = str(tmp_path / "full.dist")
    assert cli.main(base + ["--out", full]) == 0
    calls = []
    orig = pm.ShardStats.__call__

    def spy(self, *a, **k):
        calls.append(1)
        if len(calls) == spy.at:
            raise KeyboardInterrupt
        return orig(self, *a, **k)

    pars, _ = cli.parse_args(base + ["--out", full])
    pars.finalize()
    st = pmh.SiteStream.from_reader(pars, pm.make_mesh([CPU]))
    assert st.lazy and st.n_rounds >= 4
    spy.at = st.n_rounds + 3        # replicate 1, round 3
    monkeypatch.setattr(pm.ShardStats, "__call__", spy)
    out = str(tmp_path / "o.dist")
    with pytest.raises(KeyboardInterrupt):
        cli.main(base + ["--out", out])
    assert os.path.exists(out + ".rounds.npz")
    spy.at = 0
    calls.clear()
    assert cli.main(base + ["--out", out, "--resume"]) == 0
    assert len(calls) == 2 * st.n_rounds - 2       # rounds 3.. of rep 1, then rep 2
    assert open(out, "rb").read() == open(full, "rb").read()


def test_run_without_a_device_takes_the_card_or_stops(tmp_path, monkeypatch):
    """runner.run(pars) names no device: it runs on the card, and with no
    card it stops with an NgsDistError that says so (before, it reached
    distance.default_dtype(None) and raised an AttributeError)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pars = Params(in_geno=os.path.join(DATA_DIR, "gl.beagle.gz"), in_probs=True, n_ind=20,
                  n_sites=1200, out=str(tmp_path / "o.dist"), verbose=0)
    with pytest.raises(NgsDistError, match="no CUDA device is available"):
        runner.run(pars)
    with pytest.raises(NgsDistError, match="no CUDA device is available"):
        runner.run(pars, device=None)
    # the CPU when asked for
    (mat,) = runner.run(pars, device=CPU)
    assert mat.shape == (20, 20)
