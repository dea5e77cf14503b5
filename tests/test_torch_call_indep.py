"""--call_geno through the port on the CPU against the plain reference of
called genotypes (gpubench/reference/call_indep.py), on inputs with
missing calls from the benchmark's generator (gpubench/gen/callset.py),
and the tracing of the coded lane: the "expand" span and the codes
reader's counters.

The port's CPU path is float64 throughout and the scores of called
genotypes are 0, 1/2 and 1, so a pair's sums are exact under
--pairwise_del and within a few ulps without it (the uniform triple of a
missing call); the phylip text rounds each value to %.10f, 5e-11.  A
distance within 1e-9 of the reference is therefore the reference's, and
a single call read wrong moves a pair's distance by about 1/2 over the
sites it counts, 2.5e-4 here."""

import numpy as np
import pytest
import torch

from gpubench.checks.ngsdist_em import judge_file
from gpubench.gen import callset
from gpubench.reference import call_indep as ref
from gpubench.reference.ngsdist import read_binary_gp
from ngsdist_tpu_torch import cli
from ngsdist_tpu_torch.io import readers
from ngsdist_tpu_torch.utils import profiling

CPU = torch.device("cpu")
N, S = 48, 2000
SEEDS = (2**31 + 21, 2**33 + 7, 4_100_000_003)
BOUND = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tensors here are small: one intra-op thread runs them faster
    than a pool that waits on a busy host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """{seed: path} of 48 x 2,000 called-genotype inputs at the
    configuration's depths with 2% missing calls."""
    root = tmp_path_factory.mktemp("callset")
    out = {}
    for seed in SEEDS:
        out[seed] = str(root / f"{seed}.bin")
        callset.write_callset(out[seed], S, N, (35.0, 50.0), 0.01, 0.02, seed, CPU)
    return out


def _run(path, out, args, boot_seed=2**32 + 17):
    argv = ["--geno", path, "--n_ind", str(N), "--n_sites", str(S), "--probs", "--call_geno",
            *args, "--seed", str(boot_seed), "--out", out, "--verbose", "0",
            "--platform", "cpu"]
    assert cli.main(argv) == 0
    return boot_seed


@pytest.mark.parametrize("lane", ["staged", "coded"])
@pytest.mark.parametrize("n_boot_rep", [0, 2])
@pytest.mark.parametrize("evol_model", [0, 1])
@pytest.mark.parametrize("pairwise_del", [True, False], ids=["pairwise_del", "all_sites"])
@pytest.mark.parametrize("seed", SEEDS)
def test_port_matches_the_reference(inputs, tmp_path, monkeypatch, seed, pairwise_del,
                                    evol_model, n_boot_rep, lane):
    """Every pair of every matrix within BOUND of the reference, read
    staged (the CPU's default) or through the fused codes reader and the
    code plane (NGSDIST_CODED_UPLOAD=1, the card's lane)."""
    monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "1" if lane == "coded" else "0")
    args = ["--evol_model", str(evol_model)]
    args += ["--pairwise_del"] if pairwise_del else []
    args += ["--n_boot_rep", str(n_boot_rep), "--boot_block_size", "10"] if n_boot_rep else []
    out = str(tmp_path / "o.dist")
    boot_seed = _run(inputs[seed], out, args)
    I, J = np.triu_indices(N, 1)
    codes = ref.call_codes(read_binary_gp(inputs[seed], N, S, CPU))
    assert 0.01 < (codes == ref.MISSING).double().mean() < 0.03
    terms, called = ref.pair_site_terms(codes, I, J)
    expected = ref.distances(terms, called, pairwise_del, boot_seed, n_boot_rep, 10,
                             evol_model)
    d_err, bad, faults = judge_file(out, expected, I, J, N)
    assert bad == 0 and not faults
    assert d_err <= BOUND


def test_reference_calls_by_hand(tmp_path):
    """The reference's calls of a tie of two maxima (the first wins), of
    all-equal triples (missing: equal values and the all-zero triple the
    reader makes uniform) and of a log-scale input (its exp's call), and
    the port's fused codes reader on the same file; each pair's score by
    parse_args.cpp's matrix, the uniform triple's expected score for a
    missing call."""
    raw = np.array([[0.4, 0.4, 0.2], [0.2, 0.5, 0.5], [0.1, 0.2, 0.7],
                    [0.25, 0.25, 0.25], [0.0, 0.0, 0.0], [0.0, 3.0, 1.0]])
    path = str(tmp_path / "hand.bin")
    raw.tofile(path)
    want = [0, 1, 2, ref.MISSING, ref.MISSING, 1]
    codes = ref.call_codes(read_binary_gp(path, 6, 1, CPU))[0]
    assert codes.tolist() == want
    logs = torch.log(torch.tensor(raw[:4]))
    assert ref.call_codes(logs, log_scale=True).tolist() == want[:4]
    assert ref.call_codes(torch.full((3,), -2.5), log_scale=True).item() == ref.MISSING
    port, any_missing = readers.read_geno_codes(path, False, 6, 1)
    assert port[0].tolist() == want and any_missing
    table = ref.code_scores(CPU)
    assert table[0, 2] == 1.0 and table[0, 1] == 0.5 and table[1, 1] == 0.0
    assert table[0, 3] == pytest.approx(0.5, abs=1e-16)
    assert table[1, 3] == pytest.approx(1 / 3, abs=1e-16)
    assert table[3, 3] == pytest.approx(4 / 9, abs=1e-16)
    terms, called = ref.pair_site_terms(codes[None], np.array([0, 0, 3]), np.array([2, 3, 4]))
    assert terms[0].tolist() == pytest.approx([1.0, 0.5, 4 / 9], abs=1e-16)
    assert called[0].tolist() == [1.0, 0.0, 0.0]


@pytest.fixture
def spans(monkeypatch):
    """The port's spans on (profiling.ACTIVE), the codes counters at 0."""
    monkeypatch.setattr(readers, "CODED_READS", 0)
    monkeypatch.setattr(readers, "CODED_ROWS", 0)
    times = profiling.StageTimes(CPU)
    monkeypatch.setattr(profiling, "ACTIVE", times)
    return times


@pytest.mark.parametrize("n_boot_rep", [0, 2])
def test_coded_run_records_expand_and_counts_its_reads(inputs, tmp_path, monkeypatch, spans,
                                                       n_boot_rep):
    """A coded CPU run uploads the code plane once in slabs of the pipe's
    bytes of codes (here 43,680: 910 sites of 48 one-byte codes, so 910,
    910 and 180 sites): three reads of the codes reader, 2,000 sites in
    all, and one "expand" span a slab, each inside an "upload" span."""
    from ngsdist_tpu_torch.core import distance

    monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "1")
    monkeypatch.setattr(distance, "_pipe_upload_bytes", lambda: 910 * 48)
    args = ["--pairwise_del"]
    args += ["--n_boot_rep", str(n_boot_rep), "--boot_block_size", "10"] if n_boot_rep else []
    _run(inputs[SEEDS[0]], str(tmp_path / "o.dist"), args)
    assert (readers.CODED_READS, readers.CODED_ROWS) == (3, S)
    iv = spans.intervals()
    assert len(iv["expand"]) == 3
    for s, e in iv["expand"]:
        assert any(a <= s and e <= b for a, b in iv["upload"])


def test_staged_run_has_no_expand_and_no_coded_read(inputs, tmp_path, monkeypatch, spans):
    monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "0")
    _run(inputs[SEEDS[0]], str(tmp_path / "o.dist"), ["--pairwise_del"])
    assert (readers.CODED_READS, readers.CODED_ROWS) == (0, 0)
    assert spans.intervals()["expand"] == []
