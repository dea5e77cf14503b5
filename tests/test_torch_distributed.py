"""`python -m ngsdist_tpu_torch --coordinator HOST:PORT --num_processes 2
--process_id 0|1`: two processes on the CPU, joined by gloo, after the
JAX package's tests/test_run_distributed.py.

Process 0's file must be, byte for byte (md5), the port's one-process
run with `--devices 2` (the same two shards, summed in the same order),
and within 1e-9 of `python -m ngsdist_tpu --engine jax` in one process
(float64 sums taken in other orders; counts exact).  The cases: the EM
and indep, with and without --pairwise_del, the partial-sum and the
weighted bootstrap routes, resident, streamed in rounds and lazy (read
from the file or a spill cache in rounds), models 1 and 3-6, and the EM
of a text input with an empty line on the partial-sum route, whose
zero-row flags lie in process 1's sites (the case that stops the JAX
package's multi-process run: it fetches a global array there,
ngsdist_tpu/core/distance.py:1214); two of them with all-gathers of a
few elements each (mesh.GATHER_CHUNK).  A lazy run whose rounds the host
budget cuts to other lengths in two processes than in one is held to the
one process within 1e-9 instead.  Then the resume of a run after
a finished matrix, and after a hard exit of both processes in the middle
of a replicate's rounds; and an error in one process, which must stop
the other with an error too.

All runs of one launch go through one pair of worker processes in turn,
each with its own coordinator port; every worker has a wall-clock limit
and is killed past it."""

import gzip
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ngsdist_tpu import cli as jax_cli  # noqa: E402
from ngsdist_tpu_torch import cli  # noqa: E402
from ngsdist_tpu_torch.core import distance as tdist  # noqa: E402
from ngsdist_tpu_torch.parallel import mesh as pm  # noqa: E402
from ngsdist_tpu_torch.parallel import multihost as pmh  # noqa: E402
from ngsdist_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, N = 300, 8
WALL = 120  # seconds a worker may take for one launch

_WORKER = r"""
import json, os, sys
rank, spec = int(sys.argv[1]), json.load(open(sys.argv[2]))
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from ngsdist_tpu_torch import cli
from ngsdist_tpu_torch.core import distance as tdist
from ngsdist_tpu_torch.parallel import mesh as pm

call = pm.ShardStats.__call__
chunk = pm.GATHER_CHUNK
for run in spec:
    for k in ("NGSDIST_DEVICE_BUDGET", "NGSDIST_HOST_BUDGET", "NGSDIST_SPILL_DIR"):
        os.environ.pop(k, None)
    os.environ.update(run["env"])
    tdist.PARTIALS_BUDGET_BYTES = 0 if run["weighted"] else 1 << 30
    pm.GATHER_CHUNK = run.get("gather_chunk") or chunk
    pm.ShardStats.__call__ = call
    if run.get("crash_after"):
        # a hard exit (no cleanup, as a kill) at the given call of the
        # statistics: the collectives keep both processes in step, so both
        # stop at the same round
        seen = [0]

        def spy(self, *a, **k):
            seen[0] += 1
            if seen[0] == run["crash_after"]:
                os._exit(17)
            return call(self, *a, **k)

        pm.ShardStats.__call__ = spy
    rc = cli.main(run["argv"] + ["--coordinator", "127.0.0.1:%d" % run["port"],
                                 "--num_processes", "2", "--process_id", str(rank)])
    print("RUN", run["name"], rc, flush=True)
    if rc:
        sys.exit(rc)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(work, runs, tag):
    """Both workers over `runs` in turn; returns their exit codes and
    output.  Each is killed past WALL seconds."""
    worker = work / "worker.py"
    worker.write_text(_WORKER.format(repo=REPO))
    spec = work / f"spec_{tag}.json"
    spec.write_text(json.dumps([dict(r, port=_free_port()) for r in runs]))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("NGSDIST_") and k != "XLA_FLAGS"}
    procs = [subprocess.Popen([sys.executable, str(worker), str(rank), str(spec)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              text=True) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WALL)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def _inputs(work):
    """A seeded genome as raw binary and as gz text with an empty line at
    site 270 (in process 1's sites and in the EM's last bootstrap block
    of 32 sites: the EM's resident shards are 256 sites), and a POS file
    of seeded allele pairs."""
    rng = np.random.default_rng(31)
    gp = rng.dirichlet(np.ones(3), size=(S, N))
    gp[rng.random((S, N)) < 0.1] = 1 / 3
    gp.astype("<f8").tofile(work / "gp.bin")
    with gzip.open(work / "gp.txt.gz", "wt") as fh:
        for s in range(S):
            fh.write("" if s == 270 else "\t".join(f"{x:.8f}" for x in gp[s].reshape(-1)))
            fh.write("\n")
    a = rng.integers(0, 4, S)
    b = (a + rng.integers(1, 4, S)) % 4
    with open(work / "pos.txt", "w") as fh:
        fh.write("".join(f"chr1\t{s + 1}\t{'ACGT'[x]}\t{'ACGT'[y]}\n"
                         for s, (x, y) in enumerate(zip(a, b))))


def _budget(sites):
    """NGSDIST_DEVICE_BUDGET of about `sites` sites a shard."""
    return str(3 * sites * N * 3 * 8)


LAZY = {"NGSDIST_HOST_BUDGET": "1000", "NGSDIST_DEVICE_BUDGET": _budget(40)}
# A host budget that cuts a lazy round of a process of one shard to 40
# sites and of one process of two shards to 20 (SiteStream._lazy_chunk:
# a third of it over the shards' N x 3 float64 rows), under a device
# budget that cuts neither: the two runs read in rounds of other lengths.
HOST_BOUND = {"NGSDIST_HOST_BUDGET": str(3 * 40 * N * 3 * 8),
              "NGSDIST_DEVICE_BUDGET": _budget(1000)}
# name -> (input, flags, environment, weighted route forced)
CASES = {
    "em_text_partials": ("gp.txt.gz", "--probs --n_boot_rep 3 --boot_block_size 32", {}, False),
    "em_pdel_weighted": ("gp.bin", "--probs --pairwise_del --n_boot_rep 2 --boot_block_size 32",
                         {}, True),
    "indep_partials": ("gp.bin", "--probs --indep_geno --n_boot_rep 2 --boot_block_size 20",
                       {}, False),
    "indep_pdel_streamed": ("gp.bin", "--probs --indep_geno --pairwise_del --n_boot_rep 2 "
                            "--boot_block_size 20", {"NGSDIST_DEVICE_BUDGET": _budget(40)},
                            False),
    "em_jc69_streamed": ("gp.bin", "--probs --evol_model 1 --n_boot_rep 2 --boot_block_size 20",
                         {"NGSDIST_DEVICE_BUDGET": _budget(40)}, False),
    "indep_lazy": ("gp.bin", "--probs --indep_geno --n_boot_rep 2 --boot_block_size 20", LAZY,
                   False),
    "em_lazy_spill": ("gp.txt.gz", "--probs --n_boot_rep 2 --boot_block_size 20", LAZY, False),
    "k80_em_lazy_spill": ("gp.txt.gz", "--probs --pos pos.txt --evol_model 3", LAZY, False),
    "f81_indep_streamed": ("gp.bin", "--probs --pos pos.txt --evol_model 4 --indep_geno "
                           "--n_boot_rep 1 --boot_block_size 20",
                           {"NGSDIST_DEVICE_BUDGET": _budget(40)}, False),
    "f84_indep_pdel": ("gp.bin", "--probs --pos pos.txt --evol_model 5 --indep_geno "
                       "--pairwise_del --n_boot_rep 1 --boot_block_size 32", {}, False),
    "tn93_em": ("gp.bin", "--probs --pos pos.txt --evol_model 6 --n_boot_rep 1 "
                "--boot_block_size 32", {}, False),
    "indep_lazy_host_bound": ("gp.bin", "--probs --indep_geno --n_boot_rep 2 "
                              "--boot_block_size 20", HOST_BOUND, False),
}
# Cases whose rounds the host budget cuts to other lengths in two
# processes than in one: held to 1e-9, not to the one process's bytes.
PLAN_DIFFERS = ("indep_lazy_host_bound",)
# Cases whose multi-process sums go through all-gathers of a few elements
# each (mesh.GATHER_CHUNK), as a bootstrap's replicates of a long genome
# do at full width: the bytes must not change.
GATHER_CHUNKS = {"indep_partials": 5, "em_lazy_spill": 7}


def _argv(work, name, out):
    geno, flags, _, _ = CASES[name]
    flags = flags.replace("pos.txt", str(work / "pos.txt"))
    return (["--geno", str(work / geno), "--n_ind", str(N), "--n_sites", str(S), "--seed", "5",
             "--verbose", "0", "--platform", "cpu", "--out", str(out)] + flags.split())


def _env(work, name):
    env = dict(CASES[name][2])
    if "NGSDIST_HOST_BUDGET" in env:
        (work / "spill").mkdir(exist_ok=True)
        env["NGSDIST_SPILL_DIR"] = str(work / "spill")
    return env


def _run(work, name, tag="", **kw):
    return dict(name=name, argv=_argv(work, name, work / f"{name}{tag}.dist"),
                env=_env(work, name), weighted=CASES[name][3],
                gather_chunk=GATHER_CHUNKS.get(name), **kw)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every case through one launch of two workers."""
    work = tmp_path_factory.mktemp("dist")
    _inputs(work)
    rcs, outs = _launch(work, [_run(work, name) for name in CASES], "all")
    assert rcs == [0, 0], outs
    return work


def _matrices(path):
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


def _one_process(monkeypatch, work, name, argv, main):
    """A one-process run of the case under its environment and route."""
    for k in ("NGSDIST_DEVICE_BUDGET", "NGSDIST_HOST_BUDGET", "NGSDIST_SPILL_DIR"):
        monkeypatch.delenv(k, raising=False)
    for k, v in _env(work, name).items():
        monkeypatch.setenv(k, v)
    if CASES[name][3]:
        monkeypatch.setattr(tdist, "PARTIALS_BUDGET_BYTES", 0)
    assert main(argv) == 0


def _close(two, other, name):
    """Process 0's matrices against another run's: the same count and
    NaNs, and within 1e-9."""
    got, want = _matrices(two), _matrices(other)
    reps = CASES[name][1].split()
    n = 1 + (int(reps[reps.index("--n_boot_rep") + 1]) if "--n_boot_rep" in reps else 0)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert g.shape == (N, N)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g[~np.isnan(w)], w[~np.isnan(w)], rtol=0, atol=1e-9)
    return got


@pytest.mark.parametrize("name", sorted(n for n in CASES if n not in PLAN_DIFFERS))
def test_two_processes_write_the_bytes_of_one_with_two_devices(launched, tmp_path,
                                                               monkeypatch, name):
    work = launched
    two = work / f"{name}.dist"
    one = tmp_path / "one.dist"
    jax = tmp_path / "jax.dist"
    _one_process(monkeypatch, work, name, _argv(work, name, one) + ["--devices", "2"], cli.main)
    assert open(two, "rb").read() == open(one, "rb").read()
    argv = [a for a in _argv(work, name, jax) if a not in ("--platform", "cpu")]
    _one_process(monkeypatch, work, name, argv + ["--engine", "jax"], jax_cli.main)
    got = _close(two, jax, name)
    if name == "em_text_partials":
        # the empty line poisons the full data and the replicates that
        # draw its block, whose flags only process 1 holds
        assert np.isnan(got[0]).sum() == N * (N - 1)
        drawn = [np.isnan(m).any() for m in got[1:]]
        assert any(drawn) and not all(drawn)
    if "NGSDIST_SPILL_DIR" in _env(work, name):
        assert list((work / "spill").iterdir()) == []   # every process deleted its cache


def test_a_host_budget_that_cuts_the_rounds_follows_the_split(launched, tmp_path,
                                                              monkeypatch):
    """Where the host budget cuts a lazy round, a process of one shard
    reads rounds twice as long as one process of two shards
    (SiteStream._lazy_chunk): the two runs add their float64 sums in
    other orders, so process 0's file is held to the one-process run and
    to the JAX engine within 1e-9, not to the bytes."""
    work, name = launched, "indep_lazy_host_bound"
    for k, v in _env(work, name).items():
        monkeypatch.setenv(k, v)
    pars = _pars(work, name, tmp_path / "plan.dist")
    two_entries = pm.make_mesh([torch.device("cpu")] * 2)
    s_loc, chunk = pmh.SiteStream._plan(pars, two_entries)
    assert chunk == s_loc
    dtype = tdist.default_dtype(torch.device("cpu"))
    # one process of two shards; process 0 of two, one shard each
    assert pmh.SiteStream._lazy_chunk(pars, two_entries, dtype, chunk) == 20
    one_entry = pm.make_mesh([torch.device("cpu")])
    assert pmh.SiteStream._lazy_chunk(pars, one_entry, dtype, chunk) == 40
    one, jax = tmp_path / "one.dist", tmp_path / "jax.dist"
    _one_process(monkeypatch, work, name, _argv(work, name, one) + ["--devices", "2"], cli.main)
    _close(work / f"{name}.dist", one, name)
    argv = [a for a in _argv(work, name, jax) if a not in ("--platform", "cpu")]
    _one_process(monkeypatch, work, name, argv + ["--engine", "jax"], jax_cli.main)
    _close(work / f"{name}.dist", jax, name)
    assert list((work / "spill").iterdir()) == []


def _pars(work, name, out):
    pars, _ = cli.parse_args(_argv(work, name, out))
    pars.finalize()
    return pars


def test_resume_after_a_finished_matrix(launched):
    """Process 0's sidecar says 2 matrices are written: every process
    skips them, and the file ends as the uninterrupted run's."""
    work, name = launched, "em_pdel_weighted"
    full = open(work / f"{name}.dist").read()
    out = work / f"{name}_resume.dist"
    lines = full.split("\n")
    out.write_text("\n".join(lines[:2 * (N + 2)]) + "\n")
    ckpt.save(str(out), _pars(work, name, out), 2, engine=tdist.engine_name(torch.device("cpu")))
    run = _run(work, name, "_resume")
    run["argv"].append("--resume")
    rcs, outs = _launch(work, [run], "resume")
    assert rcs == [0, 0], outs
    assert out.read_text() == full
    assert not os.path.exists(ckpt.state_path(str(out)))


def test_hard_exit_in_a_round_then_resume_repeats_the_bytes(launched, monkeypatch):
    """Both processes stop hard in replicate 1's third round (process 0
    has saved its first two in the rounds file); a resumed launch starts
    there and writes the bytes of the uninterrupted run."""
    work, name = launched, "em_jc69_streamed"
    out = work / f"{name}_crash.dist"
    for k, v in _env(work, name).items():
        monkeypatch.setenv(k, v)
    s_loc, chunk = pmh.SiteStream._plan(_pars(work, name, out),
                                        pm.make_mesh([torch.device("cpu")] * 2))
    n_rounds = -(-s_loc // chunk)
    assert n_rounds >= 4
    rcs, outs = _launch(work, [_run(work, name, "_crash", crash_after=n_rounds + 3)], "crash")
    assert 0 not in rcs, outs
    assert os.path.exists(str(out) + ".rounds.npz")
    run = _run(work, name, "_crash")
    run["argv"].append("--resume")
    rcs, outs = _launch(work, [run], "crash_resume")
    assert rcs == [0, 0], outs
    assert open(out, "rb").read() == open(work / f"{name}.dist", "rb").read()


@pytest.mark.parametrize("extra,needle", [
    (["--pairs", "2"], "--pairs is not supported with --coordinator"),
    (["--throughput"], "--throughput is not supported with --coordinator"),
    (["--trace_dir", "t"], "--trace_dir is not supported with --coordinator"),
    (["--num_processes", "2"], "--coordinator needs --num_processes and --process_id"),
    (["--num_processes", "2", "--process_id", "2"], "--process_id 2 is not in [0, 2)"),
])
def test_coordinator_refusals(extra, needle, tmp_path, capsys):
    """The JAX CLI's refusals under --coordinator (ngsdist_tpu/cli.py:
    299-313), and a process count or id that cannot form a group; none
    of them starts a process group."""
    args = ["--geno", "x.bin", "--n_ind", "4", "--n_sites", "10", "--platform", "cpu",
            "--out", str(tmp_path / "x.dist"), "--verbose", "0",
            "--coordinator", "127.0.0.1:1", *extra]
    assert cli.main(args) == 255
    assert needle in capsys.readouterr().err
    assert pmh.process_count() == 1


def test_run_distributed_in_one_process_is_the_runner_on_its_mesh(tmp_path):
    """Without a coordinator run_distributed is the pipeline of one process
    over the mesh it is handed (here two `cpu` entries, as the JAX tests
    force two host devices): the bytes runner.run writes on that mesh,
    and the matrices it returns."""
    from ngsdist_tpu_torch import runner

    _inputs(tmp_path)
    mesh = pm.make_mesh([torch.device("cpu")] * 2)
    one, two = tmp_path / "runner.dist", tmp_path / "dist.dist"
    pars, _ = cli.parse_args(_argv(tmp_path, "indep_partials", one))
    want = runner.run(pars, mesh=mesh)
    pars, _ = cli.parse_args(_argv(tmp_path, "indep_partials", two))
    got = pmh.run_distributed(pars, mesh=mesh)
    assert open(two, "rb").read() == open(one, "rb").read()
    assert len(got) == len(want) == 3
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_an_error_in_one_process_stops_the_other(tmp_path):
    """A NaN in process 1's sites is its read's fatal (exit 255); process
    0, waiting in the next collective, sees the peer gone and exits with
    an error too, well within the wall-clock limit: no process carries on
    alone or hangs."""
    rng = np.random.default_rng(3)
    gp = rng.dirichlet(np.ones(3), size=(S, N))
    gp[S - 10, 2, 0] = np.nan
    gp.astype("<f8").tofile(tmp_path / "nan.bin")
    argv = ["--geno", str(tmp_path / "nan.bin"), "--probs", "--indep_geno", "--n_ind", str(N),
            "--n_sites", str(S), "--verbose", "0", "--platform", "cpu",
            "--out", str(tmp_path / "nan.dist")]
    rcs, outs = _launch(tmp_path, [dict(name="nan", argv=argv, env={}, weighted=False)], "nan")
    assert rcs[1] == 255 and "NaN found" in outs[1], outs
    assert rcs[0] not in (0, None), outs
