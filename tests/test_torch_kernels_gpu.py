"""The port's CUDA kernels against their plain PyTorch versions on a card.

Marked `gpu`; each test skips without a CUDA device.  This file imports
no jax, so on a machine with a card and no jax it runs on its own:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from ngsdist_tpu_torch.ops import em, indep  # noqa: E402

SCORE9 = np.array([[0.0, 0.5, 1.0], [0.5, 0.0, 0.5], [1.0, 0.5, 0.0]]).reshape(-1)
KERNELS = {"indep": (indep.indep_raw_cnt, indep.indep_raw_cnt_ref),
           "em": (em.em_raw_cnt, em.em_raw_cnt_ref)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(KERNELS))
@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_kernel_matches_plain(cuda, kind, pairwise_del, weighted):
    rng = np.random.default_rng(3)
    S, N = 777, 130
    P = chip_smoke.rand_probs(rng, S, N, missing=0.1)
    P[rng.random((S, N)) < 0.01] = 0.0
    P[5, 7] = np.nan
    P32 = torch.from_numpy(P).to(cuda).float()
    w = (torch.from_numpy(rng.integers(0, 4, S).astype(np.float64)).to(cuda)
         if weighted else None)
    fn, ref = KERNELS[kind]
    before = (indep.LAUNCHES, em.LAUNCHES)
    got = fn(P32, SCORE9, pairwise_del, w)
    torch.cuda.synchronize()
    launched = (indep.LAUNCHES - before[0], em.LAUNCHES - before[1])
    assert launched == ((1, 0) if kind == "indep" else (0, 1))
    chip_smoke.check_kernel(kind, torch, *got,
                            *ref(P32.double(), SCORE9, pairwise_del, w))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_kernel_rejects_float64(cuda, kind):
    P = torch.zeros((4, 3, 3), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        KERNELS[kind][0](P, SCORE9, False)


def _case(cuda, S, N, seed=4):
    rng = np.random.default_rng(seed)
    P = chip_smoke.rand_probs(rng, S, N, missing=0.1)
    P[rng.random((S, N)) < 0.01] = 0.0
    P[rng.integers(S), rng.integers(N)] = np.nan
    w = torch.from_numpy(rng.integers(0, 4, S).astype(np.float64)).to(cuda)
    return torch.from_numpy(P).to(cuda).float(), w


@pytest.mark.gpu
@pytest.mark.parametrize("N,S", chip_smoke.CHUNKED_SHAPES)
@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_indep_several_chunks_ragged(cuda, N, S, pairwise_del, weighted):
    """Shapes whose sites split into several chunks, the last one ragged:
    cnt exact, raw within chip_smoke.INDEP_RTOL, reruns byte-identical."""
    chunks, chunk_sites = indep.split_plan(N, S)
    assert chunks > 1 and S % chunk_sites != 0
    P32, w = _case(cuda, S, N)
    w = w if weighted else None
    got = indep.indep_raw_cnt(P32, SCORE9, pairwise_del, w)
    chip_smoke.check_kernel("indep", torch, *got,
                            *indep.indep_raw_cnt_ref(P32.double(), SCORE9, pairwise_del, w))
    chip_smoke.check_rerun(torch, indep.indep_raw_cnt, P32, pairwise_del, w, got)


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True])
def test_indep_reruns_byte_identical(cuda, weighted):
    """Ten calls at a multi-chunk shape give the same bytes: the order of
    every sum is fixed by the shape."""
    P32, w = _case(cuda, 3001, 256)
    w = w if weighted else None
    first = indep.indep_raw_cnt(P32, SCORE9, True, w)
    for _ in range(9):
        again = indep.indep_raw_cnt(P32, SCORE9, True, w)
        assert all(chip_smoke.same_bytes(torch, a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True])
def test_indep_cnt_exact(cuda, weighted):
    """cnt equals the float64 plain version exactly on the upper
    triangle (integer weights), unweighted and weighted."""
    P32, w = _case(cuda, 2500, 130)
    w = w if weighted else None
    _, cnt = indep.indep_raw_cnt(P32, SCORE9, True, w)
    _, want = indep.indep_raw_cnt_ref(P32.double(), SCORE9, True, w)
    iu = torch.triu_indices(130, 130, device=cuda)
    assert torch.equal(cnt[iu[0], iu[1]].double(), want[iu[0], iu[1]])
    assert not bool(torch.tril(cnt, -1).any())


@pytest.mark.gpu
@pytest.mark.parametrize("N,S", chip_smoke.EM_EDGE_SHAPES)
@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_em_tile_edges(cuda, N, S, pairwise_del, weighted):
    """Shapes across the EM kernel's 32-individual tiles and 2-site step:
    cnt exact, raw within chip_smoke.EM_ATOL_CNT x cnt, reruns
    byte-identical."""
    P32, w = _case(cuda, S, N)
    w = w if weighted else None
    got = em.em_raw_cnt(P32, SCORE9, pairwise_del, w)
    chip_smoke.check_kernel("em", torch, *got,
                            *em.em_raw_cnt_ref(P32.double(), SCORE9, pairwise_del, w))
    chip_smoke.check_rerun(torch, em.em_raw_cnt, P32, pairwise_del, w, got)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [31, 65])
@pytest.mark.parametrize("block_size", [1, 3, 5, 6])
def test_em_block_ends_inside_steps(cuda, N, block_size):
    """Block ends off the 2-site step, tiles ragged: C exact, B within
    em_table_bound(block_size) x C of the plain version and far inside
    it of the plain emulation of the kernel's arithmetic."""
    n_blocks = 50 // block_size
    P32, _ = _case(cuda, n_blocks * block_size, N)
    chip_smoke.block_case(torch, indep, em, "em", P32, True, n_blocks, block_size)
    B, C = em.em_block_partials(P32, SCORE9, True, n_blocks, block_size)
    Bt, Ct = em.em_block_partials_tables(P32.double(), SCORE9, True, n_blocks, block_size)
    assert torch.equal(C, Ct)
    ok = ~torch.isnan(Bt)
    assert torch.equal(torch.isnan(B), ~ok)
    # the same powers and stopping steps; the contraction may fuse a*b+c
    assert bool(((B - Bt).abs()[ok] <= 32 * 2.0 ** -53 * (1 + block_size) * C[ok]).all())


@pytest.mark.gpu
def test_em_reruns_byte_identical(cuda):
    """Ten calls give the same bytes: each lane sums in site order."""
    P32, w = _case(cuda, 301, 97)
    first = em.em_raw_cnt(P32, SCORE9, True, w)
    for _ in range(9):
        chip_smoke.check_rerun(torch, em.em_raw_cnt, P32, True, w, first)


@pytest.mark.gpu
@pytest.mark.parametrize("N,S", [(33, 101), (130, 777)])
@pytest.mark.parametrize("pairwise_del", [False, True])
def test_em_site_list_gives_the_whole_runs_bytes(cuda, N, S, pairwise_del):
    """The EM kernel handed an ascending list of the sites of nonzero
    weight (and of the NaN site, at weight 0): the bytes of the run over
    all sites under the same weights, and those of the kernel on the
    gathered sites; a list in another order runs in that order."""
    P32, w = _case(cuda, S, N)
    keep = ~torch.isfinite(P32.sum((1, 2)))
    assert int(keep.sum()) == 1
    w[keep] = 0.0
    index = torch.nonzero((w != 0) | keep)[:, 0]
    assert 0 < index.numel() < S
    full = em.em_raw_cnt(P32, SCORE9, pairwise_del, w)
    listed = em.em_raw_cnt(P32, SCORE9, pairwise_del, w[index], site_index=index)
    gathered = em.em_raw_cnt(P32.index_select(0, index), SCORE9, pairwise_del, w[index])
    assert bool(torch.isnan(full[0]).any())
    for a, b, c in zip(full, listed, gathered):
        assert chip_smoke.same_bytes(torch, a, b) and chip_smoke.same_bytes(torch, b, c)
    chip_smoke.check_kernel("em", torch, *listed, *em.em_raw_cnt_ref(
        P32.double(), SCORE9, pairwise_del, w[index], site_index=index))
    back = index.flip(0)
    again = em.em_raw_cnt(P32, SCORE9, pairwise_del, w[back], site_index=back)
    want = em.em_raw_cnt(P32.index_select(0, back), SCORE9, pairwise_del, w[back])
    assert all(chip_smoke.same_bytes(torch, a, b) for a, b in zip(again, want))
    with pytest.raises(ValueError, match="site_index"):
        em.em_raw_cnt(P32, SCORE9, pairwise_del, w[index], site_index=index.int())
    with pytest.raises(ValueError, match="site_weights"):
        em.em_raw_cnt(P32, SCORE9, pairwise_del, w, site_index=index)


@pytest.mark.gpu
def test_indep_unaligned_rows(cuda):
    """A tensor whose data does not start on 16 bytes takes the kernel's
    4-byte copies and gives the same bytes as an aligned copy of it."""
    P32, w = _case(cuda, 1500, 128)
    flat = torch.empty(P32.numel() + 1, dtype=torch.float32, device=cuda)
    shifted = flat[1:].view(P32.shape)
    shifted.copy_(P32)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    for a, b in zip(indep.indep_raw_cnt(P32, SCORE9, True, w),
                    indep.indep_raw_cnt(shifted, SCORE9, True, w)):
        assert chip_smoke.same_bytes(torch, a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_kernel_rejects_bad_layout(cuda, kind):
    """A CUDA tensor the kernel does not take raises; nothing falls back."""
    P = torch.zeros((4, 5, 3), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        KERNELS[kind][0](P.transpose(0, 1), SCORE9, False)
    with pytest.raises(ValueError, match="shape"):
        KERNELS[kind][0](P[..., :2], SCORE9, False)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(KERNELS))
@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("block_size", chip_smoke.BLOCK_SIZES)
def test_block_partials_match_plain(cuda, kind, pairwise_del, block_size):
    """The block modes against their float64 plain versions at ragged
    block sizes with NaN and zero rows: C exact, B within the kernels'
    bounds, reruns byte-identical; each call one launch."""
    n_blocks = chip_smoke.BLOCK_SITES // block_size
    P32, _ = chip_smoke.small_case(np.random.default_rng(block_size), torch,
                                   n_blocks * block_size, chip_smoke.BLOCK_N)
    before = (indep.BLOCK_LAUNCHES, em.BLOCK_LAUNCHES)
    chip_smoke.block_case(torch, indep, em, kind, P32, pairwise_del, n_blocks, block_size)
    torch.cuda.synchronize()
    launched = (indep.BLOCK_LAUNCHES - before[0], em.BLOCK_LAUNCHES - before[1])
    assert launched == ((2, 0) if kind == "indep" else (0, 2))


@pytest.mark.gpu
def test_indep_long_block_cnt_exact(cuda):
    """A block longer than 2^16 sites adds its float32 counts into float64
    within the block: C stays exact."""
    P32, _ = chip_smoke.small_case(np.random.default_rng(5), torch,
                                   2 * chip_smoke.LONG_BLOCK, 64)
    chip_smoke.block_case(torch, indep, em, "indep", P32, True, 2, chip_smoke.LONG_BLOCK)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_block_partials_sum_to_kernel(cuda, kind):
    """The blocks' partials add up to the unweighted kernel's (raw, cnt)."""
    P32, _ = _case(cuda, 740, 96)
    I, J = torch.triu_indices(96, 96, offset=1, device=cuda)
    if kind == "indep":
        B, C = indep.indep_block_partials(P32, SCORE9, True, 20, 37)
        raw, cnt = indep.indep_raw_cnt(P32, SCORE9, True)
    else:
        B, C = em.em_block_partials(P32, SCORE9, True, 20, 37)
        raw, cnt = em.em_raw_cnt(P32, SCORE9, True)
    assert torch.equal(C.sum(0), cnt[I, J].double())
    # each within its bound of the exact sums, so within twice it of each other
    got, want = B.sum(0), raw[I, J].double()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    bound = (2 * chip_smoke.INDEP_RTOL * want.abs() if kind == "indep"
             else 2 * chip_smoke.EM_ATOL_CNT * C.sum(0))
    assert bool(((got - want).abs()[ok] <= bound[ok]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_block_partials_reject_bad_blocks(cuda, kind):
    fn = indep.indep_block_partials if kind == "indep" else em.em_block_partials
    P = torch.zeros((10, 5, 3), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="blocks"):
        fn(P, SCORE9, False, 3, 3)


def _cli_matrices(tmp_path, monkeypatch, tag, geno, S, N, kind, budget, fused):
    """One CLI run on the card -> (matrices, launches of the kind's kernel)."""
    from ngsdist_tpu_torch import cli

    monkeypatch.setenv("NGSDIST_FUSED_READ", "auto" if fused else "0")
    if budget is None:
        monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
    else:
        monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(budget))
    out = str(tmp_path / f"{tag}.dist")
    args = ["--geno", geno, "--probs", "--n_ind", str(N), "--n_sites", str(S), "--seed", "7",
            "--evol_model", "0", "--out", out, "--verbose", "0", "--platform", "cuda",
            "--n_boot_rep", "2", "--boot_block_size", "50"]
    args += ["--indep_geno", "--pairwise_del"] if kind == "indep" else []
    mod = indep if kind == "indep" else em
    before = mod.LAUNCHES
    assert cli.main(args) == 0
    return chip_smoke.read_phylip(out), mod.LAUNCHES - before


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(KERNELS))
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_streamed_equals_resident(cuda, tmp_path, monkeypatch, kind, fused):
    """A run forced to stream (NGSDIST_DEVICE_BUDGET) launches the kernel
    once per chunk and matrix and agrees with the resident run of the
    same input and read route: each within its bound of the exact sums,
    so within twice it of each other (model 0: the matrix is raw/cnt)."""
    from ngsdist_tpu_torch.core import distance

    S, N = 4999, 130
    P = chip_smoke.rand_probs(np.random.default_rng(8), S, N)
    geno = str(tmp_path / "gp.bin")
    P.astype("<f8").tofile(geno)
    budget = 12 * 700 * N * 12 // 3  # chunks of 700 sites: 8 for 4999, the last ragged
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(budget))
    assert distance.stream_plan(S, N, cuda, None) == (True, 700)
    resident, n_res = _cli_matrices(tmp_path, monkeypatch, "res", geno, S, N, kind, None, fused)
    streamed, n_str = _cli_matrices(tmp_path, monkeypatch, "str", geno, S, N, kind, budget,
                                    fused)
    assert len(resident) == len(streamed) == 3
    # resident: the partial-sum route (the full-data call; the block mode has its own count)
    assert n_res == 1 and n_str == 8 + 2 * 8   # 4950 truncated sites are 8 chunks too
    for a, b in zip(streamed, resident):
        off = ~np.eye(N, dtype=bool)
        if kind == "indep":
            assert (np.abs(a - b)[off] <= 2 * chip_smoke.INDEP_RTOL * np.abs(b)[off] + 1e-10).all()
        else:
            assert (np.abs(a - b)[off] <= 2 * chip_smoke.EM_ATOL_CNT + 1e-10).all()


# ------------------------------------------------------------------ #
# Tile lists (K1p, K2b) and the mesh's fixed-order sum                #
# ------------------------------------------------------------------ #


def _tile_lists(kind, N, p):
    from ngsdist_tpu_torch.parallel import mesh

    return mesh.panel_tables(N, p) if kind == "indep" else mesh.pair_block_tables(N, p)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(KERNELS))
@pytest.mark.parametrize("N,S", [(65, 130), (130, 5000), (256, 3001)])
@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_tile_lists_give_the_full_launchs_bytes(cuda, kind, N, S, pairwise_del, weighted):
    """Each pairs-shard's launch holds, byte for byte, the listed tiles of
    the full launch (indep: also when the sites split into chunks) and
    zeros elsewhere; the two-way split's launches agree with the plain
    version's tile forms; the EM also with a site list; one count per
    launch."""
    from ngsdist_tpu_torch.ops import _build

    fn, ref = KERNELS[kind]
    edge, strict = (indep.TILE, False) if kind == "indep" else (em.EM_TILE, True)
    mod = indep if kind == "indep" else em
    P32, w = _case(cuda, S, N)
    if not weighted:
        w = None
    index = None
    if kind == "em" and weighted:
        index = torch.nonzero(w != 0)[:, 0]
        w = w[index]
    extra = {} if index is None else {"site_index": index}
    full = fn(P32, SCORE9, pairwise_del, w, **extra)
    for p in (2, 3, 4):
        covered = torch.zeros((N, N), dtype=torch.int32, device=cuda)
        for lst in _tile_lists(kind, N, p):
            tiles = torch.from_numpy(lst).to(cuda)
            before = mod.TILE_LAUNCHES
            got = fn(P32, SCORE9, pairwise_del, w, tiles=tiles, **extra)
            again = fn(P32, SCORE9, pairwise_del, w, tiles=tiles, **extra)
            torch.cuda.synchronize()
            assert mod.TILE_LAUNCHES - before == (2 if lst.size else 0)
            mask = _build.tile_mask(N, lst, edge, strict).to(cuda)
            covered += mask.int()
            for g, a, f in zip(got, again, full):
                assert chip_smoke.same_bytes(torch, g, a)
                assert chip_smoke.same_bytes(torch, g[mask], f[mask])
                assert (g[~mask] == 0).all()
            if p == 2:  # the two lists hold every tile: each against its plain form
                plain = ref(P32.double(), SCORE9, pairwise_del, w, tiles=tiles, **extra)
                chip_smoke.check_kernel(kind, torch, *got, *plain)
        upper = torch.ones((N, N), dtype=torch.bool, device=cuda).triu(1 if strict else 0)
        assert bool((covered[upper] >= 1).all())
        if kind == "indep":
            assert bool((covered[upper] == 1).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_empty_or_bad_tile_list(cuda, kind):
    """An empty list launches nothing and gives zeros; a list that is not
    a contiguous int32 vector on the card is refused."""
    fn = KERNELS[kind][0]
    mod = indep if kind == "indep" else em
    P32, _ = _case(cuda, 64, 40)
    before = mod.TILE_LAUNCHES
    raw, cnt = fn(P32, SCORE9, True, tiles=torch.zeros(0, dtype=torch.int32, device=cuda))
    assert mod.TILE_LAUNCHES == before and not raw.any() and not cnt.any()
    with pytest.raises(ValueError, match="tiles"):
        fn(P32, SCORE9, True, tiles=torch.zeros(1, dtype=torch.int64, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_two_shards_on_two_streams_of_one_card(cuda, kind):
    """A mesh of two entries on one card queues each shard on a stream of
    its own; the fixed-order sum on the first device waits for both.
    The second shard is the larger, so its kernel is still running when
    the sum is queued.  Equal to the sum of the shards' statistics taken
    one after another with the card synchronised between, and reruns
    byte-identical."""
    from ngsdist_tpu_torch.parallel import mesh as pm

    rng = np.random.default_rng(8)
    S, N = (40000, 256) if kind == "indep" else (2000, 256)
    P = chip_smoke.rand_probs(rng, S, N)
    mesh = pm.make_mesh([cuda, cuda])
    ranges = [(0, S // 8), (S // 8, S)]
    data = pm.shard_sites(P, mesh, ranges)
    stats = pm.ShardStats(mesh, N, SCORE9, kind == "indep", True)
    assert mesh._streams[0] is not mesh._streams[1]
    got = [stats(data) for _ in range(3)]
    want = None
    for Pk in data.parts:
        torch.cuda.synchronize()
        one = pm.ShardStats(pm.make_mesh([cuda]), N, SCORE9, kind == "indep", True)(
            pm.Sharded(pm.make_mesh([cuda]), [(0, Pk.shape[0])], [Pk]))
        torch.cuda.synchronize()
        want = one if want is None else tuple(a + b for a, b in zip(want, one))
    for g in got:
        assert all(torch.equal(a, b) for a, b in zip(g, want))


@pytest.mark.gpu
def test_mesh_run_on_one_card_matches_one_device(cuda, tmp_path, monkeypatch):
    """runner.run over a 2 x 2 mesh of one card's entries against the
    one-device run, which reads staged as a mesh does: within twice the
    kernels' bound (indep, K1p) and the same launches per shard."""
    from ngsdist_tpu_torch import runner
    from ngsdist_tpu_torch.config import Params
    from ngsdist_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(9)
    S, N = 4000, 150
    path = tmp_path / "g.bin"
    chip_smoke.rand_probs(rng, S, N).tofile(path)
    kw = dict(in_geno=str(path), in_bin=True, in_probs=True, n_ind=N, n_sites=S,
              indep_geno=True, pairwise_del=True, n_boot_rep=2, boot_block_size=100,
              seed=1, verbose=0)
    monkeypatch.setenv("NGSDIST_FUSED_READ", "0")
    one = runner.run(Params(out=str(tmp_path / "a.dist"), **kw), cuda)
    before = indep.TILE_LAUNCHES
    mats = runner.run(Params(out=str(tmp_path / "b.dist"), **kw),
                      mesh=make_mesh([cuda] * 4, pairs=2))
    assert indep.TILE_LAUNCHES - before == 4 * 3
    for a, b in zip(mats, one):
        ratio = 1.0 - np.exp(-b)
        assert (np.abs(a - b) <= 2 * chip_smoke.INDEP_RTOL * np.abs(ratio) / (1.0 - ratio)
                + 1e-12).all()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["indep", "em"])
def test_mesh_over_several_cards(cuda, tmp_path, monkeypatch, kind):
    """A mesh over real cards: the CLI's --devices 2 --pairs 2 and a 1-D
    mesh over every visible card, each against the one-device run within
    twice the kernels' bound (the shards' results are copied between
    cards on their own streams for the fixed-order sum).  The one-device
    run reads as a mesh does, staged: the fused read's float32 p2 moves
    the EM's stopping step for lanes near its threshold.  Skips with
    fewer than two cards."""
    from ngsdist_tpu_torch import cli, runner
    from ngsdist_tpu_torch.config import Params
    from ngsdist_tpu_torch.parallel import make_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.default_rng(10)
    S, N = 3000, 150
    path = tmp_path / "g.bin"
    chip_smoke.rand_probs(rng, S, N).tofile(path)
    args = ["--geno", str(path), "--probs", "--n_ind", str(N), "--n_sites", str(S),
            "--n_boot_rep", "2", "--boot_block_size", "100", "--seed", "1", "--verbose", "0"]
    if kind == "indep":
        args += ["--indep_geno", "--pairwise_del"]
    pars, _ = cli.parse_args(args + ["--out", str(tmp_path / "one.dist")])
    monkeypatch.setenv("NGSDIST_FUSED_READ", "0")
    one = runner.run(pars, cuda)
    tol = 2 * (chip_smoke.INDEP_RTOL if kind == "indep" else chip_smoke.EM_ATOL_CNT)

    def close(mats):
        assert len(mats) == len(one)
        for a, b in zip(mats, one):
            ratio = 1.0 - np.exp(-b)
            bound = tol * (np.abs(ratio) if kind == "indep" else 1.0) / (1.0 - ratio)
            assert (np.abs(a - b) <= bound + 1e-12).all()

    out = str(tmp_path / "cli.dist")
    assert cli.main(args + ["--out", out, "--devices", "2", "--pairs", "2"]) == 0
    close(chip_smoke.read_phylip(out))
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    pars, _ = cli.parse_args(args + ["--out", str(tmp_path / "all.dist")])
    close(runner.run(pars, mesh=make_mesh(cards)))


@pytest.mark.gpu
@pytest.mark.parametrize("style", ["bin", "text"])
def test_lazy_rounds_on_a_card(cuda, tmp_path, monkeypatch, style):
    """Lazy rounds of two shards of one card, each through a ChunkPipe of
    its own: a raw binary file through the fused reader, whose parts hold
    the float32 values of the staged read of their sites with p2 = 1 - p0
    - p1 restored on the card; a gz text through its spill cache, whose
    parts hold the staged read's values cast, all zero at an empty line.
    The cache is gone on close."""
    import gzip

    from ngsdist_tpu_torch.config import Params
    from ngsdist_tpu_torch.core.preprocess import preprocess
    from ngsdist_tpu_torch.io import readers
    from ngsdist_tpu_torch.parallel import mesh as pm
    from ngsdist_tpu_torch.parallel import multihost as pmh

    rng = np.random.default_rng(11)
    S, N = 3000, 40
    P = chip_smoke.rand_probs(rng, S, N)
    if style == "bin":
        path = str(tmp_path / "g.bin")
        P.astype("<f8").tofile(path)
    else:
        path = str(tmp_path / "g.txt.gz")
        with gzip.open(path, "wt") as fh:
            for s in range(S):
                fh.write("" if s == 1234 else "\t".join(f"{x:.6f}" for x in P[s].reshape(-1)))
                fh.write("\n")
    spill = tmp_path / "spill"
    spill.mkdir()
    monkeypatch.setenv("NGSDIST_HOST_BUDGET", "1000")
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(3 * 400 * N * 3 * 4))
    monkeypatch.setenv("NGSDIST_SPILL_DIR", str(spill))
    in_bin = style == "bin"
    pars = Params(in_geno=path, in_bin=in_bin, in_probs=True, n_ind=N, n_sites=S)
    st = pmh.SiteStream.from_reader(pars, pm.make_mesh([cuda, cuda]))
    assert st.lazy and st.n_rounds >= 3 and st.src.fused == in_bin
    full = preprocess(readers.read_geno(path, in_bin, True, False, N, S), False, 0.0, 0.0)
    want = torch.from_numpy(full).float()
    if in_bin:
        want[..., 2] = (1.0 - want[..., 0]) - want[..., 1]
    else:
        assert not want[1234].any()
    seen = 0
    for _, data in st.rounds(range(st.n_rounds)):
        for (lo, hi), part in zip(data.local_ranges, data.parts):
            if hi <= lo:
                assert part is None
                continue
            assert torch.equal(part.cpu(), want[lo:hi])
            seen += hi - lo
    assert seen == S
    st.close()
    assert list(spill.iterdir()) == []
