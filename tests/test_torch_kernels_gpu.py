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
    """float64 is no longer refused: it goes to the float64 entry and never
    to the float32 one; a tensor of another dtype raises."""
    P = torch.zeros((4, 3, 3), dtype=torch.float64, device=cuda)
    mod = indep if kind == "indep" else em
    before = (mod.LAUNCHES, mod.LAUNCHES_F64)
    raw, _ = KERNELS[kind][0](P, SCORE9, False)
    assert raw.dtype == torch.float64
    assert (mod.LAUNCHES, mod.LAUNCHES_F64) == (before[0], before[1] + 1)
    with pytest.raises(ValueError, match="float32 or float64"):
        KERNELS[kind][0](P.half(), SCORE9, False)


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
    assert distance.stream_plan(S, N, cuda, None, False) == (True, 700)
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


@pytest.mark.gpu
@pytest.mark.parametrize("x64", [False, True], ids=["float32", "x64"])
def test_fetch_waits_for_its_own_copy_only(cuda, tmp_path, monkeypatch, x64):
    """A resident weighted run, 1024 x 16,384 and R = R' + 1 (R' =
    em_weight_rows), where one EM call outlasts a matrix's host work: the
    full data's call, one call for replicates 1..R' and one for replicate
    R (ROW_LAUNCHES and WEIGHT_ROWS count them); the fetch of every matrix
    whose call is not the last ends before the next call's kernel span
    does, so the host does not wait for the next EM call, as a plain
    .cpu() would; and the file is byte for byte the matrices built one
    replicate at a time from _make_exact_stats with a plain .cpu() and
    _finalize."""
    import io

    from ngsdist_tpu_torch import cli, runner
    from ngsdist_tpu_torch.core import distance
    from ngsdist_tpu_torch.io import writers
    from ngsdist_tpu_torch.utils import profiling

    S, N = 16384, 1024
    step = em.em_weight_rows(False)
    R = step + 1
    geno = tmp_path / "gp.bin"
    chip_smoke.rand_probs(np.random.default_rng(16), S, N).astype("<f8").tofile(geno)
    out = tmp_path / "run.dist"
    args = ["--geno", str(geno), "--probs", "--n_ind", str(N), "--n_sites", str(S),
            "--seed", "7", "--evol_model", "1", "--n_boot_rep", str(R),
            "--boot_block_size", "5", "--out", str(out), "--verbose", "0",
            "--platform", "cuda"] + (["--x64"] if x64 else [])
    monkeypatch.setenv("NGSDIST_FUSED_READ", "0")   # the staged read, repeated below
    monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
    monkeypatch.setattr(distance, "PARTIALS_BUDGET_BYTES", 0)   # the weighted route
    times = profiling.StageTimes(cuda)
    monkeypatch.setattr(profiling, "ACTIVE", times)
    before = distance.FETCHES_AHEAD
    rows_before = _row_counts(x64)
    assert cli.main(args) == 0
    monkeypatch.setattr(profiling, "ACTIVE", None)
    iv = times.intervals()
    assert distance.FETCHES_AHEAD - before == R
    assert tuple(a - b for a, b in zip(_row_counts(x64), rows_before)) == (3, 1, 1 + R)
    call = [0] + [1 + (m - 1) // step for m in range(1, R + 1)]   # matrix -> its call
    assert len(iv["fetch"]) == R + 1 and len(iv["kernel"]) == call[-1] + 1 == 3
    for m in range(R + 1):
        if call[m] + 1 < len(iv["kernel"]):
            assert iv["fetch"][m][1] < iv["kernel"][call[m] + 1][1]

    pars, _ = cli.parse_args(args)
    pars.validate()
    pars.finalize()
    labels, _, P_host = runner.load_inputs(pars)
    P = distance.upload_resident(P_host, cuda, x64)
    score = torch.as_tensor(pars.score, dtype=distance.default_dtype(cuda, x64))
    I, J = distance._pair_indices(N)
    It, Jt = (torch.from_numpy(a).long().to(cuda) for a in (I, J))
    exact = distance._make_exact_stats(False, False, score, cuda, It, Jt, None)
    n_trunc, maps = distance.bootstrap_site_maps(pars.seed, R, S, pars.boot_block_size)
    want = io.StringIO()
    for m in range(R + 1):
        w = None if m == 0 else distance.replicate_weights(maps[m - 1], n_trunc)
        n_used = S if m == 0 else n_trunc
        raw_v, _ = exact(P if m == 0 else P[:n_trunc], w)
        raw = distance._scatter_pairs(raw_v.cpu().double().numpy(), I, J, N)
        writers.write_dist_matrix(want, labels, distance._finalize(raw, float(n_used), pars))
    assert out.read_bytes() == want.getvalue().encode()


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
    data = pm.shard_sites(P, mesh, ranges, False)
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


# ------------------------------------------------------------------ #
# The float64 entries (--x64; K1d, K2d)                               #
# ------------------------------------------------------------------ #


def _case64(cuda, S, N, seed=14):
    """_case's inputs in float64, not rounded to float32."""
    rng = np.random.default_rng(seed)
    P = chip_smoke.rand_probs(rng, S, N, missing=0.1)
    P[rng.random((S, N)) < 0.01] = 0.0
    P[rng.integers(S), rng.integers(N)] = np.nan
    w = torch.from_numpy(rng.integers(0, 4, S).astype(np.float64)).to(cuda)
    return torch.from_numpy(P).to(cuda), w


def _check64(kind, got, plain, P, S=None):
    """A float64 entry against its float64 plain version: cnt exact, raw
    within the float64 bounds (chip_smoke.kernel_tol)."""
    chip_smoke.check_kernel(kind, torch, *got, *plain,
                            *chip_smoke.kernel_tol(torch, indep, em, P, S))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(KERNELS))
@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_f64_kernel_matches_plain(cuda, kind, pairwise_del, weighted):
    """The full launch, weighted and not: within the float64 bounds of the
    float64 plain version, rerun byte-identical, one launch of the
    float64 entry and none of the float32 one."""
    P, w = _case64(cuda, 777, 130)
    w = w if weighted else None
    fn, ref = KERNELS[kind]
    mod = indep if kind == "indep" else em
    before = (mod.LAUNCHES, mod.LAUNCHES_F64)
    got = fn(P, SCORE9, pairwise_del, w)
    torch.cuda.synchronize()
    assert (mod.LAUNCHES, mod.LAUNCHES_F64) == (before[0], before[1] + 1)
    assert got[0].dtype == got[1].dtype == torch.float64
    _check64(kind, got, ref(P, SCORE9, pairwise_del, w), P)
    chip_smoke.check_rerun(torch, fn, P, pairwise_del, w, got)


@pytest.mark.gpu
@pytest.mark.parametrize("N,S", chip_smoke.CHUNKED_SHAPES)
@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_f64_indep_several_chunks_ragged(cuda, N, S, pairwise_del, weighted):
    P, w = _case64(cuda, S, N)
    w = w if weighted else None
    got = indep.indep_raw_cnt(P, SCORE9, pairwise_del, w)
    _check64("indep", got, indep.indep_raw_cnt_ref(P, SCORE9, pairwise_del, w), P)
    # the kernel's own order, emulated in plain PyTorch: far inside the bound
    emu = indep.indep_raw_cnt_f64_order(P, SCORE9, pairwise_del, w)
    _check64("indep", got, emu, P)


@pytest.mark.gpu
@pytest.mark.parametrize("N,S", chip_smoke.EM_EDGE_SHAPES)
@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_f64_em_tile_edges(cuda, N, S, pairwise_del, weighted):
    """Across the EM's 32-individual tiles and 2-site step; also against
    the plain emulation of the kernel's arithmetic (em_raw_cnt_tables),
    which it follows to a few ulp per lane."""
    P, w = _case64(cuda, S, N)
    w = w if weighted else None
    got = em.em_raw_cnt(P, SCORE9, pairwise_del, w)
    _check64("em", got, em.em_raw_cnt_ref(P, SCORE9, pairwise_del, w), P)
    raw_t, cnt_t = em.em_raw_cnt_tables(P, SCORE9, pairwise_del, w)
    iu = torch.triu_indices(N, N, offset=1, device=cuda)
    assert torch.equal(got[1][iu[0], iu[1]], cnt_t[iu[0], iu[1]])
    a, b = got[0][iu[0], iu[1]], raw_t[iu[0], iu[1]]
    ok = ~torch.isnan(b)
    assert torch.equal(torch.isnan(a), ~ok)
    assert bool(((a - b).abs()[ok] <= 32 * 2.0 ** -53 * (1 + S) * cnt_t[iu[0], iu[1]][ok]).all())
    chip_smoke.check_rerun(torch, em.em_raw_cnt, P, pairwise_del, w, got)


@pytest.mark.gpu
@pytest.mark.parametrize("N,S", [(33, 101), (130, 777)])
@pytest.mark.parametrize("pairwise_del", [False, True])
def test_f64_em_site_list_gives_the_whole_runs_bytes(cuda, N, S, pairwise_del):
    """The float64 EM with a site list: the bytes of the run over all
    sites under the same weights and of the gathered sites."""
    P, w = _case64(cuda, S, N)
    keep = ~torch.isfinite(P.sum((1, 2)))
    w[keep] = 0.0
    index = torch.nonzero((w != 0) | keep)[:, 0]
    full = em.em_raw_cnt(P, SCORE9, pairwise_del, w)
    listed = em.em_raw_cnt(P, SCORE9, pairwise_del, w[index], site_index=index)
    gathered = em.em_raw_cnt(P.index_select(0, index), SCORE9, pairwise_del, w[index])
    for a, b, c in zip(full, listed, gathered):
        assert chip_smoke.same_bytes(torch, a, b) and chip_smoke.same_bytes(torch, b, c)
    _check64("em", listed, em.em_raw_cnt_ref(P, SCORE9, pairwise_del, w[index],
                                             site_index=index), P, index.numel())


def _sliced_counts():
    return (em.SLICED_LAUNCHES, em.SITE_SLICES, em.SLICED_LAUNCHES_F64, em.SITE_SLICES_F64)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("pairwise_del", [False, True])
def test_em_site_slices(cuda, dtype, pairwise_del):
    """The full-mode EM over G > 1 site slices, G by the rule on this card
    (3 tiles x 20,001 sites: 4 on an H100) and G = 5: counted, reruns
    byte-identical, within the bounds of the sliced plain order
    (em_raw_cnt_tables(slices=G)); a tile list the full launch's tiles and
    a site list the gathered sites' bytes at the same G; G = 1 the
    one-pass launch, which a small input takes."""
    from ngsdist_tpu_torch.ops import _build

    N, S = 65, 20001
    P, w = _case64(cuda, S, N)
    if dtype == "float32":
        P = P.float()
    P64, f64 = P.double(), dtype == "float64"
    auto = em.em_site_slices(3, S, *em._card_slots(P))
    assert auto > 1
    before = _sliced_counts()
    got = em.em_raw_cnt(P, SCORE9, pairwise_del, w)
    moved = [a - b for a, b in zip(_sliced_counts(), before)]
    assert moved == ([0, 0, 1, auto] if f64 else [1, auto, 0, 0])
    iu = torch.triu_indices(N, N, offset=1, device=cuda)
    for G in (auto, 5, 1):
        if G != auto:
            got = em._em_cuda(P, SCORE9, pairwise_del, w, None, None, slices=G)
        again = em._em_cuda(P, SCORE9, pairwise_del, w, None, None, slices=G)
        assert all(chip_smoke.same_bytes(torch, a, b) for a, b in zip(got, again))
        raw_t, cnt_t = em.em_raw_cnt_tables(P64, SCORE9, pairwise_del, w, slices=G)
        if f64:
            assert torch.equal(got[1][iu[0], iu[1]], cnt_t[iu[0], iu[1]])
            a, b = got[0][iu[0], iu[1]], raw_t[iu[0], iu[1]]
            ok = ~torch.isnan(b)
            assert torch.equal(torch.isnan(a), ~ok)
            assert bool(((a - b).abs()[ok]
                         <= 32 * 2.0 ** -53 * (1 + S) * cnt_t[iu[0], iu[1]][ok]).all())
        else:
            chip_smoke.check_kernel("em", torch, *got, raw_t, cnt_t)
        lst = np.array([2, 0], dtype=np.int32)
        tiles = torch.from_numpy(lst).to(cuda)
        listed = em._em_cuda(P, SCORE9, pairwise_del, w, None, tiles, slices=G)
        mask = _build.tile_mask(N, lst, em.EM_TILE, True).to(cuda)
        for g, f in zip(listed, got):
            assert chip_smoke.same_bytes(torch, g[mask], f[mask]) and not bool(g[~mask].any())
        index = torch.nonzero(w != 0)[:, 0]
        by_list = em._em_cuda(P, SCORE9, pairwise_del, w[index], index, None, slices=G)
        gathered = em._em_cuda(P.index_select(0, index), SCORE9, pairwise_del, w[index], None,
                               None, slices=G)
        assert all(chip_smoke.same_bytes(torch, a, b) for a, b in zip(by_list, gathered))
    small = P[:101].contiguous()
    before = _sliced_counts()
    one = em.em_raw_cnt(small, SCORE9, pairwise_del, w[:101])
    moved = [a - b for a, b in zip(_sliced_counts(), before)]
    assert moved == ([0, 0, 0, 1] if f64 else [0, 1, 0, 0])
    forced = em._em_cuda(small, SCORE9, pairwise_del, w[:101], None, None, slices=1)
    assert all(chip_smoke.same_bytes(torch, a, b) for a, b in zip(one, forced))


def _row_counts(f64):
    sfx = "_F64" if f64 else ""
    return tuple(getattr(em, n + sfx) for n in ("LAUNCHES", "ROW_LAUNCHES", "WEIGHT_ROWS"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("S,G", [(777, None), (20001, None), (20001, 5)],
                         ids=["G1", "Grule", "G5"])
def test_em_weight_rows_hold_the_one_row_bytes(cuda, dtype, pairwise_del, S, G):
    """Each row of a weight-row launch (em_kernel_rows) holds the bytes of
    the one-row launch with its weights at the same G: G = 1 at 777 sites,
    by the rule (4 on an H100) and forced to 5 at 20,001, over 3 tiles.
    R' - 1 rows (a short group), R' and R' + 1 (a group and a group of
    one, which the one-row kernel runs), R' = em_weight_rows; a row of
    zeros; weight 0 at the input's NaN triple in every row but the first
    (0 x NaN spreads to its pairs in both launches alike); a site of NaN
    past the rows' sites, which makes every pair of the launch over all
    sites NaN, reaches none of them.  The counters count each launch and
    row; the rows kernel holds as many blocks an SM as the one-row
    kernel."""
    import ctypes

    from ngsdist_tpu_torch.ops import _build

    N, f64 = 65, dtype == "float64"
    P, _ = _case64(cuda, S + 1, N)
    P[S] = float("nan")   # the full data's last site, past the rows' S
    P = P if f64 else P.float()
    Ps = P[:S]
    nan_site = int(torch.nonzero(torch.isnan(Ps.sum((1, 2))))[0])
    rng = np.random.default_rng(17)
    step = em.em_weight_rows(pairwise_del)
    for n_rows in (step - 1, step, step + 1):
        W = rng.integers(0, 4, (n_rows, S)).astype(np.float64)
        W[n_rows // 2] = 0.0
        W[1:, nan_site] = 0.0
        Wt = torch.from_numpy(W).to(cuda, P.dtype)
        before = _row_counts(f64)
        raw, cnt = em._em_rows_cuda(Ps, SCORE9, pairwise_del, Wt, slices=G)
        groups = [min(step, n_rows - r0) for r0 in range(0, n_rows, step)]
        moved = tuple(a - b for a, b in zip(_row_counts(f64), before))
        assert moved == (len(groups), sum(g > 1 for g in groups), n_rows)
        assert (cnt is None) == (not pairwise_del)
        for r in range(n_rows):
            one = em._em_cuda(Ps, SCORE9, pairwise_del, Wt[r], None, None, slices=G)
            assert chip_smoke.same_bytes(torch, raw[r], one[0]), (n_rows, r)
            if pairwise_del:
                assert chip_smoke.same_bytes(torch, cnt[r], one[1]), (n_rows, r)
    iu = torch.triu_indices(N, N, offset=1, device=cuda)
    assert torch.isnan(em._em_cuda(P, SCORE9, pairwise_del, None, None, None)[0][iu[0], iu[1]]).all()
    assert not torch.isnan(raw[:, iu[0], iu[1]]).all(1).any()
    per = ctypes.c_int(0)
    _build.check_launch(_build.entry("em_rows_blocks_per_sm", P)(ctypes.byref(per)), "em rows")
    assert per.value == em._card_slots(P)[1]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(KERNELS))
@pytest.mark.parametrize("p", chip_smoke.TILE_SPLITS)
def test_f64_tile_lists_hold_the_full_launchs_tiles(cuda, kind, p):
    """Each pairs-shard's tile list: the full launch's listed tiles byte
    for byte, zeros elsewhere, one tile launch of the float64 entry each."""
    from ngsdist_tpu_torch.ops import _build
    from ngsdist_tpu_torch.parallel import mesh as pm

    N, S = 130, 1500
    P, w = _case64(cuda, S, N)
    fn = KERNELS[kind][0]
    mod = indep if kind == "indep" else em
    edge, strict = (indep.TILE, False) if kind == "indep" else (em.EM_TILE, True)
    full = fn(P, SCORE9, True, w)
    for lst in chip_smoke.tile_lists(pm, kind, N, p):
        tiles = torch.from_numpy(lst).to(cuda)
        before = mod.TILE_LAUNCHES_F64
        got = fn(P, SCORE9, True, w, tiles=tiles)
        assert mod.TILE_LAUNCHES_F64 - before == (1 if lst.size else 0)
        mask = _build.tile_mask(N, lst, edge, strict).to(cuda)
        for g, f in zip(got, full):
            assert chip_smoke.same_bytes(torch, g[mask], f[mask]) and not bool(g[~mask].any())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(KERNELS))
@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("block_size", chip_smoke.BLOCK_SIZES)
def test_f64_block_partials_match_plain(cuda, kind, pairwise_del, block_size):
    """The float64 block modes against their float64 plain versions: C
    exact, B within f64_sum_bound(block_size) (indep) and
    em_table_bound(block_size) x C (EM), reruns byte-identical."""
    n_blocks = chip_smoke.BLOCK_SITES // block_size
    P, _ = chip_smoke.small_case(np.random.default_rng(block_size), torch,
                                 n_blocks * block_size, chip_smoke.BLOCK_N, x64=True)
    mod = indep if kind == "indep" else em
    before = (mod.BLOCK_LAUNCHES, mod.BLOCK_LAUNCHES_F64)
    chip_smoke.block_case(torch, indep, em, kind, P, pairwise_del, n_blocks, block_size)
    torch.cuda.synchronize()
    assert (mod.BLOCK_LAUNCHES, mod.BLOCK_LAUNCHES_F64) == (before[0], before[1] + 2)


@pytest.mark.gpu
def test_f64_indep_long_block_cnt_exact(cuda):
    P, _ = chip_smoke.small_case(np.random.default_rng(6), torch,
                                 2 * chip_smoke.LONG_BLOCK, 64, x64=True)
    chip_smoke.block_case(torch, indep, em, "indep", P, True, 2, chip_smoke.LONG_BLOCK)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_f64_cli_run_matches_its_float32_twin(cuda, tmp_path, monkeypatch, kind):
    """The CLI under --x64 on the card launches the float64 entries only,
    and its matrices lie within the float32 policy's bounds of the float32
    run (the float32 one is the less exact of the two)."""
    from ngsdist_tpu_torch import cli

    rng = np.random.default_rng(15)
    S, N = 2000, 96
    geno = tmp_path / "p.bin"
    chip_smoke.rand_probs(rng, S, N).astype("<f8").tofile(geno)
    mod = indep if kind == "indep" else em
    outs = {}
    for x64 in (False, True):
        out = tmp_path / f"{x64}.dist"
        args = ["--geno", str(geno), "--probs", "--n_ind", str(N), "--n_sites", str(S),
                "--evol_model", "0", "--out", str(out), "--verbose", "0", "--platform", "cuda"]
        args += ["--indep_geno", "--pairwise_del"] if kind == "indep" else []
        before = (mod.LAUNCHES, mod.LAUNCHES_F64)
        assert cli.main(args + (["--x64"] if x64 else [])) == 0
        assert (mod.LAUNCHES - before[0], mod.LAUNCHES_F64 - before[1]) == (
            (0, 1) if x64 else (1, 0))
        outs[x64] = chip_smoke.read_phylip(str(out))[0]
    tol = (chip_smoke.POLICY_INDEP_RTOL if kind == "indep" else chip_smoke.POLICY_EM_ATOL_CNT)
    assert np.abs(outs[True] - outs[False]).max() <= 2 * tol + 2e-10


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 63, 64, 65, 129])
@pytest.mark.parametrize("S", [1, 13, 1029])
@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_f64_indep_tile_and_step_edges(cuda, N, S, pairwise_del, weighted):
    """K1d across its 64-wide tile edges (N odd: the 8-byte copies) and
    its 8-site step (S ragged against it): within the float64 bounds of
    the plain version, rerun byte-identical."""
    assert S % indep.STEP_F64
    P, w = _case64(cuda, S, N)
    w = w if weighted else None
    got = indep.indep_raw_cnt(P, SCORE9, pairwise_del, w)
    _check64("indep", got, indep.indep_raw_cnt_ref(P, SCORE9, pairwise_del, w), P)
    chip_smoke.check_rerun(torch, indep.indep_raw_cnt, P, pairwise_del, w, got)


@pytest.mark.gpu
def test_f64_indep_unaligned_rows(cuda):
    """A float64 tensor whose data does not start on 16 bytes takes K1d's
    8-byte copies and gives the same bytes as an aligned copy of it."""
    P, w = _case64(cuda, 1500, 128)
    flat = torch.empty(P.numel() + 1, dtype=torch.float64, device=cuda)
    shifted = flat[1:].view(P.shape)
    shifted.copy_(P)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    for a, b in zip(indep.indep_raw_cnt(P, SCORE9, True, w),
                    indep.indep_raw_cnt(shifted, SCORE9, True, w)):
        assert chip_smoke.same_bytes(torch, a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [65, 129])
@pytest.mark.parametrize("p", chip_smoke.TILE_SPLITS)
@pytest.mark.parametrize("weighted", [False, True])
def test_f64_indep_tile_lists_odd_rows(cuda, N, p, weighted):
    """K1d's tile lists at an odd N (8-byte copies) and S off the 8-site
    step: each shard's launch holds the full launch's listed tiles byte
    for byte, zeros elsewhere, and a rerun gives the same bytes."""
    from ngsdist_tpu_torch.ops import _build
    from ngsdist_tpu_torch.parallel import mesh as pm

    P, w = _case64(cuda, 1501, N)
    w = w if weighted else None
    full = indep.indep_raw_cnt(P, SCORE9, True, w)
    for lst in chip_smoke.tile_lists(pm, "indep", N, p):
        tiles = torch.from_numpy(lst).to(cuda)
        got = indep.indep_raw_cnt(P, SCORE9, True, w, tiles=tiles)
        again = indep.indep_raw_cnt(P, SCORE9, True, w, tiles=tiles)
        mask = _build.tile_mask(N, lst, indep.TILE, False).to(cuda)
        for g, a, f in zip(got, again, full):
            assert chip_smoke.same_bytes(torch, g, a)
            assert chip_smoke.same_bytes(torch, g[mask], f[mask]) and not bool(g[~mask].any())


@pytest.mark.gpu
@pytest.mark.parametrize("block_size", chip_smoke.BLOCK_SIZES + (chip_smoke.LONG_BLOCK,))
@pytest.mark.parametrize("pairwise_del", [False, True])
def test_f64_indep_blocks_odd_rows(cuda, block_size, pairwise_del):
    """K1d's block mode at an odd N (8-byte copies), blocks whose edges
    fall inside its 8-site steps and one past 2^16 sites: against the
    float64 plain version, C exact, rerun byte-identical (block_case)."""
    n_blocks = 2 if block_size == chip_smoke.LONG_BLOCK else chip_smoke.BLOCK_SITES // block_size
    P, _ = chip_smoke.small_case(np.random.default_rng(block_size), torch,
                                 n_blocks * block_size, 129, x64=True)
    chip_smoke.block_case(torch, indep, em, "indep", P, pairwise_del, n_blocks, block_size)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["resident", "streamed", "mesh", "lazy"])
@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_u16_run_holds_to_its_float32_pair_twin(cuda, tmp_path, monkeypatch, route, kind):
    """A float32 run on the card takes the uint16 lane by default, on every
    route (the fused read resident and streamed, a 2 x 2 mesh's staged
    shards, lazy rounds): only uint16 slabs are sent, and its statistics
    hold to the same run under NGSDIST_UPLOAD16=0 (float32 pairs): cnt
    equal, raw within chip_smoke.u16_bound (PERF.md section 2)."""
    from ngsdist_tpu_torch import cli, runner
    from ngsdist_tpu_torch.core import distance
    from ngsdist_tpu_torch.parallel import mesh as pm

    rng = np.random.default_rng(16)
    S, N = 3000, 96
    geno = tmp_path / "p.bin"
    chip_smoke.rand_probs(rng, S, N).astype("<f8").tofile(geno)
    for k in ("NGSDIST_UPLOAD16", "NGSDIST_UPLOAD23", "NGSDIST_DEVICE_BUDGET",
              "NGSDIST_HOST_BUDGET", "NGSDIST_FUSED_READ"):
        monkeypatch.delenv(k, raising=False)
    if route == "streamed":
        monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(3 * 4 * 500 * N * 12 // 3))
    if route == "lazy":
        monkeypatch.setenv("NGSDIST_HOST_BUDGET", str(1 << 20))
    finalize, host_pack = distance._finalize, distance._host_pack
    got = {}
    for lane in ("auto", "0"):
        stats, slabs = [], set()

        def stats_spy(raw, cnt, *a, stats=stats, **k):
            stats.append((np.array(raw), np.array(cnt, np.float64)))
            return finalize(raw, cnt, *a, **k)

        def slab_spy(*a, slabs=slabs, **k):
            slab = host_pack(*a, **k)
            slabs.add(str(getattr(slab, "dtype", "codes")))
            return slab

        monkeypatch.setattr(distance, "_finalize", stats_spy)
        monkeypatch.setattr(distance, "_host_pack", slab_spy)
        if lane == "0":
            monkeypatch.setenv("NGSDIST_UPLOAD16", "0")
        args = ["--geno", str(geno), "--probs", "--n_ind", str(N), "--n_sites", str(S),
                "--seed", "3", "--n_boot_rep", "2", "--boot_block_size", "100",
                "--out", str(tmp_path / f"{lane}.dist"), "--verbose", "0"]
        args += ["--indep_geno", "--pairwise_del"] if kind == "indep" else []
        if route == "mesh":
            runner.run(cli.parse_args(args)[0], mesh=pm.make_mesh([cuda] * 4, pairs=2))
        else:
            assert cli.main(args + ["--platform", "cuda"]) == 0
        got[lane] = (stats, slabs)
    (s16, slabs16), (s32, slabs32) = got["auto"], got["0"]
    assert slabs16 == {"uint16"} and slabs32 == {"float32"}
    assert len(s16) == len(s32) == 3
    for (r16, c16), (r32, c32) in zip(s16, s32):
        np.testing.assert_array_equal(c16, c32)
        assert (np.abs(r16 - r32) <= chip_smoke.u16_bound(kind, r16, r32, c32)).all()


@pytest.mark.gpu
def test_expand23_u16_on_the_card_is_the_cpus(cuda):
    """expand23's uint16 half on the card gives the CPU's bits, every
    sentinel included, into a new tensor and into a slice."""
    from ngsdist_tpu_torch.core import distance
    from ngsdist_tpu_torch.utils import hostmem

    rng = np.random.default_rng(17)
    P = chip_smoke.rand_probs(rng, 999, 37)
    P[rng.random((999, 37)) < 0.02] = 0.0
    P[3, 4] = np.nan
    q = hostmem.pack16(P, 1003)
    want = distance.expand23(torch.from_numpy(q))
    got = distance.expand23(torch.from_numpy(q).to(cuda))
    assert chip_smoke.same_bytes(torch, got.cpu(), want)
    big = torch.full((1005, 37, 3), 7.0, device=cuda)
    distance.expand23(torch.from_numpy(q).to(cuda), out=big[1:-1])
    assert chip_smoke.same_bytes(torch, big[1:-1].cpu(), want)


# ------------------------------------------------------------------ #
# The HMM kernel (csrc/hmm.cu)                                        #
# ------------------------------------------------------------------ #


@pytest.mark.gpu
@pytest.mark.parametrize("kind", chip_smoke.HMM_KINDS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("K,per_chain_d", [(1, False), (2, False), (3, True), (8, False)])
def test_hmm_kernel_matches_plain(cuda, kind, dtype, K, per_chain_d):
    """Each entry through its public wrapper against the plain version on
    the same inputs (70 chains, past two 32-chain blocks; 301 sites, off
    the kernel's load steps) within ops/hmm.py hmm_bound, Viterbi flips
    only at near ties (chip_smoke.check_hmm), one launch of the entry of
    its dtype."""
    from ngsdist_tpu_torch.ops import hmm

    dt = getattr(torch, dtype)
    args = chip_smoke.hmm_inputs(torch, np.random.default_rng(K), 70, 301, K, per_chain_d, dt)
    counter = f"{kind.upper()}_LAUNCHES{'_F64' if dtype == 'float64' else ''}"
    before = getattr(hmm, counter)
    got = getattr(hmm, f"hmm_{kind}")(*args)
    torch.cuda.synchronize()
    assert getattr(hmm, counter) == before + 1
    chip_smoke.check_hmm(torch, hmm, kind, args, got)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", chip_smoke.HMM_KINDS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("edge", chip_smoke.HMM_EDGES)
def test_hmm_kernel_edge_inputs(cuda, kind, dtype, edge):
    """alpha = 0 (-inf off the diagonal, NaN where 0 meets an inf
    distance), a zero proportion, dense chromosome breaks and exact ties:
    non-finite values equal to the plain version's, the rest within the
    bound; ties resolved to the first state as the plain version does."""
    from ngsdist_tpu_torch.ops import hmm

    dt = getattr(torch, dtype)
    for K in (2, 3):
        args = chip_smoke.hmm_inputs(torch, np.random.default_rng(7), 40, 300, K, K == 3, dt,
                                     edge)
        got = getattr(hmm, f"hmm_{kind}")(*args)
        err, flips = chip_smoke.check_hmm(torch, hmm, kind, args, got)
        if edge == "ties" and kind == "viterbi":
            assert flips == 0 and int(got[0].max()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", chip_smoke.HMM_KINDS)
def test_hmm_kernel_refuses_nine_states(cuda, kind):
    from ngsdist_tpu_torch.ops import hmm

    args = chip_smoke.hmm_inputs(torch, np.random.default_rng(9), 4, 10, 9, False,
                                 torch.float64)
    with pytest.raises(ValueError, match="1 to 8"):
        getattr(hmm, f"hmm_{kind}")(*args)


@pytest.mark.gpu
def test_hmm_public_functions_on_the_card(cuda):
    """popgen's forward, backward, posterior_decode and viterbi on CUDA
    tensors of one chain and of a batch go through the kernel (the counts
    move) and equal the plain version's on the same chains to its bound."""
    from ngsdist_tpu_torch import popgen
    from ngsdist_tpu_torch.ops import hmm

    q, a, e, d = chip_smoke.hmm_inputs(torch, np.random.default_rng(11), 6, 120, 2, False,
                                       torch.float64)
    before = hmm.FORWARD_LAUNCHES_F64
    Fw, ll = popgen.forward(q[0], float(a[0]), e[0], d)
    assert Fw.shape == (120, 2) and ll.shape == () and Fw.device.type == "cuda"
    post, _ = popgen.posterior_decode(q, a, e, d)
    assert hmm.FORWARD_LAUNCHES_F64 == before + 2
    ref, _ = hmm.hmm_forward_ref(q[:1], a[:1], e[:1], d)
    per, _ = hmm.hmm_bound("forward", q[:1], a[:1], e[:1], d, ref)
    assert bool(((Fw - ref[0]).abs() <= per[0][:, None]).all())
    assert post.shape == (6, 120, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", chip_smoke.HMM_KINDS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_hmm_graphed_plain_version_is_the_eager_loop(cuda, kind, dtype):
    """ops/hmm.py segment_runner, which walks the plain version's sites by
    CUDA graph replays in chip_smoke.py's full-width check: every output
    the eager loop's bits (300 sites in segments of 64, 44 left over;
    alpha 0 past inf distances, so NaN and -inf messages)."""
    from ngsdist_tpu_torch.ops import hmm

    args = chip_smoke.hmm_inputs(torch, np.random.default_rng(13), 40, 300, 3, True,
                                 getattr(torch, dtype), "alpha0")
    run = hmm.segment_runner(64)
    if kind == "viterbi":
        want = hmm.hmm_viterbi_ref(*args, full=True)
        got = hmm.hmm_viterbi_ref(*args, full=True, run=run)
    else:
        fn = getattr(hmm, f"hmm_{kind}_ref")
        want, got = fn(*args), fn(*args, run=run)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", chip_smoke.HMM_KINDS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("K,per_chain_d", [(1, False), (2, False), (3, True), (8, False)])
@pytest.mark.parametrize("segment", [1, 5, 37, 150])
def test_hmm_kernel_segments_are_the_segmented_model(cuda, kind, dtype, K, per_chain_d,
                                                     segment):
    """Each entry in segments of 1, 5, 37 and 150 sites over 301 (a short
    last segment; 70 chains, past a block's 32 segments and a warp's):
    equal to ops/hmm.py hmm_scan_segmented_ref (Viterbi:
    hmm_viterbi_segmented_ref's path and best score) bit for bit and
    within hmm_bound(..., segment) of the sequential plain version, Viterbi
    flips only at near ties (chip_smoke.check_hmm)."""
    from ngsdist_tpu_torch.ops import hmm

    args = chip_smoke.hmm_inputs(torch, np.random.default_rng(20 + K), 70, 301, K, per_chain_d,
                                 getattr(torch, dtype))
    got = hmm._chains_cuda(kind, *args, segment=segment)
    torch.cuda.synchronize()
    chip_smoke.check_hmm(torch, hmm, kind, args, got, segment=segment)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", chip_smoke.HMM_KINDS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("edge", chip_smoke.HMM_EDGES)
def test_hmm_kernel_segments_keep_the_edge_inputs(cuda, kind, dtype, edge):
    """The edge inputs in segments of chip_smoke.HMM_SMALL_SEGMENT sites:
    NaN carried into every later segment through the start vectors, -inf
    kept, as the plain version has them; the segmented model's bits;
    Viterbi's ties resolved to the first state with no flip."""
    from ngsdist_tpu_torch.ops import hmm

    for K in (2, 3):
        args = chip_smoke.hmm_inputs(torch, np.random.default_rng(7), 40, 300, K, K == 3,
                                     getattr(torch, dtype), edge)
        got = hmm._chains_cuda(kind, *args, segment=chip_smoke.HMM_SMALL_SEGMENT)
        err, flips = chip_smoke.check_hmm(torch, hmm, kind, args, got,
                                          segment=chip_smoke.HMM_SMALL_SEGMENT)
        if edge == "ties" and kind == "viterbi":
            assert flips == 0 and int(got[0].max()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", chip_smoke.HMM_KINDS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("segment", [None, 37])
def test_hmm_kernel_is_batch_invariant(cuda, kind, dtype, segment):
    """A chain alone, or in a batch of another order, gives the batch's row
    bit for bit on the card: the segments are cut from the sites alone
    (3,000 sites: three segments of hmm.SEGMENT, or 82 of 37)."""
    from ngsdist_tpu_torch.ops import hmm

    seg = segment or hmm.SEGMENT
    args = chip_smoke.hmm_inputs(torch, np.random.default_rng(31), 40, 3000, 2, True,
                                 getattr(torch, dtype))
    got = hmm._chains_cuda(kind, *args, segment=seg)
    perm = torch.randperm(40, generator=torch.Generator().manual_seed(5)).to(cuda)
    shuffled = hmm._chains_cuda(kind, *(a[perm] for a in args), segment=seg)
    assert all(chip_smoke.same_values(torch, x, y[perm]) for x, y in zip(shuffled, got))
    for b in (0, 17, 39):
        one = hmm._chains_cuda(kind, *(a[b:b + 1] for a in args), segment=seg)
        assert all(chip_smoke.same_values(torch, x[0], y[b]) for x, y in zip(one, got))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", chip_smoke.HMM_KINDS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("S,segment", [(1, 1), (2, 1), (3, 1), (3, 2), (4, 3), (5, 2), (33, 32)])
def test_hmm_kernel_segments_of_a_few_sites(cuda, kind, dtype, S, segment):
    """One to a few sites in segments of one to three (and 33 in 32): a
    last segment of one site (backward: of no step), one segment, two,
    several; 3 chains, fewer than a warp's segments."""
    from ngsdist_tpu_torch.ops import hmm

    rng = np.random.default_rng(40 + S)
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.dirichlet(np.ones(2), size=3)).to(cuda, dt)
    a = torch.from_numpy(rng.uniform(1e-3, 0.1, 3)).to(cuda, dt)
    e = torch.from_numpy(np.log(rng.random((3, S, 2)) + 1e-3)).to(cuda, dt)
    d = torch.from_numpy(rng.integers(1, 50, size=(3, S)).astype(np.float64)).to(cuda, dt)
    got = hmm._chains_cuda(kind, q, a, e, d, segment=segment)
    torch.cuda.synchronize()
    chip_smoke.check_hmm(torch, hmm, kind, (q, a, e, d), got, segment=segment)
