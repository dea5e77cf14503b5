#!/usr/bin/env python3
"""Smoke test of the PyTorch port (ngsdist_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run loudly:

1. Card identity (nvidia-smi name and power limit); build the port's
   native host runtime (C, the host compiler) and the CUDA kernels from
   this checkout; the indep kernel's machine code must hold tensor-core
   (HMMA) instructions.
2. Each kernel against its plain PyTorch version in float64 on the
   card, on the same float32 inputs, at small ragged shapes with NaN and
   all-zero rows: cnt exact, indep raw within INDEP_RTOL relative, EM
   raw within EM_ATOL_CNT x cnt.  The indep kernel also at shapes that
   split the sites into several chunks, the last one ragged; the EM
   kernel also at shapes that cross its 32-individual tile edges and its
   2-site step (EM_EDGE_SHAPES).  Every call is run twice: the reruns
   must be byte-identical.  The block modes of the partial-sum bootstrap
   likewise (per-block C exact, indep B within INDEP_RTOL, EM B within
   ops/em.py's em_table_bound(block size) x C), at ragged block sizes
   whose ends fall inside an EM step and, indep, a block longer than
   2^16 sites.  The tile lists of the mesh's pairs axis (K1p: indep's
   64 x 64 tiles, parallel/mesh.py panel_tables; K2b: the EM's 32 x 32
   tiles of a slice of the pair list, pair_block_tables) at TILE_SHAPES,
   split TILE_SPLITS ways, the EM with and without a site list, with NaN
   and all-zero rows: each launch holds its listed tiles of the full
   launch byte for byte and zeros elsewhere, reruns byte-identical, the
   lists cover every upper tile (indep: exactly once), and the launches
   of the two-way split hold every tile against the plain versions'
   tile forms within the bounds above.
3. The port's main path through its CLI entry point, in process, on
   seeded binary GP inputs at 1024 individuals (RUNS): (a) --indep_geno
   --pairwise_del, 65,536 sites, 2 bootstrap replicates of 256-site
   blocks (the weighted-recompute route); (b) the EM, 16,384 sites;
   (c) the EM with 8 replicates of 256-site blocks and (d) (a)'s flags
   with 4 replicates of 1024-site blocks (both the partial-sum route),
   all four resident, read by the fused reader and uploaded from pinned
   slabs on a copy stream; and the long-genome path (STREAMED): (e)
   (a)'s flags on (a)'s array written four times (262,144 sites, 6.4 GB
   on disk; 131,072 where the disk is short), streamed in chunks under
   a forced NGSDIST_DEVICE_BUDGET, each chunk read from disk by the
   fused reader for the full data and again for each replicate; (f) the
   EM on (b)'s array written four times (65,536 sites), streamed from
   the staged read (NGSDIST_FUSED_READ=0).
   Every launch count is set to 0 before each run and must then equal
   the run's expected launches (LAUNCHES; streamed: one per chunk and
   matrix); the output must hold 1 + n_boot_rep finite symmetric
   matrices whose 64-individual sub-matrices agree with the float64
   plain version (replicates: the plain weighted recompute), run on the
   generated array itself: within the phase-2 bounds on the float32
   values the card was given (fused read: p0 and p1 rounded, p2 = 1 -
   p0 - p1 in float32; staged read: all three rounded), and within the
   float32 policy's bounds (POLICY_*) on the float64 values that were
   written.  The full-data matrices of (c) and (d) equal those of (b)
   and (a).  (e) and (f) also: the source the engine was given (a
   fused-read handle, never the float64 tensor, for (a)-(e)), the peak
   of the device memory under the forced budget, and every matrix
   within twice the kernel's bound of the same input run resident.
   Each run logs its wall time and its read, upload and kernel seconds
   with the share of the upload that ran under a kernel or a read.
   Evolutionary models 3-6 (MODELS), with a POS file of seeded A/C/G/T
   allele pairs, ~5% of them unclassifiable: (g) the EM, --evol_model 6
   (TN93), 16,384 sites, 2 replicates of 256-site blocks; (h) indep
   --pairwise_del, --evol_model 5 (F84), 65,536 sites, 2 replicates;
   and (g) once more streamed in 4 chunks under a forced budget ("gs").
   The mesh engine (MESH_RUNS), in process through runner.run on a
   parallel.mesh.Mesh of entries of one card, at 1024 individuals: (i)
   (a)'s file and flags on 2 x 2 (K1p, the weighted bootstrap); (j) (c)'s
   on 4 x 1 (the EM per shard and its block mode, M[r] @ B per shard and
   the fixed-order sum); (k) (g)'s on 2 x 2 (K2b under class site lists,
   the base counts per shard); (is) (i) streamed in 4 rounds a shard
   under a forced budget; (il) (d)'s on 2 x 1 streamed, the single pass
   of block partials resummed through _stream_block_rows.  Each held to
   its launches (MESH_LAUNCHES, per shard and round) and every matrix to
   twice the kernels' bound of the one-device run of the same file read
   the same way; with two cards or more, (i) once more through the CLI
   with --devices 2 --pairs 2 on real cards.
   Genomes beyond host memory (LAZY_RUNS), through the CLI under a forced
   NGSDIST_HOST_BUDGET: (l) (a)'s file and flags read from disk in 10
   rounds of 7,168 sites a matrix (the fused reader per round), (lt) the
   EM on a gz beagle text of (b)'s first 4,096 sites, spilled once to a
   cache and read from it in 3 rounds; each held to one launch per round
   and matrix, its cache deleted after the run, and every matrix within
   twice the kernel's bound of the same input resident.  Two processes
   on the one card (PROC_RUNS), each the CLI with --coordinator
   127.0.0.1:PORT --num_processes 2 --process_id 0|1 (gloo): (me) (b)'s
   EM, (ma) (a)'s indep with its bootstrap, both resident, and (ml) (d)'s
   flags on (a)'s file lazy and streamed in 2,048-site rounds under forced
   NGSDIST_HOST_BUDGET and NGSDIST_DEVICE_BUDGET (the bootstrap's block
   partials in one pass); process 0's file byte for byte the one-process
   run on a mesh of two entries of the card under the same budgets, the
   two processes' launches adding up to its launches, each process's
   wall time, read and gather seconds printed; the workers are killed
   past PROC_WALL seconds.
   Each matrix takes three launches (one per substitution class, on the
   class's sites only) per chunk, 9 for (g) and (h); the engine is
   handed the staged float64 tensor.  Their 64-individual sub-matrices
   are held against the float64 plain versions under the class weights,
   the JAX engine's host form of the per-pair base frequencies and
   core/submodels.py's formulas: the bound is the model evaluated with
   every class proportion moved by its kernel's bound (all up, all
   down: the models rise with each proportion), plus the print
   rounding.  (g) streamed also against (g).
4. Each kernel's time at the main path's shapes beside its plain
   version's (float32), its bound (the least time the card could take:
   the larger of its bytes over PEAK_BYTES and its operations, counted
   from this run's data, over the peak rate of their type) and, indep,
   the PyTorch calls that compute the same function; the EM times
   beside those of the kernel before its redesign (EM_MS_BEFORE); and
   the kernel held there against the float64 plain version on the same
   inputs.  Both full modes also at 2048 individuals (WIDE_N; seeded on
   the card), held against the float64 plain version on a 64-individual
   sub-matrix.  The class sums of models 3-6 in both forms, three
   weighted launches on the whole tensor against three launches on each
   class's sites only, timed at (g)'s and (h)'s shapes: the EM's bytes
   must be equal (it adds a lane's sites in order, and a site of weight
   0 adds 0), indep's cnt equal and its raw within twice INDEP_RTOL (its
   float32 windows regroup); also on a small case with a NaN triple at a
   site of weight 0, which both forms must spread to its pairs; and
   core/distance.py pair_pi_counts at (h)'s shape.  One pairs-shard's
   K1p launch at (a)'s shape and K2b launch at (b)'s, for splits of 2 and
   4, beside the full launch, with the share of the tiles it holds and
   the bound scaled by that share; and the fixed-order sum of (i)'s four
   shards.

The bounds (PERF.md section 2): the indep kernel sums 3xTF32 products
on the tensor cores in float32 over 16-site windows and the windows in
float64; the EM kernel takes the float64 plain version's stopping
steps, its powers by sequential multiplication lie within 2^-45 of the
plain version's contribution per lane, and raw is rounded to float32
once, which is at most 6e-8 x cnt.
The policy bounds add the float32 rounding of the input, which moves
the EM's stopping step by one for lanes within ~1e-7 of its threshold.

Prints the card line, a {"kernels": [...]} line whose "max_abs_err" is
the largest absolute error of raw/cnt (the uncorrected distance)
against the float64 plain version, and as its last line
{"ok": true, "device": {...}}.  Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")  # inputs and outputs; removed at the end
SEED = 20261016
N_IND = 1024
INDEP_SITES = 65536
EM_SITES = 16384
BOOT_REPS = 2
BOOT_BLOCK = 256
DEVICE = "cuda"
INDEP_RTOL = 1e-6    # indep raw, relative (float32 kernel vs float64)
EM_ATOL_CNT = 1e-6   # EM raw, absolute per valid site (|raw err| <= 1e-6 cnt)
POLICY_INDEP_RTOL = 1e-5   # the same, against the float64 values themselves
POLICY_EM_ATOL_CNT = 1e-4
CHUNKED_SHAPES = ((130, 5000), (256, 3001))  # (N, S): indep split over sites
# (N, S) across the EM kernel's edges: below one 32-wide tile, exactly
# one and two, one past, and sites off the 2-site step
EM_EDGE_SHAPES = ((31, 7), (32, 64), (33, 101), (64, 9), (65, 130))
# Published peaks of one H100 SXM at 700 W: device memory, TF32 on the
# tensor cores (dense), float64 outside them (half the float32 rate of
# 67 TFLOP/s; nothing in the EM is a matrix product).
PEAK_BYTES = 3.35e12
PEAK_TF32 = 495e12
PEAK_F64 = 33.5e12
# The EM kernel before its redesign (one float64 lane per pair and site,
# exp/log powers), same shapes, NVIDIA H100 80GB HBM3 at 700.00 W.
EM_MS_BEFORE = {"em_raw_cnt": 903.429, "em_block_partials": 907.152}
BLOCK_N = 130                    # block modes at small shapes: individuals,
BLOCK_SIZES = (1, 5, 37, 256)    # sites per bootstrap block,
BLOCK_SITES = 777                # and sites before truncation to whole blocks
LONG_BLOCK = (1 << 16) + 37      # indep block mode: a block past 2^16 sites
# Main-path runs (c) EM and (d) indep --pairwise_del on the partial-sum
# bootstrap route: replicates and block sizes.
EM_BOOT_REPS, EM_BOOT_BLOCK = 8, 256
INDEP_BOOT_REPS, INDEP_BOOT_BLOCK = 4, 1024
# The main path's CLI runs: (kind, sites, replicates, block size,
# --pairwise_del).  By the JAX engine's rule (float32 partials of
# n_blocks x N^2, twice under --pairwise_del, within 1 GiB) (a) takes
# the weighted-recompute route (256 blocks, 2 GiB), (c) and (d) the
# partial-sum route (64 blocks, 256 and 512 MiB).
RUNS = {
    "a": ("indep", INDEP_SITES, BOOT_REPS, BOOT_BLOCK, True),
    "b": ("em", EM_SITES, 0, 1, False),
    "c": ("em", EM_SITES, EM_BOOT_REPS, EM_BOOT_BLOCK, False),
    "d": ("indep", INDEP_SITES, INDEP_BOOT_REPS, INDEP_BOOT_BLOCK, True),
}
# The kernels, by the name of their wrapper and mode: (module, launch
# counter).  The "_tiles" modes are the wrappers called with a tile list.
KERNELS = {"indep_raw_cnt": ("indep", "LAUNCHES"),
           "indep_block_partials": ("indep", "BLOCK_LAUNCHES"),
           "em_raw_cnt": ("em", "LAUNCHES"),
           "em_block_partials": ("em", "BLOCK_LAUNCHES"),
           "indep_raw_cnt_tiles": ("indep", "TILE_LAUNCHES"),
           "em_raw_cnt_tiles": ("em", "TILE_LAUNCHES")}
# The launches each run must make: the weighted route one per matrix,
# the partial-sum route the full-data call and one block-mode call.
LAUNCHES = {"a": {"indep_raw_cnt": 1 + BOOT_REPS},
            "b": {"em_raw_cnt": 1},
            "c": {"em_raw_cnt": 1, "em_block_partials": 1},
            "d": {"indep_raw_cnt": 1, "indep_block_partials": 1}}
# The long-genome runs: run -> (the run whose array is written REPEAT
# times, chunks the forced budget must give at least, fused read).  A
# streamed run launches its kernel once per chunk and matrix.
REPEAT = 4
STREAMED = {"e": ("a", 8, True), "f": ("b", 4, False)}
RUNS["e"] = ("indep", REPEAT * INDEP_SITES, BOOT_REPS, BOOT_BLOCK, True)
RUNS["f"] = ("em", REPEAT * EM_SITES, 0, 1, False)
# Evolutionary models 3-6: run -> --evol_model.  (g) the EM under TN93,
# (h) indep --pairwise_del under F84, both with 2 replicates on the
# weighted route (this path has no other): three launches per matrix,
# one per substitution class.  "gs" is (g) streamed from the same file.
MODELS = {"g": 6, "h": 5, "gs": 6}
RUNS["g"] = ("em", EM_SITES, BOOT_REPS, BOOT_BLOCK, False)
RUNS["h"] = ("indep", INDEP_SITES, BOOT_REPS, BOOT_BLOCK, True)
RUNS["gs"] = RUNS["g"]
STREAMED["gs"] = ("g", 4, False)
LAUNCHES["g"] = {"em_raw_cnt": 3 * (1 + BOOT_REPS)}
LAUNCHES["h"] = {"indep_raw_cnt": 3 * (1 + BOOT_REPS)}
UNCLASSIFIABLE = 0.05    # share of POS rows whose two alleles are equal
SHORT_DISK_BYTES = 16 << 30  # free disk below which (e) is cut to half its sites
WIDE_N = 2048                # phase 4: both full modes also at this width
# Phase 2: the tile lists of a pairs axis split 2, 3 and 4 ways, at the
# EM's edge shapes and the indep kernel's shapes of several site chunks.
TILE_SPLITS = (2, 3, 4)
TILE_SHAPES = EM_EDGE_SHAPES + CHUNKED_SHAPES
# Phase 3, the mesh engine: run -> (the one-device run whose file and
# flags it takes, mesh entries (all on one card), pairs axis, site rounds
# a shard is held to under a forced budget or None: resident).
MESH_RUNS = {"i": ("a", 4, 2, None), "j": ("c", 4, 1, None), "k": ("g", 4, 2, None),
             "is": ("a", 4, 2, 4), "il": ("d", 2, 1, 4)}
# Phase 3, the disk-read rounds: run -> (the run whose flags it takes, its
# input, NGSDIST_HOST_BUDGET, the rounds a shard must be read in).  (l)
# reads (a)'s raw binary file in rounds (the fused reader per round);
# (lt) a gz beagle text of the first LAZY_TEXT_SITES sites of (b)'s array
# from its spill cache, the EM without bootstrap.
LAZY_TEXT_SITES = 4096
LAZY_RUNS = {"l": ("a", "bin", 256 << 20, 10), "lt": ("b", "beagle", 64 << 20, 3)}
# Phase 3, two processes on one card (--coordinator): run -> (the run
# whose file and flags it takes, NGSDIST_HOST_BUDGET or None, the sites of
# a round of a shard under a forced NGSDIST_DEVICE_BUDGET or None).  (ml)
# is config 5's path in miniature: lazy, streamed, the bootstrap's block
# partials in one pass over the rounds.
PROC_RUNS = {"me": ("b", None, None), "ma": ("a", None, None), "ml": ("d", 256 << 20, 2048)}
PROC_WALL = 420   # seconds both processes may take for all of PROC_RUNS
SCORE9 = np.array([[0.0, 0.5, 1.0], [0.5, 0.0, 0.5], [1.0, 0.5, 0.0]]).reshape(-1)


def log(msg: str) -> None:
    print(msg, flush=True)


def rand_probs(rng, S: int, N: int, missing: float = 0.05) -> np.ndarray:
    """Dirichlet(1,1,1) triples with a share of missing (uniform) rows."""
    P = rng.standard_exponential((S, N, 3))
    P /= P.sum(-1, keepdims=True)
    P[rng.random((S, N)) < missing] = 1.0 / 3.0
    return P


def check_kernel(kind, torch, raw_k, cnt_k, raw_p, cnt_p, rtol=None, atol_cnt=None):
    """Hold a kernel's (raw, cnt) [N, N] against the plain version's on
    the kernel's valid triangle (check_values)."""
    N = raw_k.shape[0]
    iu = torch.triu_indices(N, N, offset=0 if kind == "indep" else 1,
                            device=raw_k.device)
    rk, ck, rp, cp = (m[iu[0], iu[1]] for m in (raw_k, cnt_k, raw_p, cnt_p))
    return check_values(kind, torch, rk, ck, rp, cp, rtol, atol_cnt)


def check_values(kind, torch, raw_k, cnt_k, raw_p, cnt_p, rtol=None, atol_cnt=None):
    """Hold a kernel's raw and cnt values (the block modes: B and C, C
    None where a mode returns none) against the plain version's: cnt
    exact, the NaN pattern equal, indep raw within rtol relative, EM raw
    within atol_cnt x cnt.  Returns the largest relative raw error and
    the largest |raw error| / cnt (0 without cnt)."""
    rtol = INDEP_RTOL if rtol is None else rtol
    atol_cnt = EM_ATOL_CNT if atol_cnt is None else atol_cnt
    rk, rp = raw_k.double().reshape(-1), raw_p.double().reshape(-1)
    if (cnt_k is None) != (cnt_p is None):
        raise AssertionError(f"{kind}: cnt returned by one version only")
    cp = None
    if cnt_p is not None:
        ck, cp = cnt_k.double().reshape(-1), cnt_p.double().reshape(-1)
        if not torch.equal(ck, cp):
            raise AssertionError(f"{kind}: cnt differs from the plain version "
                                 f"(max {(ck - cp).abs().max().item()})")
    nan_p = torch.isnan(rp)
    if not torch.equal(torch.isnan(rk), nan_p):
        raise AssertionError(f"{kind}: NaN pattern differs from the plain version")
    fin = ~nan_p
    err, rp = (rk - rp).abs()[fin], rp[fin]
    cp = None if cp is None else cp[fin]
    bound = rtol * rp.abs() if kind == "indep" else atol_cnt * cp
    if not bool((err <= bound).all()):
        worst = (err - bound).argmax()
        raise AssertionError(f"{kind}: raw error {err[worst].item()} above "
                             f"bound {bound[worst].item()}")
    nz = rp != 0
    rel = float((err[nz] / rp[nz].abs()).max().item()) if bool(nz.any()) else 0.0
    per_cnt = 0.0
    if cp is not None and bool((cp > 0).any()):
        per_cnt = float((err[cp > 0] / cp[cp > 0]).max().item())
    return rel, per_cnt


def block_pairs(torch, B, C):
    """[n_blocks, N, N] partials (the indep plain version) -> the pair
    layout [n_blocks, n_pairs] of the block modes' wrappers."""
    I, J = torch.triu_indices(B.shape[-1], B.shape[-1], offset=1, device=B.device)
    return B[:, I, J], None if C is None else C[:, I, J]


def small_case(rng, torch, S: int, N: int):
    """Seeded float32 probabilities on the card with missing, all-zero
    and NaN rows, and the same values in float64."""
    P = rand_probs(rng, S, N, missing=0.1)
    P[rng.random((S, N)) < 0.01] = 0.0          # all-zero rows
    P[rng.integers(S, size=2), rng.integers(N, size=2)] = np.nan
    P32 = torch.from_numpy(P).to(torch.device(DEVICE)).float()
    return P32, P32.double()  # the kernels' inputs, exactly


def same_bytes(torch, a, b) -> bool:
    """torch.equal on the bit patterns, so that NaN equals itself."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_rerun(torch, fn, P32, pairwise_del, w, first) -> None:
    """A second call gives the same bytes: the sums' order is fixed."""
    again = fn(P32, SCORE9, pairwise_del, w)
    if not all(same_bytes(torch, a, b) for a, b in zip(first, again)):
        raise AssertionError(f"{fn.__name__}: rerun differs at {tuple(P32.shape)}")


def phase_small_shapes(torch, indep, em) -> None:
    rng = np.random.default_rng(SEED)
    dev = torch.device(DEVICE)
    n = 0
    worst = {"indep": 0.0, "em": 0.0}

    def weights(S, weighted):
        return (torch.from_numpy(rng.integers(0, 4, S).astype(np.float64)).to(dev)
                if weighted else None)

    for N in (11, 130, 300):
        for S in (53, 777):
            P32, P64 = small_case(rng, torch, S, N)
            for pairwise_del in (False, True):
                for weighted in (False, True):
                    w = weights(S, weighted)
                    for kind, fn, ref in (("indep", indep.indep_raw_cnt, indep.indep_raw_cnt_ref),
                                          ("em", em.em_raw_cnt, em.em_raw_cnt_ref)):
                        k = fn(P32, SCORE9, pairwise_del, w)
                        p = ref(P64, SCORE9, pairwise_del, w)
                        rel, per_cnt = check_kernel(kind, torch, *k, *p)
                        worst[kind] = max(worst[kind], rel if kind == "indep" else per_cnt)
                        check_rerun(torch, fn, P32, pairwise_del, w, k)
                        n += 1
            torch.cuda.synchronize()
    # the EM kernel's tile edges and site step
    for N, S in EM_EDGE_SHAPES:
        P32, P64 = small_case(rng, torch, S, N)
        for pairwise_del in (False, True):
            for weighted in (False, True):
                w = weights(S, weighted)
                k = em.em_raw_cnt(P32, SCORE9, pairwise_del, w)
                _, per_cnt = check_kernel("em", torch, *k,
                                          *em.em_raw_cnt_ref(P64, SCORE9, pairwise_del, w))
                worst["em"] = max(worst["em"], per_cnt)
                check_rerun(torch, em.em_raw_cnt, P32, pairwise_del, w, k)
                n += 1
        torch.cuda.synchronize()
    # the indep kernel's split over sites: several chunks, the last ragged
    for N, S in CHUNKED_SHAPES:
        chunks, chunk_sites = indep.split_plan(N, S)
        if chunks < 2 or S % chunk_sites == 0:
            raise AssertionError(f"({N}, {S}) gives {chunks} chunks of {chunk_sites}")
        P32, P64 = small_case(rng, torch, S, N)
        for pairwise_del in (False, True):
            for weighted in (False, True):
                w = weights(S, weighted)
                k = indep.indep_raw_cnt(P32, SCORE9, pairwise_del, w)
                rel, _ = check_kernel("indep", torch, *k,
                                      *indep.indep_raw_cnt_ref(P64, SCORE9, pairwise_del, w))
                worst["indep"] = max(worst["indep"], rel)
                check_rerun(torch, indep.indep_raw_cnt, P32, pairwise_del, w, k)
                n += 1
        torch.cuda.synchronize()
    log(f"phase 2: {n} kernel-vs-plain cases held (cnt exact, indep raw "
        f"<= {INDEP_RTOL:g} rel, EM raw <= {EM_ATOL_CNT:g} x cnt, all reruns "
        f"byte-identical; indep also at {CHUNKED_SHAPES} (N, S), several site chunks; "
        f"EM also at {EM_EDGE_SHAPES}, across its tile edges and site step); largest "
        f"indep rel err {worst['indep']:.3e}, EM |raw err|/cnt {worst['em']:.3e}")
    phase_small_blocks(torch, indep, em, rng)


def block_case(torch, indep, em, kind, P32, pairwise_del, n_blocks, block_size):
    """One block-mode call against its float64 plain version on the same
    inputs, and a rerun, byte-identical.  The EM's B is float64 and is
    held to em_table_bound(block_size) x C (SCORE9's largest entry is
    1).  Returns check_values' errors."""
    if kind == "indep":
        fn, atol_cnt = indep.indep_block_partials, None
        p = block_pairs(torch, *indep.indep_block_partials_ref(P32.double(), SCORE9, pairwise_del,
                                                        n_blocks, block_size))
    else:
        fn, atol_cnt = em.em_block_partials, em.em_table_bound(block_size)
        p = em.em_block_partials_ref(P32.double(), SCORE9, pairwise_del, n_blocks, block_size)
    k = fn(P32, SCORE9, pairwise_del, n_blocks, block_size)
    again = fn(P32, SCORE9, pairwise_del, n_blocks, block_size)
    if not all(a is b or same_bytes(torch, a, b) for a, b in zip(k, again)):
        raise AssertionError(f"{kind} blocks: rerun differs at {n_blocks} x {block_size}")
    return check_values(kind, torch, *k, *p, atol_cnt=atol_cnt)


def phase_small_blocks(torch, indep, em, rng) -> None:
    """The block modes of the partial-sum bootstrap against their plain
    versions: ragged block sizes at N = BLOCK_N, NaN and zero rows, and
    an indep block longer than 2^16 sites (its counts must stay exact)."""
    n, worst = 0, {"indep": 0.0, "em": 0.0}
    for block_size in BLOCK_SIZES:
        n_blocks = BLOCK_SITES // block_size
        P32, _ = small_case(rng, torch, n_blocks * block_size, BLOCK_N)
        for pairwise_del in (False, True):
            for kind in ("indep", "em"):
                rel, per_cnt = block_case(torch, indep, em, kind, P32, pairwise_del,
                                          n_blocks, block_size)
                worst[kind] = max(worst[kind], rel if kind == "indep" else per_cnt)
                n += 1
        torch.cuda.synchronize()
    P32, _ = small_case(rng, torch, 2 * LONG_BLOCK, BLOCK_N)
    rel, _ = block_case(torch, indep, em, "indep", P32, True, 2, LONG_BLOCK)
    worst["indep"] = max(worst["indep"], rel)
    torch.cuda.synchronize()
    log(f"phase 2: {n + 1} block-mode cases held (block sizes {BLOCK_SIZES} and "
        f"{LONG_BLOCK}, N = {BLOCK_N}; C exact, indep B <= {INDEP_RTOL:g} rel, EM B <= "
        f"em_table_bound(block size) x C = {em.em_table_bound(min(BLOCK_SIZES)):.3e} to "
        f"{em.em_table_bound(max(BLOCK_SIZES)):.3e} x C, reruns byte-identical); largest "
        f"indep rel err "
        f"{worst['indep']:.3e}, EM |B err|/C {worst['em']:.3e}")


def tile_lists(pm, kind: str, N: int, p: int):
    """The p tile lists of a pairs axis: indep's 64 x 64 tiles (K1p) or
    the EM's 32 x 32 tiles of each slice of the pair list (K2b)."""
    return pm.panel_tables(N, p) if kind == "indep" else pm.pair_block_tables(N, p)


def phase_tile_lists(torch, indep, em, pm, build) -> None:
    """Both kernels with a tile list (module docstring, phase 2): each
    pairs-shard's launch against the listed tiles of the full launch, byte
    for byte, and zeros elsewhere; reruns byte-identical; the lists'
    cover; the two-way split's launches against the plain tile forms."""
    rng = np.random.default_rng(SEED + 5)
    dev = torch.device(DEVICE)
    n, worst = 0, {"indep": 0.0, "em": 0.0}
    for N, S in TILE_SHAPES:
        P32, P64 = small_case(rng, torch, S, N)
        w = torch.from_numpy(rng.integers(0, 4, S).astype(np.float64)).to(dev)
        index = torch.nonzero(w != 0)[:, 0]
        for pairwise_del in (False, True):
            for kind, wk, extra in (("indep", w, {}), ("em", None, {}),
                                    ("em", w[index], {"site_index": index})):
                fn, ref = ((indep.indep_raw_cnt, indep.indep_raw_cnt_ref) if kind == "indep"
                           else (em.em_raw_cnt, em.em_raw_cnt_ref))
                edge, strict = (indep.TILE, False) if kind == "indep" else (em.EM_TILE, True)
                full = fn(P32, SCORE9, pairwise_del, wk, **extra)
                upper = torch.ones((N, N), dtype=torch.bool, device=dev).triu(int(strict))
                for p in TILE_SPLITS:
                    cover = torch.zeros((N, N), dtype=torch.int32, device=dev)
                    for lst in tile_lists(pm, kind, N, p):
                        tiles = torch.from_numpy(lst).to(dev)
                        got = fn(P32, SCORE9, pairwise_del, wk, tiles=tiles, **extra)
                        again = fn(P32, SCORE9, pairwise_del, wk, tiles=tiles, **extra)
                        mask = build.tile_mask(N, lst, edge, strict).to(dev)
                        cover += mask.int()
                        for g, a, f in zip(got, again, full):
                            if not (same_bytes(torch, g, a) and same_bytes(torch, g[mask], f[mask])
                                    and not bool(g[~mask].any())):
                                raise AssertionError(
                                    f"{kind} tiles ({N}, {S}) p={p}: a launch is not the full "
                                    "launch's listed tiles, or a rerun differs")
                        if p == TILE_SPLITS[0]:
                            plain = ref(P64, SCORE9, pairwise_del, wk, tiles=tiles, **extra)
                            rel, per_cnt = check_kernel(kind, torch, *got, *plain)
                            worst[kind] = max(worst[kind], rel if kind == "indep" else per_cnt)
                        n += 1
                    covered = cover[upper]
                    if not bool((covered == 1 if kind == "indep" else covered >= 1).all()):
                        raise AssertionError(f"{kind} tiles ({N}, {S}) p={p}: the lists do not "
                                             "cover the upper tiles")
        torch.cuda.synchronize()
    log(f"phase 2: {n} tile-list launches held (K1p, K2b with and without a site list; "
        f"(N, S) {TILE_SHAPES}, splits {TILE_SPLITS}): each the full launch's listed tiles "
        f"byte for byte, zeros elsewhere, reruns byte-identical, every upper tile covered "
        f"(indep exactly once); the {TILE_SPLITS[0]}-way launches against the plain tile "
        f"forms: largest indep rel err {worst['indep']:.3e}, EM |raw err|/cnt {worst['em']:.3e}")


def read_phylip(path: str):
    mats, rows = [], []
    with open(path) as fh:
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if len(parts) > 1:
                rows.append(np.array(parts[1:], dtype=np.float64))
            elif rows:
                mats.append(np.stack(rows))
                rows = []
    if rows:
        mats.append(np.stack(rows))
    return mats


def check_output(path: str, n_mats: int):
    mats = read_phylip(path)
    if len(mats) != n_mats:
        raise AssertionError(f"{path}: {len(mats)} matrices, expected {n_mats}")
    for m in mats:
        if m.shape != (N_IND, N_IND):
            raise AssertionError(f"{path}: matrix of shape {m.shape}")
        if not np.isfinite(m).all():
            raise AssertionError(f"{path}: non-finite distances")
        if not np.array_equal(m, m.T):
            raise AssertionError(f"{path}: matrix is not symmetric")
    return mats


def check_submatrix(mat, raw_p, denom, idx, kind, rtol, atol_cnt) -> float:
    """Output sub-matrix (model 1: d = -log(1 - raw/denom)) against the
    float64 plain statistics: the bound on raw/cnt (rtol relative for
    indep, atol_cnt for the EM, whose cnt is the denominator here) scaled
    by |dT/dd| = 1/(1 - raw/cnt), plus the %.10f print rounding."""
    iu = np.triu_indices(len(idx), k=1)
    ratio = (raw_p / denom).cpu().numpy()[iu]
    want = -np.log(1.0 - ratio)
    got = mat[np.ix_(idx, idx)][iu]
    tol_ratio = rtol * np.abs(ratio) if kind == "indep" else atol_cnt
    bound = tol_ratio / (1.0 - ratio) + 1e-10
    err = np.abs(got - want)
    if not (err <= bound).all():
        k = int(np.argmax(err - bound))
        raise AssertionError(f"{kind}: output {got[k]} vs plain {want[k]} "
                             f"(bound {bound[k]})")
    return float(err.max())


def run_array(run: str, P_sub: np.ndarray, sites: int) -> np.ndarray:
    """The float64 values run `run` was given, for the columns of P_sub
    (the generated array's): its first `sites` sites, a streamed run's
    base array written over and over."""
    if run not in STREAMED:
        return P_sub[:sites]
    base = P_sub[:RUNS[STREAMED[run][0]][1]]
    return np.tile(base, (sites // len(base), 1, 1))


def run_fused(run: str) -> bool:
    """Whether run `run` hands the engine a fused-read handle: every
    resident run but those of models 3-6, which need the host tensor; a
    streamed run as STREAMED says."""
    return STREAMED[run][2] if run in STREAMED else run not in MODELS


def card_values(sub64, fused: bool):
    """The float32 values the card holds for float64 values sub64, in
    float64: all three components rounded (the staged read's cast), or
    p0 and p1 rounded and p2 = 1 - p0 - p1 in float32 (the fused read's
    two components, expanded on the card)."""
    s32 = sub64.float()
    if fused:
        s32[..., 2] = (1.0 - s32[..., 0]) - s32[..., 1]
    return s32.double()


def check_submatrices(torch, indep, em, distance, mats, P_sub, idx):
    """The 64-individual sub-matrices of every matrix of every run's CLI
    output (mats: run -> matrices) against the plain version in float64
    over the generated array's columns idx, a replicate against the plain
    weighted recompute with its per-site multiplicities: once on the
    float32 values the card was given (card_values; the kernels' bounds),
    once on the float64 values themselves (the float32 policy's bounds).
    Returns the largest |d error| of each run and comparison."""
    dev = torch.device(DEVICE)
    errs = {}
    for run, (kind, sites, reps, block, pairwise_del) in RUNS.items():
        if run in MODELS:
            continue   # check_extended
        plain = indep.indep_raw_cnt_ref if kind == "indep" else em.em_raw_cnt_ref
        n_trunc, maps = distance.bootstrap_site_maps(SEED, reps, sites, block)
        sub64 = torch.from_numpy(run_array(run, P_sub, sites)).to(dev)
        fused = run_fused(run)
        for inputs, rtol, atol_cnt in (("float32", INDEP_RTOL, EM_ATOL_CNT),
                                       ("float64", POLICY_INDEP_RTOL, POLICY_EM_ATOL_CNT)):
            sub = card_values(sub64, fused) if inputs == "float32" else sub64
            e = []
            for r, mat in enumerate(mats[run]):
                S, w = sites, None
                if r > 0:
                    S = n_trunc
                    w = torch.from_numpy(distance.replicate_weights(maps[r - 1], S)).to(dev)
                raw, cnt = plain(sub[:S].contiguous(), SCORE9, pairwise_del, w)
                # without --pairwise_del the denominator is the site count
                denom = cnt if pairwise_del else float(S)
                e.append(check_submatrix(mat, raw, denom, idx, kind, rtol, atol_cnt))
            errs[f"{run}/{inputs}"] = max(e)
        del sub, sub64
    return errs


def plain_pair_pi(torch, sub, v_src, a1, a2, w_ok, pairwise_del):
    """[n, n, 4] per-pair base frequencies of the individuals of sub
    [S, n, 3] float64 in the JAX engine's host form: the expected base
    counts bc [S, n, 4] (d2 = p1 + 2 p2 copies of allele 2, 2 - d2 of
    allele 1, none where an allele code is invalid), summed over the
    sites under the weights w_ok, per pair under both members' validity
    (taken from v_src, the values the validity is decided on)."""
    from ngsdist_tpu_torch.ops.indep import EPSILON

    d2 = sub[..., 1] + 2.0 * sub[..., 2]
    d1 = 2.0 - d2
    ok = (a1 >= 0) & (a2 >= 0)
    eye = torch.eye(4, dtype=torch.float64, device=sub.device)
    A1 = eye[a1.clamp(0, 3).long()] * ok[:, None]
    A2 = eye[a2.clamp(0, 3).long()] * ok[:, None]
    bc = d1[:, :, None] * A1[:, None, :] + d2[:, :, None] * A2[:, None, :]
    if pairwise_del:
        valid = (((v_src[..., 0] - v_src[..., 1]).abs() >= EPSILON)
                 | ((v_src[..., 1] - v_src[..., 2]).abs() >= EPSILON)).double()
        U = torch.einsum("six,sj->ijx", bc * (valid * w_ok[:, None])[:, :, None], valid)
        tot = U + U.transpose(0, 1)
    else:
        c = torch.einsum("s,six->ix", w_ok, bc)
        tot = c[:, None, :] + c[None, :, :]
    return (tot / tot.sum(-1, keepdim=True)).cpu().numpy()


def check_extended(torch, indep, em, distance, submodels, mats, P_sub, idx, alleles):
    """The 64-individual sub-matrices of the runs of MODELS against the
    float64 plain route: the plain kernels' versions under the weights
    w x class mask, plain_pair_pi, and submodels.apply_extended_model.
    The bound: every class proportion raw_cl / cnt moved by its kernel's
    bound (indep: rtol relative; EM: atol_cnt x cnt_cl / cnt), all three
    up and all three down (each model rises with each proportion), the
    larger change of d, times 1.01, plus the %.10f print rounding.  Once
    on the float32 values the card holds, once on the float64 values that
    were written (the float32 policy's bounds).  Returns the largest
    |d error| per run and comparison, and per run the largest bound of
    the first."""
    dev = torch.device(DEVICE)
    iu = np.triu_indices(len(idx), k=1)
    errs, bounds = {}, {}
    for run, model in MODELS.items():
        kind, sites, reps, block, pairwise_del = RUNS[run]
        plain = indep.indep_raw_cnt_ref if kind == "indep" else em.em_raw_cnt_ref
        n_trunc, maps = distance.bootstrap_site_maps(SEED, reps, sites, block)
        a1, a2 = alleles[0][:sites], alleles[1][:sites]
        masks = submodels.classify_sites(a1, a2)
        a1_t, a2_t = torch.from_numpy(a1).to(dev), torch.from_numpy(a2).to(dev)
        sub64 = torch.from_numpy(run_array(run, P_sub, sites)).to(dev)
        for inputs, rtol, atol_cnt in (("float32", INDEP_RTOL, EM_ATOL_CNT),
                                       ("float64", POLICY_INDEP_RTOL, POLICY_EM_ATOL_CNT)):
            sub = card_values(sub64, False) if inputs == "float32" else sub64
            v_src = sub.float() if inputs == "float32" else sub
            e, b = [], []
            for r, mat in enumerate(mats[run]):
                w = np.ones(sites)
                if r > 0:
                    w = np.zeros(sites)
                    w[:n_trunc] = distance.replicate_weights(maps[r - 1], n_trunc)
                raws, cnts = {}, {}
                for cl in distance.CLASSES:
                    raw, cnt = plain(sub, SCORE9, pairwise_del,
                                     torch.from_numpy(w * masks[cl]).to(dev))
                    raws[cl], cnts[cl] = raw.cpu().numpy()[iu], cnt.cpu().numpy()[iu]
                cnt = (sum(cnts.values()) if pairwise_del
                       else float(np.sum(w * masks["ok"])))
                pi = plain_pair_pi(torch, sub, v_src, a1_t, a2_t,
                                   torch.from_numpy(w * masks["ok"]).to(dev), pairwise_del)[iu]

                def d_of(sign):
                    moved = [raws[cl] + sign * (rtol * np.abs(raws[cl]) if kind == "indep"
                                                else atol_cnt * cnts[cl])
                             for cl in distance.CLASSES]
                    return submodels.apply_extended_model(model, *moved, cnt, pi)

                want, up, down = d_of(0.0), d_of(1.0), d_of(-1.0)
                bound = 1.01 * np.maximum(np.abs(up - want), np.abs(want - down)) + 1e-10
                err = np.abs(mat[np.ix_(idx, idx)][iu] - want)
                if not (err <= bound).all():    # a NaN bound fails too
                    k = int(np.argmax(np.where(np.isnan(bound), np.inf, err - bound)))
                    raise AssertionError(f"({run}) model {model}, matrix {r}, {inputs}: "
                                         f"output {mat[np.ix_(idx, idx)][iu][k]} vs plain "
                                         f"{want[k]} (bound {bound[k]})")
                e.append(float(err.max()))
                b.append(float(bound.max()))
            errs[f"{run}/{inputs}"] = max(e)
            if inputs == "float32":
                bounds[run] = max(b)
        del sub, sub64
    return errs, bounds


def check_same_as_resident(run: str, streamed, resident) -> float:
    """Every matrix of a streamed run against the same input run
    resident: each lies within the kernel's bound of the exact sums
    (indep: INDEP_RTOL relative on raw/cnt; EM: EM_ATOL_CNT on it), so
    the two within twice it, scaled by |dT/dd| = 1/(1 - raw/cnt) of
    model 1, plus the %.10f print rounding of both.  run: a run of RUNS,
    or of LAZY_RUNS or PROC_RUNS (its base run's kind)."""
    base = (LAZY_RUNS[run][0] if run in LAZY_RUNS else
            PROC_RUNS[run][0] if run in PROC_RUNS else run)
    kind = RUNS[base][0]
    worst = 0.0
    for a, b in zip(streamed, resident):
        ratio = 1.0 - np.exp(-b)
        tol = 2 * (INDEP_RTOL * np.abs(ratio) if kind == "indep" else EM_ATOL_CNT)
        bound = tol / (1.0 - ratio) + 2e-10
        err = np.abs(a - b)
        if not (err <= bound).all():
            k = np.unravel_index(int(np.argmax(err - bound)), err.shape)
            raise AssertionError(f"({run}): streamed {a[k]} vs resident {b[k]} "
                                 f"(bound {bound[k]})")
        worst = max(worst, float(err.max()))
    return worst


def time_cuda(torch, fn, reps: int) -> float:
    """Mean ms of fn() over reps runs after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def indep_bound(S: int, N: int, out_bytes: int):
    """(ms, "bytes" or "operations", reckoning): the least time the card
    could take for the indep statistics of [S, N, 3] float32.  Bytes: the
    input read once, the outputs written once.  Operations: the fold
    (9 multiply-adds per site and individual), then per site and pair
    a <= b three multiply-adds for raw and one for cnt, at the TF32
    tensor-core peak (one product per term; the kernel spends three to
    keep float32 accuracy)."""
    nbytes = 12 * S * N + out_bytes
    flop = 2 * (9 * S * N + 4 * S * (N * (N + 1) // 2))
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, flop / PEAK_TF32 * 1e3
    return (max(t_b, t_o), "bytes" if t_b > t_o else "operations",
            f"{nbytes:.4g} B at {PEAK_BYTES:.4g} B/s = {t_b:.3f} ms; {flop:.4g} flop at "
            f"{PEAK_TF32:.4g} TF32 flop/s = {t_o:.3f} ms")


def em_bound(work: dict, S: int, N: int, out_bytes: int):
    """The same for the EM of [S, N, 3] float32, from what this run's
    data needs (ops/em.py em_work), all float64 outside the tensor
    cores: per live row the 49 steps of its table once (3 + 2 + 4
    operations: powers, their sum, the ratio); per ratio test a multiply
    and a compare; per live lane the 9-cell contraction (21), the sums'
    product (5), the division and the weighted accumulation (6)."""
    nbytes = 12 * S * N + out_bytes
    flop = 49 * 9 * work["live_rows"] + 2 * work["tests"] + 32 * work["live_lanes"]
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, flop / PEAK_F64 * 1e3
    return (max(t_b, t_o), "bytes" if t_b > t_o else "operations",
            f"{nbytes:.4g} B at {PEAK_BYTES:.4g} B/s = {t_b:.3f} ms; {flop:.4g} flop at "
            f"{PEAK_F64:.4g} float64 flop/s = {t_o:.3f} ms")


def indep_library_call(torch, indep, P32, n_blocks: int, block_size: int):
    """The PyTorch calls that compute the indep statistics (n_blocks > 1:
    per block) from operands prepared outside the timing: one float32
    einsum for raw and one (batched) product for cnt, TF32 off.  Timed
    as a yardstick only; the port never takes this path on a card."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the yardstick is a float32 product: TF32 must be off")
    N = P32.shape[1]
    score = torch.as_tensor(SCORE9, dtype=P32.dtype, device=P32.device).reshape(3, 3)
    v = indep.valid_mask(P32, True).reshape(n_blocks, block_size, N)
    Q = P32.reshape(n_blocks, block_size, N, 3) * v[..., None]
    Y = Q @ score.T
    vT = v.transpose(1, 2).contiguous()

    def call():
        return torch.einsum("ksag,ksbg->kab", Q, Y), vT @ v
    return call


def wide_probs(torch, S: int, N: int):
    """Seeded float32 probabilities [S, N, 3] made on the card: Dirichlet
    (1,1,1) triples with 5% missing (uniform) rows, as rand_probs makes."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    P = torch.empty((S, N, 3), dtype=torch.float32, device=DEVICE).exponential_(generator=gen)
    P /= P.sum(-1, keepdim=True)
    P[torch.rand((S, N), generator=gen, device=DEVICE) < 0.05] = 1.0 / 3.0
    return P


def phase_wide(torch, indep, em, card, report) -> None:
    """Both full modes at WIDE_N individuals (the JAX package's panel
    kernel, pallas_indep.py:463, took over above 1024; here the same
    kernels run): times, bounds, and the kernel held against the float64
    plain version on a 64-individual sub-matrix of the same inputs."""
    idx = torch.from_numpy(np.sort(np.random.default_rng(SEED + 2).choice(
        WIDE_N, 64, replace=False))).to(DEVICE)

    def sub(m):
        return m[idx][:, idx]

    P32 = wide_probs(torch, INDEP_SITES, WIDE_N)
    ms_k = time_cuda(torch, lambda: indep.indep_raw_cnt(P32, SCORE9, True), 5)
    ms_p = time_cuda(torch, lambda: indep.indep_raw_cnt_ref(P32, SCORE9, True), 3)
    torch.cuda.empty_cache()
    raw, cnt = indep.indep_raw_cnt(P32, SCORE9, True)
    rel, err = check_kernel("indep", torch, sub(raw), sub(cnt), *indep.indep_raw_cnt_ref(
        P32[:, idx].double(), SCORE9, True))
    ms_lib = time_cuda(torch, indep_library_call(torch, indep, P32, 1, INDEP_SITES), 3)
    torch.cuda.empty_cache()
    log(f"phase 4: indep {WIDE_N} x {INDEP_SITES} pairwise_del: kernel {ms_k:.3f} ms, plain "
        f"float32 {ms_p:.3f} ms; 64-individual sub-matrix vs float64 plain: max rel raw err "
        f"{rel:.3e}, max |raw/cnt err| {err:.3e} [{card}]")
    report(f"indep_raw_cnt_n{WIDE_N}", "ngsdist_tpu_torch/csrc/indep.cu",
           "ngsdist_tpu/ops/pallas_indep.py:463", err, "raw/cnt", ms_k, ms_p,
           indep_bound(INDEP_SITES, WIDE_N, 2 * 4 * WIDE_N * WIDE_N), ms_lib,
           wrapper="indep_raw_cnt")

    P32 = P32[:EM_SITES].contiguous()
    torch.cuda.empty_cache()
    ms_k = time_cuda(torch, lambda: em.em_raw_cnt(P32, SCORE9, False), 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    em.em_raw_cnt_ref(P32, SCORE9, False)
    torch.cuda.synchronize()
    ms_p = (time.perf_counter() - t0) * 1e3
    raw, cnt = em.em_raw_cnt(P32, SCORE9, False)
    _, err = check_kernel("em", torch, sub(raw), sub(cnt), *em.em_raw_cnt_ref(
        P32[:, idx].double(), SCORE9, False))
    t0 = time.perf_counter()
    work = em.em_work(P32.double())
    log(f"phase 4: em {WIDE_N} x {EM_SITES}: kernel {ms_k:.3f} ms, plain float32 {ms_p:.3f} ms "
        f"(one run); 64-individual sub-matrix vs float64 plain: max |raw/cnt err| {err:.3e}; "
        f"work {work['live_rows']} live rows, {work['live_lanes']} live lanes, "
        f"{work['tests']} ratio tests (counted in {time.perf_counter() - t0:.1f} s) [{card}]")
    report(f"em_raw_cnt_n{WIDE_N}", "ngsdist_tpu_torch/csrc/em.cu",
           "ngsdist_tpu/ops/pallas_em.py:326", err, "raw/cnt", ms_k, ms_p,
           em_bound(work, EM_SITES, WIDE_N, 2 * 4 * WIDE_N * WIDE_N), None,
           wrapper="em_raw_cnt")


def class_launches(torch, indep, em, distance, kind, P32, pairwise_del, wm, keep, compacted):
    """One matrix's three launches of models 3-6 as the engine makes them
    (core/distance.py _make_exact_stats): under the class weights wm on
    the whole tensor, or compacted, on each class's sites only (those of
    nonzero weight and the non-finite ones of `keep`): the EM kernel is
    handed the site list, indep the gathered sites.  Returns the three
    (raw, cnt)."""
    fn = em.em_raw_cnt if kind == "em" else indep.indep_raw_cnt
    out = []
    for cl in distance.CLASSES:
        if not compacted:
            out.append(fn(P32, SCORE9, pairwise_del, torch.from_numpy(wm[cl]).to(P32.device)))
            continue
        sel = distance.class_sites(wm[cl], keep)
        index = torch.from_numpy(sel).to(P32.device)
        w = torch.from_numpy(wm[cl][sel]).to(P32.device)
        if kind == "em":
            out.append(fn(P32, SCORE9, pairwise_del, w, site_index=index))
        else:
            out.append(fn(P32.index_select(0, index), SCORE9, pairwise_del, w))
    return out


def check_forms(torch, kind, full, compacted, where: str, want_nan: bool = False) -> float:
    """The compacted launches against the three weighted launches: the
    EM's bytes equal; indep's cnt equal, NaN pattern equal and raw within
    twice INDEP_RTOL relative (both lie within INDEP_RTOL of the exact
    sums).  Returns the largest relative difference of raw."""
    worst = 0.0
    for (raw_f, cnt_f), (raw_c, cnt_c) in zip(full, compacted):
        if want_nan and not bool(torch.isnan(raw_f).any()):
            raise AssertionError(f"{kind} {where}: the weighted form shows no NaN pair")
        if kind == "em":
            if not (same_bytes(torch, raw_f, raw_c) and same_bytes(torch, cnt_f, cnt_c)):
                raise AssertionError(f"em {where}: compacted launches differ from the "
                                     "three weighted launches")
            continue
        nan = torch.isnan(raw_f)
        if not (torch.equal(cnt_f, cnt_c) and torch.equal(nan, torch.isnan(raw_c))):
            raise AssertionError(f"indep {where}: compacted cnt or NaN pattern differs")
        a, b = raw_f.double()[~nan], raw_c.double()[~nan]
        if not bool(((a - b).abs() <= 2 * INDEP_RTOL * a.abs()).all()):
            raise AssertionError(f"indep {where}: compacted raw differs by more than "
                                 f"{2 * INDEP_RTOL:g} relative")
        nz = a != 0
        if bool(nz.any()):
            worst = max(worst, float(((a - b).abs()[nz] / a.abs()[nz]).max().item()))
    return worst


def phase_class_sums(torch, indep, em, distance, submodels, P32, alleles, card) -> None:
    """The class sums of models 3-6 in both forms (class_launches), held
    against each other (check_forms) and timed: a small case with NaN
    triples at sites of weight 0, then the EM at run (g)'s shape and
    indep at run (h)'s, for the full data and for the run's first
    replicate; and pair_pi_counts at (h)'s shape."""
    dev = P32.device
    rng = np.random.default_rng(SEED + 4)
    S, N = 777, 130
    a = rng.integers(0, 4, (2, S))
    a[1, rng.random(S) < 0.1] = -1
    masks = submodels.classify_sites(a[0].astype(np.int8), a[1].astype(np.int8))
    w = rng.integers(0, 3, S).astype(np.float64)
    P = rand_probs(rng, S, N, missing=0.1)
    s0 = int(np.flatnonzero(w == 0)[5])                      # weight 0 in every class
    s1 = int(np.flatnonzero((w > 0) & (masks["tv"] > 0))[5])  # weight 0 in ag and ct
    P[s0, 5] = np.nan
    P[s1, 7, 1] = np.nan
    Ps = torch.from_numpy(P).to(dev).float()
    keep = distance.nonfinite_sites(Ps).cpu().numpy()
    if sorted(np.flatnonzero(keep)) != sorted((s0, s1)):
        raise AssertionError(f"non-finite sites {np.flatnonzero(keep)}, expected {s0}, {s1}")
    wm = {cl: w * masks[cl] for cl in distance.CLASSES}
    n = 0
    for kind in ("em", "indep"):
        for pairwise_del in (False, True):
            forms = [class_launches(torch, indep, em, distance, kind, Ps, pairwise_del, wm,
                                    keep, c) for c in (False, True)]
            check_forms(torch, kind, *forms, f"{N} x {S}, NaN at weight 0", want_nan=True)
            n += 1
    torch.cuda.synchronize()
    log(f"phase 4: class sums, compacted against three weighted launches at {N} x {S} with "
        f"NaN triples at sites of weight 0: {n} cases held (EM bytes equal; indep cnt equal, "
        f"raw within {2 * INDEP_RTOL:g} relative; the NaN pairs in both forms)")

    for kind, sites, pairwise_del, reps in (("em", EM_SITES, False, 2),
                                            ("indep", INDEP_SITES, True, 5)):
        Pk = P32[:sites]
        masks = submodels.classify_sites(alleles[0][:sites], alleles[1][:sites])
        keep = distance.nonfinite_sites(Pk).cpu().numpy()
        n_trunc, maps = distance.bootstrap_site_maps(SEED, BOOT_REPS, sites, BOOT_BLOCK)
        w_rep = np.zeros(sites)
        w_rep[:n_trunc] = distance.replicate_weights(maps[0], n_trunc)
        for what, w in (("full data", np.ones(sites)), ("replicate 1", w_rep)):
            wm = {cl: w * masks[cl] for cl in distance.CLASSES}
            used = sum(distance.class_sites(wm[cl], keep).size for cl in distance.CLASSES)

            def form(compacted):
                return class_launches(torch, indep, em, distance, kind, Pk, pairwise_del, wm,
                                      keep, compacted)

            ms_f = time_cuda(torch, lambda: form(False), reps)
            ms_c = time_cuda(torch, lambda: form(True), reps)
            ms_c2 = time_cuda(torch, lambda: form(True), reps)
            ms_f2 = time_cuda(torch, lambda: form(False), reps)
            rel = check_forms(torch, kind, form(False), form(True), f"{N_IND} x {sites}, {what}")
            held = ("bytes equal" if kind == "em"
                    else f"cnt equal, raw within {rel:.3e} relative")
            log(f"phase 4: class sums, {kind} {N_IND} x {sites}"
                f"{' pairwise_del' if pairwise_del else ''}, {what}: three weighted launches "
                f"{ms_f:.3f} / {ms_f2:.3f} ms, compacted ({used} of {3 * sites} launched "
                f"sites) {ms_c:.3f} / {ms_c2:.3f} ms ({ms_f / ms_c:.2f}x); {held} [{card}]")
        torch.cuda.empty_cache()

    a1_t = torch.from_numpy(alleles[0]).to(dev)
    a2_t = torch.from_numpy(alleles[1]).to(dev)
    masks = submodels.classify_sites(*alleles)
    w_ok = torch.from_numpy(masks["ok"]).to(dev)
    for pairwise_del in (True, False):
        ms = time_cuda(torch, lambda: distance.pair_pi_counts(P32, a1_t, a2_t, w_ok,
                                                              pairwise_del), 2)
        log(f"phase 4: pair_pi_counts (float64 products in PyTorch, no kernel) {N_IND} x "
            f"{INDEP_SITES}{' pairwise_del' if pairwise_del else ''}: {ms:.3f} ms [{card}]")
    torch.cuda.empty_cache()


def hmma_count(nvcc: str, path: str, kernel: str) -> int:
    """HMMA (tensor-core) instructions in the machine code of the kernels
    of the library at path whose name holds `kernel`, by the cuobjdump
    of the toolkit whose nvcc built it."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", path], capture_output=True, text=True,
                          check=True).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and "HMMA" in line:
            count += 1
    return count


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def run_args(run: str, geno: str, out: str):
    """The CLI arguments of main-path run `run` (RUNS)."""
    kind, sites, reps, block, pairwise_del = RUNS[run]
    args = ["--geno", geno, "--probs", "--n_ind", str(N_IND), "--n_sites", str(sites),
            "--seed", str(SEED), "--out", out, "--verbose", "1"]
    if kind == "indep":
        args.append("--indep_geno")
    if pairwise_del:
        args.append("--pairwise_del")
    if reps:
        args += ["--n_boot_rep", str(reps), "--boot_block_size", str(block)]
    if run in MODELS:
        args += ["--evol_model", str(MODELS[run]), "--pos", pos_path(sites)]
    return args


def pos_path(sites: int) -> str:
    """The POS file of the runs with this many sites (write_pos_files)."""
    return os.path.join(WORK, f"pos{sites}.txt")


def write_pos_files():
    """Seeded allele codes (0..3 = A, C, G, T) for INDEP_SITES sites, two
    different letters per site except for a share UNCLASSIFIABLE of them
    (the same letter twice), and for every site count of MODELS a POS file
    (chr, pos, allele1, allele2) of its first sites.  Returns (a1, a2)."""
    rng = np.random.default_rng(SEED + 3)
    a1 = rng.integers(0, 4, INDEP_SITES)
    a2 = (a1 + rng.integers(1, 4, INDEP_SITES)) % 4
    same = rng.random(INDEP_SITES) < UNCLASSIFIABLE
    a2[same] = a1[same]
    letters = np.array(list("ACGT"))
    for sites in sorted({RUNS[run][1] for run in MODELS}):
        with open(pos_path(sites), "w") as fh:
            fh.write("".join(f"chr1\t{s + 1}\t{x}\t{y}\n" for s, (x, y) in enumerate(
                zip(letters[a1[:sites]], letters[a2[:sites]]))))
    return a1.astype(np.int8), a2.astype(np.int8)


def write_inputs(work: str):
    """Seeded binary GP files, written as raw little-endian float64
    [S, N, 3]: the first S sites of one generated array for each S that
    a resident run reads, and for a streamed run the array of its base
    run written as often as its sites ask.  Returns (P, {run: path})
    with P the generated array, normalised per triple as the binary
    reader does."""
    rng = np.random.default_rng(SEED)
    P = rand_probs(rng, INDEP_SITES, N_IND)
    genos, by_sites = {}, {}
    for run, (_, sites, *_) in RUNS.items():
        if run in STREAMED and sites == RUNS[STREAMED[run][0]][1]:
            genos[run] = genos[STREAMED[run][0]]   # the base run's own file
            continue
        if run in STREAMED:
            base = RUNS[STREAMED[run][0]][1]
            genos[run] = os.path.join(work, f"p{base}x{sites // base}.bin")
            blob = P[:base].astype("<f8")
            with open(genos[run], "wb") as fh:
                for _ in range(sites // base):
                    blob.tofile(fh)
            continue
        if sites not in by_sites:
            by_sites[sites] = os.path.join(work, f"p{sites}.bin")
            P[:sites].astype("<f8").tofile(by_sites[sites])
        genos[run] = by_sites[sites]
    P /= P.sum(-1, keepdims=True)
    return P, genos


def launch_counts(mods):
    """Each kernel's launch count, by the name of its wrapper."""
    return {name: getattr(mods[mod], counter) for name, (mod, counter) in KERNELS.items()}


def forced_budget(run: str) -> int:
    """The NGSDIST_DEVICE_BUDGET of streamed run `run`: a third of it is
    the tensor's budget, three quarters of that a float32 chunk's, and
    the chunks are as many as STREAMED asks for at least."""
    sites = RUNS[run][1]
    return 3 * 4 * (sites // STREAMED[run][1]) * N_IND * 12 // 3


@contextlib.contextmanager
def environment(env: dict):
    """Set (None: unset) environment variables for a with-block."""
    saved = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def cli_run(torch, cli, mods, ngsd, run: str, geno: str, out: str, budget, fused: bool,
            extra=()):
    """One call of the CLI entry point (timed_run) with the arguments of
    run `run` and `extra`."""
    seen = timed_run(torch, mods, ngsd, budget, fused, lambda: cli.main(
        run_args(run, geno, out) + ["--platform", DEVICE, "--throughput", *extra]))
    if seen["result"] != 0:
        raise AssertionError(f"run ({run}): exit code {seen['result']}")
    return seen


def timed_run(torch, mods, ngsd, budget, fused: bool, call):
    """call() (a run of the main path) with the launch counts set to 0
    just before and read just after, under the given NGSDIST_DEVICE_BUDGET
    (None: unset) and read route.  Returns what the run showed: call()'s
    result, launches, wall seconds, the stage times' summary, the peak of
    the device memory and the type of the source the engine was handed."""
    runner, profiling = ngsd["runner"], ngsd["profiling"]
    env = {"NGSDIST_DEVICE_BUDGET": None if budget is None else str(budget),
           "NGSDIST_FUSED_READ": "auto" if fused else "0"}
    seen = {}
    load_inputs = runner.load_inputs
    from_reader = ngsd["multihost"].SiteStream.from_reader.__func__

    def spy(pars, **kw):
        got = load_inputs(pars, **kw)
        seen["source"] = type(got[2]).__name__
        return got

    def reader_spy(cls, pars, mesh):   # a lazy run's stream
        seen["stream"] = from_reader(cls, pars, mesh)
        seen["source"] = type(seen["stream"].src).__name__
        return seen["stream"]

    runner.load_inputs = spy
    ngsd["multihost"].SiteStream.from_reader = classmethod(reader_spy)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    profiling.ACTIVE = profiling.StageTimes(torch.device(DEVICE))
    for mod, counter in KERNELS.values():
        setattr(mods[mod], counter, 0)
    try:
        with environment(env):
            t0 = time.perf_counter()
            seen["result"] = call()
            torch.cuda.synchronize()
            seen["wall"] = time.perf_counter() - t0
        seen["launches"] = launch_counts(mods)
        seen["times"] = profiling.ACTIVE.summary()
        seen["peak"] = torch.cuda.max_memory_allocated()
    finally:
        profiling.ACTIVE = None
        runner.load_inputs = load_inputs
        ngsd["multihost"].SiteStream.from_reader = classmethod(from_reader)
    return seen


def log_run(run: str, what: str, seen, base=None) -> None:
    """One run's line; base: the run whose file and flags it took."""
    base = base or run
    kind, sites, reps, block, _ = RUNS[base]
    boot = f" + {reps} replicates of {block}-site blocks" if reps else ""
    if base in MODELS:
        boot += f", --evol_model {MODELS[base]}"
    t = seen["times"]
    hidden = "none" if t["upload_hidden"] is None else f"{t['upload_hidden']:.3f}"
    log(f"phase 3: ({run}) {what}{kind} {N_IND} x {sites}{boot} in {seen['wall']:.2f} s "
        f"(host clock, CLI call incl. read and write): read {t['read_s']:.3f} s, upload "
        f"{t['upload_s']:.3f} s, kernels {t['kernel_s']:.3f} s, share of the upload under a "
        f"kernel or a read {hidden}; source {seen['source']}, peak device memory "
        f"{seen['peak']} B; launches "
        + ", ".join(f"{k} {v}" for k, v in seen["launches"].items() if v))


def drive_main_path(torch, cli, mods, ngsd, genos):
    """The runs of RUNS through the CLI entry point, each with every
    launch count set to 0 just before it and read just after, held to
    its expected launches; (a)-(e) must hand the engine a fused-read
    handle, the runs of models 3-6 the host tensor although the fused
    read is left on.  A streamed run is held under its forced budget and
    run once more resident, for the comparison ((g) streamed is compared
    with (g) itself).  Returns (output path, launch counts) per run and
    the resident outputs of the streamed runs."""
    distance = ngsd["distance"]
    dev = torch.device(DEVICE)
    outs, launches, resident = {}, {}, {}
    for run, (kind, sites, reps, block, _) in RUNS.items():
        outs[run] = os.path.join(WORK, f"{run}.dist")
        want = {name: LAUNCHES.get(run, {}).get(name, 0) for name in KERNELS}
        budget, fused = None, run_fused(run)
        # models 3-6 decline the fused read themselves: it stays on
        fused_env = fused or run in MODELS
        if run in STREAMED:
            base, min_chunks, _ = STREAMED[run]
            budget = forced_budget(run)
            with environment({"NGSDIST_DEVICE_BUDGET": str(budget)}):
                chunked, chunk = distance.stream_plan(sites, N_IND, dev, None)
            chunks = -(-sites // chunk)
            if not chunked or chunks < min_chunks:
                raise AssertionError(f"run ({run}): the budget {budget} gives {chunks} chunks")
            n_trunc = sites - sites % block
            want[f"{kind}_raw_cnt"] = chunks + reps * -(-n_trunc // chunk)
            if run in MODELS:  # every chunk once per class and matrix
                want[f"{kind}_raw_cnt"] = 3 * chunks * (1 + reps)
        seen = cli_run(torch, cli, mods, ngsd, run, genos[run], outs[run], budget, fused_env)
        launches[run] = seen["launches"]
        what = ""
        if run in STREAMED:
            what = f"streamed in {chunks} chunks of {chunk} sites under a budget of {budget} B, "
            if seen["peak"] >= budget:
                raise AssertionError(f"run ({run}): peak device memory {seen['peak']} B is "
                                     f"not under the budget {budget} B")
        log_run(run, what, seen)
        if launches[run] != want:
            raise AssertionError(f"run ({run}): launches {launches[run]}, expected {want}")
        if seen["source"] != ("PackedBinInput" if fused else "ndarray"):
            raise AssertionError(f"run ({run}): the engine was handed a {seen['source']}")
        if run in STREAMED and run not in MODELS:
            resident[run] = os.path.join(WORK, f"{run}_resident.dist")
            seen = cli_run(torch, cli, mods, ngsd, run, genos[run], resident[run], None, fused)
            log_run(run, "the same resident, for the comparison: ", seen)
            if seen["launches"][f"{kind}_raw_cnt"] != 1 + reps:
                raise AssertionError(f"run ({run}) resident: launches {seen['launches']}")
    return outs, launches, resident


def forced_mesh_budget(run: str, itemsize: int) -> int:
    """The NGSDIST_DEVICE_BUDGET under which streamed mesh run `run`
    plans rounds of a shard's sites / MESH_RUNS' rounds (SiteStream._plan,
    the JAX rule: a third of the budget is a shard's, three quarters of
    that a round's)."""
    base, entries, pairs, rounds = MESH_RUNS[run]
    chunk = RUNS[base][1] // (entries // pairs) // rounds
    return 3 * -(-chunk * 4 // 3) * N_IND * 3 * itemsize


def mesh_launches(run: str, stream, pm) -> dict:
    """The launches mesh run `run` must make, by the plan of its SiteStream:
    per (shard, round) that holds sites, and per matrix where a matrix is
    a pass: K1p / K2b once per entry of a pairs axis (and per class for
    models 3-6); on a 1-D mesh the full EM and its block mode once per
    shard (the partial-sum route), or indep's block mode once per shard
    and round (the streamed single pass)."""
    base, entries, pairs, _ = MESH_RUNS[run]
    kind, _, reps, _, _ = RUNS[base]
    shards = sum(hi > lo for r in range(stream.n_rounds) for lo, hi in stream.round_ranges(r))
    if pairs > 1:  # an empty list launches nothing
        lists = sum(lst.size > 0 for lst in tile_lists(pm, kind, N_IND, pairs))
        return {f"{kind}_raw_cnt_tiles": shards * lists * (1 + reps) * (3 if base in MODELS else 1)}
    if kind == "em":
        return {"em_raw_cnt": shards, "em_block_partials": shards}
    return {"indep_block_partials": shards}


def drive_mesh_runs(torch, cli, mods, ngsd, genos, mats, ext_bounds):
    """The runs of MESH_RUNS through runner.run on meshes of entries of one
    card (module docstring, phase 3), each with its launch counts set to 0
    just before and held to mesh_launches after; every matrix within twice
    the kernels' bound of the one-device run of the same file, read the
    same way (the mesh declines the fused read, so (c) is run once more
    staged for (j)); with two cards, (i) through the CLI on real cards.
    Returns the launches and the largest |d difference| per run."""
    runner, pm, pmh = ngsd["runner"], ngsd["mesh"], ngsd["multihost"]
    dev0 = torch.device(DEVICE, 0)
    itemsize = torch.finfo(ngsd["distance"].default_dtype(dev0)).bits // 8
    c_staged = os.path.join(WORK, "c_staged.dist")
    seen = cli_run(torch, cli, mods, ngsd, "c", genos["c"], c_staged, None, False)
    log_run("c", "once more with the staged read, for (j): ", seen)
    ref = {"a": mats["a"], "c": check_output(c_staged, 1 + RUNS["c"][2]), "d": mats["d"],
           "g": mats["g"]}
    launches, diffs = {}, {}
    for run, (base, entries, pairs, rounds) in MESH_RUNS.items():
        out = os.path.join(WORK, f"{run}.dist")
        budget = None if rounds is None else forced_mesh_budget(run, itemsize)
        pars, _ = cli.parse_args(run_args(base, genos[base], out))
        mesh = pm.make_mesh([dev0] * entries, pairs=pairs)
        with environment({"NGSDIST_DEVICE_BUDGET": None if budget is None else str(budget)}):
            stream = pmh.SiteStream(None, pars, mesh, *pmh.SiteStream._plan(pars, mesh))
        if rounds is not None and (stream.resident or stream.n_rounds < rounds):
            raise AssertionError(f"run ({run}): the budget {budget} gives {stream.n_rounds} "
                                 f"rounds of {stream.chunk} sites")
        seen = timed_run(torch, mods, ngsd, budget, False,
                         lambda: runner.run(pars, mesh=mesh, report_throughput=True))
        launches[run] = seen["launches"]
        what = (f"on a {pm.sites_size(mesh)} x {pairs} mesh of {entries} entries of {dev0}, "
                + ("" if stream.resident else f"streamed in {stream.n_rounds} rounds of "
                   f"{stream.chunk} sites a shard under a budget of {budget} B, "))
        log_run(run, what, seen, base)
        want = {name: mesh_launches(run, stream, pm).get(name, 0) for name in KERNELS}
        if launches[run] != want:
            raise AssertionError(f"run ({run}): launches {launches[run]}, expected {want}")
        got = check_output(out, 1 + RUNS[base][2])
        if base in MODELS:
            diffs[run] = max(float(np.abs(a - b).max()) for a, b in zip(got, ref[base]))
            if not diffs[run] <= 2 * ext_bounds[base]:
                raise AssertionError(f"({run}): differs from ({base}) by {diffs[run]}, above "
                                     f"2 x {ext_bounds[base]}")
        else:
            diffs[run] = check_same_as_resident(base, got, ref[base])
    if torch.cuda.device_count() >= 2:
        out = os.path.join(WORK, "i_cards.dist")
        seen = cli_run(torch, cli, mods, ngsd, "a", genos["a"], out, None, True,
                       extra=("--devices", "2", "--pairs", "2"))
        launches["i_cards"] = seen["launches"]
        log_run("i_cards", "through the CLI with --devices 2 --pairs 2 on two cards, ", seen, "a")
        want = {name: 0 for name in KERNELS}
        want["indep_raw_cnt_tiles"] = 2 * (1 + RUNS["a"][2])
        if seen["launches"] != want:
            raise AssertionError(f"run (i) on two cards: launches {seen['launches']}")
        diffs["i_cards"] = check_same_as_resident("a", check_output(out, 1 + RUNS["a"][2]),
                                                  ref["a"])
    else:
        log(f"phase 3: (i) through the CLI with --devices 2 --pairs 2 on real cards not run: "
            f"this machine shows {torch.cuda.device_count()} CUDA device")
    return launches, diffs


def write_beagle(path: str, P: np.ndarray, sites: int) -> None:
    """(lt)'s input: the first `sites` sites of the generated array as a
    gz beagle text (a header line; a marker, two allele columns and
    3 x N_IND probabilities printed %.6f a line)."""
    import gzip

    fmt = "\t".join(["%.6f"] * (3 * N_IND))
    with gzip.open(path, "wt", compresslevel=1) as fh:
        fh.write("marker\tallele1\tallele2\t"
                 + "\t".join(f"Ind{i}\tInd{i}\tInd{i}" for i in range(N_IND)) + "\n")
        for s in range(sites):
            fh.write(f"chr1_{s + 1}\t0\t1\t" + fmt % tuple(P[s].reshape(-1)) + "\n")


def lazy_args(run: str, geno: str, out: str):
    """The CLI arguments of disk-read run `run` (LAZY_RUNS)."""
    args = run_args(LAZY_RUNS[run][0], geno, out)
    if LAZY_RUNS[run][1] == "beagle":
        args[args.index("--n_sites") + 1] = str(LAZY_TEXT_SITES)
    return args


def drive_lazy_runs(torch, cli, mods, ngsd, genos, mats, P, card):
    """The runs of LAZY_RUNS through the CLI entry point under their forced
    NGSDIST_HOST_BUDGET (module docstring, phase 3), each with its launch
    counts set to 0 just before and held after to one launch per round
    and matrix: the stream must be lazy, in the rounds LAZY_RUNS says, its
    spill cache (lt) gone after the run, and every matrix within twice the
    kernel's bound of the same input run resident ((a) itself for (l)).
    Returns the launches and the largest |d difference| per run."""
    spill = os.path.join(WORK, "spill")
    os.makedirs(spill)
    text = os.path.join(WORK, "lt.beagle.gz")
    t0 = time.perf_counter()
    write_beagle(text, P, LAZY_TEXT_SITES)
    log(f"phase 3: (lt)'s gz beagle text of {N_IND} x {LAZY_TEXT_SITES} written in "
        f"{time.perf_counter() - t0:.2f} s ({os.path.getsize(text)} B)")
    launches, diffs = {}, {}
    for run, (base, style, host_budget, rounds) in LAZY_RUNS.items():
        kind, _, reps, _, _ = RUNS[base]
        geno = genos[base] if style == "bin" else text
        out = os.path.join(WORK, f"{run}.dist")
        args = lazy_args(run, geno, out) + ["--platform", DEVICE, "--throughput"]
        with environment({"NGSDIST_HOST_BUDGET": str(host_budget), "NGSDIST_SPILL_DIR": spill}):
            seen = timed_run(torch, mods, ngsd, None, True, lambda: cli.main(args))
        if seen["result"] != 0:
            raise AssertionError(f"run ({run}): exit code {seen['result']}")
        st = seen.get("stream")
        if st is None or not st.lazy or st.n_rounds != rounds:
            raise AssertionError(f"run ({run}): not read from disk in {rounds} rounds "
                                 f"({None if st is None else (st.lazy, st.n_rounds)})")
        if os.listdir(spill):
            raise AssertionError(f"run ({run}): spill cache left behind: {os.listdir(spill)}")
        launches[run] = seen["launches"]
        want = {name: 0 for name in KERNELS}
        want[f"{kind}_raw_cnt"] = rounds * (1 + reps)
        if launches[run] != want:
            raise AssertionError(f"run ({run}): launches {launches[run]}, expected {want}")
        t = seen["times"]
        sites = LAZY_TEXT_SITES if style == "beagle" else RUNS[base][1]
        how = ("the fused reader" if st.src.fused else
               "its spill cache" if st.src.spill_path else "the staged reader")
        log(f"phase 3: ({run}) {kind} {N_IND} x {sites} from a {style} file through {how}, "
            f"lazy under NGSDIST_HOST_BUDGET={host_budget}: {1 + reps} matrices of "
            f"{rounds} rounds of {st.chunk} sites in {seen['wall']:.2f} s (host clock, CLI call "
            f"incl. spill and write); read {t['read_s']:.3f} s, "
            f"{t['read_s'] / (rounds * (1 + reps)):.4f} s per round; upload "
            f"{t['upload_s']:.3f} s, kernels {t['kernel_s']:.3f} s; launches "
            + ", ".join(f"{k} {v}" for k, v in launches[run].items() if v) + f" [{card}]")
        if run == "l":
            ref = mats["a"]
        else:
            res = os.path.join(WORK, f"{run}_resident.dist")
            args = lazy_args(run, text, res) + ["--platform", DEVICE]
            seen = timed_run(torch, mods, ngsd, None, True, lambda: cli.main(args))
            if seen["result"] != 0:
                raise AssertionError(f"run ({run}) resident: exit code {seen['result']}")
            launches[f"{run}_resident"] = seen["launches"]
            log(f"phase 3: ({run}) the same read eagerly, resident, for the comparison, in "
                f"{seen['wall']:.2f} s [{card}]")
            ref = check_output(res, 1 + reps)
        diffs[run] = check_same_as_resident(run, check_output(out, 1 + reps), ref)
    return launches, diffs


PROC_WORKER = r"""
import json, os, sys, time
rank, root, spec = int(sys.argv[1]), sys.argv[2], json.load(open(sys.argv[3]))
sys.path.insert(0, root)
import torch
from ngsdist_tpu_torch import cli
from ngsdist_tpu_torch.ops import em, indep
from ngsdist_tpu_torch.utils import profiling

mods = {"indep": indep, "em": em}
dev = torch.device(spec["device"])
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
for run in spec["runs"]:
    for k in ("NGSDIST_DEVICE_BUDGET", "NGSDIST_HOST_BUDGET"):
        os.environ.pop(k, None)
    os.environ.update(run["env"])
    for mod, counter in spec["kernels"].values():
        setattr(mods[mod], counter, 0)
    sync()
    profiling.ACTIVE = profiling.StageTimes(dev)
    t0 = time.perf_counter()
    rc = cli.main(run["argv"] + ["--coordinator", "127.0.0.1:%d" % run["port"],
                                 "--num_processes", "2", "--process_id", str(rank)])
    sync()
    got = {"run": run["name"], "rc": rc, "wall": time.perf_counter() - t0,
           "times": profiling.ACTIVE.summary(),
           "launches": {name: getattr(mods[mod], counter)
                        for name, (mod, counter) in spec["kernels"].items()}}
    profiling.ACTIVE = None
    print("RESULT " + json.dumps(got), flush=True)
    if rc:
        sys.exit(rc)
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def proc_env(run: str) -> dict:
    """The forced budgets of two-process run `run` (PROC_RUNS): the device
    budget under which a shard's round is the given sites (a third of it a
    shard's, three quarters of that a round's; SiteStream._plan), equal
    for two processes of one shard and one process of two, as the host
    budget leaves the device's the smaller."""
    base, host, round_sites = PROC_RUNS[run]
    env = {}
    if host is not None:
        env["NGSDIST_HOST_BUDGET"] = str(host)
    if round_sites is not None:
        env["NGSDIST_DEVICE_BUDGET"] = str(3 * -(-round_sites * 4 // 3) * N_IND * 3 * 4)
    return env


def drive_process_runs(torch, mods, ngsd, genos, mats, card):
    """The runs of PROC_RUNS in two processes on the one card (module
    docstring, phase 3): two workers, each the CLI entry point with
    --coordinator 127.0.0.1:PORT --num_processes 2 --process_id 0|1 for
    every run in turn, killed past PROC_WALL seconds; then each run in one
    process on a mesh of two entries of the card (runner.run, the bytes a
    one-process --devices 2 run writes) under the same budgets.  Process
    0's file must equal that run's byte for byte, and the two processes'
    launches add up to its launches.  Both go through the same mesh,
    stream and gather code, so every matrix is also held to the
    one-device run of the same file and flags, read the same way, within
    twice the kernel's bound: (ma) to (a) and (ml) to (d) (all but (ma)
    read fused; the indep kernel's bound holds the staged read's rounding
    of p2, as drive_mesh_runs shows for (i)); (me), read staged, to the
    full-data matrix of (c) run staged (drive_mesh_runs), which is (b)'s
    read so.  Those runs are held to the plain sums.  Returns the
    launches (both processes together) and the largest |d difference| per
    run, and prints each run's wall time and its gathers."""
    cli, runner, pm = ngsd["cli"], ngsd["runner"], ngsd["mesh"]
    worker = os.path.join(WORK, "proc_worker.py")
    with open(worker, "w") as fh:
        fh.write(PROC_WORKER)
    runs = []
    for run, (base, _, _) in PROC_RUNS.items():
        runs.append({"name": run, "env": proc_env(run), "port": free_port(),
                     "argv": run_args(base, genos[base], os.path.join(WORK, f"{run}.dist"))
                     + ["--platform", DEVICE]})
    spec = os.path.join(WORK, "proc_spec.json")
    with open(spec, "w") as fh:
        json.dump({"runs": runs, "kernels": KERNELS, "device": DEVICE}, fh)
    env = {k: v for k, v in os.environ.items() if not k.startswith("NGSDIST_")}
    logs = [open(os.path.join(WORK, f"proc{rank}.err"), "w") for rank in (0, 1)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, worker, str(rank), ROOT, spec], env=env,
                              stdout=subprocess.PIPE, stderr=logs[rank], text=True)
             for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, PROC_WALL - (time.perf_counter() - t0)))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in logs:
            fh.close()
    wall = time.perf_counter() - t0
    if [p.returncode for p in procs] != [0, 0]:
        tails = [open(os.path.join(WORK, f"proc{rank}.err")).read()[-3000:] for rank in (0, 1)]
        raise AssertionError(f"two-process runs: exit codes {[p.returncode for p in procs]}; "
                             f"stdout {outs}; stderr tails {tails}")
    results = [{r["run"]: r for r in (json.loads(ln[7:]) for ln in out.splitlines()
                                     if ln.startswith("RESULT "))} for out in outs]
    log(f"phase 3: two processes ran {', '.join(PROC_RUNS)} on {DEVICE}:0 in {wall:.2f} s "
        f"(host clock, both workers from their start to their exit) [{card}]")
    dev0 = torch.device(DEVICE, 0)
    ref = {"a": mats["a"], "d": mats["d"],
           "b": check_output(os.path.join(WORK, "c_staged.dist"), 1 + RUNS["c"][2])[:1]}
    launches, diffs = {}, {}
    for run, (base, _, round_sites) in PROC_RUNS.items():
        kind, sites, reps, block, _ = RUNS[base]
        n_mats = 1 + reps
        got = [results[rank][run] for rank in (0, 1)]
        both = {name: got[0]["launches"][name] + got[1]["launches"][name] for name in KERNELS}
        launches[f"{run}_2p"] = both
        one = os.path.join(WORK, f"{run}_1p.dist")
        pars, _ = cli.parse_args(run_args(base, genos[base], one))
        env = proc_env(run)
        with environment({"NGSDIST_HOST_BUDGET": env.get("NGSDIST_HOST_BUDGET")}):
            seen = timed_run(torch, mods, ngsd, env.get("NGSDIST_DEVICE_BUDGET"), False,
                             lambda: runner.run(pars, mesh=pm.make_mesh([dev0] * 2)))
        launches[f"{run}_1p"] = seen["launches"]
        if both != seen["launches"] or not any(both.values()):
            raise AssertionError(f"run ({run}): two processes launched {both}, one process "
                                 f"of two entries {seen['launches']}")
        with open(os.path.join(WORK, f"{run}.dist"), "rb") as a, open(one, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"run ({run}): process 0's file differs from the "
                                     "one-process run's on two entries")
        diffs[run] = check_same_as_resident(run, check_output(one, n_mats), ref[base])
        what = ("lazy and streamed under NGSDIST_HOST_BUDGET="
                f"{env['NGSDIST_HOST_BUDGET']}, NGSDIST_DEVICE_BUDGET="
                f"{env['NGSDIST_DEVICE_BUDGET']} (rounds of {round_sites} sites a shard), "
                if round_sites else "resident, ")
        boot = f" + {reps} replicates of {block}-site blocks" if reps else ""
        log(f"phase 3: ({run}) {kind} {N_IND} x {sites}{boot} in two processes, {what}"
            + "; ".join(f"process {rank}: {g['wall']:.2f} s (host clock, CLI call), read "
                        f"{g['times']['read_s']:.3f} s, kernels {g['times']['kernel_s']:.3f} s, "
                        f"{g['times']['gathers']} gathers in {g['times']['gather_s']:.4f} s = "
                        f"{g['times']['gather_s'] / n_mats * 1e3:.2f} ms per matrix"
                        for rank, g in enumerate(got))
            + f"; one process on two entries {seen['wall']:.2f} s; process 0's file equals "
            f"it byte for byte and lies within {diffs[run]:.3e} of ({base}); launches "
            + ", ".join(f"{k} {v}" for k, v in both.items() if v) + f" [{card}]")
    return launches, diffs


def tile_times(torch, kmod, pm, build, kind, P32, pairwise_del, plain64, bound, report,
               card) -> None:
    """One pairs-shard's launch (its split's first tile list) at the main
    path's shape for splits of 2 and 4, beside the full launch, with the
    share of the full launch's tiles it holds and the bound scaled by that
    share; the 2-way launch held against the float64 plain version
    (plain64, the full one, masked to the list's tiles: the plain tile
    form) and reported, with the plain tile form's time (float32)."""
    N = P32.shape[1]
    fn = kmod.indep_raw_cnt if kind == "indep" else kmod.em_raw_cnt
    ref = kmod.indep_raw_cnt_ref if kind == "indep" else kmod.em_raw_cnt_ref
    edge, strict = (kmod.TILE, False) if kind == "indep" else (kmod.EM_TILE, True)
    nt = -(-N // edge)
    reps = 5 if kind == "indep" else 3
    ms_full = time_cuda(torch, lambda: fn(P32, SCORE9, pairwise_del), reps)
    first = {}
    for p in (2, 4):
        lst = tile_lists(pm, kind, N, p)[0]
        tiles = torch.from_numpy(lst).to(P32.device)
        ms = time_cuda(torch, lambda: fn(P32, SCORE9, pairwise_del, tiles=tiles), reps)
        share = lst.size / (nt * (nt + 1) // 2)
        first[p] = (lst, tiles, ms, share)
        log(f"phase 4: {kind} tile list, first shard of {p}: {lst.size} of {nt * (nt + 1) // 2} "
            f"tiles (share {share:.4f}) in {ms:.3f} ms against the full launch's "
            f"{ms_full:.3f} ms ({ms / ms_full:.4f}); bound scaled by the share "
            f"{bound[0] * share:.3f} ms [{card}]")
    lst, tiles, ms, share = first[2]
    got = fn(P32, SCORE9, pairwise_del, tiles=tiles)
    mask = build.tile_mask(N, lst, edge, strict).to(P32.device)
    plain = [torch.where(mask, x, torch.zeros_like(x)) for x in plain64]
    rel, err = check_kernel(kind, torch, *got, *plain)
    if kind == "indep":
        ms_p = time_cuda(torch, lambda: ref(P32, SCORE9, pairwise_del, tiles=tiles), 3)
    else:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref(P32, SCORE9, pairwise_del, tiles=tiles)
        torch.cuda.synchronize()
        ms_p = (time.perf_counter() - t0) * 1e3
    torch.cuda.empty_cache()
    log(f"phase 4: {kind} tile list, first shard of 2, vs float64 plain: max rel raw err "
        f"{rel:.3e}, max |raw/cnt err| {err:.3e}; plain tile form (float32) {ms_p:.3f} ms")
    replaces = ("ngsdist_tpu/ops/pallas_indep.py:463" if kind == "indep"
                else "ngsdist_tpu/ops/pallas_em.py:326")
    report(f"{kind}_raw_cnt_tiles", f"ngsdist_tpu_torch/csrc/{kind}.cu", replaces, err,
           "raw/cnt", ms, ms_p,
           (bound[0] * share, bound[1], f"{share:.4f} of the full launch's bound: {bound[2]}"),
           None)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ngsdist_tpu_torch import cli, runner
    from ngsdist_tpu_torch.core import distance, submodels
    from ngsdist_tpu_torch.ops import _build, em, indep
    from ngsdist_tpu_torch.parallel import mesh as pm
    from ngsdist_tpu_torch.parallel import multihost
    from ngsdist_tpu_torch.utils import profiling

    # Phase 1: identity and builds.
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    runner.host_runtime()
    log(f"phase 1: native host runtime ready in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    _build.library()
    log(f"phase 1: CUDA kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({os.path.basename(_build.library_path())})")
    with open(_build.library_path()[:-3] + ".log") as fh:
        for line in fh:
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("  ptxas: " + line.strip())
    hmma = hmma_count(_build._nvcc(), _build.library_path(), "indep_mma_kernel")
    if hmma == 0:
        raise AssertionError("the indep kernel's machine code holds no HMMA instruction")
    log(f"phase 1: indep kernel SASS: {hmma} HMMA instructions over its instantiations")

    # Phase 2: kernel against plain at small ragged shapes.
    phase_small_shapes(torch, indep, em)
    phase_tile_lists(torch, indep, em, pm, _build)

    # Phase 3: the main path, through the CLI entry point.
    mods = {"indep": indep, "em": em}
    ngsd = {"runner": runner, "distance": distance, "profiling": profiling, "mesh": pm,
            "multihost": multihost, "cli": cli}
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        free_disk = shutil.disk_usage(WORK).free
        if free_disk < SHORT_DISK_BYTES:
            kind, sites, *rest = RUNS["e"]
            RUNS["e"] = (kind, sites // 2, *rest)
            log(f"phase 3: {free_disk} B of disk free: run (e) cut to {sites // 2} sites")
        t0 = time.perf_counter()
        P, genos = write_inputs(WORK)
        alleles = write_pos_files()
        log(f"phase 3: inputs written in {time.perf_counter() - t0:.2f} s "
            f"({sum(os.path.getsize(g) for g in set(genos.values()))} B)")
        outs, launches, resident = drive_main_path(torch, cli, mods, ngsd, genos)
        mats = {run: check_output(outs[run], 1 + RUNS[run][2]) for run in RUNS}
        same = {run: check_same_as_resident(
            run, mats[run], check_output(resident[run], 1 + RUNS[run][2]))
            for run in STREAMED if run not in MODELS}
        # the same full-data kernel call on the same input, whatever route
        # the replicates take
        for run, other in (("c", "b"), ("d", "a")):
            if not np.array_equal(mats[run][0], mats[other][0]):
                raise AssertionError(f"the full-data matrix of ({run}) differs from ({other})'s")
        idx = np.sort(np.random.default_rng(SEED + 1).choice(N_IND, 64, replace=False))
        P_sub = np.ascontiguousarray(P[:, idx])
        errs = check_submatrices(torch, indep, em, distance, mats, P_sub, idx)
        ext_errs, ext_bounds = check_extended(torch, indep, em, distance, submodels, mats,
                                              P_sub, idx, alleles)
        errs.update(ext_errs)
        # (g) streamed against (g): each within its bound of the exact
        # sums; the sub-matrices' largest bound stands for every pair
        for run in MODELS:
            if run in STREAMED:
                base = STREAMED[run][0]
                diff = max(float(np.abs(a - b).max()) for a, b in zip(mats[run], mats[base]))
                if not diff <= 3 * ext_bounds[base]:
                    raise AssertionError(f"({run}): streamed differs from ({base}) by {diff}, "
                                         f"above 3 x {ext_bounds[base]}")
                same[run] = diff
        mesh_launched, mesh_diffs = drive_mesh_runs(torch, cli, mods, ngsd, genos, mats,
                                                    ext_bounds)
        launches.update(mesh_launched)
        lazy_launched, lazy_diffs = drive_lazy_runs(torch, cli, mods, ngsd, genos, mats, P, card)
        launches.update(lazy_launched)
        proc_launched, proc_diffs = drive_process_runs(torch, mods, ngsd, genos, mats, card)
        launches.update(proc_launched)
        del mats, P_sub
        log(f"phase 3: outputs hold 1 + n_boot_rep finite symmetric matrices "
            f"({', '.join(f'{run} {1 + RUNS[run][2]}' for run in RUNS)}); the full-data "
            "matrices of (c), (d) equal those of (b), (a); 64-individual sub-matrices "
            "agree with float64 plain (replicates: the weighted recompute; models 3-6: the "
            "class-weighted plain sums, the host form of the base frequencies and "
            "core/submodels.py, largest bound "
            + ", ".join(f"{k} {v:.3e}" for k, v in ext_bounds.items()) + "), max |d err| "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + "; streamed against resident, max |d difference| "
            + ", ".join(f"{k} {v:.3e}" for k, v in same.items())
            + "; mesh runs against the one-device run of the same file, max |d difference| "
            + ", ".join(f"{k} {v:.3e}" for k, v in mesh_diffs.items())
            + "; disk-read runs against the same input resident, max |d difference| "
            + ", ".join(f"{k} {v:.3e}" for k, v in lazy_diffs.items())
            + "; two-process runs against the one-device run of the same file, max |d "
            "difference| " + ", ".join(f"{k} {v:.3e}" for k, v in proc_diffs.items()))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    # Phase 4: timings at the main path's shapes; each kernel held against
    # the plain version there.
    kernels = []
    launched = {name: sum(counts[name] for counts in launches.values()) for name in KERNELS}

    def report(name, source, replaces, err, err_of, ms_k, ms_p, bound, ms_lib, wrapper=None):
        bound_ms, bound_by, reckoning = bound
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launched[wrapper or name],
                        "max_abs_err": err, "err_of": err_of, "ms": ms_k, "plain_ms": ms_p,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": ms_lib})
        lib = "none" if ms_lib is None else f"{ms_lib:.3f} ms"
        log(f"phase 4: {name}: bound {bound_ms:.3f} ms by {bound_by} ({reckoning}); kernel "
            f"at {bound_ms / ms_k:.4f} of it; one-call PyTorch version: {lib}")

    dev = torch.device(DEVICE)
    P32 = distance.put_probs(P, dev)
    del P
    ms_k = time_cuda(torch, lambda: indep.indep_raw_cnt(P32, SCORE9, True), 5)
    ms_p = time_cuda(torch, lambda: indep.indep_raw_cnt_ref(P32, SCORE9, True), 3)
    plain64 = indep.indep_raw_cnt_ref(P32.double(), SCORE9, True)
    rel, err = check_kernel("indep", torch, *indep.indep_raw_cnt(P32, SCORE9, True), *plain64)
    torch.cuda.empty_cache()
    log(f"phase 4: indep {N_IND} x {INDEP_SITES} pairwise_del: kernel {ms_k:.3f} ms, "
        f"plain float32 {ms_p:.3f} ms; vs float64 plain: max rel raw err {rel:.3e}, "
        f"max |raw/cnt err| {err:.3e} [{card}]")
    ms_lib = time_cuda(torch, indep_library_call(torch, indep, P32, 1, INDEP_SITES), 3)
    torch.cuda.empty_cache()
    report("indep_raw_cnt", "ngsdist_tpu_torch/csrc/indep.cu",
           "ngsdist_tpu/ops/pallas_indep.py:358", err, "raw/cnt", ms_k, ms_p,
           indep_bound(INDEP_SITES, N_IND, 2 * 4 * N_IND * N_IND), ms_lib)
    # K1p: one pairs-shard's tile list at (a)'s shape
    tile_times(torch, indep, pm, _build, "indep", P32, True, plain64,
               indep_bound(INDEP_SITES, N_IND, 2 * 4 * N_IND * N_IND), report, card)
    del plain64
    mesh = pm.make_mesh([dev] * 4, pairs=2)
    parts = []
    for k in range(4):
        with mesh.on(k):
            parts.append((k, torch.rand(N_IND * (N_IND - 1) // 2, device=dev)))
    ms = time_cuda(torch, lambda: pm.fixed_order_sum(mesh, parts), 20)
    log(f"phase 4: the fixed-order sum of (i)'s four shards' float32 pair vectors "
        f"({N_IND * (N_IND - 1) // 2} pairs) into float64 on the first device: {ms:.4f} ms "
        f"per sum, two per matrix under --pairwise_del [{card}]")
    del parts

    # the block mode at run (d)'s shape, pairs gathered from the tiles
    nb, bs = INDEP_SITES // INDEP_BOOT_BLOCK, INDEP_BOOT_BLOCK
    ms_k = time_cuda(torch, lambda: indep.indep_block_partials(P32, SCORE9, True, nb, bs), 5)
    ms_p = time_cuda(torch, lambda: block_pairs(
        torch, *indep.indep_block_partials_ref(P32, SCORE9, True, nb, bs)), 3)
    rel, err = block_case(torch, indep, em, "indep", P32, True, nb, bs)
    torch.cuda.empty_cache()
    log(f"phase 4: indep block partials {N_IND} x {INDEP_SITES}, {nb} blocks of {bs}, "
        f"pairwise_del: kernel {ms_k:.3f} ms, plain float32 {ms_p:.3f} ms; vs float64 "
        f"plain: max rel B err {rel:.3e}, max |B err|/C {err:.3e}, rerun byte-identical "
        f"[{card}]")
    ms_lib = time_cuda(torch, indep_library_call(torch, indep, P32, nb, bs), 3)
    torch.cuda.empty_cache()
    report("indep_block_partials", "ngsdist_tpu_torch/csrc/indep.cu",
           "ngsdist_tpu/core/distance.py:365", err, "B/C", ms_k, ms_p,
           indep_bound(INDEP_SITES, N_IND, 2 * 8 * nb * (N_IND * (N_IND - 1) // 2)), ms_lib)

    # models 3-6: the class sums in both forms, at (g)'s and (h)'s shapes
    phase_class_sums(torch, indep, em, distance, submodels, P32, alleles, card)

    P32 = P32[:EM_SITES].contiguous()
    torch.cuda.empty_cache()
    ms_k = time_cuda(torch, lambda: em.em_raw_cnt(P32, SCORE9, False), 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    em.em_raw_cnt_ref(P32, SCORE9, False)
    torch.cuda.synchronize()
    ms_p = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain64 = em.em_raw_cnt_ref(P32.double(), SCORE9, False)
    rel, err = check_kernel("em", torch, *em.em_raw_cnt(P32, SCORE9, False), *plain64)
    log(f"phase 4: em {N_IND} x {EM_SITES}: kernel {ms_k:.3f} ms, plain float32 "
        f"{ms_p:.3f} ms (one run); vs float64 plain: max |raw/cnt err| {err:.3e} "
        f"(check took {time.perf_counter() - t0:.1f} s) [{card}]")
    t0 = time.perf_counter()
    work = em.em_work(P32.double())
    log(f"phase 4: em work of these inputs: {work['live_rows']} live rows, "
        f"{work['live_lanes']} live lanes, {work['tests']} ratio tests "
        f"({work['tests'] / max(1, work['live_lanes']):.3f} per lane; counted in "
        f"{time.perf_counter() - t0:.1f} s)")
    report("em_raw_cnt", "ngsdist_tpu_torch/csrc/em.cu",
           "ngsdist_tpu/ops/pallas_em.py:326", err, "raw/cnt", ms_k, ms_p,
           em_bound(work, EM_SITES, N_IND, 2 * 4 * N_IND * N_IND), None)
    # K2b: one pairs-shard's tile list at (b)'s shape
    tile_times(torch, em, pm, _build, "em", P32, False, plain64,
               em_bound(work, EM_SITES, N_IND, 2 * 4 * N_IND * N_IND), report, card)
    del plain64

    # the block mode at run (c)'s shape
    nb, bs = EM_SITES // EM_BOOT_BLOCK, EM_BOOT_BLOCK
    ms_k = time_cuda(torch, lambda: em.em_block_partials(P32, SCORE9, False, nb, bs), 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    em.em_block_partials_ref(P32, SCORE9, False, nb, bs)
    torch.cuda.synchronize()
    ms_p = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    _, err = block_case(torch, indep, em, "em", P32, False, nb, bs)
    log(f"phase 4: em block partials {N_IND} x {EM_SITES}, {nb} blocks of {bs}: kernel "
        f"{ms_k:.3f} ms, plain float32 {ms_p:.3f} ms (one run); vs float64 plain: max "
        f"|B err|/C {err:.3e} (check took {time.perf_counter() - t0:.1f} s) [{card}]")
    report("em_block_partials", "ngsdist_tpu_torch/csrc/em.cu",
           "ngsdist_tpu/core/distance.py:418", err, "B/C", ms_k, ms_p,
           em_bound(work, EM_SITES, N_IND, 2 * 8 * nb * (N_IND * (N_IND - 1) // 2)), None)
    for name, before in EM_MS_BEFORE.items():
        now = next(k["ms"] for k in kernels if k["name"] == name)
        log(f"phase 4: {name}: {now:.3f} ms, before its redesign {before:.3f} ms "
            f"({before / now:.2f}x) [{card}]")

    del P32
    torch.cuda.empty_cache()
    phase_wide(torch, indep, em, card, report)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
