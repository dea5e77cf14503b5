#!/usr/bin/env python3
"""Smoke test of the PyTorch port (ngsdist_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run loudly:

1. Card identity (nvidia-smi name and power limit); build the port's
   native host runtime (C, the host compiler) and the CUDA kernels from
   this checkout; the indep kernel's machine code must hold tensor-core
   (HMMA) instructions, and K1d's (indep_f64_kernel) FP64 tensor-core
   (DMMA) ones, logged by shape.
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
   Phase x64-kernels: the same cases on the float64 entries (--x64; K1d,
   K2d) with float64 inputs: cnt exact, indep raw within
   f64_sum_bound(S, chunks) relative, EM raw within em_table_bound(S) x
   cnt, reruns byte-identical, tile lists the full launch's tiles byte
   for byte; only the float64 entries launch.
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
   (p) the EM at the 1000 Genomes pilot's width, PILOT_N x PILOT_SITES
   (gpubench's n179.boot4), with BOOT_REPS replicates of PILOT_BLOCK-site
   blocks on the weighted route: 21 tiles, so each launch runs the site
   slices ops/em.py em_site_slices gives on this card; its launches and
   the EM's slice counters (SLICED_LAUNCHES, SITE_SLICES, set to 0 before
   every CLI run with the launch counts) held to that rule, its
   sub-matrices to the float64 plain version.
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
   Every run of the float32 path but those of U16_RUNS sends float32
   pairs (NGSDIST_UPLOAD16=0), the fused reader's or the staged route's
   (hostmem.pack23), p2 restored on the card.
   The uint16 lane (U16_RUNS, the card's default, NGSDIST_UPLOAD16 unset):
   (u) (a), (ub) (b), (us) (a) streamed in 4 chunks under a forced budget,
   (um) (i)'s 2 x 2 mesh (pack16 of the staged read), (ul) (l)'s lazy
   rounds (the fused uint16 reader), (ut) (lt)'s gz beagle text through
   its spill cache; each sends uint16 slabs only (a spy on the slabs),
   makes its twin's launches, and is held to its twin (the run of that
   name, or for (us) the same under NGSDIST_UPLOAD16=0): cnt equal, raw
   within the quantization's bound (u16_bound, PERF.md section 2); and but
   (ut) its sub-matrices to the float64 plain version on the lane's values
   within the kernels' bounds.  (tb): (b) with --trace_dir, a trace that
   names em_kernel, and (b)'s bytes.
   The code-plane lane (CODED_RUNS), each run beside its twin under
   NGSDIST_CODED_UPLOAD=0 NGSDIST_UPLOAD23=0, which must write the same
   bytes (the table's rows are the float32 casts of the staged triples,
   so both compute on one tensor): (cg) (a)'s file and flags with --call_geno on one device,
   read by the fused codes reader (a readers.CodedBinInput, one byte a
   triple); (cgs) (cg) under a forced budget of 4 chunks, the code plane
   read whole and the bootstrap's chunks sliced from it, also within
   twice the kernel's bound of (cg); (gt) a seeded gz hard-genotype text
   (-1/0/1/2, ~5% missing) of 1024 x 16,384, read staged and scanned for
   its code plane (hostmem.derive_codes, its seconds on a line of their
   own); (cgm) (cg) on a mesh of two entries of the card, the eager code
   plane sliced per shard; (cgl) (cgm) under a host budget below the
   plane's 128 MiB, lazy coded rounds read from the raw file; and, in the
   two workers, (cgp) (cgl)'s flags in two --coordinator processes,
   process 0's file (cgl)'s bytes where both cut the same rounds, else
   within 1e-7 on d.  Each line gives wall, read, scan, upload and kernel
   seconds and the host bytes sent.  Then the upload lanes of (a)'s file
   (native nd_read_geno_pack23, nd_read_geno_pack16, nd_read_geno_codes,
   each read into pinned memory and uploaded).
   The --x64 runs (phase x64-runs): (xa), (xc), (xd), (xf), the files and
   flags of (a), (c), (d), (f) under --x64 (the engine handed the staged
   float64 array; (xd) on the partial-sum route exactly at its budget
   edge; (xf) in the chunks of the JAX engine's x64 rule, under its budget
   in device memory), (xk) and (xi), (k)'s and (i)'s meshes under --x64
   (K2d's and K1d's tile lists), and (xme), (me) in the two workers, byte
   for byte one process of two entries under --x64; each held to its
   float32 twin's launches under the float64 entries' names, every
   matrix's 64-individual sub-matrix to the float64 plain version on the
   float64 values written within the float64 entries' bounds, its float32
   twin's distance printed.  Phase x64-goldens: the 31 goldens of
   tests/fixtures through cli.main with --x64 --platform cuda, each md5 the
   manifest's or, where not, every differing printed value one final-digit
   step from the golden's (docs/PARITY.md:68-75), the md5-equal count and
   each stepped value printed.
   Each matrix takes three launches (one per substitution class, on the
   class's sites only) per chunk, 9 for (g) and (h); the engine is
   handed the staged float64 tensor.  Their 64-individual sub-matrices
   are held against the float64 plain versions under the class weights,
   the JAX engine's host form of the per-pair base frequencies and
   core/submodels.py's formulas: the bound is the model evaluated with
   every class proportion moved by its kernel's bound (all up, all
   down: the models rise with each proportion), plus the print
   rounding.  (g) streamed also against (g).
   Phase popgen: the HMM kernel (csrc/hmm.cu) through its public
   wrappers, all six entries (forward, backward, viterbi; float32 and
   float64) against the plain version (ops/hmm.py) on the same seeded
   inputs at HMM_SHAPES (1024 chains x 8,192 sites x K = 2; 64 x 2,048 at
   K = 3 with distances per chain and at K = 8) and on the edge inputs
   HMM_EDGES (alpha = 0, a zero proportion, dense chromosome breaks, exact
   ties): non-finite values equal, the rest within ops/hmm.py hmm_bound,
   each entry (segmented scans) in segments of hmm.SEGMENT sites and
   again, on the edge inputs and HMM_SHAPES[1:], of HMM_SMALL_SEGMENT,
   equal bit for bit to ops/hmm.py hmm_scan_segmented_ref (forward,
   backward) or hmm_viterbi_segmented_ref (Viterbi's path and best
   score), and every step where a Viterbi path leaves the plain version's
   a near tie (check_hmm); the first shape also timed.  Then the
   quickstart's steps 4-5 (examples/quickstart.py) at full width, with
   the HMM launch counts set to 0 just before and held to POPGEN_LAUNCHES
   just after (an HMM count, and the `launches` of its entry in the
   kernels line, counts entry calls: a forward or backward call is three
   kernel launches, a Viterbi call five):
   log-GLs of N_IND individuals x POPGEN_SITES sites ((a)'s seeded array
   four times over, as (e) reads it),
   read_pos_dist of a POS file of POPGEN_CHROMS chromosomes,
   est_maf_sites on the first POPGEN_MAF_SITES sites (ms an iteration and
   iterations; the rest repeat them), calc_emission at F = 0 and 1 into e_prob
   [1024, 262,144, 2] float64, forward, backward, posterior_decode and
   viterbi through the kernel in float64 and again in float32 (on
   POPGEN_CHECK_CHAINS chains over every site: forward's, backward's and
   viterbi's outputs held to the plain version and to the segmented
   order in plain PyTorch as above, the plain site loop
   replayed from CUDA graphs, ops/hmm.py segment_runner; forward and
   backward logliks within their bounds of each other, the posterior
   normalised, paths in range, the float32 messages within hmm_bound of
   the float64 ones), haplo_freq on
   the adjacent site pairs of the first POPGEN_MAF_SITES sites (normal
   space), and lbfgsb on POPGEN_LANES lanes of n = POPGEN_N of
   tests/test_popgen.py's bounded quartic, lanes POPGEN_SCIPY_LANES held
   to scipy's L-BFGS-B; each function timed by CUDA events.
4. Each kernel's time at the main path's shapes beside its plain
   version's (float32), its bound (the least time the card could take:
   the larger of its bytes over PEAK_BYTES and its operations, counted
   from this run's data, over the peak rate of their type) and, indep,
   the PyTorch calls that compute the same function; the EM and K1d
   times beside those of the kernels before their redesigns
   (EM_MS_BEFORE, INDEP_F64_MS_BEFORE), the HMM's three scans at full
   width beside theirs (HMM_MS_BEFORE); and
   the kernel held there against the float64 plain version on the same
   inputs; the float64 entries (K1d, K2d, their tile lists and block
   modes) on the same values in float64, beside their bounds (K1d's
   operations at the float64 tensor cores' peak), the float64 plain
   version and, K1d, the float64 einsum and product.  Both full modes, and
   K1d on the same values in float64, also at 2048 individuals (WIDE_N;
   seeded on the card; the EM at WIDE_EM_SITES), held against the float64
   plain version on a 64-individual sub-matrix (K1d within
   f64_sum_bound, its rerun byte-identical).  The class sums of models 3-6 in both forms, three
   weighted launches on the whole tensor against three launches on each
   class's sites only, timed at (g)'s and (h)'s shapes: the EM's bytes
   must be equal (it adds a lane's sites in order, and a site of weight
   0 adds 0), indep's cnt equal and its raw within twice INDEP_RTOL (its
   float32 windows regroup); also on a small case with a NaN triple at a
   site of weight 0, which both forms must spread to its pairs; and
   core/distance.py pair_pi_counts at (h)'s shape; core/distance.py
   expand_codes at [65,536, 1024] uint8 -> float32 beside its bound by
   bytes and the plain indexing it must equal; expand23's uint16 and
   float32 halves at [65,536, 1024, 2] beside their bounds by bytes, the
   uint16 half the CPU's bits.  One pairs-shard's
   K1p launch at (a)'s shape and K2b launch at (b)'s, for splits of 2 and
   4, beside the full launch, with the share of the tiles it holds and
   the bound scaled by that share; and the fixed-order sum of (i)'s four
   shards.  The EM's site slices (phase_em_slices) at PILOT_N x
   PILOT_SITES, both entries: G by ops/em.py em_site_slices against one
   slice, timed; the sliced launch's rerun byte-identical, its first 64
   individuals the bytes of their own launch at the same G and within the
   entry's bound of the sliced plain order (em_raw_cnt_tables(slices=G)).
   The EM's weight rows (phase_em_rows) at ROWS_N x ROWS_SITES, both
   entries: one launch of ROWS_REPS replicates' rows timed against as
   many one-row launches, each row the bytes of its one-row launch.

The bounds (PERF.md section 2): the indep kernel sums 3xTF32 products
on the tensor cores in float32 over 16-site windows and the windows in
float64; the EM kernel takes the float64 plain version's stopping
steps, its powers by sequential multiplication lie within 2^-45 of the
plain version's contribution per lane, and raw is rounded to float32
once, which is at most 6e-8 x cnt.
The policy bounds add the float32 rounding of the input, which moves
the EM's stopping step by one for lanes within ~1e-7 of its threshold.
The float64 entries: indep sums every product in float64 in another
order than the plain version, 2 (3 S + chunks + 5) u relative
(ops/indep.py f64_sum_bound); the EM's as the float32 entry's, raw
written in float64.  Every kernel of the `kernels` line must have been
launched by the main path.

Prints the card line, a {"kernels": [...]} line whose "max_abs_err" is
the largest absolute error of raw/cnt (the uncorrected distance)
against the float64 plain version (the HMM entries: of the log messages
and logliks, or the best score, against the plain version in the
entry's type, as "err_of" says, over HMM_SHAPES, the edge inputs and
POPGEN_CHECK_CHAINS chains of the popgen path; their "ms" and "plain_ms"
at HMM_SHAPES[0], "full_width_ms" at the popgen path's shape; the two EM
full modes' "sliced_launches" and "site_slices", the slice counters
added up over phase 3's CLI runs, "n179", phase_em_slices' numbers
with their bound, and "weight_rows_n1092", phase_em_rows'), and as its last line
{"ok": true, "device": {...}}.  Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import os
import re
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
PEAK_F64_TC = 67e12   # float64 on the tensor cores (mma .f64, the --x64 indep kernel)
# The EM kernel before its redesign (one float64 lane per pair and site,
# exp/log powers), same shapes, NVIDIA H100 80GB HBM3 at 700.00 W.
EM_MS_BEFORE = {"em_raw_cnt": 903.429, "em_block_partials": 907.152}
# K1d, the float64 indep kernel, before its redesign for the FP64 tensor
# cores (mma.sync m8n8k4), same shapes, NVIDIA H100 80GB HBM3 at 700.00 W.
INDEP_F64_MS_BEFORE = {"indep_raw_cnt_f64": 14.166, "indep_block_partials_f64": 13.716}
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
# The float64 entries (--x64; K1d, K2d) under the same names with "_f64":
# a run of the float32 path launches none of them, an --x64 run none of
# the float32 ones.
KERNELS.update({f"{name}_f64": (mod, f"{counter}_F64") for name, (mod, counter)
                in list(KERNELS.items())})
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
WIDE_N = 2048                # phase 4: both full modes also at this width,
WIDE_EM_SITES = EM_SITES // 4  # the EM at a quarter of (b)'s sites
# Phase 3 run (p) and phase 4: the EM at the 1000 Genomes pilot's width
# (gpubench's n179.boot4), 21 tiles of 32 x 32, where the kernel runs its
# site slices; (p) bootstraps in PILOT_BLOCK-site blocks, whose partial
# sums exceed the route's 1 GiB, so the replicates take the weighted route.
PILOT_N, PILOT_SITES, PILOT_BLOCK = 179, 262144, 5
# Phase 4: the EM's weight rows at the 1000 Genomes phase 1 width
# (gpubench's n1092 cells): one launch of ROWS_REPS replicates' rows.
ROWS_N, ROWS_SITES, ROWS_REPS, ROWS_BLOCK = 1092, 32768, 8, 5
# The EM's site-slice counters (ops/em.py), by the name of the full mode's
# wrapper: (launches with more than one slice, slices added up).
SLICES = {"em_raw_cnt": ("SLICED_LAUNCHES", "SITE_SLICES"),
          "em_raw_cnt_f64": ("SLICED_LAUNCHES_F64", "SITE_SLICES_F64")}
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
PROC_WALL = 480   # seconds both processes may take for all of PROC_RUNS and CODED_PROC_RUNS
# Phase 3, the code-plane lane: run -> (the run whose file and flags it
# takes with --call_geno, or "gt" for the hard-genotype text; mesh
# entries of the card or None: one device; NGSDIST_HOST_BUDGET or None;
# chunks a forced NGSDIST_DEVICE_BUDGET must give or None; what the
# engine must be handed, coded and in the twin).  (cgl)'s host budget is
# below the code plane's S x N x 2 bytes (128 MiB), so the mesh declines
# the eager plane and reads coded rounds from disk.
CODED_HOST_BUDGET = 96 << 20
GT_SITES = EM_SITES
CODED_RUNS = {"cg": ("a", None, None, None, ("CodedBinInput", "ndarray")),
              "cgs": ("a", None, None, 4, ("CodedProbs", "ndarray")),
              "gt": ("gt", None, None, None, ("CodedProbs", "ndarray")),
              "cgm": ("a", 2, None, None, ("CodedProbs", "ndarray")),
              "cgl": ("a", 2, CODED_HOST_BUDGET, None,
                      ("SiteStream(DiskRows, coded)", "SiteStream(DiskRows, uncoded)"))}
# Two --coordinator processes: run -> the in-process run whose flags and
# host budget it takes, and against whose file process 0's is held.
CODED_PROC_RUNS = {"cgp": "cgl"}
CODED_PROC_ATOL = 1e-7   # on d, where the two cut other rounds
# Phase 3, the uint16 fixed-point lane (NGSDIST_UPLOAD16: on by default
# for a float32 run on a card; every other run of this script pins it off,
# NGSDIST_UPLOAD16=0, and sends float32 pairs): run -> (the run whose
# file, flags and route it takes, the run of that name it is held to, its
# twin, or None: the twin is run beside it).  (u) (a) fused and resident,
# (ub) (b)'s EM, (us) (a) streamed under a forced budget of 4 chunks,
# (um) (i)'s 2 x 2 mesh (the staged read, pack16 on the host), (ul) (l)'s
# lazy rounds (the fused uint16 reader per round), (ut) (lt)'s gz beagle
# text through its spill cache (the staged rows packed per round).
U16_RUNS = {"u": ("a", "a"), "ub": ("b", "b"), "us": ("a", None), "um": ("i", "i"),
            "ul": ("l", "l"), "ut": ("lt", "lt")}
U16_TWINS = {twin for _, twin in U16_RUNS.values() if twin}
U16_CHUNKS = 4           # (us): the chunks its forced budget must give at least
TWINS = {}               # twin -> what its run showed (timed_run)
RUN_SLICES = []          # each CLI run's slice counts (timed_run), in turn
# The lane against its twin (PERF.md section 2): per triple the summed
# |component| difference, U16_DELTA: p0 and p1 half a step of 1/65534
# each and p2 their sum, a missing row's components up to EPSILON (1e-5)
# from its mean, and six float32 roundings.  With the same valid sites
# (cnt exact: the host decides missingness), raw / cnt moves by at most
# smax (2 U16_DELTA + U16_DELTA^2) for indep (smax = 1, SCORE9's largest
# |entry|) and smax min(1, 24 EM_MAX_ITER U16_DELTA) for the EM, besides
# the kernels' own bounds on each side.
U16_DELTA = 3 * (1e-5 + 0.5 / 65534) + 6 * 2.0 ** -24
U16_SMAX = 1.0
EM_MAX_ITER = 50         # ops/em.py: the EM's longest walk of k
# --x64 on the card: run -> the run whose file and flags it takes with
# --x64.  Each reads staged in float64 (the fused and coded lanes are the
# float32 path's): (xa) the weighted route, (xc) the EM and (xd) indep on
# the partial-sum route, (xd) exactly at its budget edge (64 blocks x
# 1024^2 x 8 B x 2 = 2^30 B), (xf) streamed under (f)'s forced budget in
# the JAX engine's x64 chunk edges; (xk) (k)'s TN93 on its 2 x 2 mesh
# (K2d with site lists and tile lists), (xi) (i)'s indep on its 2 x 2 mesh
# (K1d's tile lists); (xme) (me)'s EM in the two --coordinator workers,
# against one process of two entries under --x64.
X64_RUNS = {"xa": "a", "xc": "c", "xd": "d", "xf": "f"}
X64_MESH_RUNS = {"xk": "k", "xi": "i"}
X64_PROC_RUNS = {"xme": "me"}
FIXTURES = os.path.join(ROOT, "tests", "fixtures")  # the goldens and their inputs
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


def small_case(rng, torch, S: int, N: int, x64: bool = False):
    """Seeded probabilities on the card with missing, all-zero and NaN
    rows: the kernels' input (float32, or float64 under x64) and the same
    values in float64."""
    P = rand_probs(rng, S, N, missing=0.1)
    P[rng.random((S, N)) < 0.01] = 0.0          # all-zero rows
    P[rng.integers(S, size=2), rng.integers(N, size=2)] = np.nan
    P64 = torch.from_numpy(P).to(torch.device(DEVICE))
    if x64:
        return P64, P64
    P32 = P64.float()
    return P32, P32.double()  # the kernels' inputs, exactly


def kernel_tol(torch, indep, em, P, S=None):
    """(rtol, atol_cnt) of check_values for a kernel's launch on P over S
    of its sites: the float32 entries' INDEP_RTOL and EM_ATOL_CNT; the
    float64 entries' bounds (PERF.md section 2): indep
    f64_sum_bound(S, chunks) relative (every term >= 0 with SCORE9), EM
    em_table_bound(S) x cnt (SCORE9's largest entry is 1)."""
    if P.dtype != torch.float64:
        return INDEP_RTOL, EM_ATOL_CNT
    S = P.shape[0] if S is None else S
    return indep.f64_sum_bound(S, indep.split_plan(P.shape[1], S)[0]), em.em_table_bound(S)


def same_bytes(torch, a, b) -> bool:
    """torch.equal on the bit patterns, so that NaN equals itself."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_rerun(torch, fn, P32, pairwise_del, w, first) -> None:
    """A second call gives the same bytes: the sums' order is fixed."""
    again = fn(P32, SCORE9, pairwise_del, w)
    if not all(same_bytes(torch, a, b) for a, b in zip(first, again)):
        raise AssertionError(f"{fn.__name__}: rerun differs at {tuple(P32.shape)}")


def entries(x64: bool) -> str:
    """The entries a phase holds, and their bounds, for its log lines."""
    if x64:
        return ("float64 entries (K1d, K2d) on float64 inputs: cnt exact, indep raw <= "
                "f64_sum_bound(S, chunks) rel, EM raw <= em_table_bound(S) x cnt")
    return (f"float32 entries: cnt exact, indep raw <= {INDEP_RTOL:g} rel, EM raw <= "
            f"{EM_ATOL_CNT:g} x cnt")


def phase_small_shapes(torch, indep, em, x64: bool = False) -> None:
    """Both kernels against their float64 plain versions at small ragged
    shapes (module docstring, phase 2), in float32 or, x64, in float64."""
    rng = np.random.default_rng(SEED)
    dev = torch.device(DEVICE)
    n = 0
    worst = {"indep": 0.0, "em": 0.0}

    def weights(S, weighted):
        return (torch.from_numpy(rng.integers(0, 4, S).astype(np.float64)).to(dev)
                if weighted else None)

    for N in (11, 130, 300):
        for S in (53, 777):
            P32, P64 = small_case(rng, torch, S, N, x64)
            for pairwise_del in (False, True):
                for weighted in (False, True):
                    w = weights(S, weighted)
                    for kind, fn, ref in (("indep", indep.indep_raw_cnt, indep.indep_raw_cnt_ref),
                                          ("em", em.em_raw_cnt, em.em_raw_cnt_ref)):
                        k = fn(P32, SCORE9, pairwise_del, w)
                        p = ref(P64, SCORE9, pairwise_del, w)
                        rel, per_cnt = check_kernel(kind, torch, *k, *p,
                                                    *kernel_tol(torch, indep, em, P32))
                        worst[kind] = max(worst[kind], rel if kind == "indep" else per_cnt)
                        check_rerun(torch, fn, P32, pairwise_del, w, k)
                        n += 1
            torch.cuda.synchronize()
    # the EM kernel's tile edges and site step
    for N, S in EM_EDGE_SHAPES:
        P32, P64 = small_case(rng, torch, S, N, x64)
        for pairwise_del in (False, True):
            for weighted in (False, True):
                w = weights(S, weighted)
                k = em.em_raw_cnt(P32, SCORE9, pairwise_del, w)
                _, per_cnt = check_kernel("em", torch, *k,
                                          *em.em_raw_cnt_ref(P64, SCORE9, pairwise_del, w),
                                          *kernel_tol(torch, indep, em, P32))
                worst["em"] = max(worst["em"], per_cnt)
                check_rerun(torch, em.em_raw_cnt, P32, pairwise_del, w, k)
                n += 1
        torch.cuda.synchronize()
    # the indep kernel's split over sites: several chunks, the last ragged
    for N, S in CHUNKED_SHAPES:
        chunks, chunk_sites = indep.split_plan(N, S)
        if chunks < 2 or S % chunk_sites == 0:
            raise AssertionError(f"({N}, {S}) gives {chunks} chunks of {chunk_sites}")
        P32, P64 = small_case(rng, torch, S, N, x64)
        for pairwise_del in (False, True):
            for weighted in (False, True):
                w = weights(S, weighted)
                k = indep.indep_raw_cnt(P32, SCORE9, pairwise_del, w)
                rel, _ = check_kernel("indep", torch, *k,
                                      *indep.indep_raw_cnt_ref(P64, SCORE9, pairwise_del, w),
                                      *kernel_tol(torch, indep, em, P32))
                worst["indep"] = max(worst["indep"], rel)
                check_rerun(torch, indep.indep_raw_cnt, P32, pairwise_del, w, k)
                n += 1
        torch.cuda.synchronize()
    log(f"phase 2{' x64-kernels' if x64 else ''}: {n} kernel-vs-plain cases held "
        f"({entries(x64)}, all reruns "
        f"byte-identical; indep also at {CHUNKED_SHAPES} (N, S), several site chunks; "
        f"EM also at {EM_EDGE_SHAPES}, across its tile edges and site step); largest "
        f"indep rel err {worst['indep']:.3e}, EM |raw err|/cnt {worst['em']:.3e}")
    phase_small_blocks(torch, indep, em, rng, x64)


def block_case(torch, indep, em, kind, P32, pairwise_del, n_blocks, block_size, plain=None):
    """One block-mode call (float32, or float64 under --x64) against its
    float64 plain version on the same inputs (`plain` where it has been
    taken already), and a rerun, byte-identical.  The EM's B is float64
    and is held to em_table_bound(block_size) x C (SCORE9's largest entry
    is 1); indep's B to INDEP_RTOL, the float64 entry's to
    f64_sum_bound(block_size).  Returns check_values' errors."""
    rtol = indep.f64_sum_bound(block_size) if P32.dtype == torch.float64 else None
    if kind == "indep":
        fn, atol_cnt = indep.indep_block_partials, None
        p = plain or block_pairs(torch, *indep.indep_block_partials_ref(
            P32.double(), SCORE9, pairwise_del, n_blocks, block_size))
    else:
        fn, atol_cnt = em.em_block_partials, em.em_table_bound(block_size)
        p = plain or em.em_block_partials_ref(P32.double(), SCORE9, pairwise_del, n_blocks,
                                              block_size)
    k = fn(P32, SCORE9, pairwise_del, n_blocks, block_size)
    again = fn(P32, SCORE9, pairwise_del, n_blocks, block_size)
    if not all(a is b or same_bytes(torch, a, b) for a, b in zip(k, again)):
        raise AssertionError(f"{kind} blocks: rerun differs at {n_blocks} x {block_size}")
    return check_values(kind, torch, *k, *p, rtol=rtol, atol_cnt=atol_cnt)


def phase_small_blocks(torch, indep, em, rng, x64: bool = False) -> None:
    """The block modes of the partial-sum bootstrap against their plain
    versions: ragged block sizes at N = BLOCK_N, NaN and zero rows, and
    an indep block longer than 2^16 sites (its counts must stay exact)."""
    n, worst = 0, {"indep": 0.0, "em": 0.0}
    for block_size in BLOCK_SIZES:
        n_blocks = BLOCK_SITES // block_size
        P32, _ = small_case(rng, torch, n_blocks * block_size, BLOCK_N, x64)
        for pairwise_del in (False, True):
            for kind in ("indep", "em"):
                rel, per_cnt = block_case(torch, indep, em, kind, P32, pairwise_del,
                                          n_blocks, block_size)
                worst[kind] = max(worst[kind], rel if kind == "indep" else per_cnt)
                n += 1
        torch.cuda.synchronize()
    P32, _ = small_case(rng, torch, 2 * LONG_BLOCK, BLOCK_N, x64)
    rel, _ = block_case(torch, indep, em, "indep", P32, True, 2, LONG_BLOCK)
    worst["indep"] = max(worst["indep"], rel)
    torch.cuda.synchronize()
    indep_b = "f64_sum_bound(block size)" if x64 else f"{INDEP_RTOL:g}"
    log(f"phase 2{' x64-kernels' if x64 else ''}: {n + 1} block-mode cases held "
        f"({'float64' if x64 else 'float32'} entries; block sizes {BLOCK_SIZES} and "
        f"{LONG_BLOCK}, N = {BLOCK_N}; C exact, indep B <= {indep_b} rel, EM B <= "
        f"em_table_bound(block size) x C = {em.em_table_bound(min(BLOCK_SIZES)):.3e} to "
        f"{em.em_table_bound(max(BLOCK_SIZES)):.3e} x C, reruns byte-identical); largest "
        f"indep rel err "
        f"{worst['indep']:.3e}, EM |B err|/C {worst['em']:.3e}")


def tile_lists(pm, kind: str, N: int, p: int):
    """The p tile lists of a pairs axis: indep's 64 x 64 tiles (K1p) or
    the EM's 32 x 32 tiles of each slice of the pair list (K2b)."""
    return pm.panel_tables(N, p) if kind == "indep" else pm.pair_block_tables(N, p)


def phase_tile_lists(torch, indep, em, pm, build, x64: bool = False) -> None:
    """Both kernels with a tile list (module docstring, phase 2): each
    pairs-shard's launch against the listed tiles of the full launch, byte
    for byte, and zeros elsewhere; reruns byte-identical; the lists'
    cover; the two-way split's launches against the plain tile forms.  In
    float32 or, x64, in float64."""
    rng = np.random.default_rng(SEED + 5)
    dev = torch.device(DEVICE)
    n, worst = 0, {"indep": 0.0, "em": 0.0}
    for N, S in TILE_SHAPES:
        P32, P64 = small_case(rng, torch, S, N, x64)
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
                            rel, per_cnt = check_kernel(kind, torch, *got, *plain, *kernel_tol(
                                torch, indep, em, P32, len(index) if extra else S))
                            worst[kind] = max(worst[kind], rel if kind == "indep" else per_cnt)
                        n += 1
                    covered = cover[upper]
                    if not bool((covered == 1 if kind == "indep" else covered >= 1).all()):
                        raise AssertionError(f"{kind} tiles ({N}, {S}) p={p}: the lists do not "
                                             "cover the upper tiles")
        torch.cuda.synchronize()
    log(f"phase 2{' x64-kernels' if x64 else ''}: {n} tile-list launches held "
        f"({'float64' if x64 else 'float32'} entries; K1p, K2b with and without a site list; "
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


def check_output(path: str, n_mats: int, n: int = N_IND):
    mats = read_phylip(path)
    if len(mats) != n_mats:
        raise AssertionError(f"{path}: {len(mats)} matrices, expected {n_mats}")
    for m in mats:
        if m.shape != (n, n):
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


def card_values(sub64):
    """The float32 values the card holds for float64 values sub64 on the
    float32 pair lane (NGSDIST_UPLOAD16=0), in float64: p0 and p1 rounded
    and p2 = 1 - p0 - p1 in float32, expanded on the card, whether the
    fused reader or the staged route's pack23 sent the pair."""
    s32 = sub64.float()
    s32[..., 2] = (1.0 - s32[..., 0]) - s32[..., 1]
    return s32.double()


def card_values_u16(torch, sub64):
    """The float32 values the card holds for float64 values sub64 on the
    uint16 lane, in float64, computed here from the lane's definition
    (utils/hostmem.py pack16, core/distance.py expand23): q = rint(p x
    65534) for p0 and p1, r = q x float32(1/65534), p2 = (1 - r0) - r1 in
    float32; a row the host finds missing (|p0 - p1| and |p1 - p2| below
    1e-5) is (v, v, v), v its mean quantized."""
    step = torch.tensor(np.float32(1.0 / 65534), device=sub64.device)
    r = torch.round(sub64[..., :2] * 65534).float() * step
    out = torch.empty(sub64.shape, dtype=torch.float32, device=sub64.device)
    out[..., :2] = r
    out[..., 2] = (1.0 - r[..., 0]) - r[..., 1]
    miss = (((sub64[..., 0] - sub64[..., 1]).abs() < 1e-5)
            & ((sub64[..., 1] - sub64[..., 2]).abs() < 1e-5))
    v = torch.round((sub64[..., 0] + sub64[..., 1] + sub64[..., 2]) / 3.0 * 65534).float() * step
    out = torch.where(miss[..., None], v[..., None].expand_as(out), out)
    return out.double()


def check_submatrices(torch, indep, em, distance, mats, P_sub, idx, runs=None, u16=False):
    """The 64-individual sub-matrices of every matrix of every run's CLI
    output (mats: run -> matrices) against the plain version in float64
    over the generated array's columns idx, a replicate against the plain
    weighted recompute with its per-site multiplicities: once on the
    float32 values the card was given (card_values; the kernels' bounds),
    once on the float64 values themselves (the float32 policy's bounds).
    runs: run -> the run of RUNS whose file and flags it took (default:
    every run of RUNS but those of models 3-6); u16: runs of the uint16
    lane, held once, on its values (card_values_u16), to the kernels'
    bounds (PERF.md section 2 holds the lane to its twin).  Returns the
    largest |d error| of each run and comparison."""
    dev = torch.device(DEVICE)
    errs = {}
    inputs_of = (("float32", INDEP_RTOL, EM_ATOL_CNT),)
    if not u16:
        inputs_of += (("float64", POLICY_INDEP_RTOL, POLICY_EM_ATOL_CNT),)
    for run, base in (runs or {r: r for r in RUNS if r not in MODELS}).items():
        kind, sites, reps, block, pairwise_del = RUNS[base]
        plain = indep.indep_raw_cnt_ref if kind == "indep" else em.em_raw_cnt_ref
        if u16 and kind == "em":
            # the lane's p2 = 1 - r0 - r1 falls below 0 by up to a step where
            # p2 is below one: the kernel's arithmetic (powers by
            # multiplication) takes it, the plain version's log does not
            plain = em.em_raw_cnt_tables
        n_trunc, maps = distance.bootstrap_site_maps(SEED, reps, sites, block)
        sub64 = torch.from_numpy(run_array(base, P_sub, sites)).to(dev)
        for inputs, rtol, atol_cnt in inputs_of:
            sub = sub64
            if inputs == "float32":
                sub = card_values_u16(torch, sub64) if u16 else card_values(sub64)
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
            errs[f"{run}/{'uint16' if u16 else inputs}"] = max(e)
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


def check_extended(torch, indep, em, distance, submodels, mats, P_sub, idx, alleles,
                   x64_runs=None):
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
    the first.  x64_runs (run -> the run of MODELS whose flags it took
    under --x64): those runs instead, once, on the float64 values written
    within the float64 entries' bounds (em_table_bound(S), indep
    f64_sum_bound(S, chunks))."""
    dev = torch.device(DEVICE)
    iu = np.triu_indices(len(idx), k=1)
    errs, bounds = {}, {}
    inputs_of = (("float32", INDEP_RTOL, EM_ATOL_CNT),
                 ("float64", POLICY_INDEP_RTOL, POLICY_EM_ATOL_CNT))
    todo = ({run: run for run in MODELS} if x64_runs is None else x64_runs)
    for run, base in todo.items():
        model = MODELS[base]
        kind, sites, reps, block, pairwise_del = RUNS[base]
        if x64_runs is not None:
            inputs_of = (("float64", indep.f64_sum_bound(sites, indep.split_plan(
                N_IND, sites)[0]), em.em_table_bound(sites)),)
        plain = indep.indep_raw_cnt_ref if kind == "indep" else em.em_raw_cnt_ref
        n_trunc, maps = distance.bootstrap_site_maps(SEED, reps, sites, block)
        a1, a2 = alleles[0][:sites], alleles[1][:sites]
        masks = submodels.classify_sites(a1, a2)
        a1_t, a2_t = torch.from_numpy(a1).to(dev), torch.from_numpy(a2).to(dev)
        sub64 = torch.from_numpy(run_array(base, P_sub, sites)).to(dev)
        for inputs, rtol, atol_cnt in inputs_of:
            sub = card_values(sub64) if inputs == "float32" else sub64
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
    or of LAZY_RUNS, PROC_RUNS or CODED_RUNS (its base run's kind)."""
    base = (LAZY_RUNS[run][0] if run in LAZY_RUNS else
            PROC_RUNS[run][0] if run in PROC_RUNS else
            CODED_RUNS[run][0] if run in CODED_RUNS else run)
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


def indep_bound(S: int, N: int, out_bytes: int, f64: bool = False):
    """(ms, "bytes" or "operations", reckoning): the least time the card
    could take for the indep statistics of [S, N, 3] float32 (f64:
    float64).  Bytes: the input read once, the outputs written once.
    Operations: the fold (9 multiply-adds per site and individual), then
    per site and pair a <= b three multiply-adds for raw and one for cnt,
    at the TF32 tensor-core peak (one product per term; the kernel spends
    three to keep float32 accuracy), or the float64 one."""
    nbytes = (24 if f64 else 12) * S * N + out_bytes
    flop = 2 * (9 * S * N + 4 * S * (N * (N + 1) // 2))
    peak, of = (PEAK_F64_TC, "float64 tensor-core") if f64 else (PEAK_TF32, "TF32")
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, flop / peak * 1e3
    return (max(t_b, t_o), "bytes" if t_b > t_o else "operations",
            f"{nbytes:.4g} B at {PEAK_BYTES:.4g} B/s = {t_b:.3f} ms; {flop:.4g} flop at "
            f"{peak:.4g} {of} flop/s = {t_o:.3f} ms")


def em_bound(work: dict, S: int, N: int, out_bytes: int, f64: bool = False):
    """The same for the EM of [S, N, 3] float32 (f64: float64), from what
    this run's data needs (ops/em.py em_work), all float64 outside the
    tensor cores: per live row the 49 steps of its table once (3 + 2 + 4
    operations: powers, their sum, the ratio); per ratio test a multiply
    and a compare; per live lane the 9-cell contraction (21), the sums'
    product (5), the division and the weighted accumulation (6)."""
    nbytes = (24 if f64 else 12) * S * N + out_bytes
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

    # K1d, the --x64 entry, on the same values in float64
    P64 = P32.double()
    del raw, cnt
    ms_k = time_cuda(torch, lambda: indep.indep_raw_cnt(P64, SCORE9, True), 5)
    ms_p = time_cuda(torch, lambda: indep.indep_raw_cnt_ref(P64, SCORE9, True), 3)
    torch.cuda.empty_cache()
    got = indep.indep_raw_cnt(P64, SCORE9, True)
    if not all(same_bytes(torch, a, b) for a, b in zip(got, indep.indep_raw_cnt(
            P64, SCORE9, True))):
        raise AssertionError(f"indep float64 entry: rerun differs at {WIDE_N} individuals")
    rtol = kernel_tol(torch, indep, em, P64)[0]
    rel, err = check_kernel("indep", torch, sub(got[0]), sub(got[1]), *indep.indep_raw_cnt_ref(
        P64[:, idx], SCORE9, True), rtol=rtol)
    del got
    ms_lib = time_cuda(torch, indep_library_call(torch, indep, P64, 1, INDEP_SITES), 3)
    del P64
    torch.cuda.empty_cache()
    log(f"phase 4: indep float64 entry {WIDE_N} x {INDEP_SITES} pairwise_del: kernel "
        f"{ms_k:.3f} ms, plain float64 {ms_p:.3f} ms, one-call PyTorch version (float64 einsum "
        f"and product) {ms_lib:.3f} ms; 64-individual sub-matrix vs float64 plain: max rel raw "
        f"err {rel:.3e} (bound {rtol:.3e}), max |raw/cnt err| {err:.3e}, rerun byte-identical "
        f"[{card}]")
    report(f"indep_raw_cnt_f64_n{WIDE_N}", "ngsdist_tpu_torch/csrc/indep.cu",
           "ngsdist_tpu/core/distance.py:332", err, "raw/cnt", ms_k, ms_p,
           indep_bound(INDEP_SITES, WIDE_N, 2 * 8 * WIDE_N * WIDE_N, f64=True), ms_lib,
           wrapper="indep_raw_cnt_f64")

    P32 = P32[:WIDE_EM_SITES].contiguous()
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
    log(f"phase 4: em {WIDE_N} x {WIDE_EM_SITES}: kernel {ms_k:.3f} ms, plain float32 {ms_p:.3f} ms "
        f"(one run); 64-individual sub-matrix vs float64 plain: max |raw/cnt err| {err:.3e}; "
        f"work {work['live_rows']} live rows, {work['live_lanes']} live lanes, "
        f"{work['tests']} ratio tests (counted in {time.perf_counter() - t0:.1f} s) [{card}]")
    report(f"em_raw_cnt_n{WIDE_N}", "ngsdist_tpu_torch/csrc/em.cu",
           "ngsdist_tpu/ops/pallas_em.py:326", err, "raw/cnt", ms_k, ms_p,
           em_bound(work, WIDE_EM_SITES, WIDE_N, 2 * 4 * WIDE_N * WIDE_N), None,
           wrapper="em_raw_cnt")


def phase_em_slices(torch, indep, em, card) -> dict:
    """The EM's site slices at PILOT_N x PILOT_SITES, both entries, on
    seeded probabilities (float64: the float32 values widened): G by the
    rule on this card (ops/em.py em_site_slices) timed against one slice
    (slices=1); the sliced launch's rerun byte-identical, its first 64
    individuals' corner the bytes of the launch on those individuals
    alone at the same G (every lane is independent of the others), and
    that launch within the entry's bound (kernel_tol) of the sliced plain
    order (em_raw_cnt_tables(slices=G)) in float64; the entry's bound
    (em_bound) from the work these inputs need.  Returns, by entry,
    {"slices", "ms", "one_slice_ms", "bound_ms", "bound_by", "max_abs_err"}."""
    out = {}
    nt = -(-PILOT_N // em.EM_TILE)
    P32 = wide_probs(torch, PILOT_SITES, PILOT_N)
    t0 = time.perf_counter()
    work = em.em_work(P32.double())
    log(f"phase 4: em work at {PILOT_N} x {PILOT_SITES}: {work['live_rows']} live rows, "
        f"{work['live_lanes']} live lanes, {work['tests']} ratio tests (counted in "
        f"{time.perf_counter() - t0:.1f} s)")
    for P in (P32, P32.double()):
        name = "em_raw_cnt_f64" if P.dtype == torch.float64 else "em_raw_cnt"
        G = em.em_site_slices(nt * (nt + 1) // 2, PILOT_SITES, *em._card_slots(P))
        ms = time_cuda(torch, lambda: em.em_raw_cnt(P, SCORE9, False), 3)
        ms_one = time_cuda(torch, lambda: em._em_cuda(P, SCORE9, False, None, None, None,
                                                      slices=1), 3)
        got = em.em_raw_cnt(P, SCORE9, False)
        check_rerun(torch, em.em_raw_cnt, P, False, None, got)
        corner = P[:, :64].contiguous()
        sub = em._em_cuda(corner, SCORE9, False, None, None, None, slices=G)
        if not all(same_bytes(torch, a[:64, :64].contiguous(), b) for a, b in zip(got, sub)):
            raise AssertionError(f"{name} at {PILOT_N} x {PILOT_SITES}, G = {G}: the first 64 "
                                 "individuals differ from their own launch")
        t0 = time.perf_counter()
        plain = em.em_raw_cnt_tables(corner.double(), SCORE9, False, slices=G)
        _, err = check_kernel("em", torch, *sub, *plain, *kernel_tol(torch, indep, em, P))
        del got, sub, plain
        torch.cuda.empty_cache()
        f64 = P.dtype == torch.float64
        bound_ms, bound_by, reckoning = em_bound(
            work, PILOT_SITES, PILOT_N, 2 * (8 if f64 else 4) * PILOT_N * PILOT_N, f64=f64)
        log(f"phase 4: {name} at {PILOT_N} x {PILOT_SITES} ({nt * (nt + 1) // 2} tiles): "
            f"{G} site slices {ms:.3f} ms, one slice {ms_one:.3f} ms ({ms_one / ms:.2f}x); "
            f"bound {bound_ms:.3f} ms by {bound_by} ({reckoning}), kernel at "
            f"{bound_ms / ms:.4f} of it; rerun byte-identical, the first 64 individuals their "
            f"own launch's bytes and against the sliced plain order: max |raw/cnt err| "
            f"{err:.3e} (checked in {time.perf_counter() - t0:.1f} s) [{card}]")
        out[name] = {"slices": G, "ms": ms, "one_slice_ms": ms_one, "bound_ms": bound_ms,
                     "bound_by": bound_by, "max_abs_err": err}
    return out


def phase_em_rows(torch, em, distance, card) -> dict:
    """The EM's weight rows (em_kernel_rows) at ROWS_N x ROWS_SITES, the
    n1092 cells' shape, both entries, on seeded probabilities: one launch
    of ROWS_REPS bootstrap replicates' weight rows (their truncated genome,
    ROWS_BLOCK-site blocks) timed against the ROWS_REPS one-row launches
    it replaces, both at the card's G; each row the bytes of its one-row
    launch.  Returns, by entry, {"rows", "slices", "ms", "one_row_ms"}."""
    out = {}
    P32 = wide_probs(torch, ROWS_SITES, ROWS_N)
    n_trunc, maps = distance.bootstrap_site_maps(SEED, ROWS_REPS, ROWS_SITES, ROWS_BLOCK)
    W = np.stack([distance.replicate_weights(m, n_trunc) for m in maps])
    nt = -(-ROWS_N // em.EM_TILE)
    for P in (P32, P32.double()):
        name = "em_raw_cnt_f64" if P.dtype == torch.float64 else "em_raw_cnt"
        Pt, Wt = P[:n_trunc], torch.from_numpy(W).to(DEVICE, P.dtype)
        G = em.em_site_slices(nt * (nt + 1) // 2, n_trunc, *em._card_slots(P))
        ms = time_cuda(torch, lambda: em.em_raw_cnt(Pt, SCORE9, False, Wt), 3)
        ms_one = time_cuda(torch, lambda: [em.em_raw_cnt(Pt, SCORE9, False, w) for w in Wt], 3)
        rows, _ = em.em_raw_cnt(Pt, SCORE9, False, Wt)
        for r, w in enumerate(Wt):
            if not same_bytes(torch, rows[r], em.em_raw_cnt(Pt, SCORE9, False, w)[0]):
                raise AssertionError(f"{name} weight row {r} differs from its one-row launch")
        log(f"phase 4: {name} weight rows at {ROWS_N} x {n_trunc}, G = {G}: {ROWS_REPS} rows in "
            f"one launch {ms:.3f} ms, {ROWS_REPS} one-row launches {ms_one:.3f} ms "
            f"({ms_one / ms:.2f}x); every row its one-row launch's bytes [{card}]")
        out[name] = {"rows": ROWS_REPS, "slices": G, "ms": ms, "one_row_ms": ms_one}
        del rows, Pt, Wt
    del P32
    torch.cuda.empty_cache()
    return out


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


def mma_ops(nvcc: str, path: str, kernel: str, opcode: str) -> dict:
    """{instruction: count} of the tensor-core instructions named
    `opcode` (HMMA, DMMA), each with its shape suffix as cuobjdump prints
    it, in the machine code of the kernels of the library at path whose
    name holds `kernel`, by the cuobjdump of the toolkit whose nvcc built
    it."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", path], capture_output=True, text=True,
                          check=True).stdout
    ops, inside = {}, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            m = re.search(rf"\b({opcode}\S*)", line)
            if m:
                ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return ops


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


def slice_counts(em):
    """The EM's site-slice counters (SLICES), by the name of its wrapper."""
    return {name: tuple(getattr(em, c) for c in counters) for name, counters in SLICES.items()}


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
            extra=(), twin=None, stats=False):
    """One call of the CLI entry point (timed_run) with the arguments of
    run `run` and `extra`."""
    seen = timed_run(torch, mods, ngsd, budget, fused, lambda: cli.main(
        run_args(run, geno, out) + ["--platform", DEVICE, "--throughput", *extra]),
        twin=twin, stats=stats)
    if seen["result"] != 0:
        raise AssertionError(f"run ({run}): exit code {seen['result']}")
    return seen


def timed_run(torch, mods, ngsd, budget, fused: bool, call, twin=None, stats=False):
    """call() (a run of the main path) with the launch counts set to 0
    just before and read just after, under the given NGSDIST_DEVICE_BUDGET
    (None: unset) and read route.  Returns what the run showed: call()'s
    result, launches, wall seconds, the stage times' summary, the peak of
    the device memory (and the bytes held when it was reset, "base"), the
    type of what load_inputs returned ("source")
    and of what the engine was handed ("handed": a SiteStream with its
    rows' source and lane), the dtypes of the host slabs sent ("slabs":
    the upload lane) and, with stats or twin, each matrix's (raw, cnt or
    site count) as the engine gave them ("stats"); a twin's, the run of
    that name that a run of U16_RUNS is held to, is kept in TWINS.  The
    EM's site-slice counters are set to 0 and read with the launch counts
    ("slices", slice_counts), and kept in RUN_SLICES."""
    runner, profiling, distance = ngsd["runner"], ngsd["profiling"], ngsd["distance"]
    env = {"NGSDIST_DEVICE_BUDGET": None if budget is None else str(budget),
           "NGSDIST_FUSED_READ": "auto" if fused else "0"}
    seen = {}
    load_inputs = runner.load_inputs
    from_reader = ngsd["multihost"].SiteStream.from_reader.__func__

    def spy(pars, **kw):
        got = load_inputs(pars, **kw)
        seen["source"] = type(got[2]).__name__
        return got

    def reader_spy(cls, pars, mesh, *a):   # a lazy run's stream
        seen["stream"] = from_reader(cls, pars, mesh, *a)
        seen["source"] = type(seen["stream"].src).__name__
        return seen["stream"]

    iter_replicates = distance.iter_replicates

    def engine_spy(pars, P, *a, **k):
        seen["handed"] = type(P).__name__
        if hasattr(P, "src"):
            seen["handed"] += (f"({type(P.src).__name__}, "
                               f"{'coded' if P.coded else 'uncoded'})")
        return iter_replicates(pars, P, *a, **k)

    finalize, host_pack = distance._finalize, distance._host_pack
    seen["stats"], seen["slabs"] = [], set()

    def stats_spy(raw, cnt, *a, **k):   # each matrix's statistics, as the engine gives them
        seen["stats"].append((np.array(raw, np.float64), np.array(cnt, np.float64)))
        return finalize(raw, cnt, *a, **k)

    def slab_spy(*a, **k):   # the lane: the dtype of every host slab sent
        got = host_pack(*a, **k)
        seen["slabs"].add(str(getattr(got, "dtype", "codes")))
        return got

    runner.load_inputs = spy
    distance.iter_replicates = engine_spy
    distance._finalize, distance._host_pack = stats_spy, slab_spy
    ngsd["multihost"].SiteStream.from_reader = classmethod(reader_spy)
    gc.collect()  # an earlier run's tensors in reference cycles are not this run's
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    seen["base"] = torch.cuda.memory_allocated()
    profiling.ACTIVE = profiling.StageTimes(torch.device(DEVICE))
    for mod, counter in KERNELS.values():
        setattr(mods[mod], counter, 0)
    for counters in SLICES.values():
        for c in counters:
            setattr(mods["em"], c, 0)
    try:
        with environment(env):
            t0 = time.perf_counter()
            seen["result"] = call()
            torch.cuda.synchronize()
            seen["wall"] = time.perf_counter() - t0
        seen["launches"] = launch_counts(mods)
        seen["slices"] = slice_counts(mods["em"])
        RUN_SLICES.append(seen["slices"])
        seen["times"] = profiling.ACTIVE.summary()
        seen["peak"] = torch.cuda.max_memory_allocated()
    finally:
        profiling.ACTIVE = None
        runner.load_inputs = load_inputs
        distance.iter_replicates = iter_replicates
        distance._finalize, distance._host_pack = finalize, host_pack
        ngsd["multihost"].SiteStream.from_reader = classmethod(from_reader)
    if twin is not None:
        TWINS[twin] = seen
    elif not stats:
        del seen["stats"]
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
        f"{seen['peak']} B ({seen['base']} B held before the run); launches "
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
                chunked, chunk = distance.stream_plan(sites, N_IND, dev, None, False)
            chunks = -(-sites // chunk)
            if not chunked or chunks < min_chunks:
                raise AssertionError(f"run ({run}): the budget {budget} gives {chunks} chunks")
            n_trunc = sites - sites % block
            want[f"{kind}_raw_cnt"] = chunks + reps * -(-n_trunc // chunk)
            if run in MODELS:  # every chunk once per class and matrix
                want[f"{kind}_raw_cnt"] = 3 * chunks * (1 + reps)
        seen = cli_run(torch, cli, mods, ngsd, run, genos[run], outs[run], budget, fused_env,
                       twin=run if run in U16_TWINS else None)
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


def drive_pilot_run(torch, cli, mods, ngsd, em, distance, card):
    """Run (p): the EM through the CLI at PILOT_N x PILOT_SITES (seeded
    probabilities written as a binary GP file, read by the fused reader)
    with BOOT_REPS replicates of PILOT_BLOCK-site blocks on the weighted
    route, so every launch is a full-mode launch over 21 tiles.  Its
    launch counts (the full data's em_raw_cnt and one for the BOOT_REPS
    replicates' weight rows) and site-slice counts, set to 0 before it,
    are held to what em_site_slices gives on this card for the full
    data's sites and the replicates' truncated genome; each
    matrix's 64-individual sub-matrix to the float64 plain version on the
    float32 values the card was given (EM_ATOL_CNT).  Returns the largest
    |d error| and the launch counts."""
    t0 = time.perf_counter()
    P = rand_probs(np.random.default_rng(SEED + 5), PILOT_SITES, PILOT_N)
    geno, out = os.path.join(WORK, "pilot.bin"), os.path.join(WORK, "p.dist")
    P.astype("<f8").tofile(geno)
    P /= P.sum(-1, keepdims=True)
    log(f"phase 3: (p)'s file of {PILOT_N} x {PILOT_SITES} written in "
        f"{time.perf_counter() - t0:.2f} s ({os.path.getsize(geno)} B)")
    args = ["--geno", geno, "--probs", "--n_ind", str(PILOT_N), "--n_sites",
            str(PILOT_SITES), "--seed", str(SEED), "--out", out, "--verbose", "1",
            "--n_boot_rep", str(BOOT_REPS), "--boot_block_size", str(PILOT_BLOCK),
            "--platform", DEVICE, "--throughput"]
    seen = timed_run(torch, mods, ngsd, None, True, lambda: cli.main(args))
    os.remove(geno)
    if seen["result"] != 0:
        raise AssertionError(f"run (p): exit code {seen['result']}")
    nt = -(-PILOT_N // em.EM_TILE)
    slots = em._card_slots(torch.empty(0, device=DEVICE))
    n_trunc, maps = distance.bootstrap_site_maps(SEED, BOOT_REPS, PILOT_SITES, PILOT_BLOCK)
    groups = -(-BOOT_REPS // em.em_weight_rows(False))
    G = [em.em_site_slices(nt * (nt + 1) // 2, S, *slots)
         for S in [PILOT_SITES] + [n_trunc] * groups]
    want = {name: 0 for name in KERNELS}
    want["em_raw_cnt"] = 1 + groups
    want_slices = {"em_raw_cnt": (sum(g > 1 for g in G), sum(G)), "em_raw_cnt_f64": (0, 0)}
    if seen["launches"] != want or seen["slices"] != want_slices:
        raise AssertionError(f"run (p): launches {seen['launches']}, slices {seen['slices']}; "
                             f"expected {want}, {want_slices}")
    if seen["source"] != "PackedBinInput":
        raise AssertionError(f"run (p): the engine was handed a {seen['source']}")
    mats = check_output(out, 1 + BOOT_REPS, PILOT_N)
    idx = np.sort(np.random.default_rng(SEED + 6).choice(PILOT_N, 64, replace=False))
    sub = card_values(torch.from_numpy(np.ascontiguousarray(P[:, idx])).to(DEVICE))
    del P
    errs = []
    for r, mat in enumerate(mats):
        S, w = PILOT_SITES, None
        if r > 0:
            S = n_trunc
            w = torch.from_numpy(distance.replicate_weights(maps[r - 1], S)).to(DEVICE)
        raw, _ = em.em_raw_cnt_ref(sub[:S].contiguous(), SCORE9, False, w)
        errs.append(check_submatrix(mat, raw, float(S), idx, "em", 0.0, EM_ATOL_CNT))
    del sub
    t = seen["times"]
    log(f"phase 3: (p) em {PILOT_N} x {PILOT_SITES} + {BOOT_REPS} replicates of "
        f"{PILOT_BLOCK}-site blocks in {seen['wall']:.2f} s (host clock, CLI call incl. read "
        f"and write): read {t['read_s']:.3f} s, kernels {t['kernel_s']:.3f} s; launches "
        f"em_raw_cnt {seen['launches']['em_raw_cnt']}, site slices {G} (em_site_slices on "
        f"{slots[0]} SMs x {slots[1]} blocks): sliced launches, slices "
        f"{seen['slices']['em_raw_cnt']}; 64-individual sub-matrices against the float64 "
        f"plain version on the card's values, max |d err| {max(errs):.3e} [{card}]")
    return max(errs), seen["launches"]


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
    itemsize = ngsd["distance"].itemsize(dev0, False)
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
                         lambda: runner.run(pars, mesh=mesh, report_throughput=True),
                         twin=run if run in U16_TWINS else None)
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
            seen = timed_run(torch, mods, ngsd, None, True, lambda: cli.main(args),
                             twin=run if run in U16_TWINS else None)
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


def write_genotypes(path: str, sites: int) -> None:
    """(gt)'s input: a seeded gz hard-genotype text of `sites` lines of
    N_IND genotypes in -1/0/1/2 (about 5% -1, missing)."""
    import gzip

    rng = np.random.default_rng(SEED + 5)
    g = rng.integers(0, 3, size=(sites, N_IND)).astype(np.int8)
    g[rng.random((sites, N_IND)) < 0.05] = -1
    tokens = np.array(["-1", "0", "1", "2"])
    with gzip.open(path, "wt", compresslevel=1) as fh:
        for lo in range(0, sites, 1024):
            fh.write("\n".join("\t".join(row) for row in tokens[g[lo:lo + 1024] + 1]) + "\n")


def coded_args(run: str, geno: str, out: str):
    """The CLI arguments of code-plane run `run` (CODED_RUNS): its base
    run's with --call_geno, or (gt)'s: hard genotypes (no --probs), (a)'s
    --pairwise_del and bootstrap at GT_SITES sites."""
    base = CODED_RUNS[CODED_PROC_RUNS.get(run, run)][0]
    if base != "gt":
        return run_args(base, geno, out) + ["--call_geno"]
    return ["--geno", geno, "--n_ind", str(N_IND), "--n_sites", str(GT_SITES), "--seed",
            str(SEED), "--out", out, "--verbose", "1", "--pairwise_del", "--n_boot_rep",
            str(BOOT_REPS), "--boot_block_size", str(BOOT_BLOCK)]


def coded_budget(run: str) -> int:
    """The NGSDIST_DEVICE_BUDGET under which (cgs) streams in the chunks
    CODED_RUNS asks for (forced_budget's reckoning)."""
    sites = RUNS[CODED_RUNS[run][0]][1]
    return 3 * 4 * (sites // CODED_RUNS[run][3]) * N_IND * 12 // 3


def coded_line(run: str, what: str, seen, card: str) -> str:
    t = seen["times"]
    return (f"({run}) {what} in {seen['wall']:.2f} s (host clock, call incl. read and write): "
            f"read {t['read_s']:.3f} s, scan {t['scan_s']:.3f} s, upload {t['upload_s']:.3f} s, "
            f"kernels {t['kernel_s']:.3f} s, host bytes sent {t['upload_bytes']} B; peak device "
            f"memory {seen['peak']} B; engine handed {seen['handed']}; launches "
            + ", ".join(f"{k} {v}" for k, v in seen["launches"].items() if v) + f" [{card}]")


def drive_coded_runs(torch, cli, mods, ngsd, genos, card):
    """The runs of CODED_RUNS (module docstring, phase 3), each with its
    launch counts set to 0 just before it and read just after, and its
    twin under NGSDIST_CODED_UPLOAD=0: what the engine is handed, the
    launches (the twin's; one-device runs their route's count), the bytes
    of the twin's file, and for (cgs) the peak of the device memory (the
    twin's, and at most a chunk's uint8 stage and int32 index besides).  Returns the launches, the largest |d
    difference| of (cgs) from (cg), and (cgl)'s file and round length."""
    runner, pm = ngsd["runner"], ngsd["mesh"]
    dev0 = torch.device(DEVICE, 0)
    gt = os.path.join(WORK, "gt.geno.gz")
    t0 = time.perf_counter()
    write_genotypes(gt, GT_SITES)
    log(f"phase 3: (gt)'s gz hard-genotype text of {N_IND} x {GT_SITES} written in "
        f"{time.perf_counter() - t0:.2f} s ({os.path.getsize(gt)} B)")
    launches, files, diffs, streams = {}, {}, {}, {}
    for run, (base, entries, host, chunks, handed) in CODED_RUNS.items():
        geno = gt if base == "gt" else genos[base]
        budget = coded_budget(run) if chunks else None
        got = {}
        for lane, coded in (("coded", True), ("twin", False)):
            out = os.path.join(WORK, f"{run}_{lane}.dist")
            args = coded_args(run, geno, out)
            # the twin sends the staged triples whole (NGSDIST_UPLOAD23=0):
            # the table's rows are their float32 casts, bit for bit
            env = {"NGSDIST_CODED_UPLOAD": None if coded else "0",
                   "NGSDIST_UPLOAD23": None if coded else "0",
                   "NGSDIST_HOST_BUDGET": None if host is None else str(host)}
            mesh = None if entries is None else pm.make_mesh([dev0] * entries)

            def call(args=args, mesh=mesh):
                if mesh is None:
                    return cli.main(args + ["--platform", DEVICE, "--throughput"])
                return runner.run(cli.parse_args(args)[0], mesh=mesh, report_throughput=True)

            with environment(env):
                seen = timed_run(torch, mods, ngsd, budget, True, call)
            if entries is None and seen["result"] != 0:
                raise AssertionError(f"run ({run}) {lane}: exit code {seen['result']}")
            want = handed[0 if coded else 1]
            if seen["handed"] != want:
                raise AssertionError(f"run ({run}) {lane}: the engine was handed "
                                     f"{seen['handed']}, not {want}")
            got[lane] = (seen, out)
            launches[f"{run}_{lane}"] = seen["launches"]
            what = ("coded" if coded else "its twin under NGSDIST_CODED_UPLOAD=0") + (
                f", on {entries} entries of {dev0}" if entries else "") + (
                f", NGSDIST_HOST_BUDGET={host}" if host else "") + (
                f", streamed under NGSDIST_DEVICE_BUDGET={budget}" if budget else "")
            log("phase 3: " + coded_line(run, what, seen, card))
        (seen, out), (twin, twin_out) = got["coded"], got["twin"]
        if seen["launches"] != twin["launches"] or not any(seen["launches"].values()):
            raise AssertionError(f"run ({run}): launches {seen['launches']}, its twin "
                                 f"{twin['launches']}")
        reps = BOOT_REPS
        if run == "cg" and seen["launches"]["indep_raw_cnt"] != 1 + reps:
            raise AssertionError(f"run (cg): launches {seen['launches']}")
        if run == "cgs":
            dev = torch.device(DEVICE)
            with environment({"NGSDIST_DEVICE_BUDGET": str(budget)}):
                chunked, chunk = ngsd["distance"].stream_plan(INDEP_SITES, N_IND, dev, None,
                                                              False)
            n = -(-INDEP_SITES // chunk)
            if not chunked or n < chunks or seen["launches"]["indep_raw_cnt"] != n * (1 + reps):
                raise AssertionError(f"run (cgs): {n} chunks, launches {seen['launches']}")
            # the lane holds its twin's device memory and, at most, a chunk's
            # uint8 stage and the gather's int32 index (5 bytes a code)
            if seen["peak"] > twin["peak"] + 5 * chunk * N_IND:
                raise AssertionError(f"run (cgs): peak device memory {seen['peak']} B, its "
                                     f"twin's {twin['peak']} B")
        if run == "gt" and seen["launches"] != {**{k: 0 for k in KERNELS}, "indep_raw_cnt": 1,
                                                 "indep_block_partials": 1}:
            raise AssertionError(f"run (gt): launches {seen['launches']}")
        if run == "cgl":
            st = seen["stream"]
            shards = sum(hi > lo for r in range(st.n_rounds) for lo, hi in st.round_ranges(r))
            if not st.lazy or seen["launches"]["indep_raw_cnt"] != shards * (1 + reps):
                raise AssertionError(f"run (cgl): lazy {st.lazy}, {st.n_rounds} rounds, "
                                     f"launches {seen['launches']}")
            streams[run] = st.chunk
        with open(out, "rb") as a, open(twin_out, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"run ({run}): the coded file differs from its twin's")
        files[run] = out
        mats = check_output(out, 1 + reps)
        if run == "cgs":
            diffs[run] = check_same_as_resident("cgs", mats, check_output(files["cg"], 1 + reps))
        if run == "gt":
            log(f"phase 3: (gt) the staged scan for the code plane (hostmem.derive_codes): "
                f"{seen['times']['scan_s']:.3f} s of the run's {seen['wall']:.2f} s; its twin "
                f"without the scan {twin['wall']:.2f} s [{card}]")
        log(f"phase 3: ({run}) the coded file equals its twin's byte for byte; bytes sent "
            f"{seen['times']['upload_bytes']} against {twin['times']['upload_bytes']} "
            f"({twin['times']['upload_bytes'] / max(1, seen['times']['upload_bytes']):.2f}x)"
            + (f"; within {diffs[run]:.3e} of (cg) on d" if run in diffs else ""))
    return launches, diffs, files["cgl"], streams["cgl"]


def u16_bound(kind: str, raw16, raw32, denom):
    """The largest |raw16 - raw32| the uint16 lane and its float32 pair
    twin may show (U16_DELTA's note): denom x the lane's bound on raw /
    cnt, plus the kernels' bounds on each side (indep INDEP_RTOL x |raw|,
    the EM EM_ATOL_CNT x cnt)."""
    if kind == "indep":
        lane = U16_SMAX * (2 * U16_DELTA + U16_DELTA ** 2)
        return denom * lane + INDEP_RTOL * (np.abs(raw16) + np.abs(raw32))
    lane = U16_SMAX * min(1.0, 24 * EM_MAX_ITER * U16_DELTA)
    return denom * (lane + 2 * EM_ATOL_CNT)


def hold_to_twin(run: str, kind: str, seen, twin) -> float:
    """A uint16 run's statistics against its twin's, matrix by matrix:
    the same denominators (cnt under --pairwise_del: the valid sites are
    the host's decision in both lanes), raw within u16_bound.  Returns
    the largest |raw difference| / denominator."""
    if len(seen["stats"]) != len(twin["stats"]) or not seen["stats"]:
        raise AssertionError(f"({run}): {len(seen['stats'])} matrices, its twin "
                             f"{len(twin['stats'])}")
    worst = 0.0
    for r, ((raw16, c16), (raw32, c32)) in enumerate(zip(seen["stats"], twin["stats"])):
        if not np.array_equal(c16, c32):
            raise AssertionError(f"({run}) matrix {r}: cnt differs from its twin's")
        err = np.abs(raw16 - raw32)
        bound = u16_bound(kind, raw16, raw32, c32)
        if not (err <= bound).all():
            k = np.unravel_index(int(np.argmax(err - bound)), err.shape)
            raise AssertionError(f"({run}) matrix {r}: raw {raw16[k]} vs its twin's "
                                 f"{raw32[k]} (bound {bound[k]})")
        worst = max(worst, float((err / np.maximum(c32, 1)).max()))
    return worst


def u16_line(seen) -> str:
    t = seen["times"]
    return (f"in {seen['wall']:.2f} s (host clock, call incl. read and write): read "
            f"{t['read_s']:.3f} s, upload {t['upload_s']:.3f} s, kernels {t['kernel_s']:.3f} s, "
            f"host bytes sent {t['upload_bytes']} B, slabs {sorted(seen['slabs'])}")


def drive_u16_runs(torch, cli, mods, ngsd, genos, mats, P_sub, idx, card):
    """The runs of U16_RUNS (module docstring, phase 3) with the uint16
    lane on as a card has it by default, each with its launch counts set
    to 0 just before and read just after: every host slab sent must be
    uint16, the launches its twin's; its statistics held to its twin's
    (hold_to_twin: cnt exact, raw within u16_bound); its 64-individual
    sub-matrices against the float64 plain version on the lane's values
    (card_values_u16) within the kernels' bounds, (ut), a text of other
    values, aside.  Returns the launches and the largest |d error| and
    |raw / cnt difference| from the twin per run."""
    runner, pm = ngsd["runner"], ngsd["mesh"]
    dev0 = torch.device(DEVICE, 0)
    spill, text = os.path.join(WORK, "spill"), os.path.join(WORK, "lt.beagle.gz")
    launches, diffs, outs = {}, {}, {}
    for run, (base, twin_name) in U16_RUNS.items():
        out = os.path.join(WORK, f"{run}.dist")
        outs[run] = out
        budget, env = None, {"NGSDIST_UPLOAD16": None}   # the card's default: the lane on
        if base in MESH_RUNS:
            kind_base, entries, pairs, _ = MESH_RUNS[base]
            pars = cli.parse_args(run_args(kind_base, genos[kind_base], out))[0]
            mesh = pm.make_mesh([dev0] * entries, pairs=pairs)

            def call(pars=pars, mesh=mesh):
                return runner.run(pars, mesh=mesh, report_throughput=True)
            kind = RUNS[kind_base][0]
            reps = RUNS[kind_base][2]
        elif base in LAZY_RUNS:
            kind_base, style, host_budget, _ = LAZY_RUNS[base]
            geno = genos[kind_base] if style == "bin" else text
            args = lazy_args(base, geno, out) + ["--platform", DEVICE, "--throughput"]
            env.update(NGSDIST_HOST_BUDGET=str(host_budget), NGSDIST_SPILL_DIR=spill)

            def call(args=args):
                return cli.main(args)
            kind, reps = RUNS[kind_base][0], RUNS[kind_base][2]
        else:
            kind, sites, reps = RUNS[base][0], RUNS[base][1], RUNS[base][2]
            if twin_name is None:   # (us): streamed, its twin beside it
                budget = 3 * 4 * (sites // U16_CHUNKS) * N_IND * 12 // 3
            args = run_args(base, genos[base], out) + ["--platform", DEVICE, "--throughput"]

            def call(args=args):
                return cli.main(args)
        fused = base not in MESH_RUNS   # as its twin: the mesh reads staged
        with environment(env):
            seen = timed_run(torch, mods, ngsd, budget, fused, call, stats=True)
        if isinstance(seen["result"], int) and seen["result"] != 0:
            raise AssertionError(f"run ({run}): exit code {seen['result']}")
        twin = TWINS.get(twin_name)
        if twin_name is None:
            with environment({**env, "NGSDIST_UPLOAD16": "0"}):
                twin = timed_run(torch, mods, ngsd, budget, fused, call, stats=True)
            twin_name = f"{run} under NGSDIST_UPLOAD16=0"
        if seen["slabs"] != {"uint16"} or twin["slabs"] != {"float32"}:
            raise AssertionError(f"run ({run}): slabs {seen['slabs']}, its twin's "
                                 f"{twin['slabs']}")
        launches[run] = seen["launches"]
        if seen["launches"] != twin["launches"] or not any(seen["launches"].values()):
            raise AssertionError(f"run ({run}): launches {seen['launches']}, its twin's "
                                 f"{twin['launches']}")
        if budget is not None:
            with environment({"NGSDIST_DEVICE_BUDGET": str(budget)}):
                chunked, chunk = ngsd["distance"].stream_plan(RUNS[base][1], N_IND, dev0, None,
                                                              False)
            n = -(-RUNS[base][1] // chunk)
            launched = seen["launches"][f"{kind}_raw_cnt"]
            if not chunked or n < U16_CHUNKS or launched != n * (1 + reps):
                raise AssertionError(f"run ({run}): {n} chunks, launches {seen['launches']}")
        diffs[f"{run}/twin"] = hold_to_twin(run, kind, seen, twin)
        mats[run] = check_output(out, 1 + reps)
        log(f"phase 3: ({run}) uint16 lane, ({base})'s file and flags"
            + (f", streamed under NGSDIST_DEVICE_BUDGET={budget}" if budget else "") + ", "
            + u16_line(seen) + f"; its twin ({twin_name}) "
            + u16_line(twin) + f"; cnt equal, max |raw difference| / cnt "
            f"{diffs[f'{run}/twin']:.3e} (bound {u16_bound(kind, 0.0, 0.0, 1.0):.3e} + the "
            f"kernels'); launches " + ", ".join(f"{k} {v}" for k, v in launches[run].items() if v)
            + f" [{card}]")
        del seen["stats"], twin["stats"]
    runs = {run: (MESH_RUNS[b][0] if b in MESH_RUNS else LAZY_RUNS[b][0] if b in LAZY_RUNS
                  else b) for run, (b, _) in U16_RUNS.items() if run != "ut"}
    diffs.update(check_submatrices(torch, mods["indep"], mods["em"], ngsd["distance"], mats,
                                   P_sub, idx, runs=runs, u16=True))
    return launches, diffs


def trace_run(torch, cli, mods, ngsd, genos, card) -> dict:
    """(b)'s flags once more with --trace_dir: the trace file written,
    the EM kernel's launches named in it, and (b)'s bytes.  Returns the
    launches."""
    tdir = os.path.join(WORK, "trace")
    out = os.path.join(WORK, "tb.dist")
    seen = cli_run(torch, cli, mods, ngsd, "b", genos["b"], out, None, True,
                   extra=("--trace_dir", tdir))
    files = [f for f in os.listdir(tdir) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        raise AssertionError(f"--trace_dir: trace files {os.listdir(tdir)}")
    with open(os.path.join(tdir, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    if not any("em_kernel" in k for k in kernels):
        raise AssertionError(f"--trace_dir: no em_kernel launch in the trace ({kernels[:8]})")
    with open(out, "rb") as a, open(os.path.join(WORK, "b.dist"), "rb") as b:
        if a.read() != b.read():
            raise AssertionError("--trace_dir: the traced run's file differs from (b)'s")
    log(f"phase 3: (tb) (b) with --trace_dir in {seen['wall']:.2f} s (untraced "
        f"{TWINS['b']['wall']:.2f} s): "
        f"{os.path.getsize(os.path.join(tdir, files[0]))} B of trace, {len(events)} events, "
        f"kernels {kernels}; the file equals (b)'s byte for byte [{card}]")
    return seen["launches"]


def time_upload_lanes(torch, native, path: str, card: str) -> None:
    """(a)'s raw binary file through three fused native readers into
    pinned memory, each slab then uploaded to the card: the packed
    float32 pairs (nd_read_geno_pack23, 8 bytes a triple), the uint16
    fixed-point pairs of the NGSDIST_UPLOAD16 lane (nd_read_geno_pack16,
    4 bytes; the card's default, runs U16_RUNS) and the codes of
    --call_geno (nd_read_geno_codes, 1 byte).  Read on the host clock,
    upload by CUDA events, second of two rounds (a warm page cache); the
    uint16 values within half a step of 1/65534 of the float32 ones, a
    missing triple's quantised mean in place of its pair."""
    import ctypes

    lib = native.get_lib()
    S, N = INDEP_SITES, N_IND
    dev = torch.device(DEVICE)
    lanes = {"pack23": ((S, N, 2), torch.float32, ctypes.c_float, lib.nd_read_geno_pack23),
             "pack16": ((S, N, 2), torch.int16, ctypes.c_uint16, lib.nd_read_geno_pack16),
             "codes": ((S, N), torch.uint8, ctypes.c_uint8, lib.nd_read_geno_codes)}
    on_card = {}
    for lane, (shape, dtype, ctype, fn) in lanes.items():
        host = torch.empty(shape, dtype=dtype, pin_memory=True)
        ptr = host.numpy().ctypes.data_as(ctypes.POINTER(ctype))
        for _ in range(2):
            errbuf, err = ctypes.create_string_buffer(256), ctypes.c_int(0)
            extra = (ctypes.byref(ctypes.c_int(0)),) if lane == "codes" else ()
            t0 = time.perf_counter()
            rc = fn(path.encode(), 0, N, S, 0, S, ptr, *extra, errbuf, 256, ctypes.byref(err))
            read_s = time.perf_counter() - t0
            if rc:
                raise AssertionError(f"{lane} read: rc {rc}: {errbuf.value.decode()}")
            start, stop = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            start.record()
            on_card[lane] = host.to(dev, non_blocking=True)
            stop.record()
            torch.cuda.synchronize()
        nbytes = host.numel() * host.element_size()
        log(f"phase 3: upload lane {lane} of (a)'s file ({N} x {S}): read into pinned memory "
            f"{read_s:.3f} s (host clock), upload {start.elapsed_time(stop):.3f} ms, "
            f"{nbytes} B ({nbytes / (start.elapsed_time(stop) * 1e6):.2f} GB/s) [{card}]")
        del host
    # the uint16 values; a missing triple is (65535, its quantised mean)
    q = (on_card["pack16"].int() & 0xFFFF).float()
    missing = (q[..., 0] == 65535)[..., None]
    err = float((torch.where(missing, q[..., 1:], q) / 65534.0 - on_card["pack23"]).abs().max())
    if not err <= 0.5 / 65534 + 1e-6:
        raise AssertionError(f"pack16 differs from pack23 by {err}")
    log(f"phase 3: the uint16 pairs within {err:.3e} of the float32 pairs, {int(missing.sum())} "
        f"missing triples as (65535, mean)")
    del on_card, q, missing
    torch.cuda.empty_cache()


def x64_launches(counts: dict) -> dict:
    """A float32 run's launches as the float64 entries' names."""
    return {f"{name}_f64": n for name, n in counts.items()}


def drive_x64_runs(torch, cli, mods, ngsd, genos, mats, card):
    """The --x64 runs of X64_RUNS and X64_MESH_RUNS (module docstring,
    phase x64-runs), each with its launch counts set to 0 just before and
    read just after, held to its float32 twin's launches under the float64
    entries' names: the engine handed the staged float64 array (the
    runner declines the fused read itself; NGSDIST_FUSED_READ stays
    auto), (xf) streamed in the chunks stream_plan gives under x64 (the
    JAX engine's x64 edges) and under its budget in device memory.
    Returns the launches, the output files and the largest |d| between
    each run and its float32 twin (printed, not held)."""
    distance, runner, pm, pmh = ngsd["distance"], ngsd["runner"], ngsd["mesh"], ngsd["multihost"]
    dev = torch.device(DEVICE)
    launches, outs, twin = {}, {}, {}
    for run, base in X64_RUNS.items():
        kind, sites, reps, block, _ = RUNS[base]
        outs[run] = os.path.join(WORK, f"{run}.dist")
        want = {name: 0 for name in KERNELS}
        want.update(x64_launches(LAUNCHES.get(base, {})))
        budget, what = None, ""
        if base in STREAMED:
            budget = forced_budget(base)
            with environment({"NGSDIST_DEVICE_BUDGET": str(budget)}):
                chunked, chunk = distance.stream_plan(sites, N_IND, dev, None, True)
            edges = distance._stream_chunk_sites(sites, N_IND, 8, budget // 3)
            if not chunked or chunk != edges:
                raise AssertionError(f"run ({run}): the plan {chunked, chunk} is not the JAX "
                                     f"x64 edges {edges}")
            chunks = -(-sites // chunk)
            want[f"{kind}_raw_cnt_f64"] = chunks * (1 + reps)
            what = f"streamed in {chunks} chunks of {chunk} sites under a budget of {budget} B, "
        seen = cli_run(torch, cli, mods, ngsd, base, genos[base], outs[run], budget, True,
                       extra=("--x64",))
        launches[run] = seen["launches"]
        log_run(run, f"--x64, {what}", seen, base)
        if launches[run] != want:
            raise AssertionError(f"run ({run}): launches {launches[run]}, expected {want}")
        if seen["source"] != "ndarray":
            raise AssertionError(f"run ({run}): the engine was handed a {seen['source']}")
        # the run's own peak: earlier runs leave cuBLAS workspaces of their
        # streams allocated (32 MiB each)
        if budget is not None and seen["peak"] - seen["base"] >= budget:
            raise AssertionError(f"run ({run}): peak device memory {seen['peak']} B, "
                                 f"{seen['base']} B of it held before the run, is not under "
                                 f"the budget {budget} B")
        got = check_output(outs[run], 1 + reps)
        twin[run] = max(float(np.abs(a - b).max()) for a, b in zip(got, mats[base]))
    dev0 = torch.device(DEVICE, 0)
    for run, base in X64_MESH_RUNS.items():
        one, entries, pairs, _ = MESH_RUNS[base]
        kind, sites, reps, _, _ = RUNS[one]
        outs[run] = os.path.join(WORK, f"{run}.dist")
        pars, _ = cli.parse_args(run_args(one, genos[one], outs[run]))
        mesh = pm.make_mesh([dev0] * entries, pairs=pairs)
        stream = pmh.SiteStream(None, pars, mesh, *pmh.SiteStream._plan(pars, mesh, True),
                                x64=True)
        seen = timed_run(torch, mods, ngsd, None, False,
                         lambda: runner.run(pars, mesh=mesh, report_throughput=True, x64=True))
        launches[run] = seen["launches"]
        log_run(run, f"--x64, on a {pm.sites_size(mesh)} x {pairs} mesh of {entries} entries "
                f"of {dev0}, ", seen, one)
        want = {name: 0 for name in KERNELS}
        want.update(x64_launches(mesh_launches(base, stream, pm)))
        if launches[run] != want:
            raise AssertionError(f"run ({run}): launches {launches[run]}, expected {want}")
        got = check_output(outs[run], 1 + reps)
        ref = check_output(os.path.join(WORK, f"{base}.dist"), 1 + reps)
        twin[run] = max(float(np.abs(a - b).max()) for a, b in zip(got, ref))
    return launches, outs, twin


def check_x64_outputs(torch, indep, em, distance, submodels, outs, P_sub, idx, alleles):
    """Every matrix of every --x64 run (outs: run -> file; the run whose
    flags it took by X64_RUNS, X64_MESH_RUNS or X64_PROC_RUNS) on the
    64-individual sub-matrix against the float64 plain version on the
    float64 values written, within the float64 entries' bounds (indep
    f64_sum_bound(S, chunks) relative, EM em_table_bound(S) x cnt; models
    3-6 through check_extended).  Returns the largest |d error| per run."""
    dev = torch.device(DEVICE)
    base_of = {**X64_RUNS, **{r: MESH_RUNS[b][0] for r, b in X64_MESH_RUNS.items()},
               **{r: PROC_RUNS[b][0] for r, b in X64_PROC_RUNS.items()}}
    errs = {}
    for run, out in outs.items():
        base = base_of[run]
        kind, sites, reps, block, pairwise_del = RUNS[base]
        mats = check_output(out, 1 + reps)
        if base in MODELS:
            e, _ = check_extended(torch, indep, em, distance, submodels, {run: mats}, P_sub,
                                  idx, alleles, x64_runs={run: base})
            errs[run] = e[f"{run}/float64"]
            continue
        plain = indep.indep_raw_cnt_ref if kind == "indep" else em.em_raw_cnt_ref
        n_trunc, maps = distance.bootstrap_site_maps(SEED, reps, sites, block)
        sub64 = torch.from_numpy(run_array(base, P_sub, sites)).to(dev)
        e = []
        for r, mat in enumerate(mats):
            S, w = sites, None
            if r > 0:
                S = n_trunc
                w = torch.from_numpy(distance.replicate_weights(maps[r - 1], S)).to(dev)
            raw, cnt = plain(sub64[:S].contiguous(), SCORE9, pairwise_del, w)
            rtol = indep.f64_sum_bound(S, indep.split_plan(N_IND, S)[0])
            denom = cnt if pairwise_del else float(S)
            e.append(check_submatrix(mat, raw, denom, idx, kind, rtol, em.em_table_bound(S)))
        errs[run] = max(e)
        del sub64
    return errs


def final_digit_steps(name: str, got: bytes, want: bytes):
    """The printed values of `got` that differ from `want`'s, as (golden,
    line, got, want), when each lies one final-digit step from the
    golden's and nothing else differs (docs/PARITY.md:68-75); anything
    more raises."""
    a, b = got.decode().split("\n"), want.decode().split("\n")
    if len(a) != len(b):
        raise AssertionError(f"golden {name}: {len(a)} lines, the golden {len(b)}")
    steps = []
    for i, (la, lb) in enumerate(zip(a, b)):
        if la == lb:
            continue
        ta, tb = la.split("\t"), lb.split("\t")
        if len(ta) != len(tb) or ta[0] != tb[0]:
            raise AssertionError(f"golden {name}, line {i + 1}: differs beyond its values")
        for x, y in zip(ta[1:], tb[1:]):
            if x == y:
                continue
            digits = len(y.split(".")[1]) if "." in y else -1
            step = 10.0 ** -digits
            if (digits < 1 or len(x) != len(y)
                    or not abs(float(x) - float(y)) <= 1.0000001 * step):
                raise AssertionError(f"golden {name}, line {i + 1}: {x} against the golden "
                                     f"{y}, more than one final-digit step")
            steps.append((name, i + 1, x, y))
    return steps


def phase_x64_goldens(torch, cli, mods, card):
    """Phase x64-goldens: the 31 golden configurations of
    tests/fixtures/manifest.json through the port's cli.main in process
    with --x64 --platform cuda, in the goldens' data directory, with every
    launch count set to 0 just before and read just after (only float64
    entries may run).  Each output's md5 must equal the manifest's or,
    where it does not, every differing printed value must lie one
    final-digit step from the golden's and nothing else differ
    (final_digit_steps).  Prints the count of md5-equal goldens and each
    value that took the step.  Returns the launches."""
    manifest = json.load(open(os.path.join(FIXTURES, "manifest.json")))
    out_dir = os.path.join(WORK, "goldens")
    os.makedirs(out_dir)
    for mod, counter in KERNELS.values():
        setattr(mods[mod], counter, 0)
    equal, steps = 0, []
    cwd = os.getcwd()
    t0 = time.perf_counter()
    os.chdir(os.path.join(FIXTURES, "data"))
    try:
        for name in sorted(manifest):
            out = os.path.join(out_dir, f"{name}.dist")
            args = [a.replace("{OUT}", out) for a in manifest[name]["args"]]
            if cli.main(args + ["--platform", DEVICE, "--x64", "--verbose", "0"]) != 0:
                raise AssertionError(f"golden {name} under --x64 on {DEVICE}: exit code")
            got = open(out, "rb").read()
            if hashlib.md5(got).hexdigest() == manifest[name]["md5"]:
                equal += 1
                continue
            steps += final_digit_steps(
                name, got, open(os.path.join(FIXTURES, "golden", f"{name}.dist"), "rb").read())
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = launch_counts(mods)
    if any(n for name, n in launched.items() if not name.endswith("_f64")) or not any(
            launched.values()):
        raise AssertionError(f"goldens under --x64: launches {launched}")
    log(f"phase x64-goldens: {equal} of {len(manifest)} goldens md5-equal under --x64 "
        f"--platform {DEVICE} in {wall:.2f} s (host clock, {len(manifest)} CLI calls); "
        f"{len(steps)} printed values one final-digit step from the golden's"
        + "".join(f"; {n} line {i}: {x} (golden {y})" for n, i, x, y in steps)
        + "; launches " + ", ".join(f"{k} {v}" for k, v in launched.items() if v)
        + f" [{card}]")
    return launched



PROC_WORKER = r"""
import json, os, sys, time
rank, root, spec = int(sys.argv[1]), sys.argv[2], json.load(open(sys.argv[3]))
sys.path.insert(0, root)
import torch
from ngsdist_tpu_torch import cli
from ngsdist_tpu_torch.ops import em, indep
from ngsdist_tpu_torch.parallel import multihost
from ngsdist_tpu_torch.utils import profiling

mods = {"indep": indep, "em": em}
dev = torch.device(spec["device"])
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
from_reader = multihost.SiteStream.from_reader.__func__
stream = {}

def reader_spy(cls, pars, mesh, *a):
    st = from_reader(cls, pars, mesh, *a)
    stream.update(lazy=st.lazy, coded=st.coded, chunk=st.chunk, rounds=st.n_rounds)
    return st

multihost.SiteStream.from_reader = classmethod(reader_spy)
for run in spec["runs"]:
    for k in ("NGSDIST_DEVICE_BUDGET", "NGSDIST_HOST_BUDGET", "NGSDIST_CODED_UPLOAD",
              "NGSDIST_UPLOAD23"):
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
           "times": profiling.ACTIVE.summary(), "stream": dict(stream),
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


def drive_process_runs(torch, mods, ngsd, genos, mats, card, coded_ref):
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
    read so.  Those runs are held to the plain sums.  The workers also
    run X64_PROC_RUNS, each process 0 file byte for byte the one process
    of two entries under --x64.  Returns the launches (both processes
    together), the largest |d difference| per run and the --x64 runs'
    files, and prints each run's wall time and its gathers.  The same
    workers then run CODED_PROC_RUNS and their twins (check_coded_procs;
    coded_ref: (cgl)'s file and round length)."""
    cli, runner, pm = ngsd["cli"], ngsd["runner"], ngsd["mesh"]
    worker = os.path.join(WORK, "proc_worker.py")
    with open(worker, "w") as fh:
        fh.write(PROC_WORKER)
    runs = []
    for run, (base, _, _) in PROC_RUNS.items():
        runs.append({"name": run, "env": proc_env(run), "port": free_port(),
                     "argv": run_args(base, genos[base], os.path.join(WORK, f"{run}.dist"))
                     + ["--platform", DEVICE]})
    for run, proc in X64_PROC_RUNS.items():
        base = PROC_RUNS[proc][0]
        runs.append({"name": run, "env": {}, "port": free_port(),
                     "argv": run_args(base, genos[base], os.path.join(WORK, f"{run}.dist"))
                     + ["--platform", DEVICE, "--x64"]})
    for run, ref in CODED_PROC_RUNS.items():
        host = CODED_RUNS[ref][2]
        for lane in ("coded", "twin"):
            env = {"NGSDIST_HOST_BUDGET": str(host)} if host else {}
            if lane == "twin":
                env.update(NGSDIST_CODED_UPLOAD="0", NGSDIST_UPLOAD23="0")
            out = os.path.join(WORK, f"{run}_{lane}.dist")
            runs.append({"name": f"{run}_{lane}", "env": env, "port": free_port(),
                         "argv": coded_args(run, genos[CODED_RUNS[ref][0]], out)
                         + ["--platform", DEVICE]})
    spec = os.path.join(WORK, "proc_spec.json")
    with open(spec, "w") as fh:
        json.dump({"runs": runs, "kernels": KERNELS, "device": DEVICE}, fh)
    env = {k: v for k, v in os.environ.items() if not k.startswith("NGSDIST_")}
    env["NGSDIST_UPLOAD16"] = "0"   # the lane of the in-process runs they are held to
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
    x64_outs = {}
    for run, proc in X64_PROC_RUNS.items():
        base = PROC_RUNS[proc][0]
        kind, sites, reps, block, _ = RUNS[base]
        got = [results[rank][run] for rank in (0, 1)]
        both = {name: got[0]["launches"][name] + got[1]["launches"][name] for name in KERNELS}
        launches[f"{run}_2p"] = both
        one = os.path.join(WORK, f"{run}_1p.dist")
        pars, _ = cli.parse_args(run_args(base, genos[base], one))
        seen = timed_run(torch, mods, ngsd, None, False,
                         lambda: runner.run(pars, mesh=pm.make_mesh([dev0] * 2), x64=True))
        launches[f"{run}_1p"] = seen["launches"]
        if (both != seen["launches"] or any(n for k, n in both.items() if not k.endswith("_f64"))
                or not any(both.values())):
            raise AssertionError(f"run ({run}): two processes launched {both}, one process "
                                 f"of two entries {seen['launches']}")
        x64_outs[run] = os.path.join(WORK, f"{run}.dist")
        with open(x64_outs[run], "rb") as a, open(one, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"run ({run}): process 0's file differs from the "
                                     "one-process run's on two entries under --x64")
        twin = max(float(np.abs(a - b).max()) for a, b in zip(
            check_output(x64_outs[run], 1 + reps), check_output(os.path.join(
                WORK, f"{proc}.dist"), 1 + reps)))
        log(f"phase x64-runs: ({run}) {kind} {N_IND} x {sites} --x64 in two processes, "
            "resident; "
            + "; ".join(f"process {rank}: {g['wall']:.2f} s (host clock, CLI call), read "
                        f"{g['times']['read_s']:.3f} s, upload {g['times']['upload_s']:.3f} s, "
                        f"kernels {g['times']['kernel_s']:.3f} s, {g['times']['gathers']} "
                        f"gathers in {g['times']['gather_s']:.4f} s"
                        for rank, g in enumerate(got))
            + f"; one process on two entries {seen['wall']:.2f} s, peak device memory "
            f"{seen['peak']} B; process 0's file equals it byte for byte; its float32 twin "
            f"({proc}) lies {twin:.3e} from it on d; launches "
            + ", ".join(f"{k} {v}" for k, v in both.items() if v) + f" [{card}]")
    coded_launched, coded_diffs = check_coded_procs(results, card, coded_ref)
    launches.update(coded_launched)
    diffs.update(coded_diffs)
    return launches, diffs, x64_outs


def check_coded_procs(results, card, coded_ref):
    """The two-process runs of CODED_PROC_RUNS and their twins under
    NGSDIST_CODED_UPLOAD=0: both processes lazy, coded (the twin not), the
    same launches; process 0's coded file its twin's bytes, and the
    in-process run's on two entries ((cgl), coded_ref: its file and round
    length) where both cut rounds of one length, else within
    CODED_PROC_ATOL on d.  Returns the launches (both processes together)
    and the largest |d difference| from the in-process run."""
    ref_file, ref_chunk = coded_ref
    launches, diffs = {}, {}
    for run, ref in CODED_PROC_RUNS.items():
        got = {lane: [results[rank][f"{run}_{lane}"] for rank in (0, 1)]
               for lane in ("coded", "twin")}
        for lane, procs in got.items():
            for rank, g in enumerate(procs):
                st = g["stream"]
                if not st.get("lazy") or st.get("coded") != (lane == "coded"):
                    raise AssertionError(f"run ({run}) {lane}, process {rank}: stream {st}")
            launches[f"{run}_{lane}_2p"] = {
                name: procs[0]["launches"][name] + procs[1]["launches"][name] for name in KERNELS}
            t = [g["times"] for g in procs]
            log(f"phase 3: ({run}) {lane}: {ref}'s flags in two processes, lazy in "
                f"{procs[0]['stream']['rounds']} rounds of {procs[0]['stream']['chunk']} sites; "
                + "; ".join(f"process {rank}: {g['wall']:.2f} s (host clock, CLI call), read "
                            f"{tt['read_s']:.3f} s, upload {tt['upload_s']:.3f} s, kernels "
                            f"{tt['kernel_s']:.3f} s, host bytes sent {tt['upload_bytes']} B, "
                            f"gathers {tt['gather_s']:.4f} s"
                            for rank, (g, tt) in enumerate(zip(procs, t)))
                + "; launches " + ", ".join(f"{k} {v}" for k, v in
                                            launches[f"{run}_{lane}_2p"].items() if v)
                + f" [{card}]")
        if launches[f"{run}_coded_2p"] != launches[f"{run}_twin_2p"]:
            raise AssertionError(f"run ({run}): launches {launches[f'{run}_coded_2p']}, its "
                                 f"twin {launches[f'{run}_twin_2p']}")
        out = os.path.join(WORK, f"{run}_coded.dist")
        with open(out, "rb") as a, open(os.path.join(WORK, f"{run}_twin.dist"), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"run ({run}): process 0's coded file differs from its "
                                     "twin's")
        n_mats = 1 + RUNS[CODED_RUNS[ref][0]][2]
        mats, ref_mats = check_output(out, n_mats), check_output(ref_file, n_mats)
        diffs[run] = max(float(np.abs(a - b).max()) for a, b in zip(mats, ref_mats))
        chunk = got["coded"][0]["stream"]["chunk"]
        with open(out, "rb") as a, open(ref_file, "rb") as b:
            same = a.read() == b.read()
        if chunk == ref_chunk and not same:
            raise AssertionError(f"run ({run}): rounds of {chunk} sites as ({ref})'s, but "
                                 "other bytes")
        if not diffs[run] <= CODED_PROC_ATOL:
            raise AssertionError(f"run ({run}): {diffs[run]} from ({ref}) on d, above "
                                 f"{CODED_PROC_ATOL}")
        log(f"phase 3: ({run}) process 0's coded file equals its twin's byte for byte; "
            f"against ({ref}) (rounds of {ref_chunk} sites a shard; here {chunk}): "
            + ("the same bytes" if same else f"within {diffs[run]:.3e} on d"))
    return launches, diffs


def tile_times(torch, kmod, pm, build, kind, P32, pairwise_del, plain64, bound, report,
               card) -> None:
    """One pairs-shard's launch (its split's first tile list) at the main
    path's shape for splits of 2 and 4, beside the full launch, with the
    share of the full launch's tiles it holds and the bound scaled by that
    share; the 2-way launch held against the float64 plain version
    (plain64, the full one, masked to the list's tiles: the plain tile
    form) and reported, with the plain tile form's time, in P32's dtype
    (float32, or float64 for the --x64 entries, whose name ends in
    "_f64" and which replace the XLA functions of the JAX package's x64
    runs)."""
    from ngsdist_tpu_torch.ops import em, indep

    N = P32.shape[1]
    f64 = P32.dtype == torch.float64
    dt = "float64" if f64 else "float32"
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
        log(f"phase 4: {kind} tile list ({dt} entry), first shard of {p}: {lst.size} of "
            f"{nt * (nt + 1) // 2} "
            f"tiles (share {share:.4f}) in {ms:.3f} ms against the full launch's "
            f"{ms_full:.3f} ms ({ms / ms_full:.4f}); bound scaled by the share "
            f"{bound[0] * share:.3f} ms [{card}]")
    lst, tiles, ms, share = first[2]
    got = fn(P32, SCORE9, pairwise_del, tiles=tiles)
    mask = build.tile_mask(N, lst, edge, strict).to(P32.device)
    plain = [torch.where(mask, x, torch.zeros_like(x)) for x in plain64]
    rel, err = check_kernel(kind, torch, *got, *plain, *kernel_tol(torch, indep, em, P32))
    if kind == "indep":
        ms_p = time_cuda(torch, lambda: ref(P32, SCORE9, pairwise_del, tiles=tiles), 3)
    else:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref(P32, SCORE9, pairwise_del, tiles=tiles)
        torch.cuda.synchronize()
        ms_p = (time.perf_counter() - t0) * 1e3
    torch.cuda.empty_cache()
    log(f"phase 4: {kind} tile list ({dt} entry), first shard of 2, vs float64 plain: max rel "
        f"raw err {rel:.3e}, max |raw/cnt err| {err:.3e}; plain tile form ({dt}) {ms_p:.3f} ms")
    replaces = {(False, "indep"): "ngsdist_tpu/ops/pallas_indep.py:463",
                (False, "em"): "ngsdist_tpu/ops/pallas_em.py:326",
                (True, "indep"): "ngsdist_tpu/core/distance.py:332",
                (True, "em"): "ngsdist_tpu/core/distance.py:545"}[f64, kind]
    report(f"{kind}_raw_cnt_tiles{'_f64' if f64 else ''}", f"ngsdist_tpu_torch/csrc/{kind}.cu",
           replaces, err,
           "raw/cnt", ms, ms_p,
           (bound[0] * share, bound[1], f"{share:.4f} of the full launch's bound: {bound[2]}"),
           None)


def time_expand_codes(torch, distance, hostmem, card) -> None:
    """core/distance.py expand_codes (a plain PyTorch gather, the device
    half of the code-plane lane) at (a)'s shape, uint8 [S, N] ->
    float32 [S, N, 3] into a kept buffer, by CUDA events, beside its bound
    by bytes (the codes read once, the triples written once) and held to
    the plain indexing of the table by the codes."""
    S, N = INDEP_SITES, N_IND
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    codes = torch.randint(0, 4, (S, N), generator=gen, device=dev, dtype=torch.uint8)
    lut = torch.from_numpy(hostmem.coded_call_lut(True)).float().to(dev)
    out = torch.empty((S, N, 3), dtype=torch.float32, device=dev)
    ms = time_cuda(torch, lambda: distance.expand_codes(codes, lut, out=out), 5)
    if not torch.equal(out, lut[codes.long()]):
        raise AssertionError("expand_codes differs from the table indexed by the codes")
    nbytes = S * N * (1 + 3 * 4)
    log(f"phase 4: expand_codes uint8 [{S}, {N}] -> float32 [{S}, {N}, 3]: {ms:.3f} ms; bound "
        f"{nbytes / PEAK_BYTES * 1e3:.3f} ms by bytes ({nbytes} B at {PEAK_BYTES:.3g} B/s); "
        f"equal to the plain indexing [{card}]")
    del codes, out
    torch.cuda.empty_cache()


def time_expand23(torch, distance, hostmem, card) -> None:
    """core/distance.py expand23, the device half of the two-component
    lanes (plain PyTorch ops), at (a)'s shape into a kept float32 buffer,
    by CUDA events: the uint16 half on [S, N, 2] uint16 slabs of seeded
    probabilities (pack16 on the host), the float32 half on the same
    probabilities' float32 pairs, each beside its bound by bytes (the slab
    read once, the triples written once); the uint16 half held to the CPU's
    expansion of the same slab, bit for bit."""
    S, N = INDEP_SITES, N_IND
    dev = torch.device(DEVICE)
    P = rand_probs(np.random.default_rng(SEED + 9), S, N)
    q = hostmem.pack16(P)
    p2 = torch.from_numpy(hostmem.pack23(P, torch.float32, torch.device("cpu"))).to(dev)
    del P
    q_dev = torch.from_numpy(q).to(dev)
    out = torch.empty((S, N, 3), dtype=torch.float32, device=dev)
    for name, slab in (("uint16", q_dev), ("float32", p2)):
        ms = time_cuda(torch, lambda: distance.expand23(slab, out=out), 5)
        nbytes = S * N * (2 * slab.element_size() + 3 * 4)
        log(f"phase 4: expand23, {name} half, [{S}, {N}, 2] -> float32 [{S}, {N}, 3]: "
            f"{ms:.3f} ms; bound {nbytes / PEAK_BYTES * 1e3:.3f} ms by bytes ({nbytes} B at "
            f"{PEAK_BYTES:.3g} B/s) [{card}]")
    distance.expand23(q_dev, out=out)
    want = distance.expand23(torch.from_numpy(q[:4096]))
    if not torch.equal(out[:4096].cpu().view(torch.int32), want.view(torch.int32)):
        raise AssertionError("expand23's uint16 half on the card differs from the CPU's")
    log("phase 4: expand23's uint16 half on the card equals the CPU's bit for bit (the first "
        "4,096 sites)")
    del q_dev, p2, out
    torch.cuda.empty_cache()


# Phase popgen (module docstring): the HMM kernel's six entries against the
# plain version at HMM_SHAPES (chains, sites, states, distances per chain)
# and on the edge inputs of HMM_EDGES, then the quickstart's steps 4-5
# (examples/quickstart.py) at full width: POPGEN_SITES sites of N_IND
# individuals, one HMM chain per individual.
HMM_KINDS = ("forward", "backward", "viterbi")
HMM_SHAPES = ((N_IND, 8192, 2, False), (64, 2048, 3, True), (64, 2048, 8, False))
HMM_EDGES = ("alpha0", "zero_q", "breaks", "ties")
HMM_EDGE_SHAPE = (40, 300)            # chains, sites of each edge case, at K = 2 and 3
# Sites a segment of the kernel in the second call of each edge case and
# of HMM_SHAPES[1:] (ops/hmm.py _chains_cuda's `segment`; the wrapper's
# own, hmm.SEGMENT, leaves one or two segments there): every few dozen
# sites a segment edge, off the kernel's load steps.
HMM_SMALL_SEGMENT = 37
# The three scans at full width (N_IND x POPGEN_SITES x 2, one call each
# in the popgen path) before their redesign as segmented scans (one
# thread a chain), NVIDIA H100 80GB HBM3 at 700.00 W.
HMM_MS_BEFORE = {"hmm_forward_f64": 357.908, "hmm_backward_f64": 441.240,
                 "hmm_forward": 113.110, "hmm_backward": 108.722,
                 "hmm_viterbi_f64": 288.328, "hmm_viterbi": 104.897}
HMM_REPLACES = {"forward": "ngsdist_tpu/popgen/hmm.py:73",
                "backward": "ngsdist_tpu/popgen/hmm.py:92",
                "viterbi": "ngsdist_tpu/popgen/hmm.py:130"}
HMM_ERR_OF = {"forward": "Fw and loglik (log messages)",
              "backward": "Bw and loglik (log messages)",
              "viterbi": "best log score (paths: flips counted and held)"}
# The HMM entries by the name of their wrapper and dtype: (module, counter).
HMM_KERNELS = {f"hmm_{kind}{sfx}": ("hmm", f"{kind.upper()}_LAUNCHES{sfx.upper()}")
               for kind in HMM_KINDS for sfx in ("", "_f64")}
PEAK_F32 = 67e12                      # float32 outside the tensor cores
POPGEN_SITES = 4 * INDEP_SITES
POPGEN_MAF_SITES = INDEP_SITES        # est_maf_sites timed on these first sites
POPGEN_CHROMS = 4                     # chromosomes of the POS file
POPGEN_Q, POPGEN_ALPHA = (0.9, 0.1), 1e-4   # examples/quickstart.py step 5
POPGEN_LANES, POPGEN_N = 1024, 16     # lbfgsb lanes of tests/test_popgen.py's quartic
POPGEN_SCIPY_LANES = (0, 1, 511, 1023)
POPGEN_CHECK_CHAINS = 64              # chains whose messages are held to their bounds
POPGEN_SEGMENT = 1024                 # sites a CUDA graph of the plain loop walks
# The popgen path's entry calls (a forward or backward call is three kernel
# launches, a Viterbi call five): posterior_decode runs forward and
# backward once more; the chains run in float64, then in float32.
POPGEN_LAUNCHES = {name: (1 if "viterbi" in name else 2) for name in HMM_KERNELS}


def hmm_inputs(torch, rng, B: int, S: int, K: int, per_chain_d: bool, dtype, edge=None):
    """Seeded chains on the card: q Dirichlet per chain, alpha in
    [1e-3, 0.1], log emissions log(U + 1e-3), distances 1..49 with
    chromosome breaks (inf) at S/3 and S/2; edge: "alpha0" (every alpha 0:
    off-diagonal log T -inf, NaN past the break where 0 * inf), "zero_q" (a
    state of proportion 0), "breaks" (inf at the first site and every
    seventh), "ties" (uniform q, equal emissions: exact ties)."""
    q = rng.dirichlet(np.ones(K), size=B)
    alpha = rng.uniform(1e-3, 0.1, B)
    e = np.log(rng.random((B, S, K)) + 1e-3)
    d = rng.integers(1, 50, size=(B, S) if per_chain_d else S).astype(np.float64)
    d[..., [S // 3, S // 2]] = np.inf
    if edge == "alpha0":
        alpha[:] = 0.0
    elif edge == "zero_q":
        q[:, -1] = 0.0
        q /= q.sum(-1, keepdims=True)
    elif edge == "breaks":
        d[..., ::7] = np.inf
    elif edge == "ties":
        q[:] = 1.0 / K
        e[:] = e[..., :1]
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(DEVICE, dtype)
                 for x in (q, alpha, e, d))


def held(torch, what: str, got, want, bound) -> float:
    """Hold got to want: non-finite values equal (NaN where NaN), finite ones
    within bound (broadcast).  Returns the largest finite |error|."""
    fin = torch.isfinite(want)
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    if not bool(same[~fin].all()):
        raise AssertionError(f"{what}: a non-finite value differs from the plain version's")
    diff = torch.where(fin, (got.double() - want.double()).abs(), torch.zeros_like(want.double()))
    over = diff > bound.expand_as(diff)
    if bool(over.any()):
        raise AssertionError(f"{what}: {int(over.sum())} values outside the bound, largest "
                             f"error {float(diff.max()):.3e}")
    return float(diff.max()) if diff.numel() else 0.0


def same_values(torch, a, b) -> bool:
    """Equal values of one dtype, NaN where NaN (a NaN's payload aside)."""
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def check_hmm(torch, hmm, kind: str, args, got, plain=None, run=None, segment=None,
              bounds=None):
    """One call's outputs against the plain version on the same inputs,
    within ops/hmm.py hmm_bound (PERF.md section 2).  The kernel's
    segmented order, segments of `segment` sites (the wrapper's
    hmm.SEGMENT by default), so within hmm_bound(..., segment) of the
    sequential plain version and equal to the same order in plain PyTorch
    bit for bit: forward and backward hmm_scan_segmented_ref's messages and
    logliks, Viterbi hmm_viterbi_segmented_ref's path and best score.
    Viterbi against the sequential plain version: the best score within
    its bound, and every flip a near tie (viterbi_flips).  run: how the
    plain version walks the sites (ops/hmm.py eager, the default, or
    segment_runner).  bounds: a dict that gets the largest bound on a
    message ("message") and on a loglik or best score ("last").  Returns
    (largest |error|, flips)."""
    what = f"hmm {kind} {got[0].dtype} {tuple(args[2].shape)}"
    run = run or hmm.eager
    L = segment or hmm.SEGMENT
    if kind != "viterbi":
        X, ll = plain or (hmm.hmm_forward_ref if kind == "forward"
                          else hmm.hmm_backward_ref)(*args, run=run)
        per, last = hmm.hmm_bound(kind, *args, X, L=L)
        if bounds is not None:
            bounds.update(message=float(per.max()), last=float(last.max()))
        err = max(held(torch, what, got[0], X, per[..., None]),
                  held(torch, what + " loglik", got[1], ll, last))
        model = hmm.hmm_scan_segmented_ref(kind, *args, L)
        if not (same_values(torch, got[0], model[0]) and same_values(torch, got[1], model[1])):
            raise AssertionError(f"{what}: not the bits of ops/hmm.py hmm_scan_segmented_ref "
                                 f"(segments of {L} sites)")
        return err, 0
    path, best, V, backs = hmm.hmm_viterbi_ref(*args, full=True, run=run)
    per, last = hmm.hmm_bound(kind, *args, V, L=L)
    if bounds is not None:
        bounds.update(message=float(per.max()), last=float(last.max()))
    err = held(torch, what + " best", got[1], best, last)
    model = hmm.hmm_viterbi_segmented_ref(*args, L)
    if not (torch.equal(got[0], model[0]) and same_values(torch, got[1], model[1])):
        raise AssertionError(f"{what}: not the path and best score of ops/hmm.py "
                             f"hmm_viterbi_segmented_ref (segments of {L} sites)")
    return err, viterbi_flips(torch, hmm, what, args, got[0], path, V, backs, per)


def viterbi_flips(torch, hmm, what: str, args, got_path, path, V, backs, per) -> int:
    """Where a Viterbi path got_path [B, S] leaves the plain version's
    choices (path, scores V and back pointers of hmm_viterbi_ref(...,
    full=True) on the same inputs args), each step must be a flip between
    near-tied candidates: at a site s whose back pointer at got_path's
    state differs from got_path's state at s - 1 (or at the final arg max),
    the two candidates' plain scores within twice the per-message bound
    per [B, S] (hmm_bound).  Raises where none explains it; returns the
    flips."""
    pk = got_path.long()
    if torch.equal(pk, path.long()):
        return 0
    B, S, K = V.shape
    logT = hmm.transition_matrices(args[0], args[1], args[3])
    lk, lp = pk[:, -1:], path[:, -1:].long()
    final = (lk != lp)[:, 0]
    near = V[:, -1].gather(1, lk)[:, 0] >= V[:, -1].gather(1, lp)[:, 0] - 2 * per[:, -1]
    st, prev = pk[:, 1:], pk[:, :-1]
    bp = backs[:, 1:].gather(2, st[..., None])[..., 0]
    moved = prev != bp
    # the candidates' scores V[s-1, k] + log T_s[k, state at s]
    sc = V[:, :-1] + logT[:, 1:].gather(3, st[..., None, None].expand(B, S - 1, K, 1))[..., 0]
    near_s = sc.gather(2, prev[..., None])[..., 0] >= sc.gather(2, bp[..., None])[..., 0] \
        - 2 * per[:, 1:]
    if bool((final & ~near).any()) or bool((moved & ~near_s).any()):
        raise AssertionError(f"{what}: the path leaves the plain version's where no near tie "
                             "explains it")
    return int(final.sum()) + int(moved.sum())


def hmm_bound_ms(kind: str, B: int, S: int, K: int, itemsize: int, per_chain_d: bool):
    """(ms, "bytes" or "operations", reckoning): the least time the card
    could take for one scan.  Bytes: e and the distances read once, q and
    alpha, the messages (Viterbi: the int32 path) and the logliks written
    once (the Viterbi kernel's own back-pointer scratch is not counted).
    Operations per chain and site, each exp and log counted as one: the
    transition row 4 + 5K, then forward and backward K (K + 4K) + K,
    Viterbi 2K^2 + 1, at the peak of the type outside the tensor cores."""
    nbytes = itemsize * (B * S * K + (B * S if per_chain_d else S) + B * (K + 2))
    nbytes += B * S * (4 if kind == "viterbi" else K * itemsize)
    per_step = 4 + 5 * K + (2 * K * K + 1 if kind == "viterbi" else 5 * K * K + K)
    flop = B * S * per_step
    peak = PEAK_F64 if itemsize == 8 else PEAK_F32
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, flop / peak * 1e3
    return (max(t_b, t_o), "bytes" if t_b > t_o else "operations",
            f"{nbytes:.4g} B at {PEAK_BYTES:.4g} B/s = {t_b:.3f} ms; {flop:.4g} operations at "
            f"{peak:.4g}/s = {t_o:.3f} ms")


def timed_once(torch, fn):
    """(fn()'s result, ms by the host clock around it, synchronized)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_hmm_kernels(torch, hmm, card) -> dict:
    """The six entries (forward, backward, viterbi; float32 and float64)
    through the public wrappers against the plain version on the same
    inputs, at HMM_SHAPES and on HMM_EDGES (module docstring, phase
    popgen), each within hmm_bound (check_hmm); each again in segments of
    HMM_SMALL_SEGMENT sites on the edge inputs and HMM_SHAPES[1:]; at the
    first shape also timed (kernel by CUDA events
    over 5 calls after a warm-up, the plain version once by the host
    clock).  Returns {entry: {"err", "flips", "ms", "plain_ms",
    "bound"}}."""
    rng = np.random.default_rng(SEED + 13)
    out = {f"hmm_{k}{s}": {"err": 0.0, "flips": 0} for k in HMM_KINDS for s in ("", "_f64")}
    cases = [(shape, None) for shape in HMM_SHAPES]
    cases += [((*HMM_EDGE_SHAPE, K, K == 3), edge) for edge in HMM_EDGES for K in (2, 3)]
    t0 = time.perf_counter()
    for (B, S, K, per_d), edge in cases:
        for dtype in (torch.float32, torch.float64):
            args = hmm_inputs(torch, rng, B, S, K, per_d, dtype, edge)
            main_shape = edge is None and (B, S, K, per_d) == HMM_SHAPES[0]
            for kind in HMM_KINDS:
                name = f"hmm_{kind}{'_f64' if dtype == torch.float64 else ''}"
                wrapper = getattr(hmm, f"hmm_{kind}")
                got = wrapper(*args)
                torch.cuda.synchronize()
                plain = None
                if main_shape:
                    out[name]["ms"] = time_cuda(torch, lambda: wrapper(*args), 5)
                    plain, out[name]["plain_ms"] = timed_once(
                        torch, lambda: getattr(hmm, f"hmm_{kind}_ref")(*args))
                    out[name]["bound"] = hmm_bound_ms(kind, B, S, K, args[2].element_size(),
                                                      per_d)
                    plain = None if kind == "viterbi" else plain
                bounds = {}
                err, flips = check_hmm(torch, hmm, kind, args, got, plain, bounds=bounds)
                if main_shape:
                    out[name]["err_main"], out[name]["hmm_bound"] = err, bounds
                out[name]["err"] = max(out[name]["err"], err)
                out[name]["flips"] += flips
                if not main_shape:
                    got = hmm._chains_cuda(kind, *args, segment=HMM_SMALL_SEGMENT)
                    torch.cuda.synchronize()
                    err, flips = check_hmm(torch, hmm, kind, args, got,
                                           segment=HMM_SMALL_SEGMENT)
                    out[name]["err"] = max(out[name]["err"], err)
                    out[name]["flips"] += flips
            del args
    torch.cuda.empty_cache()
    log(f"phase popgen: the HMM kernel's six entries against the plain version on the card "
        f"within hmm_bound (PERF.md section 2) at {len(HMM_SHAPES)} shapes (chains x sites x "
        f"states: {', '.join(f'{B} x {S} x {K}' for B, S, K, _ in HMM_SHAPES)}) and "
        f"{len(HMM_EDGES)} edge inputs ({', '.join(HMM_EDGES)}; {HMM_EDGE_SHAPE[0]} x "
        f"{HMM_EDGE_SHAPE[1]} at K = 2, 3), each entry in segments of {hmm.SEGMENT} sites "
        f"and, on the edge inputs and the last two shapes, of {HMM_SMALL_SEGMENT}, equal to "
        f"hmm_scan_segmented_ref or hmm_viterbi_segmented_ref, in "
        f"{time.perf_counter() - t0:.1f} s; largest "
        "|error| and Viterbi flips: " + ", ".join(
            f"{k} {v['err']:.3e} ({v['flips']} flips)" for k, v in out.items()))
    B, S, K, _ = HMM_SHAPES[0]
    for name, v in out.items():
        log(f"phase popgen: {name} at {B} x {S} x {K}: kernel {v['ms']:.3f} ms, plain "
            f"{v['plain_ms']:.3f} ms (one run), bound {v['bound'][0]:.3f} ms by "
            f"{v['bound'][1]} ({v['bound'][2]}); largest |error| {v['err_main']:.3e} against "
            f"hmm_bound up to {v['hmm_bound']['message']:.3e} on a message, "
            f"{v['hmm_bound']['last']:.3e} on a loglik or best score [{card}]")
    return out


def write_popgen_pos(path: str, rng) -> None:
    """A POS file of POPGEN_SITES sites on POPGEN_CHROMS chromosomes of equal
    length, positions rising by seeded gaps of 1..199."""
    per = POPGEN_SITES // POPGEN_CHROMS
    with open(path, "w") as fh:
        for c in range(POPGEN_CHROMS):
            pos = np.cumsum(rng.integers(1, 200, per))
            fh.write("".join(f"chr{c + 1}\t{p}\tA\tC\n" for p in pos))


def event_ms(torch, fn):
    """(fn()'s result, ms of the one call by CUDA events)."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def drive_popgen(torch, popgen, hmm, readers, P: np.ndarray, card) -> dict:
    """The quickstart's steps 4-5 (examples/quickstart.py) at full width,
    through the port's public functions, with the HMM launch counts set
    to 0 just before and read just after (module docstring, phase popgen).
    The GLs are the main path's seeded array P (rand_probs, [INDEP_SITES,
    N_IND, 3]) four times over, as run (e) reads it.  Returns {"launches":
    ..., "ms": {function: ms}}."""
    dev = torch.device(DEVICE)
    S, N = POPGEN_SITES, N_IND
    t0 = time.perf_counter()
    hap_gl = torch.from_numpy(P[:POPGEN_MAF_SITES]).to(dev)
    GL = torch.log(torch.from_numpy(P).to(dev)).repeat(S // P.shape[0], 1, 1)
    pos = os.path.join(WORK, "popgen_pos.txt")
    write_popgen_pos(pos, np.random.default_rng(SEED + 14))
    log(f"phase popgen: log-GLs [{S}, {N}, 3] float64 on the card ((a)'s array {S // P.shape[0]} "
        f"times) and a POS file of {POPGEN_CHROMS} chromosomes in "
        f"{time.perf_counter() - t0:.1f} s")
    for _, counter in HMM_KERNELS.values():
        setattr(hmm, counter, 0)
    ms = {}
    t0 = time.perf_counter()
    pos_dist, ms["read_pos_dist"] = timed_once(
        torch, lambda: readers.read_pos_dist(readers.read_pos(pos, False, S), S))
    if int(np.isinf(pos_dist).sum()) != POPGEN_CHROMS - 1 or pos_dist.min() < 1:
        raise AssertionError("read_pos_dist: not one inf per chromosome change")
    # step 4: per-site MAFs of the first POPGEN_MAF_SITES sites (the rest
    # repeat them)
    (maf0, iters), ms["est_maf_sites"] = event_ms(
        torch, lambda: popgen.freqs._est_maf_iters(GL[:POPGEN_MAF_SITES]))
    mafs = maf0.repeat(S // POPGEN_MAF_SITES)
    if not bool(((mafs >= 0) & (mafs <= 1)).all()):
        raise AssertionError("est_maf_sites: a MAF outside [0, 1]")
    # step 5: one chain per individual, F = 0 and F = 1
    gl_ind = GL.permute(1, 0, 2)
    e_prob, ms["calc_emission"] = event_ms(torch, lambda: torch.stack(
        [popgen.calc_emission(gl_ind, mafs, f) for f in (0.0, 1.0)], dim=-1))
    del GL, gl_ind
    torch.cuda.empty_cache()
    q = torch.tensor(POPGEN_Q, dtype=torch.float64, device=dev)
    d = torch.from_numpy(pos_dist).to(dev)
    res, kept, full = {}, {}, {}
    for tag, dt in (("", torch.float64), ("_f32", torch.float32)):
        args = (q.to(dt), POPGEN_ALPHA, e_prob.to(dt), d.to(dt))
        for fn in ("forward", "backward", "posterior_decode", "viterbi"):
            res[fn + tag], ms[fn + tag] = event_ms(torch, lambda: getattr(popgen, fn)(*args))
        check_popgen_chains(torch, hmm, tag, args, res, kept, full)
        res = {k: v for k, v in res.items() if k.startswith("ref")}
        torch.cuda.empty_cache()
    del e_prob
    torch.cuda.empty_cache()
    # two-site haplotype frequencies of adjacent sites (normal-space GLs)
    (hf, n_iter, x), ms["haplo_freq"] = event_ms(torch, lambda: popgen.haplo_freq(
        hap_gl[:-1], hap_gl[1:], mafs[:POPGEN_MAF_SITES - 1], mafs[1:POPGEN_MAF_SITES]))
    if not (bool(torch.isfinite(hf).all()) and float((hf.sum(-1) - 1).abs().max()) < 1e-9
            and bool(((x >= 0) & (x <= N)).all())):
        raise AssertionError("haplo_freq: frequencies not finite or not summing to 1")
    del hap_gl
    lb, lb_conv = drive_lbfgsb(torch, popgen, ms)
    launches = {name: getattr(hmm, counter) for name, (_, counter) in HMM_KERNELS.items()}
    wall = time.perf_counter() - t0
    if launches != POPGEN_LAUNCHES:
        raise AssertionError(f"phase popgen: launches {launches}, expected {POPGEN_LAUNCHES}")
    log(f"phase popgen: the quickstart's steps 4-5 at {N} individuals x {S} sites in "
        f"{wall:.1f} s: read_pos_dist {ms['read_pos_dist']:.1f} ms (host); est_maf_sites on "
        f"{POPGEN_MAF_SITES} sites {ms['est_maf_sites']:.3f} ms, {iters} iterations, "
        f"{ms['est_maf_sites'] / iters:.3f} ms an iteration; calc_emission at F = 0, 1 into "
        f"e_prob [{N}, {S}, 2] float64 {ms['calc_emission']:.3f} ms; float64 chains: "
        + ", ".join(f"{fn} {ms[fn]:.3f} ms" for fn in ("forward", "backward",
                                                       "posterior_decode", "viterbi"))
        + "; float32 chains: " + ", ".join(f"{fn} {ms[fn + '_f32']:.3f} ms" for fn in (
            "forward", "backward", "posterior_decode", "viterbi"))
        + f"; haplo_freq on {POPGEN_MAF_SITES - 1} site pairs {ms['haplo_freq']:.3f} ms, "
        f"n_iter up to {int(n_iter.max())}; lbfgsb on {POPGEN_LANES} lanes of n = "
        f"{POPGEN_N} {ms['lbfgsb']:.3f} ms, up to {lb} iterations, {lb_conv} lanes converged "
        f"to tol 1e-9; launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items()) + f" [{card}]")
    log("phase popgen: " + ", ".join(f"{k} {v}" for k, v in kept.items()))
    return {"launches": launches, "ms": ms, "full": full}


def check_popgen_chains(torch, hmm, tag: str, args, res, kept, full) -> None:
    """The full-width chains' outputs: shapes and types; on the first
    POPGEN_CHECK_CHAINS chains, over every site, forward's, backward's and
    viterbi's outputs held to the plain version on the same inputs
    (check_hmm; the plain loop replayed from CUDA graphs of POPGEN_SEGMENT
    sites, ops/hmm.py segment_runner: the eager loop's kernels, without its
    Python per site), the forward and backward logliks equal within their
    two bounds (the same quantity by two recursions), the posterior
    normalised within both messages' bounds, the Viterbi path in range and
    its score below the loglik (within both bounds); the float32 chains within hmm_bound (in
    float32) of the float64 ones.  full gets {kernel name: (largest
    |error|, Viterbi flips)} against the plain version."""
    q, alpha, e, d = args
    B, S, K = e.shape
    Fw, ll = res["forward" + tag]
    Bw, llb = res["backward" + tag]
    post, _ = res["posterior_decode" + tag]
    path, score = res["viterbi" + tag]
    if (Fw.shape, Bw.shape, post.shape, path.shape) != ((B, S, K),) * 3 + ((B, S),) \
            or Fw.dtype != e.dtype or path.dtype != torch.int32:
        raise AssertionError(f"popgen chains{tag}: shapes or types")
    c = POPGEN_CHECK_CHAINS
    sub = (q.expand(c, K), torch.full((c,), alpha, dtype=e.dtype, device=e.device), e[:c], d)
    t0 = time.perf_counter()
    run = hmm.segment_runner(POPGEN_SEGMENT)
    last_v = 0.0
    for kind, got in (("forward", (Fw[:c], ll[:c])), ("backward", (Bw[:c], llb[:c])),
                      ("viterbi", (path[:c], score[:c]))):
        bounds = {}
        name = f"hmm_{kind}{'' if tag else '_f64'}"
        full[name] = check_hmm(torch, hmm, kind, sub, got, run=run, bounds=bounds)
        last_v = bounds["last"]
        kept[f"{name} hmm_bound on {c} chains x {S} sites"] = (
            f"message {bounds['message']:.3e}, last {bounds['last']:.3e}, observed "
            f"{full[name][0]:.3e}")
        torch.cuda.empty_cache()
    kept[f"plain version on {c} chains x {S} sites{tag}"] = (
        ", ".join(f"{k} {v[0]:.3e} ({v[1]} flips)" for k, v in full.items()
                  if k.endswith("_f64") != bool(tag))
        + f" in {time.perf_counter() - t0:.1f} s")
    per_f, last_f = hmm.hmm_bound("forward", *sub, Fw[:c], L=hmm.SEGMENT)
    per_b, last_b = hmm.hmm_bound("backward", *sub, Bw[:c], L=hmm.SEGMENT)
    gap = (ll[:c].double() - llb[:c].double()).abs()
    if not bool((gap <= last_f + last_b).all()):
        raise AssertionError(f"popgen chains{tag}: forward and backward logliks differ by "
                             f"{float(gap.max()):.3e}")
    norm = hmm.logsumexp(post[:c].double(), -1).abs()
    if not bool((norm <= (per_f + per_b + last_f[:, None]) * 2).all()):
        raise AssertionError(f"popgen chains{tag}: the posterior does not normalise "
                             f"({float(norm.max()):.3e})")
    if not (bool(((path >= 0) & (path < K)).all())
            and bool((score[:c] <= ll[:c] + last_f + last_v).all())):
        raise AssertionError(f"popgen chains{tag}: a Viterbi path out of range or above the "
                             "loglik")
    kept[f"forward/backward loglik gap{tag}"] = f"{float(gap.max()):.3e}"
    kept[f"|posterior normalisation|{tag}"] = f"{float(norm.max()):.3e}"
    if not tag:
        kept["largest finite |Fw|"] = f"{float(hmm.finite_abs(Fw[:c]).max()):.6g}"
        res["ref_Fw"], res["ref_path"] = Fw[:c].clone(), path[:c].clone()
        return
    diff = (Fw[:c].double() - res["ref_Fw"]).abs()
    if not bool((diff <= per_f[..., None]).all()):
        raise AssertionError("popgen chains: float32 forward messages outside hmm_bound of "
                             "the float64 ones")
    kept["float32 Fw against float64"] = f"{float(diff.max()):.3e}"
    kept["Viterbi sites where float32 and float64 paths differ"] = str(
        int((path[:c] != res["ref_path"]).sum()))


def drive_lbfgsb(torch, popgen, ms) -> int:
    """lbfgsb on POPGEN_LANES lanes of tests/test_popgen.py's bounded quartic
    (|x - c|^2 + 0.1 |x|_4^4 in [-0.5, 0.5]^n, seeded centres c), autograd
    gradients, held lane by lane against scipy's L-BFGS-B on
    POPGEN_SCIPY_LANES (the JAX test's bounds: the value within 1e-6, x
    within 2e-4).  Returns (the most iterations a lane took, lanes
    converged)."""
    from scipy.optimize import minimize

    dev = torch.device(DEVICE)
    c = torch.from_numpy(np.random.default_rng(SEED + 15).normal(
        size=(POPGEN_LANES, POPGEN_N))).to(dev)

    def fun(x):
        return ((x - c) ** 2).sum(-1) + 0.1 * (x ** 4).sum(-1)

    lo = torch.full((POPGEN_N,), -0.5, dtype=torch.float64, device=dev)
    res, ms["lbfgsb"] = event_ms(torch, lambda: popgen.lbfgsb(
        fun, torch.zeros((POPGEN_LANES, POPGEN_N), dtype=torch.float64, device=dev),
        lower=lo, upper=-lo, max_iter=100, tol=1e-9))
    cn = c.cpu().numpy()
    for b in POPGEN_SCIPY_LANES:
        ref = minimize(lambda x: float(((x - cn[b]) ** 2).sum() + 0.1 * (x ** 4).sum()),
                       np.zeros(POPGEN_N), jac=lambda x: 2 * (x - cn[b]) + 0.4 * x ** 3,
                       method="L-BFGS-B", bounds=[(-0.5, 0.5)] * POPGEN_N,
                       options={"maxiter": 500, "ftol": 1e-15, "gtol": 1e-12})
        if not (float(res.fun[b]) <= ref.fun + 1e-6
                and np.abs(res.x[b].cpu().numpy() - ref.x).max() <= 2e-4):
            raise AssertionError(f"lbfgsb lane {b}: {float(res.fun[b])} against scipy's "
                                 f"{ref.fun}")
    return int(res.n_iter.max()), int(res.converged.sum())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    # every run but those of U16_RUNS sends float32 pairs, as before the
    # uint16 lane was ported, so that their numbers compare with earlier runs'
    os.environ["NGSDIST_UPLOAD16"] = "0"
    from ngsdist_tpu_torch import cli, popgen, runner
    from ngsdist_tpu_torch.core import distance, submodels
    from ngsdist_tpu_torch.io import readers
    from ngsdist_tpu_torch.ops import _build, em, hmm, indep
    from ngsdist_tpu_torch.parallel import mesh as pm
    from ngsdist_tpu_torch.parallel import multihost
    from ngsdist_tpu_torch.utils import hostmem, native, profiling

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
    hmma = sum(mma_ops(_build._nvcc(), _build.library_path(), "indep_mma_kernel",
                       "HMMA").values())
    if hmma == 0:
        raise AssertionError("the indep kernel's machine code holds no HMMA instruction")
    log(f"phase 1: indep kernel SASS: {hmma} HMMA instructions over its instantiations")
    dmma = mma_ops(_build._nvcc(), _build.library_path(), "indep_f64_kernel", "DMMA")
    if not dmma:
        raise AssertionError("K1d's machine code holds no DMMA instruction")
    log(f"phase 1: K1d (indep_f64_kernel) SASS: {sum(dmma.values())} DMMA instructions over "
        f"its instantiations, by instruction: {dmma}")

    # Phase 2: kernel against plain at small ragged shapes.
    phase_small_shapes(torch, indep, em)
    phase_tile_lists(torch, indep, em, pm, _build)
    # Phase x64-kernels: the float64 entries at the same shapes, and they
    # alone launch.
    mods = {"indep": indep, "em": em}
    before = launch_counts(mods)
    phase_small_shapes(torch, indep, em, x64=True)
    phase_tile_lists(torch, indep, em, pm, _build, x64=True)
    torch.cuda.synchronize()
    moved = {k: n - before[k] for k, n in launch_counts(mods).items() if n != before[k]}
    if sorted(moved) != sorted(k for k in KERNELS if k.endswith("_f64")):
        raise AssertionError(f"phase x64-kernels: launches {moved}")

    # Phase 3: the main path, through the CLI entry point.
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
        errs["p/float32"], launches["p"] = drive_pilot_run(torch, cli, mods, ngsd, em, distance,
                                                           card)
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
        x64_launched, x64_outs, x64_twin = drive_x64_runs(torch, cli, mods, ngsd, genos, mats,
                                                          card)
        launches.update(x64_launched)
        lazy_launched, lazy_diffs = drive_lazy_runs(torch, cli, mods, ngsd, genos, mats, P, card)
        launches.update(lazy_launched)
        u16_launched, u16_diffs = drive_u16_runs(torch, cli, mods, ngsd, genos, mats, P_sub,
                                                 idx, card)
        launches.update(u16_launched)
        launches["tb"] = trace_run(torch, cli, mods, ngsd, genos, card)
        TWINS.clear()
        coded_launched, coded_diffs, cgl_file, cgl_chunk = drive_coded_runs(
            torch, cli, mods, ngsd, genos, card)
        launches.update(coded_launched)
        time_upload_lanes(torch, native, genos["a"], card)
        proc_launched, proc_diffs, proc_x64 = drive_process_runs(
            torch, mods, ngsd, genos, mats, card, (cgl_file, cgl_chunk))
        launches.update(proc_launched)
        x64_outs.update(proc_x64)
        x64_errs = check_x64_outputs(torch, indep, em, distance, submodels, x64_outs, P_sub,
                                     idx, alleles)
        log("phase x64-runs: 64-individual sub-matrices of every matrix agree with the float64 "
            "plain version on the float64 values written, within the float64 entries' bounds "
            "(indep f64_sum_bound(S, chunks) rel, EM em_table_bound(S) x cnt, + the %.10f "
            "print rounding), max |d err| "
            + ", ".join(f"{k} {v:.3e}" for k, v in x64_errs.items())
            + "; the float32 twin's distance from each, max |d difference| (not held) "
            + ", ".join(f"{k} {v:.3e}" for k, v in x64_twin.items()))
        launches["goldens_x64"] = phase_x64_goldens(torch, cli, mods, card)
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
            + "; uint16 runs against their twins (max |raw difference| / cnt) and the float64 "
            "plain version on the lane's values (max |d err|) "
            + ", ".join(f"{k} {v:.3e}" for k, v in u16_diffs.items())
            + "; coded runs equal their twins byte for byte, (cgs) against (cg) max |d "
            "difference| " + ", ".join(f"{k} {v:.3e}" for k, v in coded_diffs.items())
            + "; two-process runs against the one-device run of the same file ((cgp): the "
            "in-process run on two entries), max |d difference| "
            + ", ".join(f"{k} {v:.3e}" for k, v in proc_diffs.items()))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    # Phase popgen: the HMM kernel against its plain version, then the
    # popgen path at full width with its launch counts set to 0 before it.
    hmm_rows = phase_hmm_kernels(torch, hmm, card)
    os.makedirs(WORK)
    try:
        popgen_run = drive_popgen(torch, popgen, hmm, readers, P, card)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    launches["popgen"] = popgen_run["launches"]

    # Phase 4: timings at the main path's shapes; each kernel held against
    # the plain version there.
    kernels = []
    launched = {name: sum(counts.get(name, 0) for counts in launches.values())
                for name in {**KERNELS, **HMM_KERNELS}}

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
    P32 = distance.put_probs(P, dev, False)
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
    # K1d, the --x64 entry, on the same values in float64, and its tile list
    P64 = P32.double()
    bound64 = indep_bound(INDEP_SITES, N_IND, 2 * 8 * N_IND * N_IND, f64=True)
    ms_k = time_cuda(torch, lambda: indep.indep_raw_cnt(P64, SCORE9, True), 5)
    ms_p = time_cuda(torch, lambda: indep.indep_raw_cnt_ref(P64, SCORE9, True), 3)
    got = indep.indep_raw_cnt(P64, SCORE9, True)
    rel, err = check_kernel("indep", torch, *got, *plain64, *kernel_tol(torch, indep, em, P64))
    if not all(same_bytes(torch, a, b) for a, b in zip(got, indep.indep_raw_cnt(
            P64, SCORE9, True))):
        raise AssertionError("indep float64 entry: rerun differs at the main path's shape")
    del got
    ms_lib = time_cuda(torch, indep_library_call(torch, indep, P64, 1, INDEP_SITES), 3)
    torch.cuda.empty_cache()
    log(f"phase 4: indep float64 entry {N_IND} x {INDEP_SITES} pairwise_del: kernel "
        f"{ms_k:.3f} ms, plain float64 {ms_p:.3f} ms, one-call PyTorch version (float64 "
        f"einsum and product) {ms_lib:.3f} ms; vs float64 plain: max rel raw err {rel:.3e} "
        f"(bound {kernel_tol(torch, indep, em, P64)[0]:.3e}), max |raw/cnt err| {err:.3e}, "
        f"rerun byte-identical [{card}]")
    report("indep_raw_cnt_f64", "ngsdist_tpu_torch/csrc/indep.cu",
           "ngsdist_tpu/core/distance.py:332", err, "raw/cnt", ms_k, ms_p, bound64, ms_lib)
    tile_times(torch, indep, pm, _build, "indep", P64, True, plain64, bound64, report, card)
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
    ms_k = time_cuda(torch, lambda: indep.indep_block_partials(P64, SCORE9, True, nb, bs), 5)
    ms_p = time_cuda(torch, lambda: block_pairs(
        torch, *indep.indep_block_partials_ref(P64, SCORE9, True, nb, bs)), 3)
    rel, err = block_case(torch, indep, em, "indep", P64, True, nb, bs)
    ms_lib = time_cuda(torch, indep_library_call(torch, indep, P64, nb, bs), 3)
    torch.cuda.empty_cache()
    log(f"phase 4: indep block partials, float64 entry, {N_IND} x {INDEP_SITES}, {nb} blocks "
        f"of {bs}, pairwise_del: kernel {ms_k:.3f} ms, plain float64 {ms_p:.3f} ms; vs float64 "
        f"plain: max rel B err {rel:.3e}, max |B err|/C {err:.3e}, rerun byte-identical "
        f"[{card}]")
    report("indep_block_partials_f64", "ngsdist_tpu_torch/csrc/indep.cu",
           "ngsdist_tpu/core/distance.py:365", err, "B/C", ms_k, ms_p,
           indep_bound(INDEP_SITES, N_IND, 2 * 8 * nb * (N_IND * (N_IND - 1) // 2), f64=True),
           ms_lib)
    del P64

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
    P64 = P32.double()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain64 = em.em_raw_cnt_ref(P64, SCORE9, False)
    torch.cuda.synchronize()
    ms_p64 = (time.perf_counter() - t0) * 1e3
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
    # K2d, the --x64 entry, on the same values in float64 (the same work),
    # against the float64 plain version already taken, and its tile list
    bound64 = em_bound(work, EM_SITES, N_IND, 2 * 8 * N_IND * N_IND, f64=True)
    ms_k = time_cuda(torch, lambda: em.em_raw_cnt(P64, SCORE9, False), 3)
    got = em.em_raw_cnt(P64, SCORE9, False)
    rel, err = check_kernel("em", torch, *got, *plain64, *kernel_tol(torch, indep, em, P64))
    check_rerun(torch, em.em_raw_cnt, P64, False, None, got)
    del got
    log(f"phase 4: em float64 entry {N_IND} x {EM_SITES}: kernel {ms_k:.3f} ms, plain float64 "
        f"{ms_p64:.3f} ms (one run); vs float64 plain: max |raw/cnt err| {err:.3e} (bound "
        f"{em.em_table_bound(EM_SITES):.3e}), rerun byte-identical [{card}]")
    report("em_raw_cnt_f64", "ngsdist_tpu_torch/csrc/em.cu",
           "ngsdist_tpu/core/distance.py:545", err, "raw/cnt", ms_k, ms_p64, bound64, None)
    tile_times(torch, em, pm, _build, "em", P64, False, plain64, bound64, report, card)
    del plain64

    # the block mode at run (c)'s shape, both entries against one float64
    # plain version
    nb, bs = EM_SITES // EM_BOOT_BLOCK, EM_BOOT_BLOCK
    ms_k = time_cuda(torch, lambda: em.em_block_partials(P32, SCORE9, False, nb, bs), 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    em.em_block_partials_ref(P32, SCORE9, False, nb, bs)
    torch.cuda.synchronize()
    ms_p = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain_b = em.em_block_partials_ref(P64, SCORE9, False, nb, bs)
    torch.cuda.synchronize()
    ms_p64 = (time.perf_counter() - t0) * 1e3
    _, err = block_case(torch, indep, em, "em", P32, False, nb, bs, plain_b)
    log(f"phase 4: em block partials {N_IND} x {EM_SITES}, {nb} blocks of {bs}: kernel "
        f"{ms_k:.3f} ms, plain float32 {ms_p:.3f} ms (one run); vs float64 plain: max "
        f"|B err|/C {err:.3e} [{card}]")
    report("em_block_partials", "ngsdist_tpu_torch/csrc/em.cu",
           "ngsdist_tpu/core/distance.py:418", err, "B/C", ms_k, ms_p,
           em_bound(work, EM_SITES, N_IND, 2 * 8 * nb * (N_IND * (N_IND - 1) // 2)), None)
    ms_k = time_cuda(torch, lambda: em.em_block_partials(P64, SCORE9, False, nb, bs), 3)
    _, err = block_case(torch, indep, em, "em", P64, False, nb, bs, plain_b)
    del plain_b
    log(f"phase 4: em block partials, float64 entry, {N_IND} x {EM_SITES}, {nb} blocks of "
        f"{bs}: kernel {ms_k:.3f} ms, plain float64 {ms_p64:.3f} ms (one run); vs float64 "
        f"plain: max |B err|/C {err:.3e}, rerun byte-identical [{card}]")
    report("em_block_partials_f64", "ngsdist_tpu_torch/csrc/em.cu",
           "ngsdist_tpu/core/distance.py:418", err, "B/C", ms_k, ms_p64,
           em_bound(work, EM_SITES, N_IND, 2 * 8 * nb * (N_IND * (N_IND - 1) // 2), f64=True),
           None)
    for name, before in {**EM_MS_BEFORE, **INDEP_F64_MS_BEFORE}.items():
        now = next(k["ms"] for k in kernels if k["name"] == name)
        log(f"phase 4: {name}: {now:.3f} ms, before its redesign {before:.3f} ms "
            f"({before / now:.2f}x) [{card}]")

    del P32, P64
    torch.cuda.empty_cache()
    pilot = phase_em_slices(torch, indep, em, card)
    weight_rows = phase_em_rows(torch, em, distance, card)
    for k in kernels:  # the main path's slice counts, and the pilot's width
        if k["name"] in pilot:
            sliced, slices = (sum(run[k["name"]][i] for run in RUN_SLICES) for i in (0, 1))
            k.update({"sliced_launches": sliced, "site_slices": slices,
                      f"n{PILOT_N}": pilot[k["name"]],
                      f"weight_rows_n{ROWS_N}": weight_rows[k["name"]]})
    time_expand_codes(torch, distance, hostmem, card)
    time_expand23(torch, distance, hostmem, card)
    phase_wide(torch, indep, em, card, report)

    # the HMM entries: kernel, plain and bound at HMM_SHAPES[0] (phase
    # popgen), beside the kernel's time at full width
    B, S, K, per_d = HMM_SHAPES[0]
    for name, v in hmm_rows.items():
        kind, f64 = name[4:].replace("_f64", ""), name.endswith("_f64")
        full_err, full_flips = popgen_run["full"][name]
        report(name, "ngsdist_tpu_torch/csrc/hmm.cu", HMM_REPLACES[kind],
               max(v["err"], full_err), HMM_ERR_OF[kind], v["ms"], v["plain_ms"], v["bound"],
               None)
        full = hmm_bound_ms(kind, N_IND, POPGEN_SITES, 2, 8 if f64 else 4, False)
        kernels[-1].update({"shape": f"{B} x {S} x {K}", "viterbi_flips": v["flips"],
                            "full_width_ms": popgen_run["ms"][kind + ("" if f64 else "_f32")],
                            "full_width_bound_ms": full[0],
                            "full_width_shape": f"{N_IND} x {POPGEN_SITES} x 2",
                            "full_width_max_abs_err": full_err,
                            "full_width_viterbi_flips": full_flips,
                            "full_width_checked_chains": POPGEN_CHECK_CHAINS})
        log(f"phase 4: {name} at full width ({N_IND} x {POPGEN_SITES} x 2): kernel "
            f"{kernels[-1]['full_width_ms']:.3f} ms, bound {full[0]:.3f} ms by {full[1]} "
            f"({full[2]}) [{card}]")
        if name in HMM_MS_BEFORE:
            now, before = kernels[-1]["full_width_ms"], HMM_MS_BEFORE[name]
            log(f"phase 4: {name} at full width: {now:.3f} ms, before its redesign (one thread "
                f"a chain) {before:.3f} ms ({before / now:.2f}x) [{card}]")

    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels the main path launched no time: {idle}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
