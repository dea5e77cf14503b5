// Independent-genotypes sufficient statistics on Hopper tensor cores.
//
// Replaces: ngsdist_tpu/ops/pallas_indep.py, the Pallas kernels behind
// _indep_pallas_resident (pallas_call at :358) and _indep_pallas_super
// (pallas_call at :463), entry indep_raw_cnt_pallas.  One kernel covers
// both: their split exists only for the TPU's VMEM.
//
// Computes, for the upper triangle of the [N, N] output (diagonal
// included):
//   v[s,a]   = row nonzero, and under pairwise deletion also not missing
//   Qi_g     = P_g * (v * w[s])          i side, weighted
//   Y_g      = sum_h score[g,h] * P_h * v   j side, score folded
//   raw[a,b] = sum_{s,g} Qi_g[s,a] * Y_g[s,b]
//   cnt[a,b] = sum_s (v*w)[s,a] * v[s,b]
// Masks multiply (NaN * 0 stays NaN, as in the Pallas fold), so a NaN row
// poisons exactly the pairs it touches.  The strict lower triangle is
// left as the caller allocated it (zero).
//
// Design, for the H100:
// - Tensor cores through mma.sync m16n8k8 TF32, the reduction dimension
//   k = (genotype, site) as the Pallas kernel stacks it.  raw is 3xTF32:
//   each float32 operand x splits into hi = rna_tf32(x) and lo =
//   rna_tf32(x - hi); hi*hi goes to one float32 accumulator, hi*lo +
//   lo*hi to another (the TPU kernel's bf16x3 carried to TF32).  Both are
//   added into float64 registers after every window of kWindow = 16
//   sites (48 products; PERF.md section 2 derives the bound).  cnt has a
//   {0,1} j side: one exact TF32 pass unweighted, the i side split when
//   weighted, float32 over the whole chunk (integer sums below 2^24 are
//   exact; ops/indep.py caps the chunk so).
// - A fixed-order split over sites against wave quantisation (136 upper
//   64x64 tiles at N = 1024 on 132 SMs): one-dimensional grid of
//   (site chunk, upper tile) pairs, the tile fastest, the chunk count a
//   function of (N, S) alone (ops/indep.py split_plan).  Each block
//   writes float64 partials to scratch and a second kernel sums the
//   chunks in index order: no atomics, reruns are byte-identical.
// - Tile list (full mode; replaces the panels= argument of
//   _indep_pallas_super / indep_raw_cnt_pallas, pallas_indep.py:403, :502,
//   :546-585): with `list` [L] int32 given, the grid runs over (chunk,
//   list position) and position k stands for upper tile list[k]; only those
//   tiles of raw and cnt are written, the rest stay as the caller allocated
//   them.  The chunk split stays a function of (N, S), the scratch keeps
//   its full [2, chunks, tiles, 64, 64] layout, indexed by the tile itself,
//   and the chunk reduce walks the same list: a listed tile's sums are the
//   full launch's, bit for bit.  A pairs-axis shard of the mesh engine
//   (parallel/mesh.py) runs its own list; the lists of the shards partition
//   the upper tiles, so no padding entry is needed.
// - Block mode (ngsd_indep_block_partials_f32), for the partial-sum
//   bootstrap (replaces ngsdist_tpu/core/distance.py indep_block_partials,
//   :365, an XLA einsum there): one chunk is one bootstrap block of any
//   length, unweighted; the chunk reduce is skipped and the float64
//   partials are the output.  A chunk's last step, and so its last
//   window, may be ragged (zero filled).  A chunk longer than 2^16 sites
//   adds its float32 counts into the float64 partials every 2^16 sites,
//   so they stay exact.  The one-dimensional grid puts no 65,535 limit
//   on the number of blocks.
// - 4 warps of 32x32 outputs per block, 240 registers: two blocks per SM.
//   Each step stages 8 sites of both sides' P rows with coalesced 16-byte
//   cp.async (every 32-byte sector read once) into a 4-stage ring, three
//   steps ahead.  Step t+1 is folded (validity mask, missing test,
//   weight, score fold) into double-buffered operand tiles while step t
//   runs on the tensor cores, in one basic block; one barrier per step.
//   Ragged edges (N not a multiple of 64, a chunk's last step) are zero
//   filled by the copy; all-zero rows are inert.
// - Operand rows are padded 64 -> 72 floats: fragment loads are free of
//   bank conflicts.
// What bounds it: the MMA phase.  At 1024 x 65,536 the 3.6e8 mma.sync
// take 2.3 ms at this card's measured mma.sync TF32 peak (320 TFLOP/s);
// the fold, split and flush alone take 2.8 ms and overlap little with
// them (PERF.md).  wgmma with producer warps, TMA and a persistent grid
// are the next step (ROADMAP Queue 2b).
//
// Float64 entries (ngsd_indep_raw_cnt_f64, ngsd_indep_block_partials_f64;
// K1d), for --x64, where the JAX package turns Pallas off and runs the XLA
// functions indep_suffstats and indep_block_partials
// (ngsdist_tpu/core/distance.py:332, :365) in float64.  The same
// statistics, weights, tile lists, block mode, split over sites
// (split_plan) and chunk reduce, on a float64 [S, N, 3] tensor, by a
// kernel of its own (indep_f64_kernel), every sum in float64, so no split
// of the operands, no window and no count flush.  Design, for Hopper's
// FP64 tensor cores:
// - mma.sync m16n8k8 .f64 (sm_90): a step of 8 sites is one k8 depth per
//   operand plane (genotypes 0, 1, 2 into raw; the masks into cnt).  On
//   an H100 the sm_90 shapes (m16n8k4, k8, k16) run at the full 66
//   TFLOP/s and m8n8k4, the only shape before sm_90, at half of it
//   (profile_indep_parts.py's rate loop).
// - 128 threads own a 64 x 64 tile, 2 x 2 warps of 32 x 32.  Both sides'
//   raw rows (1,536 contiguous bytes a side and site) are staged by
//   cp.async, 16 bytes a copy (8 when a row does not start on 16 bytes),
//   two steps ahead into a ring of two stages; each thread's copies are a
//   base pointer plus constants.
// - The fold (validity mask, missing test, weight, score) runs once per
//   column, side and site for the whole block, spread over all threads,
//   into double-buffered operand planes laid out as the MMA reads them:
//   a thread's fragment pair is one 16-byte word, swizzled so that the
//   fragment loads and the fold's stores are free of bank conflicts.
//   The fold of step t + 1 runs between the MMAs of step t, in one basic
//   block; one barrier per step.
// What bounds it: the FP64 tensor cores (4.2 ms of MMAs at 1024 x 65,536
// at the measured rate), and beside them the fold and the shared memory.
// The fold's float64 arithmetic does not overlap the FP64 MMAs: DFMAs
// beside them cost more than their own time (the rate loop's overlap
// tests), so the fold is done once per block and not once per warp, and
// its masks take no branch.  Staged rows, folded planes and fragments
// move about 18 KB of shared memory per site and tile.  114,816 bytes of
// shared memory and up to 255 registers: two blocks (8 warps) an SM,
// which the accumulators' 128 registers a thread and the ring allow; the
// ring hides the copies' latency, not more warps.  The sums' order is
// fixed by (N, S), so reruns are byte-identical.

#include <limits.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTile = 64;               // output tile edge
constexpr int kTileElems = kTile * kTile;
constexpr int kSites = 8;               // sites per pipeline step
constexpr int kWindow = 16;             // sites per float32 raw window
constexpr int kK = 3 * kSites;          // raw reduction depth per step
constexpr int kWarp = 32;               // warp tile edge: 2 x 4 m16n8 tiles
constexpr int kWarpsN = kTile / kWarp;  // 2 x 2 warps
constexpr int kThreads = 32 * kWarpsN * kWarpsN;
constexpr int kStages = 4;              // cp.async ring depth
constexpr int kLd = kTile + 8;          // padded operand row (floats)
constexpr long long kCntFlushSteps = (1 << 16) / kSites;  // exact float32 counts

static_assert(kWindow % kSites == 0, "a window is whole steps");
static_assert(kThreads == kSites * kTile / 4, "one fold group per thread and side");

// Operand rows are padded so that the fragment loads of a warp hit 32
// distinct banks.  86,016 bytes: two blocks fit on an SM.
struct Smem {
  float slab_i[kStages][kSites][kTile * 3];  // raw P rows, i side
  float slab_j[kStages][kSites][kTile * 3];  // raw P rows, j side
  float a[2][kK][kLd];       // i side: P_g * v * w, k = g * kSites + site
  float b[2][kK][kLd];       // j side: score-folded P * v
  float va[2][kSites][kLd];  // i side: v * w
  float vb[2][kSites][kLd];  // j side: v
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// x rounded to TF32, to nearest with ties away from zero (the rounding
// of cvt.rna.tf32.f32): add half of the 13 dropped mantissa bits to the
// magnitude, then clear them.  Two integer instructions where cvt.rna
// takes four; exact for finite values and infinities.  A NaN with a full
// mantissa would wrap to -0, so the fold stores only kNaN, which stays
// NaN (and its lo half becomes -0, which the NaN hi half dominates).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

constexpr uint32_t kNaN = 0x7FC00000u;  // the canonical quiet NaN

__device__ __forceinline__ float canonical_nan(float x) {
  return x != x ? __uint_as_float(kNaN) : x;
}

// x = hi + lo + O(2^-22 |x|), both halves exact TF32 values.
__device__ __forceinline__ void split_tf32(float x, uint32_t* hi, uint32_t* lo) {
  *hi = tf32_rna(x);
  *lo = tf32_rna(x - __uint_as_float(*hi));
}

// d += a * b on a 16x8x8 TF32 tile, float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fold one group (one site's triples of 4 consecutive individuals of one
// side, 48 bytes of the staged rows) into the operand rows of its site: the
// validity mask, the missing test, the weight (i side) or the score fold
// (j side).  Masks multiply, so a NaN row stays NaN.
// ops_row: the group's site row of genotype plane 0; planes are `plane`
// floats apart.
template <bool kSideI, bool kPairwiseDel>
__device__ __forceinline__ void fold_group(const float* slab, float* ops_row, int plane,
                                           float* msk_row, int col, float ws,
                                           const ngsd::Score9& sc) {
  const float4* q = reinterpret_cast<const float4*>(slab);
  const float4 x0 = q[0], x1 = q[1], x2 = q[2];
  const float p[4][3] = {{x0.x, x0.y, x0.z}, {x0.w, x1.x, x1.y},
                         {x1.z, x1.w, x2.x}, {x2.y, x2.z, x2.w}};
  float o[3][4], m[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float v = (p[c][0] + p[c][1] + p[c][2]) > 0.0f ? 1.0f : 0.0f;
    if (kPairwiseDel) v = v * ngsd::nonmissing(p[c][0], p[c][1], p[c][2]);
    if (kSideI) {
      const float vi = v * ws;
#pragma unroll
      for (int g = 0; g < 3; ++g) o[g][c] = p[c][g] * vi;
      m[c] = vi;
    } else {
      const float q0 = p[c][0] * v, q1 = p[c][1] * v, q2 = p[c][2] * v;
#pragma unroll
      for (int g = 0; g < 3; ++g)
        o[g][c] = sc.v[3 * g + 0] * q0 + sc.v[3 * g + 1] * q1 + sc.v[3 * g + 2] * q2;
      m[c] = v;
    }
  }
#pragma unroll
  for (int g = 0; g < 3; ++g)
    *reinterpret_cast<float4*>(ops_row + g * plane + col) =
        make_float4(canonical_nan(o[g][0]), canonical_nan(o[g][1]), canonical_nan(o[g][2]),
                    canonical_nan(o[g][3]));
  *reinterpret_cast<float4*>(msk_row + col) = make_float4(m[0], m[1], m[2], m[3]);
}

// kPairwiseDel is a template parameter so that the fold has no branch:
// it shares one basic block with the MMAs it is interleaved with.
// part: null when the sites make one chunk and raw, cnt are written
// directly; else the float64 partials [2, chunks, tiles, kTile, kTile].
// kBlocks: block mode (see the header), part is its output.
template <bool kWeighted, bool kVec16, bool kPairwiseDel, bool kBlocks>
__global__ void __launch_bounds__(kThreads)
indep_mma_kernel(const float* __restrict__ P, const float* __restrict__ w,
                 float* __restrict__ raw, float* __restrict__ cnt, double* __restrict__ part,
                 long long S, int N, long long tiles, const int* __restrict__ list,
                 long long grid_tiles, long long chunk_sites, ngsd::Score9 sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  // grid_tiles: the list's length, or every upper tile without a list
  const long long pos = blockIdx.x % grid_tiles, chunk = blockIdx.x / grid_tiles;
  const long long tile = list ? (long long)list[pos] : pos;
  if (tile < 0 || tile >= tiles) return;  // not an upper tile: the whole block leaves
  // this block's raw (plane 0) or cnt (plane 1) partial tile
  auto part_at = [&](int plane) {
    return part +
           ((plane * (long long)(gridDim.x / grid_tiles) + chunk) * tiles + tile) * kTileElems;
  };
  int ti, tj;
  ngsd::upper_tile(tile, &ti, &tj);
  const int i0 = ti * kTile, j0 = tj * kTile;
  const long long c0 = chunk * chunk_sites;
  const long long c_end = c0 + chunk_sites < S ? c0 + chunk_sites : S;
  const long long steps = c_end > c0 ? (c_end - c0 + kSites - 1) / kSites : 0;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int m0 = (warp / kWarpsN) * kWarp, n0 = (warp % kWarpsN) * kWarp;
  // this thread's fold group, the same on both sides: site sl, columns c4..c4+3
  const int sl = tid / (kTile / 4), c4 = 4 * (tid % (kTile / 4));

  // A step's copies: each side's 8 rows of 64 triples, cut into
  // contiguous 16-byte (4-byte unless kVec16) chunks that consecutive
  // threads take in turn, so every 32-byte sector is read once.  Copies
  // past the chunk end or past N are zero filled, so steps past the last
  // are staged and folded like any other, without a branch.
  auto stage_copy = [&](int stage, long long s0) {
    constexpr int kC = kVec16 ? 4 : 1, kRow = 3 * kTile / kC;
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int col0 = side == 0 ? i0 : j0;
      const int valid = 3 * (N - col0);  // floats of a row inside N
      float(*slab)[kTile * 3] = side == 0 ? sm.slab_i[stage] : sm.slab_j[stage];
      auto chunk = [&](int r) {
        const int q = tid + r * kThreads, row = q / kRow, f = kC * (q % kRow);
        const long long s = s0 + row;
        const bool ok = s < c_end && f < valid;
        const float* src = ok ? P + (s * N + col0) * 3 + f : P;
        if (kVec16)
          cp_async16(&slab[row][f], src, ok);
        else
          cp_async4(&slab[row][f], src, ok);
      };
      if constexpr (kVec16) {
#pragma unroll
        for (int r = 0; r < kSites * kRow / kThreads; ++r) chunk(r);
      } else {  // 12 narrow copies: a loop keeps their addresses out of registers
#pragma unroll 1
        for (int r = 0; r < kSites * kRow / kThreads; ++r) chunk(r);
      }
    }
  };
  auto fold_i = [&](int stage, int buf, long long s0) {
    const long long s = s0 + sl;
    const float ws = (kWeighted && s < c_end) ? __ldg(w + s) : 1.0f;
    fold_group<true, kPairwiseDel>(&sm.slab_i[stage][sl][3 * c4], &sm.a[buf][sl][0],
                                   kSites * kLd, &sm.va[buf][sl][0], c4, ws, sc);
  };
  auto fold_j = [&](int stage, int buf) {
    fold_group<false, kPairwiseDel>(&sm.slab_j[stage][sl][3 * c4], &sm.b[buf][sl][0],
                                    kSites * kLd, &sm.vb[buf][sl][0], c4, 1.0f, sc);
  };

  // Per thread: 2 x 4 m16n8 tiles of raw (hi*hi, and hi*lo + lo*hi, in
  // float32 over one window, then float64) and of cnt (float32 over the
  // chunk: integer sums below 2^24 are exact).
  float hh[2][4][4], corr[2][4][4], cn[2][4][4];
  double r64[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        hh[i][j][r] = corr[i][j][r] = cn[i][j][r] = 0.0f;
        r64[i][j][r] = 0.0;
      }

  // raw, genotype plane gk of operand buffer buf: 3xTF32, one k-step of 8
  auto mma_raw = [&](int buf, int gk) {
    const int k0 = gk * kSites;
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int m = m0 + 16 * mi + g;
      split_tf32(sm.a[buf][k0 + t4][m], &ah[mi][0], &al[mi][0]);
      split_tf32(sm.a[buf][k0 + t4][m + 8], &ah[mi][1], &al[mi][1]);
      split_tf32(sm.a[buf][k0 + t4 + 4][m], &ah[mi][2], &al[mi][2]);
      split_tf32(sm.a[buf][k0 + t4 + 4][m + 8], &ah[mi][3], &al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = n0 + 8 * ni + g;
      split_tf32(sm.b[buf][k0 + t4][n], &bh[ni][0], &bl[ni][0]);
      split_tf32(sm.b[buf][k0 + t4 + 4][n], &bh[ni][1], &bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_tf32(hh[mi][ni], ah[mi], bh[ni]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_tf32(corr[mi][ni], ah[mi], bl[ni]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_tf32(corr[mi][ni], al[mi], bh[ni]);
  };
  // cnt: the j side is {0,1} and exact; the i side splits when weighted
  auto mma_cnt = [&](int buf) {
    uint32_t ah[2][4], al[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int m = m0 + 16 * mi + g;
      const float x[4] = {sm.va[buf][t4][m], sm.va[buf][t4][m + 8], sm.va[buf][t4 + 4][m],
                          sm.va[buf][t4 + 4][m + 8]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (kWeighted)
          split_tf32(x[e], &ah[mi][e], &al[mi][e]);
        else
          ah[mi][e] = __float_as_uint(x[e]);
      }
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = n0 + 8 * ni + g;
      b[ni][0] = __float_as_uint(sm.vb[buf][t4][n]);
      b[ni][1] = __float_as_uint(sm.vb[buf][t4 + 4][n]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        mma_tf32(cn[mi][ni], ah[mi], b[ni]);
        if (kWeighted) mma_tf32(cn[mi][ni], al[mi], b[ni]);
      }
  };

  // Calls f(mi, ni, r, e) for this thread's accumulator entries, e the
  // entry's offset in a kTile x kTile tile: C fragment rows lane/4 (+8),
  // columns 2 * (lane%4) (+1).
  auto for_each_output = [&](auto f) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          f(mi, ni, r, (m0 + 16 * mi + g + 8 * (r / 2)) * kTile + n0 + 8 * ni + 2 * t4 + r % 2);
  };
  bool cnt_flushed = false;  // block mode: part_cnt holds earlier counts

  // Pipeline: step t's copies are issued three steps ahead and waited for
  // before the barrier that precedes their fold; step t+1 is folded while
  // step t runs on the tensor cores (one basic block, so the scheduler
  // interleaves the fold's ALU work with the MMAs); one barrier per step.
  stage_copy(0, c0);
  cp_async_commit();
  stage_copy(1, c0 + kSites);
  cp_async_commit();
  stage_copy(2, c0 + 2 * kSites);
  cp_async_commit();
  cp_async_wait<1>();  // steps 0 and 1 landed
  __syncthreads();
  fold_i(0, 0, c0);
  fold_j(0, 0);
  __syncthreads();
  for (long long t = 0; t < steps; ++t) {
    const int buf = (int)(t & 1), nxt = buf ^ 1, stage1 = (int)((t + 1) % kStages);
    const long long s1 = c0 + (t + 1) * kSites;
    stage_copy((int)((t + 3) % kStages), c0 + (t + 3) * kSites);
    cp_async_commit();
    mma_raw(buf, 0);
    fold_i(stage1, nxt, s1);
    mma_raw(buf, 1);
    fold_j(stage1, nxt);
    mma_raw(buf, 2);
    mma_cnt(buf);
    // at a window's end, add its float32 raw sums into float64
    if ((t + 1) % (kWindow / kSites) == 0 || t + 1 == steps) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            r64[i][j][r] += (double)(hh[i][j][r] + corr[i][j][r]);
            hh[i][j][r] = corr[i][j][r] = 0.0f;
          }
    }
    if constexpr (kBlocks) {
      // every 2^16 sites, add the float32 counts into the float64 partials
      if ((t + 1) % kCntFlushSteps == 0) {
        double* part_cnt = part_at(1);
        for_each_output([&](int mi, int ni, int r, int e) {
          part_cnt[e] = (cnt_flushed ? part_cnt[e] : 0.0) + (double)cn[mi][ni][r];
          cn[mi][ni][r] = 0.0f;
        });
        cnt_flushed = true;
      }
    }
    cp_async_wait<1>();  // step t+2 landed
    __syncthreads();     // ... for every thread; operands of step t+1 complete
  }
  cp_async_wait<0>();

  const bool direct = part == nullptr;  // one chunk: no scratch, no reduce
  double* part_raw = direct ? nullptr : part_at(0);
  double* part_cnt = direct ? nullptr : part_at(1);
  for_each_output([&](int mi, int ni, int r, int e) {
    if (direct) {
      const int a = i0 + e / kTile, b = j0 + e % kTile;
      if (a < N && b < N && a <= b) {
        raw[(long long)a * N + b] = (float)r64[mi][ni][r];
        cnt[(long long)a * N + b] = cn[mi][ni][r];
      }
    } else {
      part_raw[e] = r64[mi][ni][r];
      part_cnt[e] = (cnt_flushed ? part_cnt[e] : 0.0) + (double)cn[mi][ni][r];
    }
  });
}

// raw, cnt = sum over chunks 0, 1, ... in that order of the partials, for
// upper tile list[blockIdx.x] (every tile without a list); OutT: float
// (the f32 entry) or double (the f64 entry).
template <typename OutT>
__global__ void __launch_bounds__(256)
indep_reduce_kernel(const double* __restrict__ part, OutT* __restrict__ raw,
                    OutT* __restrict__ cnt, int N, int chunks, long long tiles,
                    const int* __restrict__ list) {
  const long long tile = list ? (long long)list[blockIdx.x] : (long long)blockIdx.x;
  if (tile < 0 || tile >= tiles) return;
  int ti, tj;
  ngsd::upper_tile(tile, &ti, &tj);
  const double* pr = part + tile * kTileElems;
  const double* pc = pr + (long long)chunks * tiles * kTileElems;
  for (int e = threadIdx.x; e < kTileElems; e += blockDim.x) {
    const int a = ti * kTile + e / kTile, b = tj * kTile + e % kTile;
    if (a >= N || b >= N || a > b) continue;
    double r = 0.0, c = 0.0;
    for (int k = 0; k < chunks; ++k) {
      r += pr[(long long)k * tiles * kTileElems + e];
      c += pc[(long long)k * tiles * kTileElems + e];
    }
    raw[(long long)a * N + b] = (OutT)r;
    cnt[(long long)a * N + b] = (OutT)c;
  }
}

// ------------------------------------------------------------------ //
// K1d: the float64 kernel                                             //
// ------------------------------------------------------------------ //

constexpr int kDSites = 8;          // sites per step: one m16n8k8 depth per plane
constexpr int kDStages = 2;         // cp.async ring: steps t + 1 (folded) and t + 2 (landing)
constexpr int kDPlanes = 4;         // operand planes: genotypes 0, 1, 2 (raw) and v (cnt)
constexpr int kDThreads = 128;      // 2 x 2 warps of 32 x 32 outputs
constexpr int kDRow = 3 * kTile;    // doubles of one side's staged row of a site

static_assert(kDThreads == 2 * kTile, "two fold units a thread and side");
static_assert(kDSites == 8, "a step is one k8 depth: sites k and k + 4 are a fragment pair");

// 114,816 bytes: two blocks fit on an SM (228 KB, 1 KB reserved a block).
// The folded operands are laid out as the MMA reads them, a thread's
// fragment pair one 16-byte word: the i side (A) as [k][row pair], the
// pair rows m, m + 8 of one 16-row block (pair index 8 (m / 16) + m % 8);
// the j side (B) as [k % 4][column][k / 4], the pair sites k, k + 4.
// Both swizzle the pair index by 2 (k % 4), which sends the 8 lanes of a
// quarter warp to 8 distinct 16-byte bank groups, for the fragment loads
// and the fold's stores alike.
struct SmemD {
  double ring[kDStages][2][kDSites][kDRow];  // staged P rows [stage][side][site][3 col + g]
  double opa[2][kDPlanes][kDSites][kTile / 2][2];  // i side [buf][plane][k][row pair ^][2]
  double opb[2][kDPlanes][4][kTile][2];            // j side [buf][plane][k % 4][column ^][k / 4]
  double wt[kDStages][kDSites];              // staged site weights [stage][site]
};

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem),
               "r"(full ? 8 : 0)
               : "memory");
}

// d += A B on a 16x8x8 float64 tile (sm_90): A row-major with entries
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B
// column-major with b0 (t, g), b1 (t + 4, g); d (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1); g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_f64(double (&d)[4], double2 a01, double2 a23, double2 b) {
#ifdef NGSD_INDEP_F64_SKIP_MMA
  d[0] = __longlong_as_double(__double_as_longlong(d[0]) ^ __double_as_longlong(a01.x) ^
                              __double_as_longlong(a01.y) ^ __double_as_longlong(a23.x) ^
                              __double_as_longlong(a23.y) ^ __double_as_longlong(b.x) ^
                              __double_as_longlong(b.y));
#else
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a01.x), "d"(a01.y), "d"(a23.x), "d"(a23.y), "d"(b.x), "d"(b.y));
#endif
}

// The fold of one staged triple p into its four operand values: the
// validity v (row nonzero, and under pairwise deletion not missing) as a
// predicate, o[g] = P_g v ws (i side, ws the site weight) or
// sum_h score[g][h] P_h v (j side), o[3] = v ws or v.  Masks multiply, so
// a NaN row stays NaN.
template <bool kSideI, bool kWeighted, bool kPairwiseDel>
__device__ __forceinline__ void fold_f64(const double* p, double ws, const ngsd::Score9d& sc,
                                         double (&o)[4]) {
  const double p0 = p[0], p1 = p[1], p2 = p[2];
#ifdef NGSD_INDEP_F64_SKIP_FOLD
  o[0] = p0;
  o[1] = p1;
  o[2] = p2;
  o[3] = ws;
#else
  // bitwise, not short-circuit: no branch, so the folds interleave
  bool valid = (p0 + p1 + p2) > 0.0;
  if (kPairwiseDel)
    valid &= (fabs(p0 - p1) >= ngsd::kEpsilonD) | (fabs(p1 - p2) >= ngsd::kEpsilonD);
  const double v = valid ? 1.0 : 0.0;
  if (kSideI) {
    const double vi = kWeighted ? v * ws : v;
    o[0] = p0 * vi;
    o[1] = p1 * vi;
    o[2] = p2 * vi;
    o[3] = vi;
  } else {
    const double x0 = p0 * v, x1 = p1 * v, x2 = p2 * v;
#pragma unroll
    for (int g = 0; g < 3; ++g)
      o[g] = sc.v[3 * g + 0] * x0 + sc.v[3 * g + 1] * x1 + sc.v[3 * g + 2] * x2;
    o[3] = v;
  }
#endif
}

// Launched, and its arguments read, as indep_mma_kernel; P, w, raw and cnt
// in float64.  kVec16: every row starts on 16 bytes (N even, P aligned).
template <bool kWeighted, bool kPairwiseDel, bool kVec16>
__global__ void __launch_bounds__(kDThreads, 2)
indep_f64_kernel(const double* __restrict__ P, const double* __restrict__ w,
                 double* __restrict__ raw, double* __restrict__ cnt,
                 double* __restrict__ part, long long S, int N, long long tiles,
                 const int* __restrict__ list, long long grid_tiles, long long chunk_sites,
                 ngsd::Score9d sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemD& sm = *reinterpret_cast<SmemD*>(smem_raw);

  const long long pos = blockIdx.x % grid_tiles, chunk = blockIdx.x / grid_tiles;
  const long long tile = list ? (long long)list[pos] : pos;
  if (tile < 0 || tile >= tiles) return;  // not an upper tile: the whole block leaves
  int ti, tj;
  ngsd::upper_tile(tile, &ti, &tj);
  const int i0 = ti * kTile, j0 = tj * kTile;
  const long long c0 = chunk * chunk_sites;
  const long long c_end = c0 + chunk_sites < S ? c0 + chunk_sites : S;
  const long long steps = c_end > c0 ? (c_end - c0 + kDSites - 1) / kDSites : 0;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int m0 = (warp / 2) * 32, n0 = (warp % 2) * 32;
  // This thread's copies: warp w stages sites 2 w and 2 w + 1 of both
  // sides, lane l the 16-byte pieces l, l + 32, l + 64 of each row (8-byte
  // pieces l + 32 c, c < 6, unless kVec16), so that a piece's address is
  // the side's base pointer plus a constant.  Pieces past the chunk end or
  // past N are zero filled (a copy of 0 bytes reads nothing), so the steps
  // past the last are staged like any other.  Weighted: the step's 8
  // site weights.
  constexpr int kC = kVec16 ? 2 : 1, kPerRow = kDRow / kC / 32;
  const double* src_side[2];
  int valid_side[2];  // doubles of a row inside N
#pragma unroll
  for (int sd = 0; sd < 2; ++sd) {
    const int col0 = sd == 0 ? i0 : j0;
    src_side[sd] = P + (c0 + 2 * warp) * 3 * (long long)N + 3 * col0 + kC * lane;
    valid_side[sd] = 3 * (N - col0);
  }
  const long long row_stride = 3 * (long long)N;
  auto stage_copy = [&](int stage, long long s0) {
#ifndef NGSD_INDEP_F64_SKIP_LOAD
#pragma unroll
    for (int sd = 0; sd < 2; ++sd)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = 2 * warp + rr;
        const bool live = s0 + row < c_end;
        const double* src = src_side[sd] + ((s0 - c0) + rr) * row_stride;
#pragma unroll
        for (int c = 0; c < kPerRow; ++c) {
          const int f = kC * (lane + 32 * c);
          const bool ok = live && f < valid_side[sd];
          if (kVec16)
            cp_async16(&sm.ring[stage][sd][row][f], src + kC * 32 * c, ok);
          else
            cp_async8(&sm.ring[stage][sd][row][f], src + kC * 32 * c, ok);
        }
      }
    if (kWeighted && tid < kDSites) {
      const long long s = s0 + tid;
      cp_async8(&sm.wt[stage][tid], s < c_end ? w + s : w, s < c_end);
    }
#endif
  };

  // The fold of the step staged in `stage` into operand buffer buf, once
  // for the block, each thread two units a side (u = 0, 1): on the i side
  // the rows m, m + 8 of pair `lane` at site warp + 4 u; on the j side
  // column tid % 64 at sites j, j + 4 for j = tid / 64 + 2 u.  One 16-byte
  // store per unit and plane.
  const int qa = lane, ma = 16 * (lane / 8) + lane % 8;
  const int nb = tid % kTile, jb = tid / kTile;
  auto fold_i = [&](int stage, int buf, int u) {
    const int k = warp + 4 * u;
    const double ws = kWeighted ? sm.wt[stage][k] : 1.0;
    double o[2][kDPlanes];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      fold_f64<true, kWeighted, kPairwiseDel>(&sm.ring[stage][0][k][3 * (ma + 8 * e)], ws, sc,
                                              o[e]);
#pragma unroll
    for (int pl = 0; pl < kDPlanes; ++pl)
      *reinterpret_cast<double2*>(&sm.opa[buf][pl][k][qa ^ (2 * (k % 4))][0]) =
          make_double2(o[0][pl], o[1][pl]);
  };
  auto fold_j = [&](int stage, int buf, int u) {
    const int j = jb + 2 * u;
    double o[2][kDPlanes];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      fold_f64<false, kWeighted, kPairwiseDel>(&sm.ring[stage][1][j + 4 * e][3 * nb], 1.0, sc,
                                               o[e]);
#pragma unroll
    for (int pl = 0; pl < kDPlanes; ++pl)
      *reinterpret_cast<double2*>(&sm.opb[buf][pl][j][nb ^ (2 * j)][0]) =
          make_double2(o[0][pl], o[1][pl]);
  };

  // Per thread: 2 x 4 m16n8 tiles of raw and of cnt, four entries each.
  double acc[2][4][4], cn[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = cn[mi][ni][r] = 0.0;

  // Plane pl of operand buffer buf into d: 4 + 4 128-bit fragment loads,
  // 8 MMAs of one k8 depth.
  auto mma_plane = [&](int buf, int pl, double (&d)[2][4][4]) {
    double2 a[2][2], b[4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[mi][h] = *reinterpret_cast<const double2*>(
            &sm.opa[buf][pl][t4 + 4 * h][(8 * (m0 / 16 + mi) + g) ^ (2 * t4)][0]);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      b[ni] = *reinterpret_cast<const double2*>(
          &sm.opb[buf][pl][t4][(n0 + 8 * ni + g) ^ (2 * t4)][0]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_f64(d[mi][ni], a[mi][0], a[mi][1], b[ni]);
  };

  // Pipeline: step t's rows are copied two steps ahead into a ring of two
  // stages; step t + 1 is folded into the other operand buffer while step
  // t runs on the tensor cores, plane by plane in one basic block; one
  // barrier per step.  A stage is copied into again, and a buffer folded
  // into again, only after the barrier that every thread passes when done
  // with it.
  stage_copy(0, c0);
  cp_async_commit();
  stage_copy(1, c0 + kDSites);
  cp_async_commit();
  cp_async_wait<1>();  // step 0 landed
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    fold_i(0, 0, u);
    fold_j(0, 0, u);
  }
  cp_async_wait<0>();  // step 1 landed
  __syncthreads();
  for (long long t = 0; t < steps; ++t) {
    const int cur = (int)(t & 1), nxt = cur ^ 1;
    stage_copy(cur, c0 + (t + 2) * kDSites);  // step t's stage was folded a step ago
    cp_async_commit();
    mma_plane(cur, 0, acc);
    fold_i(nxt, nxt, 0);
    mma_plane(cur, 1, acc);
    fold_i(nxt, nxt, 1);
    mma_plane(cur, 2, acc);
    fold_j(nxt, nxt, 0);
    mma_plane(cur, 3, cn);
    fold_j(nxt, nxt, 1);
    cp_async_wait<0>();  // step t + 2 landed
    __syncthreads();     // ... for every thread; operands of step t + 1 complete
  }
  cp_async_wait<0>();

  const bool direct = part == nullptr;  // one chunk: no scratch, no reduce
  auto part_at = [&](int plane) {
    return part +
           ((plane * (long long)(gridDim.x / grid_tiles) + chunk) * tiles + tile) * kTileElems;
  };
  double* part_raw = direct ? nullptr : part_at(0);
  double* part_cnt = direct ? nullptr : part_at(1);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + 16 * mi + 8 * h + g, c = n0 + 8 * ni + 2 * t4;
        if (direct) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int a = i0 + r, b = j0 + c + q;
            if (a < N && b < N && a <= b) {
              raw[(long long)a * N + b] = acc[mi][ni][2 * h + q];
              cnt[(long long)a * N + b] = cn[mi][ni][2 * h + q];
            }
          }
        } else {
          *reinterpret_cast<double2*>(part_raw + r * kTile + c) =
              make_double2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
          *reinterpret_cast<double2*>(part_cnt + r * kTile + c) =
              make_double2(cn[mi][ni][2 * h], cn[mi][ni][2 * h + 1]);
        }
      }
}

template <bool kWeighted>
cudaError_t launch_f64(const double* P, const double* w, double* raw, double* cnt,
                       double* part, long long S, int N, long long tiles, const int* list,
                       long long grid_tiles, long long chunks, long long chunk_sites,
                       const ngsd::Score9d& sc, int pairwise_del, cudaStream_t stream) {
  // 16-byte copies when every row starts on 16 bytes
  const bool vec16 = N % 2 == 0 && reinterpret_cast<uintptr_t>(P) % 16 == 0;
  auto go = [&](auto kernel) {
    const int bytes = (int)sizeof(SmemD);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)  // two blocks an SM need the largest shared-memory carveout
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)(grid_tiles * chunks), kDThreads, bytes, stream>>>(
        P, w, raw, cnt, part, S, N, tiles, list, grid_tiles, chunk_sites, sc);
    return cudaGetLastError();
  };
  if (vec16)
    return pairwise_del ? go(indep_f64_kernel<kWeighted, true, true>)
                        : go(indep_f64_kernel<kWeighted, false, true>);
  return pairwise_del ? go(indep_f64_kernel<kWeighted, true, false>)
                      : go(indep_f64_kernel<kWeighted, false, false>);
}

// grid_tiles: the length of `list`, or tiles without one.
template <bool kWeighted, bool kVec16, bool kPairwiseDel, bool kBlocks>
cudaError_t launch(const float* P, const float* w, float* raw, float* cnt, double* part,
                   long long S, int N, long long tiles, const int* list, long long grid_tiles,
                   long long chunks, long long chunk_sites, const ngsd::Score9& sc,
                   cudaStream_t stream) {
  auto kernel = indep_mma_kernel<kWeighted, kVec16, kPairwiseDel, kBlocks>;
  const int bytes = (int)sizeof(Smem);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(grid_tiles * chunks), kThreads, bytes, stream>>>(
      P, w, raw, cnt, part, S, N, tiles, list, grid_tiles, chunk_sites, sc);
  return cudaGetLastError();
}

template <bool kWeighted, bool kBlocks>
cudaError_t launch(const float* P, const float* w, float* raw, float* cnt, double* part,
                   long long S, int N, long long tiles, const int* list, long long grid_tiles,
                   long long chunks, long long chunk_sites, const ngsd::Score9& sc,
                   int pairwise_del, cudaStream_t stream) {
  // 16-byte copies when every row starts on 16 bytes
  const bool vec16 = N % 4 == 0 && reinterpret_cast<uintptr_t>(P) % 16 == 0;
  auto go = [&](auto vec, auto pdel) {
    return launch<kWeighted, decltype(vec)::value, decltype(pdel)::value, kBlocks>(
        P, w, raw, cnt, part, S, N, tiles, list, grid_tiles, chunks, chunk_sites, sc, stream);
  };
  using T = std::true_type;
  using F = std::false_type;
  if (vec16) return pairwise_del ? go(T{}, T{}) : go(T{}, F{});
  return pairwise_del ? go(F{}, T{}) : go(F{}, F{});
}

long long upper_tiles(int N) {
  const long long nt = (N + kTile - 1) / kTile;
  return nt * (nt + 1) / 2;
}

}  // namespace

// list [n_list] int32 upper-tile indices on the card, or null for every
// upper tile: only the listed tiles of raw and cnt are written.
extern "C" int ngsd_indep_raw_cnt_f32(const float* P, const float* w, float* raw, float* cnt,
                                      double* scratch, const int* list, long long n_list,
                                      long long S, int N, int chunks, long long chunk_sites,
                                      const float* score9, int pairwise_del, void* stream) {
  const long long tiles = N < 1 ? 0 : upper_tiles(N);
  const long long grid_tiles = list != nullptr ? n_list : tiles;
  if (N < 1 || S < 0 || chunks < 1 || chunk_sites < kWindow || chunk_sites % kWindow != 0 ||
      chunk_sites > (1 << 16) || (long long)chunks * chunk_sites < S ||
      (chunks > 1) != (scratch != nullptr) || grid_tiles < 1 ||
      grid_tiles * chunks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  ngsd::Score9 sc;
  memcpy(sc.v, score9, sizeof(sc.v));
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      w != nullptr
          ? launch<true, false>(P, w, raw, cnt, scratch, S, N, tiles, list, grid_tiles, chunks,
                                chunk_sites, sc, pairwise_del, st)
          : launch<false, false>(P, w, raw, cnt, scratch, S, N, tiles, list, grid_tiles, chunks,
                                 chunk_sites, sc, pairwise_del, st);
  if (err != cudaSuccess || chunks == 1) return (int)err;
  indep_reduce_kernel<float><<<(unsigned)grid_tiles, 256, 0, st>>>(scratch, raw, cnt, N, chunks,
                                                                   tiles, list);
  return (int)cudaGetLastError();
}

// Block mode: P [n_blocks * block_size, N, 3] float32; part [2, n_blocks,
// tiles, 64, 64] float64 receives each block's unweighted raw and cnt
// partials, every entry of every tile written (the caller reads the
// upper triangle).
extern "C" int ngsd_indep_block_partials_f32(const float* P, double* part, int N,
                                             long long n_blocks, long long block_size,
                                             const float* score9, int pairwise_del,
                                             void* stream) {
  const long long tiles = N < 1 ? 0 : upper_tiles(N);
  if (N < 1 || n_blocks < 1 || block_size < 1 || part == nullptr ||
      tiles * n_blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  ngsd::Score9 sc;
  memcpy(sc.v, score9, sizeof(sc.v));
  return (int)launch<false, true>(P, nullptr, nullptr, nullptr, part, n_blocks * block_size, N,
                                  tiles, nullptr, tiles, n_blocks, block_size, sc, pairwise_del,
                                  (cudaStream_t)stream);
}

// The float64 entries (K1d): P [S, N, 3] and w [S] float64, the score
// float64[9], raw and cnt [N, N] float64; otherwise as
// ngsd_indep_raw_cnt_f32 (the same split, tile list and scratch layout).
extern "C" int ngsd_indep_raw_cnt_f64(const double* P, const double* w, double* raw,
                                      double* cnt, double* scratch, const int* list,
                                      long long n_list, long long S, int N, int chunks,
                                      long long chunk_sites, const double* score9,
                                      int pairwise_del, void* stream) {
  const long long tiles = N < 1 ? 0 : upper_tiles(N);
  const long long grid_tiles = list != nullptr ? n_list : tiles;
  if (N < 1 || S < 0 || chunks < 1 || chunk_sites < 1 || (long long)chunks * chunk_sites < S ||
      (chunks > 1) != (scratch != nullptr) || grid_tiles < 1 ||
      grid_tiles * chunks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  ngsd::Score9d sc;
  memcpy(sc.v, score9, sizeof(sc.v));
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      w != nullptr
          ? launch_f64<true>(P, w, raw, cnt, scratch, S, N, tiles, list, grid_tiles, chunks,
                             chunk_sites, sc, pairwise_del, st)
          : launch_f64<false>(P, w, raw, cnt, scratch, S, N, tiles, list, grid_tiles, chunks,
                              chunk_sites, sc, pairwise_del, st);
  if (err != cudaSuccess || chunks == 1) return (int)err;
  indep_reduce_kernel<double><<<(unsigned)grid_tiles, 256, 0, st>>>(scratch, raw, cnt, N,
                                                                    chunks, tiles, list);
  return (int)cudaGetLastError();
}

// Block mode on float64 probabilities: part [2, n_blocks, tiles, 64, 64]
// float64 as ngsd_indep_block_partials_f32's; the counts are float64
// throughout, so a block of any length needs no flush.
extern "C" int ngsd_indep_block_partials_f64(const double* P, double* part, int N,
                                             long long n_blocks, long long block_size,
                                             const double* score9, int pairwise_del,
                                             void* stream) {
  const long long tiles = N < 1 ? 0 : upper_tiles(N);
  if (N < 1 || n_blocks < 1 || block_size < 1 || part == nullptr ||
      tiles * n_blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  ngsd::Score9d sc;
  memcpy(sc.v, score9, sizeof(sc.v));
  return (int)launch_f64<false>(P, nullptr, nullptr, nullptr, part, n_blocks * block_size, N,
                                tiles, nullptr, tiles, n_blocks, block_size, sc, pairwise_del,
                                (cudaStream_t)stream);
}

extern "C" const char* ngsd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
