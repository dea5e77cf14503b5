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
// kernel of its own (indep_f64_kernel): the fold (mask, weight, score)
// in float64 into double-buffered operand tiles in shared memory, then
// mma.sync m8n8k4 with .f64 operands and float64 accumulators for raw and
// cnt alike, so no split of the operands, no window and no count flush.
// 128 threads own a 64 x 64 tile, 2 x 2 warps of 32 x 32; each thread
// prefetches its next step's 4 sites into registers while the tensor
// cores run the current one; one barrier per step.  Operand rows are
// padded 64 -> 68 doubles: fragment loads are free of bank conflicts.
// What bounds it: the FP64 tensor cores (67 TFLOP/s dense on an H100
// SXM); every two m8n8k4 take one 8-byte fragment load from shared
// memory, so shared-memory bandwidth is about as tight.  A simple first
// kernel (PERF.md has its time beside its bound); the sums' order is
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

constexpr int kDSites = 4;            // sites per step: one m8n8k4 depth per genotype
constexpr int kDK = 3 * kDSites;      // raw reduction depth per step
constexpr int kDThreads = 128;        // 2 x 2 warps of 32 x 32 outputs
constexpr int kDLd = kTile + 4;       // padded operand row (doubles)

static_assert(kDThreads == 2 * kTile, "one thread per side and column of a tile");

// One step's operands, double-buffered: 34,816 bytes.
struct SmemD {
  double a[2][kDK][kDLd];       // i side: P_g * v * w, k = g * kDSites + site
  double b[2][kDK][kDLd];       // j side: score-folded P * v
  double va[2][kDSites][kDLd];  // i side: v * w
  double vb[2][kDSites][kDLd];  // j side: v
};

// d += a * b on an 8x8x4 float64 tile: a the row-major A's entry (row
// lane/4, column lane%4), b the column-major B's (row lane%4, column
// lane/4), d the two entries (row lane/4, columns 2 (lane%4) + 0, 1).
__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// Launched, and its arguments read, as indep_mma_kernel; P, w, raw and cnt
// in float64.
template <bool kWeighted, bool kPairwiseDel>
__global__ void __launch_bounds__(kDThreads)
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
  // this thread's fold column: side (0: i, 1: j) and individual col
  const int side = tid / kTile, col = tid % kTile;
  const int ind = (side == 0 ? i0 : j0) + col;

  // The step's triples of this thread's individual, zero past the chunk
  // end or past N (an all-zero row is inert).
  double q[kDSites][3];
  auto fetch = [&](long long s0) {
#pragma unroll
    for (int sl = 0; sl < kDSites; ++sl) {
      const long long s = s0 + sl;
      q[sl][0] = q[sl][1] = q[sl][2] = 0.0;
      if (s < c_end && ind < N) {
        const double* p = P + (s * N + ind) * 3;
        q[sl][0] = p[0];
        q[sl][1] = p[1];
        q[sl][2] = p[2];
      }
    }
  };
  // Fold the fetched triples into operand buffer buf: the validity mask,
  // the missing test, the weight (i side) or the score (j side).  Masks
  // multiply, so a NaN row stays NaN.
  auto fold = [&](int buf, long long s0) {
#pragma unroll
    for (int sl = 0; sl < kDSites; ++sl) {
      const double p0 = q[sl][0], p1 = q[sl][1], p2 = q[sl][2];
      double v = (p0 + p1 + p2) > 0.0 ? 1.0 : 0.0;
      if (kPairwiseDel) v = v * ngsd::nonmissing(p0, p1, p2);
      if (side == 0) {
        const long long s = s0 + sl;
        const double vi = (kWeighted && s < c_end) ? v * w[s] : v;
        sm.a[buf][0 * kDSites + sl][col] = p0 * vi;
        sm.a[buf][1 * kDSites + sl][col] = p1 * vi;
        sm.a[buf][2 * kDSites + sl][col] = p2 * vi;
        sm.va[buf][sl][col] = vi;
      } else {
        const double x0 = p0 * v, x1 = p1 * v, x2 = p2 * v;
#pragma unroll
        for (int gg = 0; gg < 3; ++gg)
          sm.b[buf][gg * kDSites + sl][col] =
              sc.v[3 * gg + 0] * x0 + sc.v[3 * gg + 1] * x1 + sc.v[3 * gg + 2] * x2;
        sm.vb[buf][sl][col] = v;
      }
    }
  };

  // Per thread: 4 x 4 m8n8 tiles of raw and of cnt, two entries each.
  double acc[4][4][2], cn[4][4][2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 2; ++r) acc[mi][ni][r] = cn[mi][ni][r] = 0.0;

  // k-step k0 of operand rows A[k][m], B[k][n] into d
  auto mma_step = [&](const double (*A)[kDLd], const double (*B)[kDLd], int k0,
                      double (&d)[4][4][2]) {
    double a[4], b[4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) a[mi] = A[k0 + t4][m0 + 8 * mi + g];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) b[ni] = B[k0 + t4][n0 + 8 * ni + g];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_f64(d[mi][ni], a[mi], b[ni]);
  };

  // Step t: fold its triples (fetched during step t - 1) into buffer
  // t & 1, one barrier, fetch step t + 1's, run step t on the tensor
  // cores.  A buffer is folded again two steps later, after the barrier
  // that every warp passes only when done with it.
  fetch(c0);
  for (long long t = 0; t < steps; ++t) {
    const int buf = (int)(t & 1);
    const long long s0 = c0 + t * kDSites;
    fold(buf, s0);
    __syncthreads();
    if (t + 1 < steps) fetch(s0 + kDSites);
#pragma unroll
    for (int gk = 0; gk < 3; ++gk) mma_step(sm.a[buf], sm.b[buf], gk * kDSites, acc);
    mma_step(sm.va[buf], sm.vb[buf], 0, cn);
  }

  const bool direct = part == nullptr;  // one chunk: no scratch, no reduce
  auto part_at = [&](int plane) {
    return part +
           ((plane * (long long)(gridDim.x / grid_tiles) + chunk) * tiles + tile) * kTileElems;
  };
  double* part_raw = direct ? nullptr : part_at(0);
  double* part_cnt = direct ? nullptr : part_at(1);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = (m0 + 8 * mi + g) * kTile + n0 + 8 * ni + 2 * t4 + r;
        if (direct) {
          const int a = i0 + e / kTile, b = j0 + e % kTile;
          if (a < N && b < N && a <= b) {
            raw[(long long)a * N + b] = acc[mi][ni][r];
            cnt[(long long)a * N + b] = cn[mi][ni][r];
          }
        } else {
          part_raw[e] = acc[mi][ni][r];
          part_cnt[e] = cn[mi][ni][r];
        }
      }
}

// Below the 48 KB a block gets without asking for more.
static_assert(sizeof(SmemD) <= 48 * 1024, "static shared-memory limit");

template <bool kWeighted>
cudaError_t launch_f64(const double* P, const double* w, double* raw, double* cnt,
                       double* part, long long S, int N, long long tiles, const int* list,
                       long long grid_tiles, long long chunks, long long chunk_sites,
                       const ngsd::Score9d& sc, int pairwise_del, cudaStream_t stream) {
  auto go = [&](auto kernel) {
    kernel<<<(unsigned)(grid_tiles * chunks), kDThreads, sizeof(SmemD), stream>>>(
        P, w, raw, cnt, part, S, N, tiles, list, grid_tiles, chunk_sites, sc);
    return cudaGetLastError();
  };
  return pairwise_del ? go(indep_f64_kernel<kWeighted, true>)
                      : go(indep_f64_kernel<kWeighted, false>);
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
