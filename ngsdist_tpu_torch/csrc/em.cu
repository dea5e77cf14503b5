// Pairwise-EM sufficient statistics on Hopper.
//
// Replaces: ngsdist_tpu/ops/pallas_em.py, the Pallas kernel _em_kernel
// with its slab body _em_slab (entry em_raw_cnt_pallas).
//
// Per pair a < b and site s it runs the converged 9-cell EM of the
// reference (emOptim2.cpp, tole 0.001, 50 iterations) in the rank-1 power
// form of _em_slab: with p = P / max(P) per individual and
// t_k = sum_g p_g^k, the EM stops at the first step k (1..49) where
// rI_k * rJ_k < exp(0.001), r_k = t_{k+1} t_{k-1} / t_k^2, giving
// k* = k (50 when no step converges).  The lane then adds
//   w * m * sum_{g,h} score[g,h] x_g y_h / (sum x * sum y),  x = p^{k*}
// to raw and w * m to cnt, with m = 1 for live lanes (both rows nonzero)
// times, under pairwise deletion, both rows' not-missing flags.  Dead
// lanes (an all-zero row) add nothing.  NaN rows propagate: the row max
// keeps NaN, and masks multiply.
//
// Precision: the probabilities arrive as float32 (ngsd_em_*_f32) or
// float64 (ngsd_em_*_f64, the --x64 runs), and the EM runs in float64
// either way (p/max, the power sums, the ratio test against hi =
// exp(0.001) and the final powers); the two entries are one template,
// differing in the loads, the weights and the stored raw and cnt, which
// the f32 entry rounds to float32 once.  The stopping step is a threshold decision: in
// float32, rounding near the threshold moves k* by one step for roughly
// one lane in a thousand, and one such step shifts a lane's contribution
// by up to ~1e-2.  In float64 the kernel takes the decisions of the
// float64 plain version on the same inputs: r_k is computed with that
// version's expressions in its order, and never depended on the pair.
// The powers x = p^{k*} come from k* - 1 sequential multiplications by p
// (each within 2^-53 relative), where the plain version takes
// exp(k* log p): the two differ by a few tens of ulp, which moves a
// lane's contribution by at most 2^-45 max|score| (ops/em.py,
// EM_TABLE_LANE_BOUND, has the reckoning).
//
// Design.  Everything that depends on one individual only is computed
// once per (tile, site, individual) and shared by the tile's lanes.  One
// block of 256 threads owns an upper-triangular 32 x 32 tile of
// individuals; a thread owns the four pair lanes of four consecutive
// rows i and one column j, a warp four rows and 32 different j.  Per step
// of kSites = 2 sites:
//   build:  128 threads (one per side, site and individual) walk
//           k = 1..49 once and write to shared memory the ratio r_k and
//           every third power p^{1+3c} (c = 0..16), from which a lane
//           reaches any p^{k*}, k* <= 50, with at most two more
//           multiplications by p, bit for bit the sequential product.
//           Each thread's next triple is read from device memory a step
//           ahead.
//   search: a lane's stopping test is !(rI[k] * rJ[k] >= hi).  A thread
//           loads rJ[k] once for its four rows (32 consecutive doubles
//           per warp) and the four rI[k] as two 16-byte broadcasts, seven
//           steps at a time so that the loads and the float64 multiplies
//           of a group overlap; then x, y from the power tables, the
//           9-cell contraction and one division.  No log, no exp, no
//           per-individual work in the lanes.
// The tables take 800 bytes per (site, individual): 392 for r_k, 408 for
// the powers; 128 of them are 100 KB, so two blocks share an SM and one
// block's build overlaps the other's search.  The i side's powers are
// laid out [individual][c][g], so that a warp's lanes, which share i and
// differ in c, fall on different banks; the j side's [c][g][individual],
// so that lanes on consecutive j do.
// A table is always built to its full depth: r_k >= 1 only up to
// rounding and is not monotone in k, so no r_k of one individual proves
// that every partner has stopped.
//
// What bounds it on the card: float64 issue (64 lanes per clock and SM)
// and the latency of its dependent chains, not memory.  A lane-site
// costs about two float64 instructions per search step in warp lockstep
// (a warp runs to its slowest lane, ~26 steps where the mean lane stops
// after 13), ~45 for powers, contraction and division, and a 1/16 share
// of two ~850-instruction tables.  profile_em_parts.py times the kernel
// with each part taken out (the NGSD_EM_SKIP_* switches below).  One pair
// lane per thread (1024 threads, four sites a step, one block per SM)
// was slower: the four rows per thread cut the shared-memory loads of the
// search to a third, and the unrolled groups hide their latency.
// Building the tables to depth 36 first and to 49 only where a block-wide
// vote finds a lane still running was a few percent faster; left out for
// its second code path.  A 64-wide tile would halve the tables' share
// but give a quarter of the blocks.
//
// Site slices (full mode).  The grid is tiles x G: block (k, g) runs
// tile k over site slice g of G (site_slice: 2-site steps split evenly,
// so every slice but the last ends on a step).  Every (pair, site) lane
// converges on its own, and a pair's raw and cnt are plain sums over
// sites, so a slice changes no lane's arithmetic, only the order of the
// float64 additions.  The wrapper (ops/em.py em_site_slices) picks G from
// the tile count, the site count, the SMs and the resident blocks per SM:
// the G that fills the most of the waves it needs, each slice at least
// 4,096 sites.  Two blocks of 100 KB fit an SM, so 264 blocks run at
// once: at 1024 individuals the 528 tiles are two whole waves (G = 1),
// at 179 the 21 tiles would leave 111 of the 132 SMs empty (G = 25 gives
// 525 blocks, 99.4% of two waves), at 1,092 the 630 tiles' third wave is
// 39% full (G = 5: 99.4% of 12).
//
// Sums are kept per lane in float64 registers, in site order.  With G = 1
// they are written once, rounded to T, strict upper triangle only.  With
// G > 1 each block writes its slice's float64 sums for every lane of its
// tile to a scratch [G, tiles, sums, 1024] the wrapper allocates (2 sums,
// raw and cnt, for one weight row), and a second kernel on the same
// stream (em_kernel_sum_slices) adds each lane's G sums in slice order
// g = 0..G-1 in float64 and writes raw and cnt as the one-pass kernel
// does.  No atomics: the order of every addition is fixed, so reruns are
// byte-identical and the bytes do not depend on which block ran first;
// G = 1 writes the one-pass bytes.
//
// Weight rows (full mode; em_kernel_rows, ngsd_em_raw_cnt_rows_*).  A
// lane's stopping step, powers and contribution do not depend on the site
// weight, which only scales what the lane adds.  So the bootstrap
// replicates of a job, which weigh the same n_trunc sites, go in groups:
// w [rows, S], one launch a group.  Each lane builds its tables, runs its
// search and does its contraction once a site, then adds w[r][s] * v into
// kWeightRows = 8 float64 sums (slots): raw of row r in slot r, or under
// pairwise deletion raw in slot 2r and cnt (w[r][s] * m) in 2r + 1, so 4
// rows; without it cnt is not kept, as its reader then divides by the
// sites used.  A slot keeps the one-row kernel's order (site order within
// a slice, slices added in order by em_kernel_sum_slices from a scratch
// [G, tiles, 8, 1024]) and its single rounding to T, and G is the one-row
// launch's, so row r holds the bytes of the one-row launch with weights
// w[r].  For that the lanes' float64 arithmetic is written as explicit
// roundings (dmul, dadd, dfma, __ddiv_rn): left to the compiler, a * b + c
// is fused or not as the assembler's register allocation suggests, and
// the two kernels, and the slots of one, then rounded a float64 row's
// sums apart by an ulp (6,363 and 6,602 of the 595,686 pairs of two rows
// at 1,092 x 32,765; the float32 entry's rounding hid it).  The one-row
// kernel rounds as written too: the x64 goldens keep their md5 and its
// time is unchanged.
// Registers (ptxas -v, sm_90a): em_kernel 90-100, no spills; em_kernel_rows
// the 128 of two blocks an SM, with 24-32 bytes of stack (28-36 bytes of
// spill stores, 84-92 of loads): one launch of 8 rows takes 1.12x one
// row's time at 1,092 x 32,765 on an H100.  4 slots spill nothing and take
// 1.05x, 8 rows in two launches 2.1x; 8 slots at one block an SM (no
// spills) take 1.79x.  Shared memory cannot hold the slots beside two
// blocks' 100 KB tables.
//
// Site list (full mode): with `sites` [S] given, step s of the loop reads
// site sites[s] of P and weight w[s], so that a caller whose weights are 0
// on most sites (a substitution class of evolutionary models 3-6, a
// bootstrap replicate) pays for the listed sites only.  A lane adds its
// terms in list order, and a site left out would have added w * x = 0 to
// both sums, so at G = 1 an ascending list of every site of nonzero
// weight gives the bytes of the run over all sites (slices cut list
// positions, so at G > 1 the two group the sums differently).  The one
// exception, a site of
// weight 0 that holds a NaN (0 * NaN), is the caller's to keep in the list.
//
// Tile list (full mode; replaces the blocks= argument of em_raw_cnt_pallas,
// pallas_em.py:349, :364-372, :390-393): with `tiles` [L] int32 given, the
// grid has L blocks and block k owns upper tile tiles[k] in place of tile k;
// only those tiles of raw and cnt are written.  Every lane of a tile is
// independent of the others, so a listed tile holds the bytes of the full
// launch at the same G, with or without a site list (the wrapper's G
// follows L, the list's length).  A pairs-axis shard of the mesh engine
// (parallel/mesh.py) lists the tiles that hold its slice of the pair list.
//
// Block mode (ngsd_em_block_partials_f32), for the partial-sum bootstrap:
// replaces the want_blocks output of ngsdist_tpu/core/distance.py _em_scan
// (:418, a lax.scan there).  Unweighted; each lane writes its float64
// sums B[b, p] = sum_{s in b} contrib * m and C[b, p] = sum_{s in b} m for
// every bootstrap block b of block_size sites, and resets them, when its
// site loop crosses the block's end.  Blocks need not align with the
// 2-site step.  p is the pair's index in triu row-major order.
// A float32 search with a float64 re-check near the threshold is later
// work.
//
// Float64 entries (ngsd_em_raw_cnt_f64, ngsd_em_block_partials_f64; K2d)
// for --x64, where the JAX package runs the XLA functions em_suffstats
// and _em_scan (ngsdist_tpu/core/distance.py:545, :418) in float64: the
// same kernel instantiated for double inputs and weights, the score taken
// in float64, raw and cnt written in float64.  The tables, the search and
// the stopping decisions are the float32 entry's; the lane work was
// float64 already, so the operations bound is the same and only the
// input's bytes double.

#include <limits.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"

// Timing switches of profile_em_parts.py: a part taken out gives wrong
// results and the time of what is left.  Never set in the port's build.
#ifndef NGSD_EM_SKIP_BUILD
#define NGSD_EM_SKIP_BUILD 0    // tables built at the first step only
#endif
#ifndef NGSD_EM_SKIP_SEARCH
#define NGSD_EM_SKIP_SEARCH 0   // every lane stops at k* = 1
#endif
#ifndef NGSD_EM_SKIP_CONTRACT
#define NGSD_EM_SKIP_CONTRACT 0  // a lane adds its k* instead of its contribution
#endif

namespace {

constexpr int kTile = 32;     // individuals per tile side: 1024 pair lanes
constexpr int kSites = 2;     // sites per step
constexpr int kRows = 4;      // rows of the tile (pair lanes) per thread
constexpr int kThreads = kTile * kTile / kRows;
constexpr int kSteps = 49;    // EM_MAX_ITER - 1 ratio tests
constexpr int kUnroll = 7;    // ratio tests per group of the search
constexpr int kStride = 3;    // every third power is stored,
constexpr int kPowers = 17;   // p^(1 + 3c) for c = 0..16
constexpr int kTableThreads = 2 * kSites * kTile;  // tables per step
constexpr int kLanes = kTile * kTile;  // pair lanes of a tile
constexpr int kWeightRows = 8;  // slots of em_kernel_rows (ops/em.py EM_WEIGHT_ROWS)

static_assert(kSteps == kStride * (kPowers - 1) + 1, "powers reach k* = 50");
static_assert(kSteps % kUnroll == 0, "whole groups of ratio tests");
static_assert(kTableThreads <= kThreads, "one thread per table");
static_assert(kRows == 4, "the i side's ratios are read as two double2");
static_assert(kWeightRows % 2 == 0, "pairwise deletion takes two slots a row");

// Shared memory, in doubles, then floats, then the weights of kW rows in
// the input's type T.
constexpr int kRSide = kSites * kSteps * kTile;        // r: [site][k][individual]
constexpr int kXSide = kSites * kPowers * 3 * kTile;   // powers, per side
constexpr int kFlags = 2 * kSites * kTile;             // live, valid: [side][site][individual]
template <typename T, int kW>
constexpr size_t kSmemBytes = sizeof(double) * 2 * (kRSide + kXSide) +
                              sizeof(float) * 2 * kFlags + sizeof(T) * kW * kSites;

using ngsd::Score9d;  // the score matrix in float64, as the lanes use it

// The lanes' float64 arithmetic, each operation rounded as written: nvcc
// leaves a plain a * b + c to the assembler, which fuses it into one FMA
// or not as its register allocation suggests, so that the same source
// line rounds differently in the two kernels and in the slots of one.
__device__ __forceinline__ double dmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double dadd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dfma(double a, double b, double c) { return __fma_rn(a, b, c); }

__device__ __forceinline__ int r_index(int sl, int k, int col) {
  return (sl * kSteps + k) * kTile + col;
}
// Powers of the i side: [site][individual][c][g].
__device__ __forceinline__ int xi_index(int sl, int col, int c, int g) {
  return ((sl * kTile + col) * kPowers + c) * 3 + g;
}
// Powers of the j side: [site][c][g][individual].
__device__ __forceinline__ int xj_index(int sl, int col, int c, int g) {
  return ((sl * kPowers + c) * 3 + g) * kTile + col;
}

// Slice g of G of S sites (or list positions): with n = ceil(S / 2)
// steps, [2 floor(g n / G), 2 floor((g + 1) n / G)) cut to [0, S), so that
// every bound but S is a multiple of the 2-site step; slice 0 of 1 is
// [0, S).  ops/em.py em_slice_bounds is the same.
__device__ __forceinline__ void site_slice(long long S, long long g, long long G,
                                           long long* begin, long long* end) {
  const long long n = (S + kSites - 1) / kSites;
  *begin = min(S, kSites * (g * n / G));
  *end = min(S, kSites * ((g + 1) * n / G));
}

// One individual's tables at one site: Rb[k] = r at step k, and through
// store(c, ...) the powers pn^(1 + 3c).  The expressions and their order
// are the plain version's (ops/em.py _em_sites).
template <typename Store>
__device__ __forceinline__ void build_tables(double pn0, double pn1, double pn2,
                                             double* Rb, Store store) {
  // Entering step k: PW_g = pn_g^(k+1), tm = t_k, tc = t_(k+1).
  double PW0 = pn0, PW1 = pn1, PW2 = pn2;
  double tm = 3.0, tc = pn0 + pn1 + pn2;
  store(0, PW0, PW1, PW2);
  auto step = [&](int k) {
    PW0 *= pn0; PW1 *= pn1; PW2 *= pn2;
    const double tn = PW0 + PW1 + PW2;
    Rb[k * kTile] = tn * tm / (tc * tc);
    tm = tc; tc = tn;
  };
  for (int c = 1; c < kPowers; ++c) {
#pragma unroll
    for (int u = 0; u < kStride; ++u) step(kStride * (c - 1) + u);
    store(c, PW0, PW1, PW2);  // pn^(1 + 3c)
  }
  step(kSteps - 1);
}

// T: the type of the probabilities, the weights, raw and cnt (float or
// double).  kBlocks: block mode; B, C [S / block_size, N (N - 1) / 2]
// float64 take the place of raw and cnt.  Block (k, g) runs site slice g
// of gridDim.y (site_slice); with more than one slice (full mode only) it
// writes its float64 sums to part [gridDim.y, gridDim.x, kSums, kLanes] in
// place of raw and cnt, for em_kernel_sum_slices.  kW: the weight rows of
// w [rows, S] (full mode) that a lane adds its terms to, rows <= kW; with
// kW = 1 the lane keeps raw and cnt of one row (em_kernel), else one sum a
// slot (em_kernel_rows): raw of row j, or under pairwise deletion raw and
// cnt of row j / 2 in slots j and j + 1 (rows <= kW / 2).
template <typename T, bool kBlocks, int kW>
__device__ __forceinline__ void em_body(
    const T* __restrict__ P, const T* __restrict__ w, int rows,
    const long long* __restrict__ sites, const int* __restrict__ tiles, T* __restrict__ raw,
    T* __restrict__ cnt, double* __restrict__ B, double* __restrict__ C,
    double* __restrict__ part, long long S, int N, long long block_size, const Score9d& sc,
    double hi, int pairwise_del) {
  static_assert(kW == 1 || (!kBlocks && kW % 2 == 0), "block mode keeps one row");
  constexpr int kSums = kW == 1 ? 2 : kW;  // float64 sums a lane keeps
  const bool paired = kW == 1 || pairwise_del;  // slots j, j + 1: raw, cnt of row j / 2
  extern __shared__ __align__(16) double smem[];
  double* R = smem;                 // [side] r tables
  double* X = R + 2 * kRSide;       // [side] power tables
  float* Live = reinterpret_cast<float*>(X + 2 * kXSide);  // 1 unless the row is all zero
  float* Val = Live + kFlags;       // not missing (pairwise deletion)
  T* Ws = reinterpret_cast<T*>(Val + kFlags);  // [weight row][site]

  const long long nt = (N + kTile - 1) / kTile;
  const long long tile = tiles ? (long long)tiles[blockIdx.x] : (long long)blockIdx.x;
  if (tile < 0 || tile >= nt * (nt + 1) / 2) return;  // not an upper tile: the block leaves
  int ti, tj;
  ngsd::upper_tile(tile, &ti, &tj);
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int li0 = kRows * (threadIdx.x / kTile), lj = threadIdx.x % kTile;
  long long s_begin, s_end;  // this block's sites (list positions)
  site_slice(S, blockIdx.y, gridDim.y, &s_begin, &s_end);
  const int b = j0 + lj;
  const long long n_pairs = (long long)N * (N - 1) / 2;
  bool lane[kRows];       // strict upper triangle
  long long pair[kRows];  // the lane's pair index (block mode)
  double acc[kSums][kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int a = i0 + li0 + q;
    lane[q] = a < b && b < N;
    pair[q] = (long long)a * (2 * N - a - 1) / 2 + (b - a - 1);
#pragma unroll
    for (int j = 0; j < kSums; ++j) acc[j][q] = 0.0;
  }

  // The table threads: one table per (side, site of the step, individual).
  const bool fills = threadIdx.x < kTableThreads;
  const int b_side = threadIdx.x / (kSites * kTile);
  const int b_sl = (threadIdx.x / kTile) % kSites, b_col = threadIdx.x % kTile;
  const int b_ind = (b_side == 0 ? i0 : j0) + b_col;
  T q0 = T(0), q1 = T(0), q2 = T(0);  // this step's triple; padding: a dead row
  auto fetch = [&](long long s0) {
    const long long s = s0 + b_sl;
    q0 = q1 = q2 = T(0);
    if (fills && s < s_end && b_ind < N) {
      const T* q = P + ((sites ? sites[s] : s) * N + b_ind) * 3;
      q0 = q[0];
      q1 = q[1];
      q2 = q[2];
    }
  };
  fetch(s_begin);

  const double2* Ri = reinterpret_cast<const double2*>(R + li0);  // rows li0..li0+3
  const double* Rj = R + kRSide + lj;
  const double* Xi = X;
  const double* Xj = X + kXSide;

  long long blk = 0, blk_end = block_size;  // block mode: the current block
  auto flush_block = [&]() {
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      if (!lane[q]) continue;
      B[blk * n_pairs + pair[q]] = acc[0][q];
      C[blk * n_pairs + pair[q]] = acc[1][q];
      acc[0][q] = acc[1][q] = 0.0;
    }
  };
  for (long long s0 = s_begin; s0 < s_end; s0 += kSites) {
    if (fills && !(NGSD_EM_SKIP_BUILD && s0 > 0)) {
      const T p0 = q0, p1 = q1, p2 = q2;
      fetch(s0 + kSites);  // the next step's triple, in flight during this step
      const T mx = ngsd::nan_max(ngsd::nan_max(p0, p1), p2);
      const bool dead = mx <= T(0);  // false for NaN
      const int flag = (b_side * kSites + b_sl) * kTile + b_col;
      Live[flag] = dead ? 0.0f : 1.0f;
      Val[flag] = ngsd::nonmissing(p0, p1, p2);
      if (!dead) {
        const double den = (double)mx;
        double* Xb = X + b_side * kXSide;
        build_tables((double)p0 / den, (double)p1 / den, (double)p2 / den,
                     R + b_side * kRSide + r_index(b_sl, 0, b_col),
                     [&](int c, double v0, double v1, double v2) {
                       if (b_side == 0) {
                         Xb[xi_index(b_sl, b_col, c, 0)] = v0;
                         Xb[xi_index(b_sl, b_col, c, 1)] = v1;
                         Xb[xi_index(b_sl, b_col, c, 2)] = v2;
                       } else {
                         Xb[xj_index(b_sl, b_col, c, 0)] = v0;
                         Xb[xj_index(b_sl, b_col, c, 1)] = v1;
                         Xb[xj_index(b_sl, b_col, c, 2)] = v2;
                       }
                     });
      }
    }
    if (threadIdx.x < kW * kSites) {  // weight row r at site s of the step
      const int r = kW == 1 ? 0 : threadIdx.x / kSites;
      const long long s = s0 + (kW == 1 ? threadIdx.x : threadIdx.x % kSites);
      Ws[threadIdx.x] = s < s_end && (kW == 1 || r < rows) ? (w ? w[r * S + s] : T(1)) : T(0);
    }
    __syncthreads();

    // The passed ratio tests (k* - 1) of the thread's lanes at each site.
    const int n_sl = (int)((s_end - s0) < kSites ? (s_end - s0) : kSites);
    bool live[kSites][kRows];
    int ksum[kSites][kRows];
#pragma unroll
    for (int sl = 0; sl < kSites; ++sl) {
      const bool live_j = sl < n_sl && Live[(kSites + sl) * kTile + lj] != 0.0f;
      bool act[kRows], any = false;
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        live[sl][q] = lane[q] && live_j && Live[sl * kTile + li0 + q] != 0.0f;
        act[q] = live[sl][q];
        ksum[sl][q] = 0;
        any = any || act[q];
      }
      const double2* ri = Ri + r_index(sl, 0, 0) / 2;
      const double* rj = Rj + r_index(sl, 0, 0);
      for (int k0 = 0; k0 < kSteps && any && !NGSD_EM_SKIP_SEARCH; k0 += kUnroll) {
        double rjk[kUnroll];
        double2 ra[kUnroll], rb[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          rjk[u] = rj[(k0 + u) * kTile];
          ra[u] = ri[(k0 + u) * (kTile / 2)];
          rb[u] = ri[(k0 + u) * (kTile / 2) + 1];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {  // NaN fails at once
          act[0] = act[0] && (ra[u].x * rjk[u] >= hi);
          act[1] = act[1] && (ra[u].y * rjk[u] >= hi);
          act[2] = act[2] && (rb[u].x * rjk[u] >= hi);
          act[3] = act[3] && (rb[u].y * rjk[u] >= hi);
#pragma unroll
          for (int q = 0; q < kRows; ++q) ksum[sl][q] += act[q];
        }
        any = act[0] || act[1] || act[2] || act[3];
      }
    }

#pragma unroll
    for (int sl = 0; sl < kSites; ++sl) {
      if (sl >= n_sl) break;
      if constexpr (kBlocks) {
        if (s0 + sl == blk_end) {
          flush_block();
          ++blk;
          blk_end += block_size;
        }
      }
      const int fj = (kSites + sl) * kTile + lj;
      const double w0 = Ws[sl];  // one row: its weight, read once a site
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        if (!live[sl][q]) continue;
        if (NGSD_EM_SKIP_CONTRACT) {
          acc[kSums - 1][q] += ksum[sl][q];
          continue;
        }
        const int li = li0 + q;
        // x = pi^(k*), k* = 1 + ksum = (1 + 3c) + rem.
        const int c = ksum[sl][q] / kStride, rem = ksum[sl][q] - kStride * c;
        double x0 = Xi[xi_index(sl, li, c, 0)], x1 = Xi[xi_index(sl, li, c, 1)],
               x2 = Xi[xi_index(sl, li, c, 2)];
        double y0 = Xj[xj_index(sl, lj, c, 0)], y1 = Xj[xj_index(sl, lj, c, 1)],
               y2 = Xj[xj_index(sl, lj, c, 2)];
        if (rem > 0) {
          const double pi0 = Xi[xi_index(sl, li, 0, 0)], pi1 = Xi[xi_index(sl, li, 0, 1)],
                       pi2 = Xi[xi_index(sl, li, 0, 2)];
          const double pj0 = Xj[xj_index(sl, lj, 0, 0)], pj1 = Xj[xj_index(sl, lj, 0, 1)],
                       pj2 = Xj[xj_index(sl, lj, 0, 2)];
          x0 = dmul(x0, pi0); x1 = dmul(x1, pi1); x2 = dmul(x2, pi2);
          y0 = dmul(y0, pj0); y1 = dmul(y1, pj1); y2 = dmul(y2, pj2);
          if (rem > 1) {
            x0 = dmul(x0, pi0); x1 = dmul(x1, pi1); x2 = dmul(x2, pi2);
            y0 = dmul(y0, pj0); y1 = dmul(y1, pj1); y2 = dmul(y2, pj2);
          }
        }
        // sum_{g,h} score[g,h] x_g y_h, row by row, in the order of the
        // plain version's sums, then / (sum x * sum y); every step rounded
        // as written (the header's "Weight rows").
        auto z = [&](int g) {
          return dfma(sc.v[3 * g + 2], y2, dfma(sc.v[3 * g + 1], y1, dmul(sc.v[3 * g], y0)));
        };
        const double num = dfma(x2, z(2), dfma(x1, z(1), dmul(x0, z(0))));
        const double Sf = dmul(dadd(dadd(x0, x1), x2), dadd(dadd(y0, y1), y2));
        const double contrib = __ddiv_rn(num, Sf);
        double m = 1.0;
        if (pairwise_del) m = dmul(dmul(m, (double)Val[sl * kTile + li]), (double)Val[fj]);
        const double v = dmul(contrib, m);
        // Every slot the one row's expression: acc += w * v for raw,
        // acc += w * m for cnt.
#pragma unroll
        for (int j = 0; j < kSums; ++j) {
          const double ws = kW == 1 ? w0 : (double)Ws[(paired ? j / 2 : j) * kSites + sl];
          acc[j][q] = dfma(ws, paired && (j & 1) ? m : v, acc[j][q]);
        }
      }
    }
    __syncthreads();
  }

  if constexpr (kBlocks) {
    flush_block();  // the last block
  } else if (part != nullptr) {  // this slice's sums, every lane of the tile
    double* pr = part + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * kSums * kLanes;
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int l = (li0 + q) * kTile + lj;
#pragma unroll
      for (int j = 0; j < kSums; ++j) pr[j * kLanes + l] = acc[j][q];
    }
  } else {
    const long long nn = (long long)N * N;
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      if (!lane[q]) continue;
      const long long a = i0 + li0 + q;
#pragma unroll
      for (int j = 0; j < kSums; ++j) {
        const int r = paired ? j / 2 : j;
        if (kW > 1 && r >= rows) continue;
        (paired && (j & 1) ? cnt : raw)[r * nn + a * N + b] = (T)acc[j][q];
      }
    }
  }
}

// One weight row: raw and cnt of w [S] (null: every weight 1), full mode
// or block mode.
template <typename T, bool kBlocks>
__global__ void __launch_bounds__(kThreads, 2)
em_kernel(const T* __restrict__ P, const T* __restrict__ w,
          const long long* __restrict__ sites, const int* __restrict__ tiles,
          T* __restrict__ raw, T* __restrict__ cnt, double* __restrict__ B,
          double* __restrict__ C, double* __restrict__ part, long long S, int N,
          long long block_size, Score9d sc, double hi, int pairwise_del) {
  em_body<T, kBlocks, 1>(P, w, 1, sites, tiles, raw, cnt, B, C, part, S, N, block_size, sc, hi,
                         pairwise_del);
}

// Weight rows: raw [rows, N, N] of w [rows, S] and, under pairwise
// deletion, cnt [rows, N, N]; full mode over P's first S sites, every
// upper tile.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
em_kernel_rows(const T* __restrict__ P, const T* __restrict__ w, int rows,
               T* __restrict__ raw, T* __restrict__ cnt, double* __restrict__ part,
               long long S, int N, Score9d sc, double hi, int pairwise_del) {
  em_body<T, false, kWeightRows>(P, w, rows, nullptr, nullptr, raw, cnt, nullptr, nullptr, part,
                                 S, N, 0, sc, hi, pairwise_del);
}

// The second pass of a sliced launch: one thread per (tile k, lane) adds
// each of the lane's `sums` sums over its G slices from part [G, n_tiles,
// sums, kLanes] in slice order g = 0..G-1 in float64 and writes it on the
// strict upper triangle, rounded to T once, as the one-pass kernel does:
// slot j to raw of row j, or, paired, to raw (j even) or cnt (j odd) of
// row j / 2; rows past `rows` are not written.
template <typename T>
__global__ void __launch_bounds__(kThreads)
em_kernel_sum_slices(const double* __restrict__ part, const int* __restrict__ tiles,
                     int n_tiles, int G, int N, int sums, int paired, int rows,
                     T* __restrict__ raw, T* __restrict__ cnt) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)n_tiles * kLanes) return;
  const int k = (int)(i / kLanes), l = (int)(i % kLanes);
  const long long nt = (N + kTile - 1) / kTile;
  const long long tile = tiles ? (long long)tiles[k] : (long long)k;
  if (tile < 0 || tile >= nt * (nt + 1) / 2) return;  // the first pass left it too
  int ti, tj;
  ngsd::upper_tile(tile, &ti, &tj);
  const long long a = ti * kTile + l / kTile, b = tj * kTile + l % kTile;
  if (!(a < b && b < N)) return;
  for (int j = 0; j < sums; ++j) {
    const int r = paired ? j / 2 : j;
    if (r >= rows) continue;
    double t = 0.0;
    for (int g = 0; g < G; ++g) t += part[(((long long)g * n_tiles + k) * sums + j) * kLanes + l];
    (paired && (j & 1) ? cnt : raw)[r * (long long)N * N + a * N + b] = (T)t;
  }
}

long long upper_tiles(int N) {
  const long long nt = (N + kTile - 1) / kTile;
  return nt * (nt + 1) / 2;
}

// The score in float64: the f32 entries' float32 copy widened, the f64
// entries' taken as it is.
template <typename S9>
Score9d score_f64(const S9* score9) {
  Score9d sc;
  for (int i = 0; i < 9; ++i) sc.v[i] = (double)score9[i];
  return sc;
}

// The kernel that keeps kW weight rows.
template <typename T, bool kBlocks, int kW>
constexpr auto kernel_of() {
  if constexpr (kW == 1) return em_kernel<T, kBlocks>;
  else return em_kernel_rows<T>;
}

// The tables need more than the 48 KB a block gets without asking.
template <typename T, bool kBlocks, int kW>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(kernel_of<T, kBlocks, kW>(),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kSmemBytes<T, kW>);
}

// grid: the length of `tiles`, or every upper tile without a list; slices
// site slices of each (full mode; part [slices, grid, kSums, kLanes]
// float64 when more than one), then the second pass on the same stream.
template <typename T, bool kBlocks, int kW>
int launch(const T* P, const T* w, int rows, const long long* sites, const int* tiles,
           long long grid, int slices, double* part, T* raw, T* cnt, double* B, double* C,
           long long S, int N, long long block_size, const T* score9, double hi,
           int pairwise_del, void* stream) {
  cudaError_t err = allow_smem<T, kBlocks, kW>();
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((unsigned)grid, (unsigned)slices);
  const cudaStream_t st = (cudaStream_t)stream;
  double* sums = slices > 1 ? part : nullptr;
  if constexpr (kW == 1)
    em_kernel<T, kBlocks><<<blocks, kThreads, kSmemBytes<T, kW>, st>>>(
        P, w, sites, tiles, raw, cnt, B, C, sums, S, N, block_size, score_f64(score9), hi,
        pairwise_del);
  else
    em_kernel_rows<T><<<blocks, kThreads, kSmemBytes<T, kW>, st>>>(
        P, w, rows, raw, cnt, sums, S, N, score_f64(score9), hi, pairwise_del);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  const long long threads = grid * kLanes;
  em_kernel_sum_slices<T><<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      part, tiles, (int)grid, slices, N, kW == 1 ? 2 : kW, kW == 1 || pairwise_del, rows, raw,
      cnt);
  return (int)cudaGetLastError();
}

// The full mode's entries: `slices` site slices of each tile, with their
// scratch when more than one.
template <typename T, int kW>
int raw_cnt(const T* P, const T* w, int rows, const long long* sites, const int* tiles,
            long long n_tiles, T* raw, T* cnt, long long S, int N, const T* score9, double hi,
            int pairwise_del, int slices, double* part, void* stream) {
  const long long grid = tiles != nullptr ? n_tiles : (N < 1 ? 0 : upper_tiles(N));
  const bool paired = kW == 1 || pairwise_del;  // raw and cnt a row
  if (N < 1 || S < 0 || grid < 1 || grid > INT_MAX || slices < 1 || slices > 65535 ||
      (slices > 1 && (part == nullptr || grid > INT_MAX / (kLanes / kThreads))) || rows < 1 ||
      rows > (kW == 1 ? 1 : paired ? kW / 2 : kW) || (paired && cnt == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch<T, false, kW>(P, w, rows, sites, tiles, grid, slices, part, raw, cnt, nullptr,
                              nullptr, S, N, 0, score9, hi, pairwise_del, stream);
}

// Resident blocks per SM of the full-mode kernel of kW weight rows on the
// current device.
template <typename T, int kW>
int blocks_per_sm(int* blocks) {
  cudaError_t err = allow_smem<T, false, kW>();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel_of<T, false, kW>(), kThreads, kSmemBytes<T, kW>);
}

}  // namespace

// P [., N, 3] float32; sites [S] int64, the sites of P to run on in this
// order, or null for P's first S sites; tiles [n_tiles] int32, the upper
// 32 x 32 tiles to compute, or null for all of them; w [S] float32 or null;
// raw, cnt [N, N] float32, written on the strict upper triangle of the
// tiles run.  hi = exp(0.001) in float64, the precision of the ratio test.
// slices: the site slices of each tile (site_slice); with more than one,
// part [slices, n_tiles or upper tiles, 2, 1024] float64 holds their sums,
// added in slice order by a second launch on the same stream (1: the
// one-pass launch, part unused).  Returns the CUDA error of the launch.
extern "C" int ngsd_em_raw_cnt_f32(const float* P, const float* w, const long long* sites,
                                   const int* tiles, long long n_tiles, float* raw, float* cnt,
                                   long long S, int N, const float* score9, double hi,
                                   int pairwise_del, int slices, double* part, void* stream) {
  return raw_cnt<float, 1>(P, w, 1, sites, tiles, n_tiles, raw, cnt, S, N, score9, hi,
                           pairwise_del, slices, part, stream);
}

// *blocks = resident blocks per SM of the full-mode kernel on the current
// device, with its shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int ngsd_em_blocks_per_sm_f32(int* blocks) { return blocks_per_sm<float, 1>(blocks); }

// Weight rows, every upper tile over P's first S sites: w [rows, S]
// float32 (null: every weight 1); raw [rows, N, N] float32 and, under
// pairwise deletion, cnt [rows, N, N] (else null), written on the strict
// upper triangle; rows at most ngsd_em_weight_rows(), half as many under
// pairwise deletion.  Row r holds the bytes of ngsd_em_raw_cnt_f32 with
// weights w[r] at the same slices; part [slices, upper tiles,
// ngsd_em_weight_rows(), 1024] float64 when slices > 1.
extern "C" int ngsd_em_raw_cnt_rows_f32(const float* P, const float* w, int rows, float* raw,
                                        float* cnt, long long S, int N, const float* score9,
                                        double hi, int pairwise_del, int slices, double* part,
                                        void* stream) {
  return raw_cnt<float, kWeightRows>(P, w, rows, nullptr, nullptr, 0, raw, cnt, S, N, score9, hi,
                                     pairwise_del, slices, part, stream);
}

extern "C" int ngsd_em_rows_blocks_per_sm_f32(int* blocks) {
  return blocks_per_sm<float, kWeightRows>(blocks);
}

// The float64 sums (slots) a lane keeps in ngsd_em_raw_cnt_rows_*: the
// weight rows a launch takes, half as many under pairwise deletion.
extern "C" int ngsd_em_weight_rows(void) { return kWeightRows; }

// Block mode: P [n_blocks * block_size, N, 3] float32; B, C [n_blocks,
// N (N - 1) / 2] float64, every entry written.
extern "C" int ngsd_em_block_partials_f32(const float* P, double* B, double* C, int N,
                                          long long n_blocks, long long block_size,
                                          const float* score9, double hi,
                                          int pairwise_del, void* stream) {
  if (N < 2 || n_blocks < 1 || block_size < 1 || B == nullptr || C == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch<float, true, 1>(P, nullptr, 1, nullptr, nullptr, upper_tiles(N), 1, nullptr,
                                nullptr, nullptr, B, C, n_blocks * block_size, N, block_size,
                                score9, hi, pairwise_del, stream);
}

// The float64 entries (K2d): P [., N, 3] and w [S] float64, the score
// float64[9], raw and cnt [N, N] float64; otherwise as ngsd_em_raw_cnt_f32.
extern "C" int ngsd_em_raw_cnt_f64(const double* P, const double* w, const long long* sites,
                                   const int* tiles, long long n_tiles, double* raw,
                                   double* cnt, long long S, int N, const double* score9,
                                   double hi, int pairwise_del, int slices, double* part,
                                   void* stream) {
  return raw_cnt<double, 1>(P, w, 1, sites, tiles, n_tiles, raw, cnt, S, N, score9, hi,
                            pairwise_del, slices, part, stream);
}

extern "C" int ngsd_em_blocks_per_sm_f64(int* blocks) { return blocks_per_sm<double, 1>(blocks); }

// Weight rows on float64 probabilities; as ngsd_em_raw_cnt_rows_f32.
extern "C" int ngsd_em_raw_cnt_rows_f64(const double* P, const double* w, int rows, double* raw,
                                        double* cnt, long long S, int N, const double* score9,
                                        double hi, int pairwise_del, int slices, double* part,
                                        void* stream) {
  return raw_cnt<double, kWeightRows>(P, w, rows, nullptr, nullptr, 0, raw, cnt, S, N, score9,
                                      hi, pairwise_del, slices, part, stream);
}

extern "C" int ngsd_em_rows_blocks_per_sm_f64(int* blocks) {
  return blocks_per_sm<double, kWeightRows>(blocks);
}

// Block mode on float64 probabilities; as ngsd_em_block_partials_f32.
extern "C" int ngsd_em_block_partials_f64(const double* P, double* B, double* C, int N,
                                          long long n_blocks, long long block_size,
                                          const double* score9, double hi,
                                          int pairwise_del, void* stream) {
  if (N < 2 || n_blocks < 1 || block_size < 1 || B == nullptr || C == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch<double, true, 1>(P, nullptr, 1, nullptr, nullptr, upper_tiles(N), 1, nullptr,
                                 nullptr, nullptr, B, C, n_blocks * block_size, N, block_size,
                                 score9, hi, pairwise_del, stream);
}
