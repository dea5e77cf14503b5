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
// Precision: the probabilities arrive as float32, but each lane's EM runs
// in float64 (p/max, the power sums, the ratio test against
// hi = exp(0.001) in float64, and the final powers).  The stopping step
// is a threshold decision: in float32, rounding near the threshold moves
// k* by one step for roughly one lane in a thousand, and one such step
// shifts a lane's contribution by up to ~1e-2.  In float64 the kernel
// takes the decisions of the float64 plain version on the same inputs.
//
// What bounds it on the card: the float64 instruction rate in each lane's own
// convergence loop (about 20 operations and two divisions per step, a
// few to 49 steps, then six exp/log per lane), with warps diverging where
// lanes stop at different steps.  Device-memory traffic is negligible.
// Design: one block per upper-triangular 16x16 tile of individuals,
// one thread per pair lane.  For each tile of 32 sites the block stages
// p/max, the live flag and the validity of its 16 + 16 individuals in
// shared memory; each thread then runs its own k loop and stops at its
// own convergence, which drops the TPU kernel's 7-step chunks and
// whole-slab while loop with identical k* semantics.  Sums are kept in
// float64 registers and written once, strict upper triangle only.
//
// Block mode (ngsd_em_block_partials_f32), for the partial-sum bootstrap:
// replaces the want_blocks output of ngsdist_tpu/core/distance.py _em_scan
// (:418, a lax.scan there).  Unweighted; each lane writes its float64
// sums B[b, p] = sum_{s in b} contrib * m and C[b, p] = sum_{s in b} m for
// every bootstrap block b of block_size sites, and resets them, when its
// site loop crosses the block's end.  Blocks need not align with the
// 32-site staging step.  p is the pair's index in triu row-major order.
// Sharing each individual's power sequence across the lanes of a tile,
// and a float32 loop with a float64 re-check near the threshold, are
// later work.

#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kTile = 16;     // individuals per tile side: 256 pair lanes
constexpr int kSites = 32;    // sites staged per step
constexpr int kThreads = kTile * kTile;
constexpr int kSteps = 49;    // EM_MAX_ITER - 1 ratio tests

// kBlocks: block mode; B, C [S / block_size, N (N - 1) / 2] float64 take
// the place of raw and cnt.
template <bool kBlocks>
__global__ void __launch_bounds__(kThreads)
em_kernel(const float* __restrict__ P, const float* __restrict__ w,
          float* __restrict__ raw, float* __restrict__ cnt, double* __restrict__ B,
          double* __restrict__ C, long long S, int N, long long block_size,
          ngsd::Score9 sc, double hi, int pairwise_del) {
  __shared__ double Pn[2][kSites][kTile][3];  // p / max, per side
  __shared__ float Live[2][kSites][kTile];    // 1 unless the row is all zero
  __shared__ float Val[2][kSites][kTile];     // not missing (pairwise deletion)
  __shared__ float Ws[kSites];

  int ti, tj;
  ngsd::upper_tile(blockIdx.x, &ti, &tj);
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int li = threadIdx.x / kTile, lj = threadIdx.x % kTile;
  const int a = i0 + li, b = j0 + lj;
  const bool lane = a < b && b < N;  // strict upper triangle
  const long long n_pairs = (long long)N * (N - 1) / 2;
  const long long p = (long long)a * (2 * N - a - 1) / 2 + (b - a - 1);

  double acc_raw = 0.0, acc_cnt = 0.0;
  long long blk = 0, blk_end = block_size;  // block mode: the current block
  auto flush_block = [&]() {
    B[blk * n_pairs + p] = acc_raw;
    C[blk * n_pairs + p] = acc_cnt;
    acc_raw = acc_cnt = 0.0;
  };
  for (long long s0 = 0; s0 < S; s0 += kSites) {
    for (int e = threadIdx.x; e < 2 * kSites * kTile; e += kThreads) {
      const int side = e / (kSites * kTile);
      const int sl = (e / kTile) % kSites, col = e % kTile;
      const long long s = s0 + sl;
      const int ind = (side == 0 ? i0 : j0) + col;
      float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;  // padding: a dead row
      if (s < S && ind < N) {
        const float* q = P + (s * N + ind) * 3;
        p0 = q[0];
        p1 = q[1];
        p2 = q[2];
      }
      const float mx = ngsd::nan_max(ngsd::nan_max(p0, p1), p2);
      const bool dead = mx <= 0.0f;  // false for NaN
      const double den = dead ? 1.0 : (double)mx;
      Pn[side][sl][col][0] = (double)p0 / den;
      Pn[side][sl][col][1] = (double)p1 / den;
      Pn[side][sl][col][2] = (double)p2 / den;
      Live[side][sl][col] = dead ? 0.0f : 1.0f;
      Val[side][sl][col] = ngsd::nonmissing(p0, p1, p2);
    }
    if (threadIdx.x < kSites) {
      const long long s = s0 + threadIdx.x;
      Ws[threadIdx.x] = s < S ? (w ? w[s] : 1.0f) : 0.0f;
    }
    __syncthreads();

    if (lane) {
      const int n_sl = (int)((S - s0) < kSites ? (S - s0) : kSites);
      for (int sl = 0; sl < n_sl; ++sl) {
        if constexpr (kBlocks) {
          if (s0 + sl == blk_end) {
            flush_block();
            ++blk;
            blk_end += block_size;
          }
        }
        if (Live[0][sl][li] == 0.0f || Live[1][sl][lj] == 0.0f) continue;
        const double pi0 = Pn[0][sl][li][0], pi1 = Pn[0][sl][li][1],
                     pi2 = Pn[0][sl][li][2];
        const double pj0 = Pn[1][sl][lj][0], pj1 = Pn[1][sl][lj][1],
                     pj2 = Pn[1][sl][lj][2];
        // Entering step k: PI_g = pi_g^k, tIm = t_{k-1}, tIc = t_k.
        double PI0 = pi0, PI1 = pi1, PI2 = pi2;
        double PJ0 = pj0, PJ1 = pj1, PJ2 = pj2;
        double tIm = 3.0, tIc = pi0 + pi1 + pi2;
        double tJm = 3.0, tJc = pj0 + pj1 + pj2;
        int ksum = 0;
        for (int k = 0; k < kSteps; ++k) {
          PI0 *= pi0; PI1 *= pi1; PI2 *= pi2;
          PJ0 *= pj0; PJ1 *= pj1; PJ2 *= pj2;
          const double tIn = PI0 + PI1 + PI2;
          const double tJn = PJ0 + PJ1 + PJ2;
          const double rI = tIn * tIm / (tIc * tIc);
          const double rJ = tJn * tJm / (tJc * tJc);
          if (!(rI * rJ >= hi)) break;  // NaN stops here too
          ++ksum;
          tIm = tIc; tIc = tIn;
          tJm = tJc; tJc = tJn;
        }
        const double kstar = 1.0 + (double)ksum;
        // log 0 = -inf -> exp(-inf) = 0, the value such channels converge to.
        const double x[3] = {exp(kstar * log(pi0)), exp(kstar * log(pi1)),
                             exp(kstar * log(pi2))};
        const double y0 = exp(kstar * log(pj0)), y1 = exp(kstar * log(pj1)),
                     y2 = exp(kstar * log(pj2));
        double num = 0.0;
#pragma unroll
        for (int g = 0; g < 3; ++g)
          num = num + x[g] * ((double)sc.v[3 * g + 0] * y0 +
                              (double)sc.v[3 * g + 1] * y1 +
                              (double)sc.v[3 * g + 2] * y2);
        const double Sf = (x[0] + x[1] + x[2]) * (y0 + y1 + y2);
        const double contrib = num / Sf;
        double m = 1.0;
        if (pairwise_del) m = m * Val[0][sl][li] * Val[1][sl][lj];
        const double ws = Ws[sl];
        acc_raw += ws * (contrib * m);
        acc_cnt += ws * m;
      }
    }
    __syncthreads();
  }

  if (!lane) return;
  if constexpr (kBlocks) {
    flush_block();  // the last block
  } else {
    raw[(long long)a * N + b] = (float)acc_raw;
    cnt[(long long)a * N + b] = (float)acc_cnt;
  }
}

long long upper_tiles(int N) {
  const long long nt = (N + kTile - 1) / kTile;
  return nt * (nt + 1) / 2;
}

}  // namespace

// P [S, N, 3] float32, w [S] float32 or null; raw, cnt [N, N] float32,
// written on the strict upper triangle.  hi = exp(0.001) in float64, the
// precision of the ratio test.  Returns the CUDA error of the launch.
extern "C" int ngsd_em_raw_cnt_f32(const float* P, const float* w, float* raw,
                                   float* cnt, long long S, int N,
                                   const float* score9, double hi,
                                   int pairwise_del, void* stream) {
  if (N < 1 || S < 0) return (int)cudaErrorInvalidValue;
  ngsd::Score9 sc;
  memcpy(sc.v, score9, sizeof(sc.v));
  em_kernel<false><<<(unsigned)upper_tiles(N), kThreads, 0, (cudaStream_t)stream>>>(
      P, w, raw, cnt, nullptr, nullptr, S, N, 0, sc, hi, pairwise_del);
  return (int)cudaGetLastError();
}

// Block mode: P [n_blocks * block_size, N, 3] float32; B, C [n_blocks,
// N (N - 1) / 2] float64, every entry written.
extern "C" int ngsd_em_block_partials_f32(const float* P, double* B, double* C, int N,
                                          long long n_blocks, long long block_size,
                                          const float* score9, double hi,
                                          int pairwise_del, void* stream) {
  if (N < 2 || n_blocks < 1 || block_size < 1 || B == nullptr || C == nullptr)
    return (int)cudaErrorInvalidValue;
  ngsd::Score9 sc;
  memcpy(sc.v, score9, sizeof(sc.v));
  em_kernel<true><<<(unsigned)upper_tiles(N), kThreads, 0, (cudaStream_t)stream>>>(
      P, nullptr, nullptr, nullptr, B, C, n_blocks * block_size, N, block_size, sc, hi,
      pairwise_del);
  return (int)cudaGetLastError();
}
