// The inbreeding HMM's log-space scans on Hopper: forward, backward and
// Viterbi over the sites of a batch of chains.
//
// Replaces: ngsdist_tpu/popgen/hmm.py forward (:73), backward (:92) and
// viterbi (:130), each a lax.scan over sites (XLA, not Pallas) vmapped
// over chains.  The plain PyTorch versions, a loop over sites batched
// over chains, are ngsdist_tpu_torch/ops/hmm.py hmm_*_ref.
//
// What it computes.  B chains of S sites and K states (1 <= K <= 8, a
// template argument), in float32 or float64.  Chain b has stationary
// proportions q[b, :], rate alpha[b], log emissions e[b, s, :] and the
// distance d[s] (or d[b, s]) entering site s.  Between sites the chain
// stays with probability stay = exp(-alpha d) and otherwise redraws its
// state from q:  log T[k][l] = log((1 - stay) q[l] + [k == l] stay).
//   forward:  f = log q;  f_s[l] = lse_k(f_{s-1}[k] + log T_s[k][l]) + e_s[l];
//             writes f_s for every s and the loglik lse(f_{S-1}).
//   backward: b_{S-1} = 0;  b_{s-1}[k] = lse_l(log T_s[k][l] + (e_s[l] + b_s[l]))
//             for s = S-1 .. 1; the loglik from the virtual start row,
//             lse_k(log q[k] + lse_l(log T_0[k][l] + (e_0[l] + b_0[l]))).
//   viterbi:  v = log q;  v_s[l] = max_k(v_{s-1}[k] + log T_s[k][l]) + e_s[l],
//             the arg max (the first maximal k; a NaN counts as maximal,
//             as jnp.argmax) into a [S, B, K] uint8 scratch; then the
//             traceback from the arg max of v_{S-1} through sites S-1 .. 1.
// lse is jax.scipy.special.logsumexp's arithmetic: m = max (NaN-propagating),
// m := 0 where it is not finite (all -inf gives -inf), the exponentials of
// a_k - m added in k order, log of the sum plus m.
//
// Rounding.  Every add, subtract and multiply goes through the _rn
// intrinsics, so nvcc contracts none of them into an FMA: each is rounded
// once, and exp and log are the CUDA math library's, which PyTorch's own
// exp and log call on the card.  Viterbi walks the sites in the plain
// version's order and equals it bit for bit.  Forward and backward
// reassociate the recursion (below); ops/hmm.py hmm_scan_segmented_ref is
// their order in plain PyTorch, which they equal bit for bit, and
// hmm_bound(..., L) the derived bound that holds them to the sequential
// plain version (PERF.md section 2).
//
// Forward and backward: site segments composed in the log semiring.  A
// step is linear in the exponentials of the messages, so the steps over
// a segment of sites compose into a K x K transfer matrix in the log
// semiring (log-sum-exp for the sum, + for the product).  A chain's S
// sites split into G = ceil(S / L) segments of L sites; L is the wrapper's
// constant (ops/hmm.py SEGMENT; smaller only in tests, to cross segment
// edges at small S), never a function of B, so a chain's bits do not
// depend on the batch it came in.  Three launches on the caller's stream:
//   1. transfers (hmm_transfer_kernel): per (chain, segment), the steps
//      over the segment from each of the K unit log-vectors (0 at k, -inf
//      elsewhere), one lane a vector, the Kp (K rounded up to a power of 2)
//      lanes of a segment sharing each site's transition row through
//      shuffles; forward's first segment walks from log q instead, backward's
//      last from 0, and gives the scan its first start vector.  Forward's
//      last segment and backward's first need no matrix.
//   2. starts (hmm_starts_kernel): per chain, each segment's start vector
//      from the previous one and a transfer matrix (K^2 log-sum-exps a
//      segment), in segment order.
//   3. messages (hmm_messages_kernel): per (chain, segment), the steps
//      over the segment from its start vector, the messages written; the
//      logliks as the sequential walk forms them.
// With G = 1 step 3 is the sequential walk, and with G = 2 its second
// start is the sequential walk's own message, so below 2 L sites both stay
// bit for bit the plain version's.  At 1024 chains x 262,144 sites, L =
// 1024: 262,144 (chain, segment) threads in step 3, Kp times that many
// lanes in step 1, where the sequential walk had 1024 threads on 32 SMs.
//
// Loads and stores.  A warp's lanes walk 32 segments (step 3) or 32 / Kp
// (step 1) in lock step.  The next U sites of each (their emissions and
// distances) are copied by all the warp's lanes together, with cp.async,
// into a double buffer in shared memory while the current U sites are
// computed: each copy instruction reads four segments' adjacent values,
// and the slots' odd strides let each lane read its own segment's
// without bank conflicts.  Step 3 writes each message over the emissions
// it came from, and the warp stores the group's messages as it loaded
// them.
//
// What bounds it.  By bytes, forward at 1024 chains x 262,144 sites x
// K = 2 in float64 reads e (4.29 GB) and writes the messages (4.29 GB):
// 2.56 ms at 3.35e12 B/s (this design reads e twice).  By operations, the
// exps and logs: at K = 2 a step-1 lane's 9 a site (its share of the
// transition row, 1 exp and 2 logs, and its vector's 2 log-sum-exps) and
// step 3's 11, 29 a (chain, site), on the FP64 pipe in float64, which
// binds (more warps a SM do not help).  Tensor cores do not apply: the
// step is a log-sum-exp, not a sum of products, and nothing of the log
// semiring maps onto an MMA.
//
// Viterbi (hmm_viterbi_kernel): one thread per chain, one warp a block,
// walking the sites in order; the transition (no dependence on the
// scores) and the loads of the next U sites (issued together, a register
// array) overlap the step's dependent chain.  Max-plus segments with its
// flips rule are its site-parallel redesign (ROADMAP).
//
// Layout.  e and the messages are chain-major [B, S, K] and the path
// [B, S], the JAX layout, so nothing is copied on the way in or out.  A
// site-major layout (a warp's loads contiguous, a transpose each way) was
// measured once against the sequential walk (PERF.md section 6) and not
// kept.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 32;       // Viterbi: one warp a block
constexpr int kScanThreads = 128;  // forward and backward: four warps a block
constexpr int kWarps = kScanThreads / 32;
constexpr int kMaxStates = 8;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }

// Sites whose loads a Viterbi thread issues together.
template <int K>
struct Ahead {
  static constexpr int U = K <= 2 ? 8 : (K <= 4 ? 4 : 2);
};

// One site's log transition row: log T[k][l] = k == l ? dg[l] : off[l],
// with JAX's products: T = (1 - stay) * q[l] + stay * eye[k][l].
template <typename T, int K>
__device__ __forceinline__ void transition(const T (&q)[K], T nalpha, T d, T (&off)[K],
                                           T (&dg)[K]) {
  const T stay = exp_(mul_rn(nalpha, d));
  const T om = sub_rn(T(1), stay);
  const T zero = mul_rn(stay, T(0));
#pragma unroll
  for (int l = 0; l < K; ++l) {
    const T t = mul_rn(om, q[l]);
    off[l] = log_(add_rn(t, zero));
    dg[l] = log_(add_rn(t, stay));   // stay * 1 is stay
  }
}

template <typename T, int K>
__device__ __forceinline__ T lse(const T (&a)[K]) {
  T m = a[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = ngsd::nan_max(m, a[k]);
  if (!isfinite(m)) m = T(0);
  T s = exp_(sub_rn(a[0], m));
#pragma unroll
  for (int k = 1; k < K; ++k) s = add_rn(s, exp_(sub_rn(a[k], m)));
  return add_rn(log_(s), m);
}

// The chain's q, log q and -alpha.
template <typename T, int K>
__device__ __forceinline__ T chain_start(const T* q, const T* alpha, int b, T (&qb)[K],
                                         T (&lq)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    qb[k] = q[(long long)b * K + k];
    lq[k] = log_(qb[k]);
  }
  return -alpha[b];
}

// ---- forward and backward: segments composed in the log semiring ----

// K rounded up to a power of two: the lanes of one segment in step 1.
template <int K>
struct Lanes {
  static constexpr int Kp = K <= 1 ? 1 : (K <= 2 ? 2 : (K <= 4 ? 4 : 8));
};

// Sites a staged group holds: a segment's U sites of K emissions (at
// most kSlot = 8 values) and U distances, each in a slot of odd stride.
// A lane copies the same place of a slot in every group (kSlot and U
// divide 32), and step 3 writes its messages back over the emissions it
// has read, whence the warp stores them.
template <int K>
struct Group {
  static constexpr int U = K <= 1 ? 8 : (K <= 2 ? 4 : (K <= 4 ? 2 : 1));
  static constexpr int kSlot = 8;
  static constexpr int kEStride = kSlot + 1;
  static constexpr int kDStride = U | 1;
};

// A segment a warp walks: e, d (and in step 3 the messages) at its
// first step's site (backward: the top site, and the row below it),
// from which its steps walk up (forward) or down; its number of steps.
template <typename T>
struct SegRef {
  const T* e;
  const T* d;
  T* out;
  int n;
};

__device__ __forceinline__ void cp_async(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async(double* smem, const double* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One forward step: f[l] := lse_k(f[k] + log T[k][l]) + e[l].
template <typename T, int K>
__device__ __forceinline__ void forward_step(T (&f)[K], const T (&off)[K], const T (&dg)[K],
                                             const T (&es)[K]) {
  T nf[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    T a[K];
#pragma unroll
    for (int k = 0; k < K; ++k) a[k] = add_rn(f[k], k == l ? dg[l] : off[l]);
    nf[l] = add_rn(lse<T, K>(a), es[l]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) f[k] = nf[k];
}

// One backward step: b[k] := lse_l(log T[k][l] + (e[l] + b[l])).
template <typename T, int K>
__device__ __forceinline__ void backward_step(T (&b)[K], const T (&off)[K], const T (&dg)[K],
                                              const T (&es)[K]) {
  T eb[K];
#pragma unroll
  for (int l = 0; l < K; ++l) eb[l] = add_rn(es[l], b[l]);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T a[K];
#pragma unroll
    for (int l = 0; l < K; ++l) a[l] = add_rn(k == l ? dg[l] : off[l], eb[l]);
    b[k] = lse<T, K>(a);
  }
}

// A start vector composed with a segment's transfer matrix m[run][comp],
// v[j] := lse_i(v[i] + m[i][j]): forward runs start at the segment's
// first site (i the state before it), backward runs at its top row.
template <typename T, int K>
__device__ __forceinline__ void compose(T (&v)[K], const T* m) {
  T nv[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    T a[K];
#pragma unroll
    for (int i = 0; i < K; ++i) a[i] = add_rn(v[i], m[i * K + j]);
    nv[j] = lse<T, K>(a);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = nv[k];
}

// A site's transition row shared by the Kp lanes of a segment: lane r
// takes state min(r, K-1)'s two logs, the shuffles hand every lane all K.
// The same operations as transition(), so the same bits.
template <typename T, int K>
__device__ __forceinline__ void transition_shared(T q_own, T nalpha, T d, unsigned mask,
                                                  T (&off)[K], T (&dg)[K]) {
  constexpr int Kp = Lanes<K>::Kp;
  const T stay = exp_(mul_rn(nalpha, d));
  const T om = sub_rn(T(1), stay);
  const T zero = mul_rn(stay, T(0));
  const T t = mul_rn(om, q_own);
  const T own_off = log_(add_rn(t, zero));
  const T own_dg = log_(add_rn(t, stay));
#pragma unroll
  for (int l = 0; l < K; ++l) {
    off[l] = __shfl_sync(mask, own_off, l, Kp);
    dg[l] = __shfl_sync(mask, own_dg, l, Kp);
  }
}

// The walk of a warp's segments in lock step over their sites, U at a
// time through the staged double buffer: the lane's own segment is
// tab[c], its message v; each step's transition row from the lane's own
// q (kShared: one state's, shuffled); kStore: the messages after each
// step written to the segment's out.
template <typename T, int K, bool kFwd, int CH, bool kShared, bool kStore>
__device__ __forceinline__ void walk(const SegRef<T>* tab, T* ebuf, T* dbuf, int c,
                                     const T (&qb)[K], T q_own, T nalpha, unsigned mask,
                                     T (&v)[K]) {
  using Gr = Group<K>;
  constexpr int U = Gr::U, kSlot = Gr::kSlot, ES = Gr::kEStride, DS = Gr::kDStride;
  constexpr long long dir = kFwd ? 1 : -1;
  const int lane = threadIdx.x & 31;
  // the lane's place in an e slot (step u, state k) and in a d slot
  const int re = lane % kSlot, ue = re / K, ke = re % K, ud = lane % U;
  const int n_own = tab[c].n;
  const int n_max = (int)__reduce_max_sync(0xffffffffu, (unsigned)n_own);
  const int groups = (n_max + U - 1) / U;
  auto issue = [&](int j) {
    T* de = ebuf + (j & 1) * CH * ES;
    T* dd = dbuf + (j & 1) * CH * DS;
#pragma unroll
    for (int t = 0; t < CH * kSlot / 32; ++t) {
      const int cc = t * (32 / kSlot) + lane / kSlot, at = j * U + ue;
      if (re < U * K && at < tab[cc].n) cp_async(de + cc * ES + re, tab[cc].e + dir * at * K + ke);
    }
#pragma unroll
    for (int t = 0; t < (CH * U + 31) / 32; ++t) {
      const int cc = t * (32 / U) + lane / U, at = j * U + ud;
      if (cc < CH && at < tab[cc].n) cp_async(dd + cc * DS + ud, tab[cc].d + dir * at);
    }
    cp_async_commit();
  };
  if (groups > 0) issue(0);
  for (int j = 0; j < groups; ++j) {
    if (j + 1 < groups)
      issue(j + 1);
    else
      cp_async_commit();   // an empty group: wait_group 1 then waits for j
    cp_async_wait_one();
    __syncwarp();
    T* es_ = ebuf + (j & 1) * CH * ES;
    T* rec = es_ + c * ES;
    const T* drec = dbuf + (j & 1) * CH * DS + c * DS;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j * U + u < n_own) {   // the same for a segment's lanes
        T es[K], off[K], dg[K];
#pragma unroll
        for (int k = 0; k < K; ++k) es[k] = rec[u * K + k];
        if constexpr (kShared)
          transition_shared<T, K>(q_own, nalpha, drec[u], mask, off, dg);
        else
          transition<T, K>(qb, nalpha, drec[u], off, dg);
        if constexpr (kFwd)
          forward_step<T, K>(v, off, dg, es);
        else
          backward_step<T, K>(v, off, dg, es);
        if constexpr (kStore) {
#pragma unroll
          for (int k = 0; k < K; ++k) rec[u * K + k] = v[k];
        }
      }
    }
    __syncwarp();
    if constexpr (kStore) {
#pragma unroll
      for (int t = 0; t < CH * kSlot / 32; ++t) {
        const int cc = t * (32 / kSlot) + lane / kSlot, at = j * U + ue;
        if (re < U * K && at < tab[cc].n) tab[cc].out[dir * at * K + ke] = es_[cc * ES + re];
      }
      __syncwarp();
    }
  }
}

// Segment g of a chain of S sites: its first site (forward) or top site
// (backward) and its number of steps.  Backward segment g holds rows
// [gL, (g+1)L), made by sites (g+1)L .. gL+1 (the last: S-1 .. (G-1)L+1).
template <bool kFwd>
__device__ __forceinline__ void segment_of(long long g, long long G, long long L, long long S,
                                           long long* first, int* n) {
  if (kFwd) {
    *first = g * L;
    *n = (int)min(L, S - g * L);
  } else {
    *first = g == G - 1 ? S - 1 : (g + 1) * L;
    *n = (int)(*first - g * L);
  }
}

// Step 1.  Lane r of the Kp lanes of (chain b, segment g) walks the unit
// vector of state min(r, K-1) (forward g = 0: log q; backward g = G-1:
// 0) and writes row r of the segment's transfer matrix (or the start
// vector it gives).  Forward takes segments 0 .. G-2, backward 1 .. G-1.
template <typename T, int K, bool kFwd>
__global__ void __launch_bounds__(kScanThreads)
    hmm_transfer_kernel(const T* __restrict__ q, const T* __restrict__ alpha,
                        const T* __restrict__ e, const T* __restrict__ d, long long d_sb,
                        T* __restrict__ mats, T* __restrict__ starts, int B, long long S,
                        long long G, long long L) {
  constexpr int Kp = Lanes<K>::Kp, CH = 32 / Kp;
  __shared__ T ebuf[kWarps][2 * CH * Group<K>::kEStride];
  __shared__ T dbuf[kWarps][2 * CH * Group<K>::kDStride];
  __shared__ SegRef<T> tab[kWarps][CH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, r = lane % Kp, c = lane / Kp;
  const long long seg = ((long long)blockIdx.x * kScanThreads + threadIdx.x) / Kp;
  const bool live = seg < (long long)B * (G - 1);
  const int b = live ? (int)(seg / (G - 1)) : 0;
  const long long g = live ? seg % (G - 1) + (kFwd ? 0 : 1) : 0;
  long long first;
  int n;
  segment_of<kFwd>(g, G, L, S, &first, &n);
  if (r == 0)
    tab[warp][c] = SegRef<T>{e + ((long long)b * S + first) * K, d + (long long)b * d_sb + first,
                             nullptr, live ? n : 0};
  __syncwarp();
  const int own = r < K ? r : K - 1;
  T qb[K], lq[K], v[K];
  const T na = chain_start<T, K>(q, alpha, b, qb, lq);
  const bool vec = kFwd ? g == 0 : g == G - 1;
  T q_own = qb[0];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = vec ? (kFwd ? lq[k] : T(0)) : (k == own ? T(0) : -INFINITY);
    q_own = k == own ? qb[k] : q_own;
  }
  const unsigned mask = Kp == 32 ? 0xffffffffu : ((1u << Kp) - 1u) << (lane - r);
  walk<T, K, kFwd, CH, true, false>(tab[warp], ebuf[warp], dbuf[warp], c, qb, q_own, na, mask,
                                    v);
  if (!live || r >= K) return;
  T* out = vec ? (r == 0 ? starts + ((long long)b * G + (kFwd ? 1 : G - 2)) * K : nullptr)
               : mats + (((long long)b * G + g) * K + r) * K;
  if (out) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = v[k];
  }
}

// Step 2.  One thread a chain: forward starts[g+1] from starts[g] and
// segment g's matrix for g = 1 .. G-2; backward starts[g-1] from
// starts[g] for g = G-2 .. 1 (backward starts[g] is row (g+1)L).
template <typename T, int K, bool kFwd>
__global__ void __launch_bounds__(kScanThreads)
    hmm_starts_kernel(const T* __restrict__ mats, T* __restrict__ starts, int B, long long G) {
  const int b = blockIdx.x * kScanThreads + threadIdx.x;
  if (b >= B) return;
  const T* mb = mats + (long long)b * G * K * K;
  T* sb = starts + (long long)b * G * K;
  T v[K];
  const long long g0 = kFwd ? 1 : G - 2;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = sb[g0 * K + k];
  for (long long i = 1; i <= G - 2; ++i) {
    const long long g = kFwd ? i : G - 1 - i;
    compose<T, K>(v, mb + g * K * K);
    const long long to = kFwd ? g + 1 : g - 1;
#pragma unroll
    for (int k = 0; k < K; ++k) sb[to * K + k] = v[k];
  }
}

// Step 3.  One thread a (chain b, segment g): the steps over the segment
// from its start vector (forward g = 0: log q; backward g = G-1: 0, row
// S-1), each message written; forward's last segment writes the loglik,
// backward's first the virtual start row's.
template <typename T, int K, bool kFwd>
__global__ void __launch_bounds__(kScanThreads)
    hmm_messages_kernel(const T* __restrict__ q, const T* __restrict__ alpha,
                        const T* __restrict__ e, const T* __restrict__ d, long long d_sb,
                        const T* __restrict__ starts, T* __restrict__ out, T* __restrict__ ll,
                        int B, long long S, long long G, long long L) {
  __shared__ T ebuf[kWarps][2 * 32 * Group<K>::kEStride];
  __shared__ T dbuf[kWarps][2 * 32 * Group<K>::kDStride];
  __shared__ SegRef<T> tab[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long seg = (long long)blockIdx.x * kScanThreads + threadIdx.x;
  const bool live = seg < (long long)B * G;
  const int b = live ? (int)(seg / G) : 0;
  const long long g = live ? seg % G : 0;
  long long first;
  int n;
  segment_of<kFwd>(g, G, L, S, &first, &n);
  // backward: site first makes row first - 1
  T* ob = out + (long long)b * S * K;
  tab[warp][lane] = SegRef<T>{e + ((long long)b * S + first) * K, d + (long long)b * d_sb + first,
                              ob + (first - (kFwd ? 0 : 1)) * K, live ? n : 0};
  __syncwarp();
  T qb[K], lq[K], v[K];
  const T na = chain_start<T, K>(q, alpha, b, qb, lq);
  const bool edge = kFwd ? g == 0 : g == G - 1;
#pragma unroll
  for (int k = 0; k < K; ++k)
    v[k] = edge ? (kFwd ? lq[k] : T(0)) : starts[((long long)b * G + g) * K + k];
  if (live && !kFwd && edge) {
#pragma unroll
    for (int k = 0; k < K; ++k) ob[(S - 1) * K + k] = T(0);
  }
  walk<T, K, kFwd, 32, false, true>(tab[warp], ebuf[warp], dbuf[warp], lane, qb, qb[0], na, 0u,
                                    v);
  if (!live) return;
  if (kFwd) {
    if (g == G - 1) ll[b] = lse<T, K>(v);
    return;
  }
  if (g != 0) return;
  // the virtual start row, through site 0's transition and emission
  const T* eb = e + (long long)b * S * K;
  T off[K], dg[K], eb_[K], st[K];
  transition<T, K>(qb, na, d[(long long)b * d_sb], off, dg);
#pragma unroll
  for (int l = 0; l < K; ++l) eb_[l] = add_rn(eb[l], v[l]);   // site 0: e[b, 0, l]
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T a[K];
#pragma unroll
    for (int l = 0; l < K; ++l) a[l] = add_rn(k == l ? dg[l] : off[l], eb_[l]);
    st[k] = add_rn(lq[k], lse<T, K>(a));
  }
  ll[b] = lse<T, K>(st);
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    hmm_viterbi_kernel(const T* __restrict__ q, const T* __restrict__ alpha,
                       const T* __restrict__ e, const T* __restrict__ d, long long d_sb,
                       uint8_t* __restrict__ backs, int* __restrict__ path,
                       T* __restrict__ best, int B, long long S) {
  constexpr int U = Ahead<K>::U;
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  T qb[K], v[K];
  const T na = chain_start<T, K>(q, alpha, b, qb, v);
  const T* eb = e + (long long)b * S * K;
  const T* db = d + (long long)b * d_sb;
  // backs[s][b][l]: the warp's chains side by side
  uint8_t* bb = backs + (long long)b * K;
  const long long b_ss = (long long)B * K;
  for (long long s0 = 0; s0 < S; s0 += U) {
    T es[U][K], ds[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u < S) {
        ds[u] = db[s0 + u];
#pragma unroll
        for (int k = 0; k < K; ++k) es[u][k] = eb[(s0 + u) * K + k];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u < S) {
        T off[K], dg[K], nv[K];
        transition<T, K>(qb, na, ds[u], off, dg);
#pragma unroll
        for (int l = 0; l < K; ++l) {
          T top = add_rn(v[0], 0 == l ? dg[l] : off[l]);
          int arg = 0;
#pragma unroll
          for (int k = 1; k < K; ++k) {
            const T sc = add_rn(v[k], k == l ? dg[l] : off[l]);
            if (top == top && (sc > top || sc != sc)) {
              top = sc;
              arg = k;
            }
          }
          nv[l] = add_rn(top, es[u][l]);
          bb[(s0 + u) * b_ss + l] = (uint8_t)arg;
        }
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = nv[k];
      }
    }
  }
  T top = v[0];
  int state = 0;
#pragma unroll
  for (int k = 1; k < K; ++k) {
    if (top == top && (v[k] > top || v[k] != v[k])) {
      top = v[k];
      state = k;
    }
  }
  best[b] = top;
  // traceback through sites S-1 .. 1; each site's K pointers are loaded
  // U sites ahead (their addresses do not depend on the state)
  int* pb = path + (long long)b * S;
  pb[S - 1] = state;
  for (long long s1 = S - 1; s1 >= 1; s1 -= U) {
    uint8_t row[U][K];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s1 - u >= 1) {
#pragma unroll
        for (int k = 0; k < K; ++k) row[u][k] = bb[(s1 - u) * b_ss + k];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s1 - u >= 1) {
        int next = row[u][0];
#pragma unroll
        for (int k = 1; k < K; ++k) next = state == k ? row[u][k] : next;
        state = next;
        pb[s1 - u - 1] = state;
      }
    }
  }
}

inline unsigned grid_of(int B) { return (unsigned)((B + kThreads - 1) / kThreads); }

inline unsigned blocks_of(long long threads) {
  return (unsigned)((threads + kScanThreads - 1) / kScanThreads);
}

// The three launches of one scan (the header's steps 1-3); scratch holds
// the transfer matrices [B, G, K, K] and then the start vectors [B, G, K].
template <typename T, int K, bool kFwd>
int launch_scan(const T* q, const T* alpha, const T* e, const T* d, long long d_sb, T* out,
                T* ll, T* scratch, int B, long long S, long long L, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long G = (S + L - 1) / L;
  T* mats = scratch;
  T* starts = scratch + (long long)B * G * K * K;
  if (G >= 2) {
    hmm_transfer_kernel<T, K, kFwd><<<blocks_of((long long)B * (G - 1) * Lanes<K>::Kp),
                                      kScanThreads, 0, st>>>(q, alpha, e, d, d_sb, mats, starts,
                                                             B, S, G, L);
    if (G >= 3)
      hmm_starts_kernel<T, K, kFwd><<<blocks_of(B), kScanThreads, 0, st>>>(mats, starts, B, G);
  }
  hmm_messages_kernel<T, K, kFwd><<<blocks_of((long long)B * G), kScanThreads, 0, st>>>(
      q, alpha, e, d, d_sb, starts, out, ll, B, S, G, L);
  return (int)cudaGetLastError();
}

template <typename T, int K>
int launch_viterbi(const T* q, const T* alpha, const T* e, const T* d, long long d_sb,
                   uint8_t* backs, int* path, T* best, int B, long long S, void* stream) {
  hmm_viterbi_kernel<T, K><<<grid_of(B), kThreads, 0, (cudaStream_t)stream>>>(
      q, alpha, e, d, d_sb, backs, path, best, B, S);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, long long S, int K) {
  return B < 1 || S < 1 || K < 1 || K > kMaxStates;
}

template <typename T>
int scan_entry(bool fwd, const T* q, const T* alpha, const T* e, const T* d, long long d_sb,
               T* out, T* ll, T* scratch, int B, long long S, int K, long long L,
               void* stream) {
  if (bad_shape(B, S, K) || L < 1 || !q || !alpha || !e || !d || !out || !ll || !scratch)
    return (int)cudaErrorInvalidValue;
  L = L < S ? L : S;
#define NGSD_HMM_SCAN(KK)                                                                   \
  case KK:                                                                                  \
    return fwd ? launch_scan<T, KK, true>(q, alpha, e, d, d_sb, out, ll, scratch, B, S, L,  \
                                          stream)                                           \
               : launch_scan<T, KK, false>(q, alpha, e, d, d_sb, out, ll, scratch, B, S, L, \
                                           stream);
  switch (K) {
    NGSD_HMM_SCAN(1) NGSD_HMM_SCAN(2) NGSD_HMM_SCAN(3) NGSD_HMM_SCAN(4)
    NGSD_HMM_SCAN(5) NGSD_HMM_SCAN(6) NGSD_HMM_SCAN(7) NGSD_HMM_SCAN(8)
  }
#undef NGSD_HMM_SCAN
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int viterbi_entry(const T* q, const T* alpha, const T* e, const T* d, long long d_sb,
                  uint8_t* backs, int* path, T* best, int B, long long S, int K,
                  void* stream) {
  if (bad_shape(B, S, K) || !q || !alpha || !e || !d || !backs || !path || !best)
    return (int)cudaErrorInvalidValue;
#define NGSD_HMM_VITERBI(KK)                                                                \
  case KK:                                                                                  \
    return launch_viterbi<T, KK>(q, alpha, e, d, d_sb, backs, path, best, B, S, stream);
  switch (K) {
    NGSD_HMM_VITERBI(1) NGSD_HMM_VITERBI(2) NGSD_HMM_VITERBI(3) NGSD_HMM_VITERBI(4)
    NGSD_HMM_VITERBI(5) NGSD_HMM_VITERBI(6) NGSD_HMM_VITERBI(7) NGSD_HMM_VITERBI(8)
  }
#undef NGSD_HMM_VITERBI
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Chain-major: e and out [B, S, K], path [B, S] int32, all contiguous;
// q [B, K] and alpha [B] contiguous; d[b * d_sb + s] (d_sb = 0: one
// distance vector for every chain, else S); forward and backward take a
// scratch of B G K (K + 1) elements, G = ceil(S / L), and the segment
// length L (the header); backs a [S, B, K] uint8 scratch.  Returns a CUDA
// error code (0: launched).
#define NGSD_HMM_ENTRIES(T, SUFFIX)                                                          \
  extern "C" int ngsd_hmm_forward_##SUFFIX(const T* q, const T* alpha, const T* e,           \
                                           const T* d, long long d_sb, T* out, T* ll,         \
                                           T* scratch, int B, long long S, int K,             \
                                           long long L, void* stream) {                       \
    return scan_entry<T>(true, q, alpha, e, d, d_sb, out, ll, scratch, B, S, K, L, stream);  \
  }                                                                                           \
  extern "C" int ngsd_hmm_backward_##SUFFIX(const T* q, const T* alpha, const T* e,          \
                                            const T* d, long long d_sb, T* out, T* ll,        \
                                            T* scratch, int B, long long S, int K,            \
                                            long long L, void* stream) {                      \
    return scan_entry<T>(false, q, alpha, e, d, d_sb, out, ll, scratch, B, S, K, L, stream); \
  }                                                                                           \
  extern "C" int ngsd_hmm_viterbi_##SUFFIX(const T* q, const T* alpha, const T* e,           \
                                           const T* d, long long d_sb, uint8_t* backs,        \
                                           int* path, T* best, int B, long long S, int K,     \
                                           void* stream) {                                    \
    return viterbi_entry<T>(q, alpha, e, d, d_sb, backs, path, best, B, S, K, stream);       \
  }

NGSD_HMM_ENTRIES(float, f32)
NGSD_HMM_ENTRIES(double, f64)
#undef NGSD_HMM_ENTRIES
