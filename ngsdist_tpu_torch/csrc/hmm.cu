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
//   viterbi:  v = log q;  v_s[l] = max_k(v_{s-1}[k] + log T_s[k][l]) + e_s[l]
//             and its arg max (the first maximal k; a NaN counts as
//             maximal, as jnp.argmax), the back pointer of (s, l); the best
//             score max(v_{S-1}), the path from its arg max back through the
//             pointers of sites S-1 .. 1.
// lse is jax.scipy.special.logsumexp's arithmetic: m = max (NaN-propagating),
// m := 0 where it is not finite (all -inf gives -inf), the exponentials of
// a_k - m added in k order, log of the sum plus m.
//
// Rounding.  Every add, subtract and multiply goes through the _rn
// intrinsics, so nvcc contracts none of them into an FMA: each is rounded
// once, and exp and log are the CUDA math library's, which PyTorch's own
// exp and log call on the card.  All three reassociate the recursion
// (below): ops/hmm.py hmm_scan_segmented_ref (forward, backward) and
// hmm_viterbi_segmented_ref are their order in plain PyTorch, which they
// equal bit for bit, and hmm_bound(..., L) the derived bound that holds
// them to the sequential plain version (PERF.md section 2).
//
// Site segments.  A step is linear in the exponentials of the messages
// (forward, backward) or in max-plus (Viterbi: max for the sum, + for the
// product), so the steps over a segment of sites compose into a K x K
// transfer matrix in that semiring.  A chain's S sites split into G =
// ceil(S / L) segments of L sites; L is the wrapper's constant
// (ops/hmm.py SEGMENT; smaller only in tests, to cross segment edges at
// small S), never a function of B, so a chain's bits do not depend on the
// batch it came in.  Launches on the caller's stream:
//   1. transfers (hmm_transfer_kernel): per (chain, segment), the steps
//      over the segment from each of the K unit log-vectors (0 at k, -inf
//      elsewhere), one lane a vector, the Kp (K rounded up to a power of 2)
//      lanes of a segment sharing each site's transition row through
//      shuffles; the first segment (backward: the last) walks from log q
//      (backward: 0) instead and gives the scan its first start vector.
//      The last segment (backward: the first) needs no matrix.
//   2. starts (hmm_starts_kernel): per chain, each segment's start vector
//      from the previous one and a transfer matrix (K^2 log-sum-exps, or
//      maxes, a segment), in segment order.
//   3. messages: per (chain, segment), the steps over the segment from its
//      start vector.  Forward and backward (hmm_messages_kernel) write the
//      messages and the logliks as the sequential walk forms them.
//      Viterbi (hmm_backpointers_kernel) writes the back pointers, and
//      carries for each state j the state at the previous segment's last
//      site that the best path to j comes from (K registers, updated with
//      each arg max): the segment's map; the last segment gives the best
//      score and the final state.
//   Viterbi then has two more:
//   4. stitch (hmm_stitch_kernel): per chain, in reverse segment order,
//      the state at the end of segment g - 1 is segment g's map of the
//      state at the end of segment g.
//   5. traceback (hmm_traceback_kernel): per (chain, segment), the path
//      over the segment from its end state through its back pointers (the
//      first site's pointer, into the previous segment or the virtual
//      start row, is not followed: the map or nothing gives that state).
// With G = 1 step 3 is the sequential walk, and with G = 2 its second
// start is the sequential walk's own message, so below 2 L sites all stay
// bit for bit the plain version's.  At 1024 chains x 262,144 sites, L =
// 1024: 262,144 (chain, segment) threads in steps 3 and 5, Kp times that
// many lanes in step 1, where a sequential walk has 1024 threads.
//
// Loads and stores.  A warp's lanes walk 32 segments (steps 3, 5) or
// 32 / Kp (step 1) in lock step.  The next U sites of each (their
// emissions and distances) are copied by all the warp's lanes together,
// with cp.async, into a double buffer in shared memory while the current
// U sites are computed: each copy instruction reads four segments'
// adjacent values, and the slots' odd strides let each lane read its own
// segment's without bank conflicts.  Forward's and backward's step 3
// writes each message over the emissions it came from, and the warp
// stores the group's messages as it loaded them.  Viterbi's back pointers
// are a site's K arg maxes in one word (a nibble each: 1, 2 or 4 bytes
// for K <= 2, 4, 8), laid out [L][B G] (step i of every segment side by
// side), so a warp's lanes store and load adjacent words; the traceback
// stages U path entries of each lane's segment in shared memory and the
// warp stores them as rows of adjacent sites.
//
// What bounds it.  By bytes, forward at 1024 chains x 262,144 sites x
// K = 2 in float64 reads e (4.29 GB) and writes the messages (4.29 GB):
// 2.56 ms at 3.35e12 B/s (this design reads e twice); Viterbi reads e
// and writes the int32 path (1.07 GB): 1.60 ms (it reads e twice and
// writes and reads 0.27 GB of back pointers).  By operations, the exps
// and logs: at K = 2 a forward step-1 lane's 9 a site (its share of the
// transition row, 1 exp and 2 logs, and its vector's 2 log-sum-exps) and
// step 3's 11, 29 a (chain, site), on the FP64 pipe in float64, which
// binds (more warps a SM do not help); Viterbi's step-1 lane 3 and step
// 3's 5 (the row's 1 exp and 2K logs; max-plus has none of its own).
// Tensor cores do not apply: the step is a log-sum-exp or a max of sums,
// and neither semiring maps onto an MMA.
//
// Layout.  e and the messages are chain-major [B, S, K] and the path
// [B, S], the JAX layout, so nothing is copied on the way in or out.  A
// site-major layout (a warp's loads contiguous, a transpose each way) was
// measured once against the sequential walk (PERF.md section 6) and not
// kept.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kScanThreads = 128;  // four warps a block
constexpr int kWarps = kScanThreads / 32;
constexpr int kMaxStates = 8;
constexpr int kTraceSites = 32;    // path entries a traceback lane stages: a row of 128 bytes

enum Kind { kForward, kBackward, kViterbi };

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

// ---- the segmented scans ----

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

// max_k a[k] as argmax_first takes it: the first maximal value, a NaN
// maximal (the first NaN).
template <typename T, int K>
__device__ __forceinline__ T max_first(const T (&a)[K]) {
  T top = a[0];
#pragma unroll
  for (int k = 1; k < K; ++k)
    if (top == top && (a[k] > top || a[k] != a[k])) top = a[k];
  return top;
}

// One Viterbi step: v[l] := max_k(v[k] + log T[k][l]) + e[l], the max as
// max_first takes it.  kPtr: also each l's arg max k, returned as nibble l
// of a word, and org[l] := org[that k] (the state a segment's path to l
// started from).
template <typename T, int K, bool kPtr>
__device__ __forceinline__ unsigned viterbi_step(T (&v)[K], const T (&off)[K], const T (&dg)[K],
                                                 const T (&es)[K], int (&org)[K]) {
  T nv[K];
  int no[K];
  unsigned word = 0;
#pragma unroll
  for (int l = 0; l < K; ++l) {
    T top = add_rn(v[0], 0 == l ? dg[l] : off[l]);
    int arg = 0, o = org[0];
#pragma unroll
    for (int k = 1; k < K; ++k) {
      const T sc = add_rn(v[k], k == l ? dg[l] : off[l]);
      if (top == top && (sc > top || sc != sc)) {
        top = sc;
        arg = k;
        o = org[k];
      }
    }
    nv[l] = add_rn(top, es[l]);
    word |= (unsigned)arg << (4 * l);
    no[l] = o;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = nv[k];
    if (kPtr) org[k] = no[k];
  }
  return word;
}

// The step of a scan of kind kKind on one lane's vector, as walk() calls it.
template <typename T, int K, int kKind>
struct ScanStep {
  __device__ __forceinline__ void operator()(T (&v)[K], const T (&off)[K], const T (&dg)[K],
                                             const T (&es)[K], int) const {
    if constexpr (kKind == kForward) {
      forward_step<T, K>(v, off, dg, es);
    } else if constexpr (kKind == kBackward) {
      backward_step<T, K>(v, off, dg, es);
    } else {
      int org[K] = {};
      viterbi_step<T, K, false>(v, off, dg, es, org);
    }
  }
};

// A start vector composed with a segment's transfer matrix m[run][comp],
// v[j] := lse_i(v[i] + m[i][j]) (Viterbi: max_first): forward and Viterbi
// runs start at the segment's first site (i the state before it),
// backward runs at its top row.
template <typename T, int K, int kKind>
__device__ __forceinline__ void compose(T (&v)[K], const T* m) {
  T nv[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    T a[K];
#pragma unroll
    for (int i = 0; i < K; ++i) a[i] = add_rn(v[i], m[i * K + j]);
    nv[j] = kKind == kViterbi ? max_first<T, K>(a) : lse<T, K>(a);
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
// tab[c], its message v, step(v, off, dg, es, i) its step i; each step's
// transition row from the lane's own q (kShared: one state's, shuffled);
// kStore: the messages after each step written to the segment's out.
template <typename T, int K, bool kFwd, int CH, bool kShared, bool kStore, typename Step>
__device__ __forceinline__ void walk(const SegRef<T>* tab, T* ebuf, T* dbuf, int c,
                                     const T (&qb)[K], T q_own, T nalpha, unsigned mask,
                                     T (&v)[K], Step step) {
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
        step(v, off, dg, es, j * U + u);
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
// vector of state min(r, K-1) (forward and Viterbi g = 0: log q; backward
// g = G-1: 0) and writes row r of the segment's transfer matrix (or the
// start vector it gives).  Forward and Viterbi take segments 0 .. G-2,
// backward 1 .. G-1.
template <typename T, int K, int kKind>
__global__ void __launch_bounds__(kScanThreads)
    hmm_transfer_kernel(const T* __restrict__ q, const T* __restrict__ alpha,
                        const T* __restrict__ e, const T* __restrict__ d, long long d_sb,
                        T* __restrict__ mats, T* __restrict__ starts, int B, long long S,
                        long long G, long long L) {
  constexpr int Kp = Lanes<K>::Kp, CH = 32 / Kp;
  constexpr bool kFwd = kKind != kBackward;
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
                                    v, ScanStep<T, K, kKind>{});
  if (!live || r >= K) return;
  T* out = vec ? (r == 0 ? starts + ((long long)b * G + (kFwd ? 1 : G - 2)) * K : nullptr)
               : mats + (((long long)b * G + g) * K + r) * K;
  if (out) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = v[k];
  }
}

// Step 2.  One thread a chain: forward and Viterbi starts[g+1] from
// starts[g] and segment g's matrix for g = 1 .. G-2; backward starts[g-1]
// from starts[g] for g = G-2 .. 1 (backward starts[g] is row (g+1)L).
template <typename T, int K, int kKind>
__global__ void __launch_bounds__(kScanThreads)
    hmm_starts_kernel(const T* __restrict__ mats, T* __restrict__ starts, int B, long long G) {
  constexpr bool kFwd = kKind != kBackward;
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
    compose<T, K, kKind>(v, mb + g * K * K);
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
                                    v, ScanStep<T, K, kFwd ? kForward : kBackward>{});
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

// Viterbi's back pointers of one site: its K arg maxes, a nibble each.
template <int K>
struct Ptrs {
  using W = typename std::conditional<K <= 2, uint8_t,
                                      typename std::conditional<K <= 4, uint16_t,
                                                                uint32_t>::type>::type;
};

// Viterbi's step 3.  One thread a (chain b, segment g): the steps over
// the segment from its start vector (g = 0: log q), the back pointers of
// its step i written to backs[i][b G + g]; then the segment's map (the
// state at the previous segment's last site that the best path to each
// state comes from) to maps[b][g], and the last segment's best score and
// final state (max_first's value and the first index that gives it).
template <typename T, int K>
__global__ void __launch_bounds__(kScanThreads)
    hmm_backpointers_kernel(const T* __restrict__ q, const T* __restrict__ alpha,
                            const T* __restrict__ e, const T* __restrict__ d, long long d_sb,
                            const T* __restrict__ starts, typename Ptrs<K>::W* __restrict__ backs,
                            uint8_t* __restrict__ maps, uint8_t* __restrict__ ends,
                            T* __restrict__ best, int B, long long S, long long G, long long L) {
  using W = typename Ptrs<K>::W;
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
  segment_of<true>(g, G, L, S, &first, &n);
  tab[warp][lane] = SegRef<T>{e + ((long long)b * S + first) * K, d + (long long)b * d_sb + first,
                              nullptr, live ? n : 0};
  __syncwarp();
  T qb[K], lq[K], v[K];
  int org[K];
  const T na = chain_start<T, K>(q, alpha, b, qb, lq);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = g == 0 ? lq[k] : starts[((long long)b * G + g) * K + k];
    org[k] = k;
  }
  W* bp = backs + seg;
  const long long stride = (long long)B * G;
  walk<T, K, true, 32, false, false>(
      tab[warp], ebuf[warp], dbuf[warp], lane, qb, qb[0], na, 0u, v,
      [&](T (&x)[K], const T (&off)[K], const T (&dg)[K], const T (&es)[K], int i) {
        bp[i * stride] = (W)viterbi_step<T, K, true>(x, off, dg, es, org);
      });
  if (!live) return;
#pragma unroll
  for (int k = 0; k < K; ++k) maps[seg * K + k] = (uint8_t)org[k];
  if (g != G - 1) return;
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
  ends[seg] = (uint8_t)state;
}

// Viterbi's step 4.  One thread a chain: ends[b][g-1] := maps[b][g]
// [ends[b][g]] for g = G-1 .. 1.
__global__ void __launch_bounds__(kScanThreads)
    hmm_stitch_kernel(const uint8_t* __restrict__ maps, uint8_t* __restrict__ ends, int B,
                      long long G, int K) {
  const int b = blockIdx.x * kScanThreads + threadIdx.x;
  if (b >= B) return;
  const uint8_t* mb = maps + (long long)b * G * K;
  uint8_t* eb = ends + (long long)b * G;
  int state = eb[G - 1];
  for (long long g = G - 1; g >= 1; --g) {
    state = mb[g * K + state];
    eb[g - 1] = (uint8_t)state;
  }
}

// A segment's path in the traceback: its first entry and its sites.
struct PathRef {
  int* out;
  int n;
};

// Viterbi's step 5.  One thread a (chain b, segment g): from the state at
// the segment's last site (ends[b][g]) down its sites, each site's state
// written and its back pointer followed (not the first site's), U sites
// at a time: the lane loads the U sites' pointer words together (their
// addresses do not depend on the state), stages the U states in shared
// memory, and the warp stores each segment's U adjacent entries.
template <int K>
__global__ void __launch_bounds__(kScanThreads)
    hmm_traceback_kernel(const typename Ptrs<K>::W* __restrict__ backs,
                         const uint8_t* __restrict__ ends, int* __restrict__ path, int B,
                         long long S, long long G, long long L) {
  using W = typename Ptrs<K>::W;
  constexpr int U = kTraceSites, PS = U + 1;
  __shared__ int pbuf[kWarps][32 * PS];
  __shared__ PathRef tab[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long seg = (long long)blockIdx.x * kScanThreads + threadIdx.x;
  const bool live = seg < (long long)B * G;
  const int b = live ? (int)(seg / G) : 0;
  const long long g = live ? seg % G : 0;
  long long first;
  int n;
  segment_of<true>(g, G, L, S, &first, &n);
  if (!live) n = 0;
  tab[warp][lane] = PathRef{path + (long long)b * S + first, n};
  __syncwarp();
  const int n_max = (int)__reduce_max_sync(0xffffffffu, (unsigned)n);
  const W* bp = backs + (live ? seg : 0);
  const long long stride = (long long)B * G;
  int state = live ? ends[seg] : 0;
  int* pb = pbuf[warp];
  for (int j = (n_max + U - 1) / U - 1; j >= 0; --j) {
    W w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = j * U + u;
      w[u] = (i >= 1 && i < n) ? bp[i * stride] : W(0);
    }
#pragma unroll
    for (int u = U - 1; u >= 0; --u) {
      if (j * U + u < n) {
        pb[lane * PS + u] = state;
        state = (int)(((unsigned)w[u] >> (4 * state)) & 0xFu);
      }
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < U; ++t) {
      const int cc = t * (32 / U) + lane / U, uu = lane % U, i = j * U + uu;
      if (i < tab[warp][cc].n) tab[warp][cc].out[i] = pb[cc * PS + uu];
    }
    __syncwarp();
  }
}

inline unsigned blocks_of(long long threads) {
  return (unsigned)((threads + kScanThreads - 1) / kScanThreads);
}

// The three launches of one scan (the header's steps 1-3); scratch holds
// the transfer matrices [B, G, K, K] and then the start vectors [B, G, K].
template <typename T, int K, bool kFwd>
int launch_scan(const T* q, const T* alpha, const T* e, const T* d, long long d_sb, T* out,
                T* ll, T* scratch, int B, long long S, long long L, void* stream) {
  constexpr int kKind = kFwd ? kForward : kBackward;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long G = (S + L - 1) / L;
  T* mats = scratch;
  T* starts = scratch + (long long)B * G * K * K;
  if (G >= 2) {
    hmm_transfer_kernel<T, K, kKind><<<blocks_of((long long)B * (G - 1) * Lanes<K>::Kp),
                                       kScanThreads, 0, st>>>(q, alpha, e, d, d_sb, mats, starts,
                                                              B, S, G, L);
    if (G >= 3)
      hmm_starts_kernel<T, K, kKind><<<blocks_of(B), kScanThreads, 0, st>>>(mats, starts, B, G);
  }
  hmm_messages_kernel<T, K, kFwd><<<blocks_of((long long)B * G), kScanThreads, 0, st>>>(
      q, alpha, e, d, d_sb, starts, out, ll, B, S, G, L);
  return (int)cudaGetLastError();
}

// Viterbi's five launches (the header's steps 1-5; 1 and 4 need two
// segments, 2 three); scratch as launch_scan's, backs the pointer words
// [L][B G], then the maps [B, G, K] and the end states [B, G] (uint8).
template <typename T, int K>
int launch_viterbi(const T* q, const T* alpha, const T* e, const T* d, long long d_sb,
                   uint8_t* backs, int* path, T* best, T* scratch, int B, long long S,
                   long long L, void* stream) {
  using W = typename Ptrs<K>::W;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long G = (S + L - 1) / L;
  T* mats = scratch;
  T* starts = scratch + (long long)B * G * K * K;
  W* bp = reinterpret_cast<W*>(backs);
  uint8_t* maps = backs + L * B * G * (long long)sizeof(W);
  uint8_t* ends = maps + (long long)B * G * K;
  if (G >= 2) {
    hmm_transfer_kernel<T, K, kViterbi><<<blocks_of((long long)B * (G - 1) * Lanes<K>::Kp),
                                          kScanThreads, 0, st>>>(q, alpha, e, d, d_sb, mats,
                                                                 starts, B, S, G, L);
    if (G >= 3)
      hmm_starts_kernel<T, K, kViterbi><<<blocks_of(B), kScanThreads, 0, st>>>(mats, starts, B,
                                                                              G);
  }
  hmm_backpointers_kernel<T, K><<<blocks_of((long long)B * G), kScanThreads, 0, st>>>(
      q, alpha, e, d, d_sb, starts, bp, maps, ends, best, B, S, G, L);
  if (G >= 2) hmm_stitch_kernel<<<blocks_of(B), kScanThreads, 0, st>>>(maps, ends, B, G, K);
  hmm_traceback_kernel<K><<<blocks_of((long long)B * G), kScanThreads, 0, st>>>(bp, ends, path,
                                                                                 B, S, G, L);
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
                  uint8_t* backs, int* path, T* best, T* scratch, int B, long long S, int K,
                  long long L, void* stream) {
  if (bad_shape(B, S, K) || L < 1 || !q || !alpha || !e || !d || !backs || !path || !best ||
      !scratch)
    return (int)cudaErrorInvalidValue;
  L = L < S ? L : S;
#define NGSD_HMM_VITERBI(KK)                                                                 \
  case KK:                                                                                   \
    return launch_viterbi<T, KK>(q, alpha, e, d, d_sb, backs, path, best, scratch, B, S, L, \
                                 stream);
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
// distance vector for every chain, else S); each entry takes a scratch of
// B G K (K + 1) elements, G = ceil(S / L), and the segment length L (the
// header); Viterbi also backs, a uint8 scratch of L' B G P + B G (K + 1)
// bytes, L' = min(L, S), P = 1, 2 or 4 for K <= 2, 4 or 8 (its back
// pointers, maps and end states).  Returns a CUDA error code (0: launched).
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
                                           int* path, T* best, T* scratch, int B, long long S, \
                                           int K, long long L, void* stream) {                \
    return viterbi_entry<T>(q, alpha, e, d, d_sb, backs, path, best, scratch, B, S, K, L,    \
                            stream);                                                          \
  }

NGSD_HMM_ENTRIES(float, f32)
NGSD_HMM_ENTRIES(double, f64)
#undef NGSD_HMM_ENTRIES
