// The inbreeding HMM's log-space scans on Hopper: forward, backward and
// Viterbi over the sites of a batch of chains.
//
// Replaces: ngsdist_tpu/popgen/hmm.py forward (:73), backward (:92) and
// viterbi (:130), each a lax.scan over sites (XLA, not Pallas) vmapped
// over chains.  The plain PyTorch version, a loop over sites batched
// over chains, is ngsdist_tpu_torch/ops/hmm.py hmm_*_ref.
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
// once, in the plain version's order, and exp and log are the CUDA math
// library's, which PyTorch's own exp and log call on the card.  The bound
// the smoke holds the two to (ops/hmm.py hmm_bound, PERF.md section 2)
// assumes only that each side's exp and log lie within 1 ulp.
//
// What bounds it.  By bytes, forward at 1024 chains x 262,144 sites x
// K = 2 in float64 reads e (4.29 GB) and writes the messages (4.29 GB):
// 2.56 ms at 3.35e12 B/s.  This first design runs one thread per chain,
// walking the sites in order, so its time is the serial chain of each
// step: the transition row's exp and 2K logs, then per state K
// exponentials and one log that depend on the previous step.  The
// transition (no dependence on the messages) and the loads of the next
// U sites (issued together, a register array) overlap that chain; the
// [S, K, K] matrices are never written to memory.  One warp a block
// spreads 1024 chains over 32 SMs.  Splitting the sites into segments
// whose K x K transfer matrices compose in the log semiring is the
// site-parallel redesign (ROADMAP).
//
// Layout.  e and the messages are chain-major [B, S, K] and the path
// [B, S], the JAX layout, so nothing is copied on the way in or out: a
// thread's consecutive sites are adjacent and reach it through L1.  A
// site-major layout (a warp's loads contiguous, a transpose each way) was
// measured once against it (PERF.md section 6) and not kept.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 32;   // one warp a block
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

// Sites whose loads a thread issues together.
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

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    hmm_forward_kernel(const T* __restrict__ q, const T* __restrict__ alpha,
                       const T* __restrict__ e, const T* __restrict__ d, long long d_sb,
                       T* __restrict__ out, T* __restrict__ ll, int B, long long S) {
  constexpr int U = Ahead<K>::U;
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  T qb[K], f[K];
  const T na = chain_start<T, K>(q, alpha, b, qb, f);
  const T* eb = e + (long long)b * S * K;
  const T* db = d + (long long)b * d_sb;
  T* ob = out + (long long)b * S * K;
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
        T off[K], dg[K], nf[K];
        transition<T, K>(qb, na, ds[u], off, dg);
#pragma unroll
        for (int l = 0; l < K; ++l) {
          T a[K];
#pragma unroll
          for (int k = 0; k < K; ++k) a[k] = add_rn(f[k], k == l ? dg[l] : off[l]);
          nf[l] = add_rn(lse<T, K>(a), es[u][l]);
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          f[k] = nf[k];
          ob[(s0 + u) * K + k] = nf[k];
        }
      }
    }
  }
  ll[b] = lse<T, K>(f);
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    hmm_backward_kernel(const T* __restrict__ q, const T* __restrict__ alpha,
                        const T* __restrict__ e, const T* __restrict__ d, long long d_sb,
                        T* __restrict__ out, T* __restrict__ ll, int B, long long S) {
  constexpr int U = Ahead<K>::U;
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  T qb[K], lq[K], bk[K];
  const T na = chain_start<T, K>(q, alpha, b, qb, lq);
  const T* eb = e + (long long)b * S * K;
  const T* db = d + (long long)b * d_sb;
  T* ob = out + (long long)b * S * K;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bk[k] = T(0);
    ob[(S - 1) * K + k] = T(0);
  }
  // site s gives row s - 1, for s = S-1 .. 1
  for (long long s1 = S - 1; s1 >= 1; s1 -= U) {
    T es[U][K], ds[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s1 - u >= 1) {
        ds[u] = db[s1 - u];
#pragma unroll
        for (int k = 0; k < K; ++k) es[u][k] = eb[(s1 - u) * K + k];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s1 - u >= 1) {
        T off[K], dg[K], eb_[K], nb[K];
        transition<T, K>(qb, na, ds[u], off, dg);
#pragma unroll
        for (int l = 0; l < K; ++l) eb_[l] = add_rn(es[u][l], bk[l]);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          T a[K];
#pragma unroll
          for (int l = 0; l < K; ++l) a[l] = add_rn(k == l ? dg[l] : off[l], eb_[l]);
          nb[k] = lse<T, K>(a);
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          bk[k] = nb[k];
          ob[(s1 - u - 1) * K + k] = nb[k];
        }
      }
    }
  }
  // the virtual start row, through site 0's transition and emission
  T off[K], dg[K], eb_[K], st[K];
  transition<T, K>(qb, na, db[0], off, dg);
#pragma unroll
  for (int l = 0; l < K; ++l) eb_[l] = add_rn(eb[l], bk[l]);   // site 0: e[b, 0, l]
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

template <typename T, int K>
int launch_scan(bool fwd, const T* q, const T* alpha, const T* e, const T* d, long long d_sb,
                T* out, T* ll, int B, long long S, void* stream) {
  if (fwd)
    hmm_forward_kernel<T, K><<<grid_of(B), kThreads, 0, (cudaStream_t)stream>>>(
        q, alpha, e, d, d_sb, out, ll, B, S);
  else
    hmm_backward_kernel<T, K><<<grid_of(B), kThreads, 0, (cudaStream_t)stream>>>(
        q, alpha, e, d, d_sb, out, ll, B, S);
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
               T* out, T* ll, int B, long long S, int K, void* stream) {
  if (bad_shape(B, S, K) || !q || !alpha || !e || !d || !out || !ll)
    return (int)cudaErrorInvalidValue;
#define NGSD_HMM_SCAN(KK)                                                                   \
  case KK:                                                                                  \
    return launch_scan<T, KK>(fwd, q, alpha, e, d, d_sb, out, ll, B, S, stream);
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
// distance vector for every chain, else S); backs a [S, B, K] uint8
// scratch.  Returns a CUDA error code (0: launched).
#define NGSD_HMM_ENTRIES(T, SUFFIX)                                                          \
  extern "C" int ngsd_hmm_forward_##SUFFIX(const T* q, const T* alpha, const T* e,           \
                                           const T* d, long long d_sb, T* out, T* ll, int B, \
                                           long long S, int K, void* stream) {                \
    return scan_entry<T>(true, q, alpha, e, d, d_sb, out, ll, B, S, K, stream);              \
  }                                                                                           \
  extern "C" int ngsd_hmm_backward_##SUFFIX(const T* q, const T* alpha, const T* e,          \
                                            const T* d, long long d_sb, T* out, T* ll, int B, \
                                            long long S, int K, void* stream) {               \
    return scan_entry<T>(false, q, alpha, e, d, d_sb, out, ll, B, S, K, stream);             \
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
