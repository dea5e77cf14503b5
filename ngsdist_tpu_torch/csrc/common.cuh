// Helpers shared by the port's CUDA kernels (indep.cu, em.cu).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ngsd {

// Missing-genotype tolerance of the reference's miss_data
// (gen_func.hpp:16; ngsdist_tpu/ops/pallas_indep.py EPSILON), in the
// type of the probabilities it is compared with.
constexpr float kEpsilon = 1e-5f;
constexpr double kEpsilonD = 1e-5;

// The 3x3 genotype score matrix, row-major, passed by value.
struct Score9 {
  float v[9];
};

// The same in float64.
struct Score9d {
  double v[9];
};

// max that propagates NaN like jnp.max; fmaxf would drop it.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ double nan_max(double a, double b) {
  return (a > b || a != a) ? a : b;
}

// 1 when the triple is not missing (miss_data: some pair of adjacent
// probabilities differs by at least kEpsilon), else 0.  NaN compares
// false, so a NaN triple counts as missing.
__device__ __forceinline__ float nonmissing(float p0, float p1, float p2) {
  return (fabsf(p0 - p1) >= kEpsilon || fabsf(p1 - p2) >= kEpsilon) ? 1.0f
                                                                      : 0.0f;
}

__device__ __forceinline__ double nonmissing(double p0, double p1, double p2) {
  return (fabs(p0 - p1) >= kEpsilonD || fabs(p1 - p2) >= kEpsilonD) ? 1.0 : 0.0;
}

// Block index k -> tile pair (ti, tj) with ti <= tj, over nt tiles per
// side: blocks enumerate only the upper triangle of the output, diagonal
// tiles included.  k walks the lower triangle row by row (r, c <= r) and
// the pair is transposed; the float estimate of r is corrected exactly.
__device__ __forceinline__ void upper_tile(long long k, int* ti, int* tj) {
  long long r = (long long)((sqrt(8.0 * (double)k + 1.0) - 1.0) * 0.5);
  while (r * (r + 1) / 2 > k) --r;
  while ((r + 1) * (r + 2) / 2 <= k) ++r;
  *ti = (int)(k - r * (r + 1) / 2);
  *tj = (int)r;
}

}  // namespace ngsd
