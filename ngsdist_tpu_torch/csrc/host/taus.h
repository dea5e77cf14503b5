/* Tausworthe ("taus") combined LFSR random number generator.
 *
 * Implements the classic three-component maximally-equidistributed
 * combined Tausworthe generator of L'Ecuyer (1996), with the same
 * seeding procedure and output scaling used by the GNU Scientific
 * Library's "gsl_rng_taus" generator, so that bootstrap block index
 * streams are reproducible against pipelines that used GSL-seeded
 * ngsDist (reference: reference ngsDist.cpp:179-180 seeds
 * gsl_rng_taus; reference shared/gen_func.cpp:117-119 consumes
 * one uniform per block draw).
 *
 * This is an independent implementation from the published algorithm:
 *   P. L'Ecuyer, "Maximally equidistributed combined Tausworthe
 *   generators", Mathematics of Computation 65 (1996) 203-213.
 */
#ifndef NGSDIST_TAUS_H
#define NGSDIST_TAUS_H

#include <stdint.h>

typedef struct {
  uint32_t s1, s2, s3;
} nd_taus_state;

static inline uint32_t nd_taus_next(nd_taus_state *st) {
  /* One step of each component LFSR, combined by xor. */
  st->s1 = (((st->s1 & 4294967294u) << 12)) ^ (((st->s1 << 13) ^ st->s1) >> 19);
  st->s2 = (((st->s2 & 4294967288u) << 4)) ^ (((st->s2 << 2) ^ st->s2) >> 25);
  st->s3 = (((st->s3 & 4294967280u) << 17)) ^ (((st->s3 << 3) ^ st->s3) >> 11);
  return st->s1 ^ st->s2 ^ st->s3;
}

static inline void nd_taus_seed(nd_taus_state *st, uint32_t seed) {
  /* Seed each component with an LCG chain; component k must have its
   * low k bits avoided (periods require s1>=2, s2>=8, s3>=16), then
   * discard six outputs to decorrelate from the seed. */
  uint32_t s = seed ? seed : 1u;
  st->s1 = 69069u * s;
  if (st->s1 < 2u) st->s1 += 2u;
  st->s2 = 69069u * st->s1;
  if (st->s2 < 8u) st->s2 += 8u;
  st->s3 = 69069u * st->s2;
  if (st->s3 < 16u) st->s3 += 16u;
  for (int i = 0; i < 6; i++) (void)nd_taus_next(st);
}

/* Uniform deviate on [0,1): 32 output bits scaled by 2^-32. */
static inline double nd_taus_uniform(nd_taus_state *st) {
  return nd_taus_next(st) / 4294967296.0;
}

#endif /* NGSDIST_TAUS_H */
