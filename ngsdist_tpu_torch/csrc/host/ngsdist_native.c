/* ngsdist_tpu_torch native host runtime: exact host-side I/O,
 * preprocessing and a bit-exact CPU pairwise-distance engine.  A copy of
 * the JAX package's runtime (ngsdist_tpu/native/src), whole: the port's
 * Python side (utils/native.py) calls the readers, the elementwise
 * transforms, the matrix formatter, the bootstrap stream and the
 * per-site EM; the fused readers' and the pair engine's entry points
 * wait for the parts of the port that will call them.
 *
 * Role in the framework: the device compute path lives in PyTorch and
 * CUDA (core/distance.py, ops/, csrc/).  This library is the native
 * runtime around it:
 *   - gzip/TSV/binary genotype-probability readers with the exact field
 *     splitting, normalization and error semantics of the reference
 *     implementation (behavior contract: reference shared/
 *     read_data.cpp:13-116, gen_func.cpp:123-181,886-932);
 *   - glibc-backed elementwise exp/log/log-normalize used so that the
 *     preprocessing pipeline is bit-identical to a C pipeline (numpy's
 *     vectorized exp/log differ from glibc by 1 ulp);
 *   - a threaded, ordered-accumulation pairwise distance engine used as
 *     the md5-parity oracle and CPU fallback (behavior contract:
 *     reference ngsDist.cpp:325-404, emOptim2.cpp:69-135);
 *   - the Tausworthe bootstrap index stream (taus.h) matching GSL-seeded
 *     runs of the reference (reference ngsDist.cpp:416-437).
 *
 * This is a from-scratch implementation: data is carried in flat
 * site-major / individual-major arrays handed to numpy via ctypes, not
 * in the reference's per-site pointer structures.
 */

#include <fcntl.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <stdint.h>
#include <errno.h>
#include <math.h>
#include <pthread.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

#include "taus.h"

#define ND_EXPORT __attribute__((visibility("default")))

/* Constants shared with the reference semantics
 * (reference shared/gen_func.hpp:14-17). */
#define ND_NGENO 3
#define ND_BIGNEG 1.0e15 /* "INF" sentinel: log-space missing = -1e15 */
#define ND_EPSILON 1.0e-5
#define ND_LINE_MAX 500000

/* ------------------------------------------------------------------ */
/* Bootstrap block index stream                                        */
/* ------------------------------------------------------------------ */

/* Fill out[rep*n_blocks + b] with the source block drawn for destination
 * block b of replicate rep (1-based replicates; rep 0 of the reference is
 * the unresampled full data and consumes no draws).  One uniform deviate
 * is consumed per (rep, block) in row order, matching the single global
 * RNG stream of the reference (reference ngsDist.cpp:217-237,423;
 * draw_rnd at shared/gen_func.cpp:117-119). */
ND_EXPORT void nd_boot_block_indices(uint32_t seed, uint64_t n_reps,
                                     uint64_t n_blocks, uint64_t *out) {
  nd_taus_state st;
  nd_taus_seed(&st, seed);
  for (uint64_t r = 0; r < n_reps; r++)
    for (uint64_t b = 0; b < n_blocks; b++) {
      double u = 0.0 + nd_taus_uniform(&st) * (double)(n_blocks - 0);
      out[r * n_blocks + b] = (uint64_t)floor(u);
    }
}

/* Raw uniforms, for tests of the RNG stream itself. */
ND_EXPORT void nd_taus_uniforms(uint32_t seed, uint64_t n, double *out) {
  nd_taus_state st;
  nd_taus_seed(&st, seed);
  for (uint64_t i = 0; i < n; i++) out[i] = nd_taus_uniform(&st);
}

/* ------------------------------------------------------------------ */
/* Exact elementwise transforms (glibc libm)                           */
/* ------------------------------------------------------------------ */

typedef struct {
  double *x;
  int64_t lo, hi;
} nd_exp_job;

static void *nd_exp_worker(void *arg) {
  nd_exp_job *j = (nd_exp_job *)arg;
  for (int64_t i = j->lo; i < j->hi; i++) {
    j->x[i] = exp(j->x[i]);
    if (j->x[i] == -INFINITY) j->x[i] = -ND_BIGNEG; /* conv_space clamp */
  }
  return NULL;
}

ND_EXPORT void nd_exp_array(double *x, int64_t n) {
  /* Elementwise exp is the whole of normal-space conversion for
   * billion-element tensors (1k ind x 1M sites = 3e9 doubles), so it
   * runs parallel across cores; per-element arithmetic is unchanged. */
  long nt = sysconf(_SC_NPROCESSORS_ONLN);
  if (nt < 1) nt = 1;
  if (nt > 16) nt = 16;
  if (n < (1 << 20) || nt == 1) {
    nd_exp_job j = {x, 0, n};
    nd_exp_worker(&j);
    return;
  }
  nd_exp_job jobs[16];
  pthread_t tids[16];
  int64_t chunk = (n + nt - 1) / nt;
  long nw = 0; /* created threads only: a failed create runs inline */
  for (long w = 0; w < nt; w++) {
    int64_t lo = w * chunk, hi = (w + 1) * chunk;
    if (hi > n) hi = n;
    jobs[w] = (nd_exp_job){x, lo, hi};
    if (pthread_create(&tids[nw], NULL, nd_exp_worker, &jobs[w]))
      nd_exp_worker(&jobs[w]);
    else
      nw++;
  }
  for (long w = 0; w < nw; w++) pthread_join(tids[w], NULL);
}

typedef struct {
  double *x;
  int64_t lo, hi;
  double v;
} nd_fill_job;

static void *nd_fill_worker(void *arg) {
  nd_fill_job *j = (nd_fill_job *)arg;
  for (int64_t i = j->lo; i < j->hi; i++) j->x[i] = j->v;
  return NULL;
}

/* Threaded fill: the first write to a fresh allocation pays the page
 * fault, and on para-virtualized kernels faulting is slow per thread,
 * so a serial init of a multi-GB tensor is cut by as many threads as
 * fill it.  Also the bandwidth-bound fast path on bare metal. */
ND_EXPORT void nd_fill_array(double *x, int64_t n, double v) {
  long nt = sysconf(_SC_NPROCESSORS_ONLN);
  if (nt < 1) nt = 1;
  if (nt > 16) nt = 16;
  if (n < (1 << 20) || nt == 1) {
    nd_fill_job j = {x, 0, n, v};
    nd_fill_worker(&j);
    return;
  }
  nd_fill_job jobs[16];
  pthread_t tids[16];
  int64_t chunk = (n + nt - 1) / nt;
  long nw = 0;
  for (long w = 0; w < nt; w++) {
    int64_t lo = w * chunk, hi = (w + 1) * chunk;
    if (hi > n) hi = n;
    jobs[w] = (nd_fill_job){x, lo, hi, v};
    if (pthread_create(&tids[nw], NULL, nd_fill_worker, &jobs[w]))
      nd_fill_worker(&jobs[w]);
    else
      nw++;
  }
  for (long w = 0; w < nw; w++) pthread_join(tids[w], NULL);
}

ND_EXPORT void nd_log_array(double *x, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    x[i] = log(x[i]);
    if (x[i] == -INFINITY) x[i] = -ND_BIGNEG;
  }
}

/* Stable log-sum-exp of a length-3 log-probability triple, with the
 * ordered max/accumulate of the reference (gen_func.cpp:135-151). */
static double nd_logsum3(const double *a) {
  double m = a[0];
  if (a[1] > m) m = a[1];
  if (a[2] > m) m = a[2];
  if (m == -INFINITY) return -INFINITY;
  double s = 0.0;
  s += exp(a[0] - m);
  s += exp(a[1] - m);
  s += exp(a[2] - m);
  return log(s) + m;
}

/* Normalize n_triples log-space triples in place so each triple log-sums
 * to zero (post_prob with NULL prior, gen_func.cpp:920-932). */
ND_EXPORT void nd_postprob3(double *g, int64_t n_triples) {
  for (int64_t t = 0; t < n_triples; t++) {
    double *p = g + 3 * t;
    double norm = nd_logsum3(p);
    p[0] -= norm;
    p[1] -= norm;
    p[2] -= norm;
  }
}

/* Hard-call / missing-data thresholding on log-space triples, matching
 * call_geno with miss_mode=0 (gen_func.cpp:886-914): first-max wins,
 * an all-equal triple is "missing" (max_pp := -1), a max below N_thresh
 * resets the triple to uniform, a max at or above call_thresh one-hots.
 * Returns nonzero if N_thresh > call_thresh (caller raises). */
ND_EXPORT int nd_call_geno3(double *g, int64_t n_triples, double N_thresh,
                            double call_thresh) {
  if (N_thresh > call_thresh) return 1;
  for (int64_t t = 0; t < n_triples; t++) {
    double *p = g + 3 * t;
    int max_pos = 0, min_pos = 0;
    double mx = -INFINITY, mn = INFINITY;
    for (int k = 0; k < 3; k++) {
      if (p[k] > mx) { mx = p[k]; max_pos = k; }
      if (p[k] < mn) { mn = p[k]; min_pos = k; }
    }
    double max_pp = exp(p[max_pos]);
    if (p[min_pos] == p[max_pos]) max_pp = -1.0;
    if (max_pp < N_thresh)
      for (int k = 0; k < 3; k++) p[k] = log(1.0 / 3.0);
    if (max_pp >= call_thresh) {
      for (int k = 0; k < 3; k++) p[k] = -ND_BIGNEG;
      p[max_pos] = log(1.0);
    }
  }
  return 0;
}

/* ------------------------------------------------------------------ */
/* Genotype / GL / GP reader                                           */
/* ------------------------------------------------------------------ */

static void nd_seterr(char *errbuf, int64_t cap, const char *msg) {
  if (errbuf && cap > 0) {
    strncpy(errbuf, msg, (size_t)cap - 1);
    errbuf[cap - 1] = '\0';
  }
}

/* Strip a single trailing '\n' or '\r' (chomp, gen_func.cpp:192-199). */
static void nd_chomp(char *s) {
  size_t len = strlen(s);
  if (len == 0) return;
  char c = s[len - 1];
  if (c == '\n' || c == '\r') s[len - 1] = '\0';
}

/* ------------------------------------------------------------------ */
/* Parallel text parsing                                               */
/* ------------------------------------------------------------------ */

/* Tokenize a line on single ' '/'\t' separators and keep only fields
 * that strtod fully consumes — the numeric-field filter of the
 * reference splitter (gen_func.cpp:390-417) — in O(K) memory:
 * counts every numeric field but keeps only the last K in a ring
 * (ring[i % K]) — the reader only ever uses the LAST n_ind*n_geno
 * fields (Beagle-style leading columns), and per-line field counts can
 * otherwise force a full-line buffer per parallel slot. */
static int64_t nd_split_lastk(char *line, double *ring, int64_t K) {
  int64_t n = 0;
  char *tok = line;
  while (tok) {
    char *sep = tok + strcspn(tok, " \t");
    char *next = (*sep == '\0') ? NULL : sep + 1;
    *sep = '\0';
    if (*tok != '\0') {
      char *end = NULL;
      double v = strtod(tok, &end);
      if (end && *end == '\0') {
        ring[n % K] = v;
        n++;
      }
    }
    tok = next;
  }
  return n;
}

/* One line of a text slab.  Workers fill n_fields/geno_err/stage; the
 * serial assignment pass replicates the reference's control flow (site
 * numbering, header skips, error precedence) over the parsed slots. */
typedef struct {
  char *buf;        /* malloc'd, chomped in the worker (kept intact for
                     * the serial pass's header/debug echoes) */
  int64_t n_fields; /* -1: empty line (site stays missing) */
  int geno_err;     /* genotype code > 2 seen on this line */
  int parse_errno;  /* libm errno set while parsing THIS line */
  double *stage;    /* [n_ind*ND_NGENO] parsed log-normalized triples;
                     * for short lines, stage[0..1] hold the first two
                     * numeric fields (the reference's t[0]/t[1] debug
                     * print before the Less-fields fatal) */
} nd_text_slot;

typedef struct {
  nd_text_slot *slots;
  int64_t lo, hi;
  int64_t n_ind;
  int in_probs, in_logscale;
  double *ring; /* per-worker [n_ind*n_geno] scratch */
} nd_text_job;

static void nd_parse_text_slot(nd_text_slot *sl, int64_t n_ind, int in_probs,
                               int in_logscale, double *ring) {
  int64_t n_geno = in_probs ? ND_NGENO : 1;
  int64_t K = n_ind * n_geno;
  sl->geno_err = 0;
  errno = 0; /* per-line errno: the serial pass merges in consumption
              * order so the perror-suffix state never includes lines
              * the reference would not have parsed */
  nd_chomp(sl->buf);
  if (sl->buf[0] == '\0') {
    sl->n_fields = -1;
    sl->parse_errno = 0;
    return;
  }
  /* split a COPY: the reference's tokenizer copies (gen_func.cpp:305),
   * leaving the line intact for the header/debug stderr echoes */
  char *tmp = (char *)malloc(strlen(sl->buf) + 1);
  memcpy(tmp, sl->buf, strlen(sl->buf) + 1);
  int64_t n = nd_split_lastk(tmp, ring, K);
  free(tmp);
  sl->n_fields = n;
  if (n < K) { /* header or wrong-columns: the serial pass decides */
    sl->stage[0] = n >= 1 && n < K ? ring[0] : 0.0;
    sl->stage[1] = n >= 2 && n < K ? ring[1] : 0.0;
    sl->parse_errno = errno;
    return;
  }
  for (int64_t i = 0; i < n_ind; i++) {
    double *p = sl->stage + i * ND_NGENO;
    if (in_probs) {
      for (int g = 0; g < ND_NGENO; g++) {
        double v = ring[(n - K + i * ND_NGENO + g) % K];
        p[g] = in_logscale ? v : log(v);
        if (p[g] == -INFINITY) p[g] = -ND_BIGNEG;
      }
    } else {
      int g = (int)ring[(n - K + i) % K];
      p[0] = p[1] = p[2] = -ND_BIGNEG; /* reference rows start missing */
      if (g >= 0) {
        if (g > 2) {
          sl->geno_err = 1;
          sl->parse_errno = errno;
          return;
        }
        p[g] = log(1.0);
      } else {
        p[0] = p[1] = p[2] = log(1.0 / ND_NGENO);
      }
    }
    nd_postprob3(p, 1);
  }
  sl->parse_errno = errno;
}

static void *nd_text_worker(void *arg) {
  nd_text_job *j = (nd_text_job *)arg;
  for (int64_t k = j->lo; k < j->hi; k++)
    nd_parse_text_slot(&j->slots[k], j->n_ind, j->in_probs, j->in_logscale,
                       j->ring);
  return NULL;
}

/* Double-buffered slab feed: a producer thread owns the gz handle and
 * fills slab set produced%2 (gzgets + line copies — the serial
 * decompress stream) while the consumer parses and assigns the
 * previous set, overlapping decompress with the strtod/libm work.
 * Sets are published in sequence order under the mutex; the final
 * (possibly empty) set carries the eof/read-error kind. */
typedef struct {
  nd_text_slot *slots;
  int64_t n_lines;
  int eof_kind; /* 1: EOF, 2: gz read error (recorded at fill time) */
  int rc;       /* allocation failure during fill */
} nd_text_set;

typedef struct {
  gzFile fh;
  char *line;
  int64_t slab;
  nd_text_set *sets[2];
  int64_t produced, consumed;
  int stop, fin;
  pthread_mutex_t mu;
  pthread_cond_t cv;
} nd_text_feed;

static int nd_fill_set(nd_text_feed *fd, nd_text_set *st) {
  st->n_lines = 0;
  st->eof_kind = 0;
  st->rc = 0;
  while (st->n_lines < fd->slab) {
    if (gzgets(fd->fh, fd->line, ND_LINE_MAX) == NULL) {
      st->eof_kind = gzeof(fd->fh) ? 1 : 2;
      break;
    }
    size_t len = strlen(fd->line);
    free(st->slots[st->n_lines].buf);
    st->slots[st->n_lines].buf = (char *)malloc(len + 1);
    if (!st->slots[st->n_lines].buf) {
      st->rc = 1;
      break;
    }
    memcpy(st->slots[st->n_lines].buf, fd->line, len + 1);
    st->n_lines++;
  }
  return st->eof_kind || st->rc;
}

static void *nd_text_producer(void *arg) {
  nd_text_feed *fd = (nd_text_feed *)arg;
  for (;;) {
    pthread_mutex_lock(&fd->mu);
    while (!fd->stop && fd->produced - fd->consumed >= 2)
      pthread_cond_wait(&fd->cv, &fd->mu);
    if (fd->stop) {
      pthread_mutex_unlock(&fd->mu);
      return NULL;
    }
    pthread_mutex_unlock(&fd->mu);
    nd_text_set *st = fd->sets[fd->produced % 2];
    int done = nd_fill_set(fd, st);
    pthread_mutex_lock(&fd->mu);
    fd->produced++;
    if (done) fd->fin = 1;
    pthread_cond_broadcast(&fd->cv);
    pthread_mutex_unlock(&fd->mu);
    if (done) return NULL;
  }
}

/* Read a genotype / genotype-probability file into out[site][ind][geno]
 * (site-major, log-space, per-individual normalized) with the exact
 * format semantics of the reference reader (read_data.cpp:13-116):
 *
 *  - in_bin: site-major raw doubles, 3 per individual; logged when
 *    in_logscale is false; normalized; NaN check.
 *  - text (gz or plain): one line per site; single-space/tab split;
 *    non-numeric fields dropped; empty line consumes the site leaving it
 *    at the -1e15 missing sentinel; a line with zero numeric fields (or
 *    a short first line) is skipped as a header; the LAST n_ind*n_geno
 *    numeric fields are used (Beagle-style leading columns ignored).
 *  - in_probs: 3 fields per individual (logged if not already); else 1
 *    genotype field coded {-1,0,1,2} mapped to uniform / one-hot.
 *  - strict EOF check: exactly n_sites of data then EOF.
 *
 * Returns 0 on success, nonzero with errbuf filled on failure. */
typedef struct {
  double *out;
  int64_t lo, hi; /* triple range */
  int in_logscale;
  int *nan_flag;   /* shared; benign racy write of 1 */
  int saved_errno; /* libm errno seen by this worker (ERANGE underflow) */
} nd_norm_job;

static void *nd_norm_worker(void *arg) {
  nd_norm_job *j = (nd_norm_job *)arg;
  errno = 0;
  for (int64_t t = j->lo; t < j->hi; t++) {
    double *p = j->out + 3 * t;
    if (!j->in_logscale) nd_log_array(p, ND_NGENO);
    nd_postprob3(p, 1);
    if (isnan(p[0]) || isnan(p[1]) || isnan(p[2])) *j->nan_flag = 1;
  }
  j->saved_errno = errno;
  return NULL;
}

/* log-if-needed + per-triple normalize over n_triples, parallel across
 * available cores.  Returns nonzero if any NaN was produced. */
static int nd_normalize_rows(double *out, int64_t n_triples, int in_logscale,
                             int *err_out) {
  long nt = sysconf(_SC_NPROCESSORS_ONLN);
  if (nt < 1) nt = 1;
  if (nt > 16) nt = 16;
  if (nt > n_triples) nt = (long)(n_triples > 0 ? n_triples : 1);
  int nan_flag = 0;
  if (nt == 1) {
    nd_norm_job j = {out, 0, n_triples, in_logscale, &nan_flag, 0};
    nd_norm_worker(&j);
    if (j.saved_errno) *err_out = j.saved_errno;
    return nan_flag;
  }
  nd_norm_job *jobs = (nd_norm_job *)malloc((size_t)nt * sizeof(nd_norm_job));
  pthread_t *tids = (pthread_t *)malloc((size_t)nt * sizeof(pthread_t));
  int64_t chunk = (n_triples + nt - 1) / nt;
  long nw = 0;
  for (long w = 0; w < nt; w++) {
    int64_t lo = w * chunk, hi = (w + 1) * chunk;
    if (hi > n_triples) hi = n_triples;
    jobs[w] = (nd_norm_job){out, lo, hi, in_logscale, &nan_flag, 0};
    if (pthread_create(&tids[nw], NULL, nd_norm_worker, &jobs[w]))
      nd_norm_worker(&jobs[w]);
    else
      nw++;
  }
  for (long w = 0; w < nw; w++) pthread_join(tids[w], NULL);
  /* libm errno semantics: the LAST non-zero call wins (errno is only
   * ever set, never cleared) — workers partition triples in order */
  for (long w = 0; w < nt; w++)
    if (jobs[w].saved_errno) *err_out = jobs[w].saved_errno;
  free(jobs);
  free(tids);
  return nan_flag;
}

/* The binary reader's normalization (nd_normalize_rows) of n_triples
 * triples read by other means, a site range of a binary file: each
 * triple takes the calls of the full read, so a range holds its bits.
 * Returns nonzero if a NaN was produced; err_out the libm errno. */
ND_EXPORT int nd_normalize_triples(double *out, int64_t n_triples,
                                   int in_logscale, int *err_out) {
  *err_out = 0;
  return nd_normalize_rows(out, n_triples, in_logscale, err_out);
}

/* err_out receives the libm errno observed while parsing (the
 * reference's error() helper ends in perror, so its fatal reader
 * messages carry strerror(errno) — ERANGE whenever an earlier triple's
 * log-sum-exp underflowed, e.g. any one-hot genotype; thread-local
 * errno from the parse workers is aggregated here). */
/* Parallel-pread slice job for the raw-binary fast path. */
typedef struct {
  int fd;
  char *dst;
  int64_t off, len;
  int err;
} nd_pread_job;

static void *nd_pread_worker(void *arg) {
  nd_pread_job *j = (nd_pread_job *)arg;
  int64_t done = 0;
  while (done < j->len) {
    ssize_t r = pread(j->fd, j->dst + done, (size_t)(j->len - done),
                      j->off + done);
    if (r <= 0) {
      j->err = 1;
      return NULL;
    }
    done += r;
  }
  return NULL;
}

/* Core reader.  out != NULL: parse sites [site_start, site_stop) into
 * out[(site_stop-site_start)][n_ind][ND_NGENO] (the classic eager read
 * is the full range).  spill != NULL (text only, out == NULL): stream
 * the parsed log-normalized rows of the range to the already-open spill
 * FILE instead — bounded memory regardless of genome length, for the
 * lazy disk-round cache of gz/text inputs the reference can only hold
 * in RAM (read_data.cpp:21).  Reference control flow (site numbering,
 * header skips, error precedence) is identical in all modes; the
 * EOF/trailing-content checks only apply when the range runs to
 * n_sites. */
static int nd_read_geno_impl(const char *path, int in_bin, int in_probs,
                             int in_logscale, int64_t n_ind, int64_t n_sites,
                             int64_t site_start, int64_t site_stop,
                             double *out, FILE *spill, char *errbuf,
                             int64_t errbuf_cap, int *err_out) {
  int64_t n_geno = in_probs ? ND_NGENO : 1;
  *err_out = 0;
  gzFile fh;
  if (strcmp(path, "-") == 0)
    fh = gzdopen(0 /* stdin */, in_bin ? "rb" : "r");
  else
    fh = gzopen(path, in_bin ? "rb" : "r");
  if (fh == NULL) {
    nd_seterr(errbuf, errbuf_cap, "cannot open GENO file!");
    return 1;
  }
  gzbuffer(fh, 1 << 20);

  /* Raw (non-gzip) binary files take a parallel-pread fast path: the
   * reader threads' writes double as the parallel first-touch of the
   * fresh output tensor (a serial gzread into an untouched buffer is
   * page-fault-bound on faulting-bound VMs), and
   * disk/page-cache reads parallelize with them. */
  int raw_fd = -1;
  if (in_bin && out != NULL && strcmp(path, "-") != 0) {
    raw_fd = open(path, O_RDONLY);
    if (raw_fd >= 0) {
      unsigned char magic[2];
      if (!(pread(raw_fd, magic, 2, 0) == 2 &&
            !(magic[0] == 0x1f && magic[1] == 0x8b))) {
        close(raw_fd);
        raw_fd = -1; /* gzip (or unreadable): serial gz-decode path */
      }
    }
  }

  /* Threaded init: doubles as the parallel first-touch of the fresh
   * output tensor (see nd_fill_array) — the serial loop here was the
   * single slowest line of a large binary load on faulting-bound VMs.
   * The pread fast path first-touches through its reader threads
   * instead (bytes past a short file are never normalized or read). */
  if (out && raw_fd < 0)
    nd_fill_array(out, (site_stop - site_start) * n_ind * ND_NGENO,
                  -ND_BIGNEG);

  char *line = NULL;
  int rc = 0;

  if (in_bin) {
    /* Bulk read: stream multi-megabyte slabs straight into the output
     * buffer (a per-site gzread of a few KB costs more in call
     * overhead than the decode), then normalize in parallel — the
     * log + per-triple log-sum-exp over n_sites*n_ind*3 doubles is the
     * actual bottleneck of large binary loads and is embarrassingly
     * parallel per site.  Arithmetic per element is unchanged (glibc
     * log/exp in the reference's order), so results stay bit-exact. */
    int64_t total = n_sites * n_ind * ND_NGENO * (int64_t)sizeof(double);
    char *dst = (char *)out;
    int64_t got = 0;
    if (raw_fd >= 0) {
      /* Parallel pread: threads read disjoint slices; a short file
       * reads exactly st_size bytes and falls into the same
       * premature-EOF handling as a short gzread stream. */
      struct stat stv;
      int64_t have = 0;
      if (fstat(raw_fd, &stv) == 0)
        have = stv.st_size < total ? (int64_t)stv.st_size : total;
      long nt = sysconf(_SC_NPROCESSORS_ONLN);
      if (nt < 1) nt = 1;
      if (nt > 16) nt = 16;
      int64_t per = (have + nt - 1) / nt;
      nd_pread_job jobs[16];
      pthread_t tids[16];
      long nw = 0;
      for (long w = 0; w < nt && w * per < have; w++) {
        int64_t lo = w * per;
        int64_t hi = lo + per < have ? lo + per : have;
        jobs[w] = (nd_pread_job){raw_fd, dst + lo, lo, hi - lo, 0};
        if (pthread_create(&tids[w], NULL, nd_pread_worker, &jobs[w])) {
          nd_pread_worker(&jobs[w]); /* degraded: run inline */
          continue;
        }
        tids[nw] = tids[w];
        nw++;
      }
      for (long w = 0; w < nw; w++) pthread_join(tids[w], NULL);
      int read_err = 0;
      for (long w = 0; w < nt && w * per < have; w++) read_err |= jobs[w].err;
      got = have;
      if (read_err) {
        rc = 1;
        nd_seterr(errbuf, errbuf_cap,
                  "cannot read binary GENO file. Check GENO file and "
                  "number of sites!");
      } else if (have < total) {
        rc = 1;
        nd_seterr(errbuf, errbuf_cap,
                  "GENO file at premature EOF. Check GENO file and "
                  "number of sites!");
      } else {
        /* leave the gz handle where the serial loop would have: the
         * strict 1-byte EOF probe below must see byte `total`. */
        gzseek(fh, (z_off_t)total, SEEK_SET);
      }
    } else {
      while (got < total) {
        int64_t want = total - got;
        if (want > (1 << 24)) want = 1 << 24;
        int r = gzread(fh, dst + got, (unsigned)want);
        if (r <= 0) {
          rc = 1;
          nd_seterr(errbuf, errbuf_cap,
                    gzeof(fh)
                        ? "GENO file at premature EOF. Check GENO file and "
                          "number of sites!"
                        : "cannot read binary GENO file. Check GENO file "
                          "and number of sites!");
          break;
        }
        got += r;
      }
    }
    if (rc != 0) {
      /* the reference normalizes + NaN-checks each COMPLETE TRIPLE as
       * it reads (per individual, read_data.cpp:29-45 — NOT per site),
       * so (a) errno at a premature-EOF error reflects the completed
       * triples' underflows and (b) a NaN among them — including
       * complete triples inside a partially-read final site — outranks
       * the EOF error.  Floor division excludes only a partial triple,
       * which the reference's short gzread likewise never normalizes.
       * (A/B-verified: NaN planted in a complete triple of the
       * incomplete site makes the reference print "NaN found!".) */
      if (nd_normalize_rows(out, got / (ND_NGENO * (int64_t)sizeof(double)),
                            in_logscale, err_out)) {
        nd_seterr(errbuf, errbuf_cap,
                  "NaN found! Is the file format correct?");
      }
    } else if (nd_normalize_rows(out, n_sites * n_ind, in_logscale, err_out)) {
      rc = 1;
      nd_seterr(errbuf, errbuf_cap, "NaN found! Is the file format correct?");
    }
  } else {
    /* Slab-parallel text parse: lines are read serially (gz decompress
     * is a serial stream) into a slab of slots, workers split/convert/
     * normalize each line independently (strtod + log + log-sum-exp is
     * the actual bottleneck of large TSV loads), and a serial
     * assignment pass replays the reference's exact control flow over
     * the parsed slots — site numbering, empty-line missing sites,
     * header skips (with their stderr prints in order), and the
     * precedence of format errors over the EOF check.  Per-element
     * arithmetic is unchanged. */
    long nt = sysconf(_SC_NPROCESSORS_ONLN);
    if (nt < 1) nt = 1;
    if (nt > 16) nt = 16;
    int64_t K_out = n_ind * ND_NGENO;
    int64_t slab = (16 << 20) / (K_out * (int64_t)sizeof(double) + 64);
    if (slab < 16) slab = 16;
    if (slab > 4096) slab = 4096;
    line = (char *)malloc(ND_LINE_MAX);
    /* two slab sets: the producer thread fills one while the consumer
     * parses/assigns the other (decompress overlaps strtod/libm) */
    nd_text_slot *slots =
        (nd_text_slot *)calloc((size_t)(2 * slab), sizeof(nd_text_slot));
    double *stage =
        (double *)malloc((size_t)(2 * slab * K_out) * sizeof(double));
    double *rings =
        (double *)malloc((size_t)(nt * n_ind * n_geno) * sizeof(double));
    nd_text_set set0, set1;
    nd_text_feed feed;
    pthread_t prod;
    int prod_started = 0;
    if (!line || !slots || !stage || !rings) {
      nd_seterr(errbuf, errbuf_cap, "cannot allocate read buffers!");
      rc = 1;
    } else {
      for (int64_t k = 0; k < 2 * slab; k++)
        slots[k].stage = stage + k * K_out;
      set0 = (nd_text_set){slots, 0, 0, 0};
      set1 = (nd_text_set){slots + slab, 0, 0, 0};
      memset(&feed, 0, sizeof(feed));
      feed.fh = fh;
      feed.line = line;
      feed.slab = slab;
      feed.sets[0] = &set0;
      feed.sets[1] = &set1;
      pthread_mutex_init(&feed.mu, NULL);
      pthread_cond_init(&feed.cv, NULL);
      if (pthread_create(&prod, NULL, nd_text_producer, &feed)) {
        nd_seterr(errbuf, errbuf_cap, "cannot allocate read buffers!");
        rc = 1;
      } else {
        prod_started = 1;
      }
    }
    /* spilled missing row: empty lines consume their site as missing
     * (same -ND_BIGNEG row the eager prefill leaves in place) */
    double *missrow = NULL;
    if (spill) {
      missrow = (double *)malloc((size_t)K_out * sizeof(double));
      if (!missrow) {
        nd_seterr(errbuf, errbuf_cap, "cannot allocate read buffers!");
        rc = 1;
      } else {
        for (int64_t q = 0; q < K_out; q++) missrow[q] = -ND_BIGNEG;
      }
    }
    int64_t s = 0;
    int eof_kind = 0; /* 1: EOF, 2: gz read error */
    while (rc == 0 && s < site_stop && eof_kind == 0) {
      pthread_mutex_lock(&feed.mu);
      while (feed.consumed == feed.produced && !feed.fin)
        pthread_cond_wait(&feed.cv, &feed.mu);
      if (feed.consumed == feed.produced) { /* fin: no more sets */
        pthread_mutex_unlock(&feed.mu);
        break;
      }
      pthread_mutex_unlock(&feed.mu);
      nd_text_set *cur = feed.sets[feed.consumed % 2];
      int64_t n_lines = cur->n_lines;
      nd_text_slot *cslots = cur->slots;
      eof_kind = cur->eof_kind; /* checked after this set is processed */
      if (cur->rc) {
        nd_seterr(errbuf, errbuf_cap, "cannot allocate read buffers!");
        rc = 1;
      }
      if (rc != 0 || n_lines == 0) {
        pthread_mutex_lock(&feed.mu);
        feed.consumed++;
        pthread_cond_broadcast(&feed.cv);
        pthread_mutex_unlock(&feed.mu);
        break;
      }
      long nw = nt;
      if (nw > n_lines) nw = (long)n_lines;
      if (nw <= 1 || n_lines < 64) {
        nd_text_job j = {cslots, 0, n_lines, n_ind, in_probs, in_logscale,
                         rings};
        nd_text_worker(&j);
      } else {
        nd_text_job jobs[16];
        pthread_t tids[16];
        int64_t per = (n_lines + nw - 1) / nw;
        long nc = 0;
        for (long w = 0; w < nw; w++) {
          int64_t lo = w * per, hi = (w + 1) * per;
          if (hi > n_lines) hi = n_lines;
          jobs[w] = (nd_text_job){cslots, lo,       hi,
                                  n_ind,  in_probs, in_logscale,
                                  rings + w * n_ind * n_geno};
          if (pthread_create(&tids[nc], NULL, nd_text_worker, &jobs[w]))
            nd_text_worker(&jobs[w]);
          else
            nc++;
        }
        for (long w = 0; w < nc; w++) pthread_join(tids[w], NULL);
      }
      int64_t k = 0;
      for (; k < n_lines && rc == 0 && s < site_stop; k++) {
        nd_text_slot *sl = &cslots[k];
        if (sl->n_fields == -1) { /* empty line: site stays missing */
          if (spill && s >= site_start &&
              fwrite(missrow, sizeof(double), (size_t)K_out, spill) !=
                  (size_t)K_out) {
            rc = 1;
            nd_seterr(errbuf, errbuf_cap, "cannot write spill cache!");
            break;
          }
          s++;
          continue;
        }
        /* merge this line's parse errno NOW: the reference splits and
         * converts a line before deciding its fate, and libm errno
         * (last non-zero call wins) is what perror reports at a fatal */
        if (sl->parse_errno) *err_out = sl->parse_errno;
        if (sl->n_fields == 0 || (s == 0 && sl->n_fields < n_ind * n_geno)) {
          fprintf(stderr, "> Header found! Skipping line...\n");
          if (s != 0) {
            fprintf(stderr,
                    "\n=======\nWARNING: [read_geno]  header found but not on "
                    "first line. Is this an error?\n=======\n\n");
            /* the reference echoes the line with a literal "/n"
             * (read_data.cpp:68 fprintf(stderr, "%s/n", buf)) */
            fprintf(stderr, "%s/n", sl->buf);
          }
          continue;
        }
        if (sl->n_fields < n_ind * n_geno) {
          /* reference debug dump before the fatal (read_data.cpp:75-76);
           * t[1] past n_fields is an out-of-bounds read there — printed
           * as 0 here */
          fprintf(stderr, "\tline: %s\n\tt[0]: %f\n\tt[1]: %f\n",
                  sl->buf, sl->stage[0], sl->stage[1]);
          fprintf(stderr,
                  "\tn_line: %lu\n\tfields: %lu\n\tn_ind: %lu\n\tn_geno: "
                  "%lu\n",
                  (unsigned long)s, (unsigned long)sl->n_fields,
                  (unsigned long)n_ind, (unsigned long)n_geno);
          rc = 1;
          nd_seterr(errbuf, errbuf_cap,
                    "wrong GENO file format. Less fields than expected!");
          break;
        }
        if (!in_probs && sl->geno_err) {
          rc = 1;
          nd_seterr(errbuf, errbuf_cap,
                    "wrong GENO file format. Genotypes must be coded as "
                    "{-1,0,1,2} !");
          break;
        }
        if (s >= site_start) {
          if (spill) {
            if (fwrite(sl->stage, sizeof(double), (size_t)K_out, spill) !=
                (size_t)K_out) {
              rc = 1;
              nd_seterr(errbuf, errbuf_cap, "cannot write spill cache!");
              break;
            }
          } else {
            memcpy(out + (s - site_start) * K_out, sl->stage,
                   (size_t)K_out * sizeof(double));
          }
        }
        s++;
      }
      if (rc == 0 && site_stop == n_sites && s == n_sites && k < n_lines) {
        /* lines past the last site were already consumed from the gz
         * stream: the reference's strict 1-byte probe below would miss
         * them, so the "not at EOF" error is raised here. */
        rc = 1;
        nd_seterr(errbuf, errbuf_cap,
                  "GENO file not at EOF. Check GENO file and number of "
                  "sites!");
      }
      pthread_mutex_lock(&feed.mu);
      feed.consumed++;
      pthread_cond_broadcast(&feed.cv);
      pthread_mutex_unlock(&feed.mu);
    }
    if (prod_started) {
      pthread_mutex_lock(&feed.mu);
      feed.stop = 1;
      pthread_cond_broadcast(&feed.cv);
      pthread_mutex_unlock(&feed.mu);
      pthread_join(prod, NULL);
      /* lines the producer read past the consumer's stop point are
       * content the 1-byte probe can no longer see */
      if (rc == 0 && site_stop == n_sites && s == n_sites) {
        for (int64_t q = feed.consumed; q < feed.produced; q++)
          if (feed.sets[q % 2]->n_lines > 0) {
            rc = 1;
            nd_seterr(errbuf, errbuf_cap,
                      "GENO file not at EOF. Check GENO file and number of "
                      "sites!");
            break;
          }
      }
      pthread_mutex_destroy(&feed.mu);
      pthread_cond_destroy(&feed.cv);
    }
    if (rc == 0 && s < site_stop) {
      rc = 1;
      nd_seterr(errbuf, errbuf_cap,
                eof_kind == 2 ? "cannot read GZip GENO file. Check GENO file "
                                "and number of sites!"
                              : "GENO file at premature EOF. Check GENO file "
                                "and number of sites!");
    }
    if (slots) {
      for (int64_t k = 0; k < 2 * slab; k++) free(slots[k].buf);
      free(slots);
    }
    free(stage);
    free(rings);
    free(missrow);
  }

  if (rc == 0 && site_stop == n_sites) {
    /* Strict EOF check: one extra readable byte is an error
     * (read_data.cpp:106-109). */
    char probe;
    if (gzread(fh, &probe, 1) > 0) {
      rc = 1;
      nd_seterr(errbuf, errbuf_cap,
                "GENO file not at EOF. Check GENO file and number of sites!");
    }
  }

  free(line);
  if (raw_fd >= 0) close(raw_fd);
  gzclose(fh);
  return rc;
}

ND_EXPORT int nd_read_geno(const char *path, int in_bin, int in_probs,
                           int in_logscale, int64_t n_ind, int64_t n_sites,
                           double *out, char *errbuf, int64_t errbuf_cap,
                           int *err_out) {
  return nd_read_geno_impl(path, in_bin, in_probs, in_logscale, n_ind,
                           n_sites, 0, n_sites, out, NULL, errbuf, errbuf_cap,
                           err_out);
}

/* Parse sites [site_start, site_stop) of a TEXT genome (plain, gz or
 * stdin) into out[(site_stop - site_start)][n_ind][ND_NGENO]: the rows
 * of the eager read, bit for bit (shared impl above), so that the ranges
 * of several processes hold the sites of one full read.  The EOF checks
 * apply when the range runs to n_sites. */
ND_EXPORT int nd_read_text_range(const char *path, int in_probs,
                                 int in_logscale, int64_t n_ind,
                                 int64_t n_sites, int64_t site_start,
                                 int64_t site_stop, double *out,
                                 char *errbuf, int64_t errbuf_cap,
                                 int *err_out) {
  return nd_read_geno_impl(path, 0 /* text */, in_probs, in_logscale, n_ind,
                           n_sites, site_start, site_stop, out, NULL, errbuf,
                           errbuf_cap, err_out);
}

/* Stream-parse a TEXT genome once, writing the log-normalized rows of
 * sites [site_start, site_stop) to cache_path as raw f64
 * [rows][n_ind][ND_NGENO] — the lazy disk-round cache for gz/text
 * inputs larger than host RAM.  Bounded memory: only one slab of lines
 * is ever resident.  Parse arithmetic, stderr prints and fatal
 * precedence are the eager reader's (shared impl above). */
ND_EXPORT int nd_spill_text_geno(const char *path, int in_probs,
                                 int in_logscale, int64_t n_ind,
                                 int64_t n_sites, int64_t site_start,
                                 int64_t site_stop, const char *cache_path,
                                 char *errbuf, int64_t errbuf_cap,
                                 int *err_out) {
  FILE *spf = fopen(cache_path, "wb");
  if (spf == NULL) {
    *err_out = errno;
    nd_seterr(errbuf, errbuf_cap, "cannot open spill cache!");
    return 1;
  }
  int rc = nd_read_geno_impl(path, 0 /* text */, in_probs, in_logscale,
                             n_ind, n_sites, site_start, site_stop, NULL,
                             spf, errbuf, errbuf_cap, err_out);
  int wrc = fflush(spf);
  if (fclose(spf) != 0) wrc = -1;
  if (wrc != 0 && rc == 0) {
    rc = 1;
    nd_seterr(errbuf, errbuf_cap, "cannot write spill cache!");
  }
  return rc;
}

/* ------------------------------------------------------------------ */
/* Phylip %.10f matrix formatter                                       */
/* ------------------------------------------------------------------ */

/* The output contract is glibc printf("%.10f") byte-for-byte
 * (reference join(), gen_func.cpp:479-496) — a pure-Python per-element
 * format runs ~1 us/value, which at 1k individuals is ~1 s per matrix
 * and dominates a 100-replicate bootstrap stream.  Each row is
 * formatted "\tv1\tv2...\tvn" into its own fixed-stride slot (threaded
 * across rows; snprintf IS glibc printf, so inf/nan spellings and
 * rounding are exact by construction). */

typedef struct {
  const double *m;
  int64_t n_cols, r_lo, r_hi;
  char *out;
  int64_t stride;
  int64_t *lens;
  int overflow;
} nd_fmt_job;

static void *nd_fmt_worker(void *arg) {
  nd_fmt_job *j = (nd_fmt_job *)arg;
  for (int64_t r = j->r_lo; r < j->r_hi; r++) {
    char *dst = j->out + r * j->stride;
    int64_t pos = 0;
    const double *row = j->m + r * j->n_cols;
    for (int64_t c = 0; c < j->n_cols; c++) {
      int wrote = snprintf(dst + pos, (size_t)(j->stride - pos), "\t%.10f",
                           row[c]);
      if (wrote < 0 || pos + wrote >= j->stride) {
        j->overflow = 1;
        return NULL;
      }
      pos += wrote;
    }
    j->lens[r] = pos;
  }
  return NULL;
}

/* Format an [n_rows, n_cols] f64 matrix as per-row "\tv\tv..." byte
 * runs: row r occupies out[r*stride .. r*stride+lens[r]).  Returns 0,
 * or 1 if any row overflowed `stride` (caller retries with a larger
 * one). */
ND_EXPORT int nd_format_matrix10f(const double *m, int64_t n_rows,
                                  int64_t n_cols, char *out, int64_t stride,
                                  int64_t *lens) {
  long nt = sysconf(_SC_NPROCESSORS_ONLN);
  if (nt < 1) nt = 1;
  if (nt > 16) nt = 16;
  if (nt > n_rows) nt = (long)(n_rows > 0 ? n_rows : 1);
  nd_fmt_job jobs[16];
  pthread_t tids[16];
  int64_t per = (n_rows + nt - 1) / nt;
  long nw = 0, nj = 0;
  for (long w = 0; w < nt && w * per < n_rows; w++) {
    int64_t lo = w * per, hi = lo + per < n_rows ? lo + per : n_rows;
    jobs[w] = (nd_fmt_job){m, n_cols, lo, hi, out, stride, lens, 0};
    if (pthread_create(&tids[nw], NULL, nd_fmt_worker, &jobs[w]))
      nd_fmt_worker(&jobs[w]); /* degraded: run inline, no tid to join */
    else
      nw++;
    nj = w + 1;
  }
  for (long w = 0; w < nw; w++) pthread_join(tids[w], NULL);
  int ov = 0;
  for (long w = 0; w < nj; w++) ov |= jobs[w].overflow;
  return ov;
}

/* ------------------------------------------------------------------ */
/* Fused packed reader (read -> normalize -> exp -> f32 2-comp pack)   */
/* ------------------------------------------------------------------ */

/* The staged pipeline (nd_read_geno f64 -> nd_exp_array -> host pack23
 * cast) makes three full passes over the [S, n_ind, 3] f64 tensor — at
 * 1k individuals x 1M sites that is ~75 GB of extra memory traffic and
 * a 25 GB resident f64 tensor.  This reader fuses them for RAW binary
 * GP inputs (the reference's -geno + -in_bin double stream,
 * read_data.cpp:29-47): the workers pread pieces of the range in turn
 * into bounded scratch and, per triple, applies the exact staged arithmetic —
 * log (clamped, if the input is normal-space), the ordered log-sum-exp
 * normalize (nd_postprob3), the NaN check, then exp and a float cast of
 * the first TWO components (the third reconstructs on device as
 * 1 - p0 - p1; hostmem.pack23 semantics with may_zero=False — binary
 * triples always normalize to sum 1, so the PAD23 sentinel scan is
 * vacuous).  Identical libm calls in identical order make the output
 * bit-equal to the staged f32 path.  Worker writes double as the
 * parallel first touch of the fresh output slab. */

typedef struct {
  int fd;
  int64_t base_off;  /* file byte offset of triple 0 of the range */
  int64_t t_hi;      /* triples in the range */
  int64_t *next_piece; /* shared: the next piece of ND_PACK_PIECE_TRIPLES */
  float *out2;       /* MODE_PACK23: packed output, triple t -> out2[2*t] */
  unsigned char *outc; /* MODE_CODES: one code per triple */
  unsigned short *out16; /* MODE_PACK16: quantized pair per triple */
  int mode;          /* ND_FUSED_PACK23 | ND_FUSED_CODES | ND_FUSED_PACK16 */
  int in_logscale;
  int nan_flag;
  int read_err;
  int any_missing;   /* MODE_CODES: emitted at least one code 3 */
  int saved_errno;   /* libm errno from normalize only (not exp) */
  int64_t errno_piece; /* the last piece of this worker that set it */
} nd_pack_job;

#define ND_FUSED_PACK23 0
#define ND_FUSED_CODES 1
#define ND_FUSED_PACK16 2

/* uint16 fixed-point lane (hostmem.pack16 semantics): q = rint(p*65534)
 * with 65535 the all-zero-triple sentinel for host-decided missing
 * rows.  llrint under the default rounding mode matches np.rint
 * (round-half-to-even), so fused output is bit-equal to the staged
 * read -> preprocess -> pack16 route. */
#define ND_U16_ONE 65534.0
#define ND_PAD16 65535u

/* Workers take pieces of the range in turn from a shared counter, so a
 * worker that the host preempts holds back one piece only; a piece is
 * one pread and one pass over its scratch. */
#define ND_PACK_PIECE_TRIPLES 16384 /* 384 KB f64 scratch per worker */

static void *nd_pack_worker(void *arg) {
  nd_pack_job *j = (nd_pack_job *)arg;
  double *scratch =
      (double *)malloc(ND_PACK_PIECE_TRIPLES * 3 * sizeof(double));
  if (!scratch) {
    j->read_err = 1;
    return NULL;
  }
  int64_t k = -1;
  for (;;) {
    /* the previous piece's errno, kept with its index: the last one in
     * triple order wins across workers (nd_fused_read_impl) */
    if (k >= 0 && errno) {
      j->saved_errno = errno;
      j->errno_piece = k;
    }
    errno = 0;
    k = __atomic_fetch_add(j->next_piece, 1, __ATOMIC_RELAXED);
    int64_t t0 = k * ND_PACK_PIECE_TRIPLES;
    if (t0 >= j->t_hi) break;
    int64_t nt = j->t_hi - t0;
    if (nt > ND_PACK_PIECE_TRIPLES) nt = ND_PACK_PIECE_TRIPLES;
    int64_t bytes = nt * 3 * (int64_t)sizeof(double);
    int64_t off = j->base_off + t0 * 3 * (int64_t)sizeof(double);
    int64_t done = 0;
    while (done < bytes) {
      ssize_t r = pread(j->fd, (char *)scratch + done,
                        (size_t)(bytes - done), off + done);
      if (r <= 0) {
        j->read_err = 1;
        free(scratch);
        return NULL;
      }
      done += r;
    }
    if (j->mode == ND_FUSED_PACK16 && !j->in_logscale) {
      /* Libm-free fast path for the quantized lane: for NORMAL-SPACE
       * triples, exp(log p - logsumexp) == p / sum in exact
       * arithmetic; the f64 routes differ by <= ~3 ulps, which the
       * rint(p * 65534) quantization absorbs EXCEPT within ~1e-11 of
       * a half-integer boundary (and the EPSILON missing test within
       * ~2e-16 of its threshold).  Per-triple guards route those
       * measure-zero cases through the exact staged arithmetic, so
       * the emitted codes stay bit-identical to the staged
       * read -> preprocess -> pack16 route while the common case
       * drops all 9 libm calls (the 1M-site e2e's 98 s parse
       * residual).  Anomalous slabs (NaN/inf, negative, zero sum)
       * fall back wholesale for the NaN-fatal parity. */
      int anomaly = 0, saw_zero = 0;
      for (int64_t t = 0; t < nt && !anomaly; t++) {
        double *p = scratch + 3 * t;
        /* isinf(sum): finite components can still overflow the sum
         * (p0 + p1 -> inf), which would silently normalize to
         * (0,0,0) and mis-classify as missing — the staged route
         * normalizes in log space and stays finite (review r05) */
        if (isnan(p[0]) || isnan(p[1]) || isnan(p[2]) ||
            isinf(p[0]) || isinf(p[1]) || isinf(p[2]) ||
            p[0] < 0 || p[1] < 0 || p[2] < 0 ||
            p[0] + p[1] + p[2] == 0.0 || isinf(p[0] + p[1] + p[2]))
          anomaly = 1;
        if (p[0] == 0.0 || p[1] == 0.0 || p[2] == 0.0) saw_zero = 1;
      }
      if (!anomaly) {
        for (int64_t t = 0; t < nt; t++) {
          double *p = scratch + 3 * t;
          double s = p[0] + p[1] + p[2];
          double e0 = p[0] / s, e1 = p[1] / s, e2 = p[2] / s;
          double d01 = e0 > e1 ? e0 - e1 : e1 - e0;
          double d12 = e1 > e2 ? e1 - e2 : e2 - e1;
          int guard = fabs(d01 - ND_EPSILON) < 1e-12 ||
                      fabs(d12 - ND_EPSILON) < 1e-12;
          unsigned short o0 = 0, o1 = 0;
          if (!guard) {
            if (d01 < ND_EPSILON && d12 < ND_EPSILON) {
              double qm = ((e0 + e1 + e2) / 3.0) * ND_U16_ONE;
              double fr = qm - floor(qm);
              guard = fabs(fr - 0.5) < 1e-9;
              o0 = (unsigned short)ND_PAD16;
              o1 = (unsigned short)llrint(qm);
            } else {
              double q0 = e0 * ND_U16_ONE, q1 = e1 * ND_U16_ONE;
              double f0 = q0 - floor(q0), f1 = q1 - floor(q1);
              guard = fabs(f0 - 0.5) < 1e-9 || fabs(f1 - 0.5) < 1e-9;
              o0 = (unsigned short)llrint(q0);
              o1 = (unsigned short)llrint(q1);
            }
          }
          if (guard) {
            /* boundary case: the exact staged arithmetic decides */
            double q[3] = {p[0], p[1], p[2]};
            nd_log_array(q, ND_NGENO);
            nd_postprob3(q, 1);
            double g0 = exp(q[0]), g1 = exp(q[1]), g2 = exp(q[2]);
            double gd01 = g0 > g1 ? g0 - g1 : g1 - g0;
            double gd12 = g1 > g2 ? g1 - g2 : g2 - g1;
            if (gd01 < ND_EPSILON && gd12 < ND_EPSILON) {
              o0 = (unsigned short)ND_PAD16;
              o1 = (unsigned short)llrint(((g0 + g1 + g2) / 3.0) *
                                          ND_U16_ONE);
            } else {
              o0 = (unsigned short)llrint(g0 * ND_U16_ONE);
              o1 = (unsigned short)llrint(g1 * ND_U16_ONE);
            }
          }
          unsigned short *o = j->out16 + 2 * (t0 + t);
          o[0] = o0;
          o[1] = o1;
        }
        /* errno parity: the staged normalize records ERANGE when
         * log(0) underflows (zero components); the fast path skips
         * log entirely, so mirror the state for the fatal-message
         * perror suffix (readers.py err plumb) */
        if (saw_zero) errno = ERANGE;
        continue;
      }
    }
    if (j->mode == ND_FUSED_CODES && !j->in_logscale) {
      /* Libm-free fast path: log is strictly monotone on (0, inf), so
       * the log-normalized argmax / all-equal classification of a
       * NORMAL-SPACE triple equals the classification of the raw
       * doubles — EXCEPT within rounding distance of a tie: distinct
       * doubles can share a rounded log (adjacent doubles collide
       * ~6% of the time around 1/3-0.5), which in the staged path
       * turns a strict order into a first-argmax tie or a near-
       * uniform triple into the all-equal missing code.  Per-triple
       * guard: when the max-min relative spread is below 1e-12
       * (thousands of ulps above any possible log collision), the
       * triple takes the staged arithmetic so the emitted code is
       * bit-identical to the preprocess+derive route.  Anomalous
       * SLABS (NaN/inf input, negative component, all-zero sum —
       * log/normalize would produce the reference's NaN fatal) fall
       * back wholesale (anomalies are fatal anyway). */
      int anomaly = 0, saw_zero = 0;
      for (int64_t t = 0; t < nt && !anomaly; t++) {
        double *p = scratch + 3 * t;
        if (isnan(p[0]) || isnan(p[1]) || isnan(p[2]) ||
            isinf(p[0]) || isinf(p[1]) || isinf(p[2]) ||
            p[0] < 0 || p[1] < 0 || p[2] < 0 ||
            p[0] + p[1] + p[2] == 0.0)
          anomaly = 1;
        if (p[0] == 0.0 || p[1] == 0.0 || p[2] == 0.0) saw_zero = 1;
      }
      if (!anomaly) {
        for (int64_t t = 0; t < nt; t++) {
          double *p = scratch + 3 * t;
          int max_pos = 0, min_pos = 0;
          double mx = -INFINITY, mn = INFINITY;
          for (int k = 0; k < 3; k++) {
            if (p[k] > mx) { mx = p[k]; max_pos = k; }
            if (p[k] < mn) { mn = p[k]; min_pos = k; }
          }
          /* second-largest: the argmax can only flip when the TOP-2
           * collide in log space (and all-equal needs the full spread
           * to collide, which the top-2 gap subsumes: mx-mn >= mx-p2) */
          double second = -INFINITY;
          for (int k = 0; k < 3; k++)
            if (k != max_pos && p[k] > second) second = p[k];
          unsigned char c = (unsigned char)max_pos;
          if (p[min_pos] == p[max_pos]) {
            c = 3;
            j->any_missing = 1;
          } else if (mx - second < 1e-12 * mx || mx < 1e-300) {
            /* near-tie (or near-subnormal, where the guard product
             * underflows): classify via the exact staged arithmetic */
            double q[3] = {p[0], p[1], p[2]};
            nd_log_array(q, ND_NGENO);
            nd_postprob3(q, 1);
            int mp = 0, np_ = 0;
            double qmx = -INFINITY, qmn = INFINITY;
            for (int k = 0; k < 3; k++) {
              if (q[k] > qmx) { qmx = q[k]; mp = k; }
              if (q[k] < qmn) { qmn = q[k]; np_ = k; }
            }
            c = (unsigned char)mp;
            if (q[np_] == q[mp]) {
              c = 3;
              j->any_missing = 1;
            }
          }
          j->outc[t0 + t] = c;
        }
        /* errno parity with the staged normalize (see the pack16
         * fast path's note) */
        if (saw_zero) errno = ERANGE;
        continue;
      }
    }
    /* normalize pass: the staged reader's per-triple arithmetic */
    for (int64_t t = 0; t < nt; t++) {
      double *p = scratch + 3 * t;
      if (!j->in_logscale) nd_log_array(p, ND_NGENO);
      nd_postprob3(p, 1);
      if (isnan(p[0]) || isnan(p[1]) || isnan(p[2])) j->nan_flag = 1;
    }
    /* exp+cast pass: exp's ERANGE underflow (one-hot triples) must not
     * leak into the reported errno — the staged pipeline captures errno
     * at read time, before preprocessing exp's (readers.py err plumb) */
    int norm_errno = errno;
    if (j->mode == ND_FUSED_PACK23) {
      for (int64_t t = 0; t < nt; t++) {
        double *p = scratch + 3 * t;
        float *o = j->out2 + 2 * (t0 + t);
        o[0] = (float)exp(p[0]);
        o[1] = (float)exp(p[1]);
      }
    } else if (j->mode == ND_FUSED_PACK16) {
      /* quantized lane: exp to normal space (same libm order as the
       * staged preprocess), host-side miss_data (gen_func.cpp:862-868)
       * -> sentinel, else rint-quantize the first two components */
      for (int64_t t = 0; t < nt; t++) {
        double *p = scratch + 3 * t;
        double e0 = exp(p[0]), e1 = exp(p[1]), e2 = exp(p[2]);
        unsigned short *o = j->out16 + 2 * (t0 + t);
        double d01 = e0 > e1 ? e0 - e1 : e1 - e0;
        double d12 = e1 > e2 ? e1 - e2 : e2 - e1;
        if (d01 < ND_EPSILON && d12 < ND_EPSILON) {
          /* value-preserving sentinel: (PAD16, quantized mean) — the
           * non-pairwise-deletion sums USE missing values (hostmem
           * U16_ONE note).  Same f64 arithmetic as the staged pack16:
           * ((e0 + e1) + e2) / 3. */
          o[0] = (unsigned short)ND_PAD16;
          o[1] = (unsigned short)llrint(((e0 + e1 + e2) / 3.0) * ND_U16_ONE);
        } else {
          o[0] = (unsigned short)llrint(e0 * ND_U16_ONE);
          o[1] = (unsigned short)llrint(e1 * ND_U16_ONE);
        }
      }
    } else {
      /* ND_FUSED_CODES: default-threshold call_geno (nd_call_geno3 with
       * N_thresh = call_thresh = 0, gen_func.cpp:886-914) maps EVERY
       * normalized triple to either a one-hot at the FIRST log-space
       * argmax (code 0-2) or, for an exactly all-equal triple, the
       * uniform exp(log(1/3)) missing value (code 3).  The downstream
       * values are fully determined by the code, so no exp is needed —
       * hostmem.coded_call_lut reconstructs the exact staged triples. */
      for (int64_t t = 0; t < nt; t++) {
        double *p = scratch + 3 * t;
        int max_pos = 0, min_pos = 0;
        double mx = -INFINITY, mn = INFINITY;
        for (int k = 0; k < 3; k++) {
          if (p[k] > mx) { mx = p[k]; max_pos = k; }
          if (p[k] < mn) { mn = p[k]; min_pos = k; }
        }
        unsigned char c = (unsigned char)max_pos;
        if (p[min_pos] == p[max_pos]) {
          c = 3;
          j->any_missing = 1;
        }
        j->outc[t0 + t] = c;
      }
    }
    errno = norm_errno;
  }
  free(scratch);
  return NULL;
}

/* Fused ranged reader for RAW (non-gzip, seekable) binary GP files.
 * ND_FUSED_PACK23 fills out2[(site_stop-site_start)][n_ind][2] with
 * normal-space f32 2-component triples; ND_FUSED_CODES fills outc with
 * one call_geno code per triple.  Returns 0 on success, 1 on a reader fatal
 * (errbuf set, reference messages), 2 when the file is not raw binary
 * (gzip magic / unseekable) and the caller must take the staged path.
 * Error semantics mirror nd_read_geno_impl's binary branch: complete
 * triples are normalized before a short-file error is raised, a NaN
 * among them outranks premature EOF, and when the range runs to
 * n_sites a longer-than-expected file is "not at EOF"
 * (read_data.cpp:29-47,106-109). */
static int nd_fused_read_impl(const char *path, int in_logscale,
                              int64_t n_ind, int64_t n_sites,
                              int64_t site_start, int64_t site_stop,
                              float *out2, unsigned char *outc,
                              unsigned short *out16, int mode,
                              int *any_missing_out, char *errbuf,
                              int64_t errbuf_cap, int *err_out) {
  *err_out = 0;
  if (strcmp(path, "-") == 0) return 2;
  int fd = open(path, O_RDONLY);
  if (fd < 0) {
    nd_seterr(errbuf, errbuf_cap, "cannot open GENO file!");
    *err_out = errno;
    return 1;
  }
  unsigned char magic[2];
  struct stat stv;
  if (pread(fd, magic, 2, 0) != 2 || (magic[0] == 0x1f && magic[1] == 0x8b) ||
      fstat(fd, &stv) != 0 || !S_ISREG(stv.st_mode)) {
    close(fd);
    return 2;
  }
  int64_t row = n_ind * ND_NGENO * (int64_t)sizeof(double);
  int64_t total = n_sites * row;
  int64_t base_off = site_start * row;
  int64_t want = (site_stop - site_start) * n_ind; /* triples */
  int64_t avail_bytes = (int64_t)stv.st_size - base_off;
  if (avail_bytes < 0) avail_bytes = 0;
  if (avail_bytes > want * 3 * (int64_t)sizeof(double))
    avail_bytes = want * 3 * (int64_t)sizeof(double);
  /* complete triples only: a partial trailing triple is never
   * normalized (the reference's short gzread likewise drops it) */
  int64_t have = avail_bytes / (3 * (int64_t)sizeof(double));

  int64_t pieces = (have + ND_PACK_PIECE_TRIPLES - 1) / ND_PACK_PIECE_TRIPLES;
  long nt = sysconf(_SC_NPROCESSORS_ONLN);
  if (nt < 1) nt = 1;
  if (nt > 16) nt = 16;
  if (nt > pieces) nt = (long)(pieces > 0 ? pieces : 1);
  nd_pack_job jobs[16];
  pthread_t tids[16];
  int64_t next_piece = 0;
  long nw = 0, nj = 0; /* created threads vs jobs run (incl. inline) */
  for (long w = 0; w < nt; w++) {
    jobs[w] = (nd_pack_job){fd, base_off, have, &next_piece, out2, outc,
                            out16, mode, in_logscale, 0, 0, 0, 0, -1};
    if (pthread_create(&tids[nw], NULL, nd_pack_worker, &jobs[w]))
      nd_pack_worker(&jobs[w]); /* degraded: run inline, no tid to join */
    else
      nw++;
    nj = w + 1;
  }
  for (long w = 0; w < nw; w++) pthread_join(tids[w], NULL);
  int rc = 0;
  int nan = 0, read_err = 0, any_missing = 0;
  int64_t errno_piece = -1;
  for (long w = 0; w < nj; w++) {
    nan |= jobs[w].nan_flag;
    read_err |= jobs[w].read_err;
    any_missing |= jobs[w].any_missing;
    /* last non-zero errno in triple order wins (nd_normalize_rows) */
    if (jobs[w].saved_errno && jobs[w].errno_piece > errno_piece) {
      *err_out = jobs[w].saved_errno;
      errno_piece = jobs[w].errno_piece;
    }
  }
  if (any_missing_out) *any_missing_out = any_missing;
  close(fd);
  if (nan) {
    nd_seterr(errbuf, errbuf_cap, "NaN found! Is the file format correct?");
    return 1;
  }
  if (read_err) {
    nd_seterr(errbuf, errbuf_cap,
              "cannot read binary GENO file. Check GENO file and number of "
              "sites!");
    return 1;
  }
  if (have < want) {
    nd_seterr(errbuf, errbuf_cap,
              "GENO file at premature EOF. Check GENO file and number of "
              "sites!");
    return 1;
  }
  if (site_stop == n_sites && (int64_t)stv.st_size > total) {
    nd_seterr(errbuf, errbuf_cap,
              "GENO file not at EOF. Check GENO file and number of sites!");
    return 1;
  }
  return rc;
}

ND_EXPORT int nd_read_geno_pack23(const char *path, int in_logscale,
                                  int64_t n_ind, int64_t n_sites,
                                  int64_t site_start, int64_t site_stop,
                                  float *out2, char *errbuf,
                                  int64_t errbuf_cap, int *err_out) {
  return nd_fused_read_impl(path, in_logscale, n_ind, n_sites, site_start,
                            site_stop, out2, NULL, NULL, ND_FUSED_PACK23,
                            NULL, errbuf, errbuf_cap, err_out);
}

/* Fused ranged uint16-quantized reader for RAW binary GP files
 * (hostmem.pack16 lane, NGSDIST_UPLOAD16): fills
 * out16[(site_stop-site_start)][n_ind][2] with rint(p * 65534)
 * quantized 2-component triples (sentinel 65535 for host-missing rows)
 * in ONE threaded pass — 4 bytes/triple on the host link vs pack23's
 * 8.  Bit-equal to the staged read -> preprocess -> pack16 route.
 * Same return/error contract as nd_read_geno_pack23. */
ND_EXPORT int nd_read_geno_pack16(const char *path, int in_logscale,
                                  int64_t n_ind, int64_t n_sites,
                                  int64_t site_start, int64_t site_stop,
                                  unsigned short *out16, char *errbuf,
                                  int64_t errbuf_cap, int *err_out) {
  return nd_fused_read_impl(path, in_logscale, n_ind, n_sites, site_start,
                            site_stop, NULL, NULL, out16, ND_FUSED_PACK16,
                            NULL, errbuf, errbuf_cap, err_out);
}

/* Fused ranged CODES reader for RAW binary GP files under
 * default-threshold --call_geno: fills outc[(site_stop-site_start)*n_ind]
 * with one uint8 code per triple (0-2 = one-hot at the log-space argmax,
 * 3 = all-equal missing) in ONE threaded pass — no [S, N, 3] f64 tensor,
 * no call_geno / exp / derive_codes passes.  any_missing_out reports
 * whether code 3 occurred (the Python side zeroes the unused lut row to
 * stay bit-identical to hostmem.derive_codes on the staged tensor).
 * Same return/error contract as nd_read_geno_pack23. */
ND_EXPORT int nd_read_geno_codes(const char *path, int in_logscale,
                                 int64_t n_ind, int64_t n_sites,
                                 int64_t site_start, int64_t site_stop,
                                 unsigned char *outc, int *any_missing_out,
                                 char *errbuf, int64_t errbuf_cap,
                                 int *err_out) {
  return nd_fused_read_impl(path, in_logscale, n_ind, n_sites, site_start,
                            site_stop, NULL, outc, NULL, ND_FUSED_CODES,
                            any_missing_out, errbuf, errbuf_cap, err_out);
}

/* ------------------------------------------------------------------ */
/* Exact pairwise distance engine                                      */
/* ------------------------------------------------------------------ */

/* Missing-data test on a normal-space triple: all three probabilities
 * within EPSILON of each other (gen_func.cpp:862-868). */
static int nd_miss3(const double *p) {
  double d01 = p[0] - p[1];
  double d12 = p[1] - p[2];
  if (d01 < 0) d01 = -d01;
  if (d12 < 0) d12 = -d12;
  return d01 < ND_EPSILON && d12 < ND_EPSILON;
}

/* Single-site 3x3 joint-genotype EM with the exact arithmetic order of
 * the reference (emOptim2.cpp:69-135 via the call at ngsDist.cpp:349):
 * tole=0.001, maxIter=50, per-iteration double normalization, and a
 * log-likelihood convergence break evaluated after the update. */
static void nd_em2_site(double *sfs, const double *a, const double *b) {
  double tmp;
  int inc;
  /* lik2 of the uniform start */
  tmp = 0.0;
  inc = 0;
  for (int x = 0; x < 3; x++)
    for (int y = 0; y < 3; y++) {
      tmp += sfs[inc] * a[x] * b[y];
      inc++;
    }
  double oldLik = log(tmp);

  for (int it = 0; it < 50; it++) {
    double inner[9];
    inc = 0;
    for (int x = 0; x < 3; x++)
      for (int y = 0; y < 3; y++) {
        inner[inc] = sfs[inc] * a[x] * b[y];
        inc++;
      }
    double s1 = 0.0;
    for (int k = 0; k < 9; k++) s1 += inner[k];
    for (int k = 0; k < 9; k++) inner[k] /= s1;
    /* post accumulate (single site: post == inner) then renormalize */
    double post[9];
    for (int k = 0; k < 9; k++) post[k] = 0.0 + inner[k];
    double s2 = 0.0;
    for (int k = 0; k < 9; k++) s2 += post[k];
    for (int k = 0; k < 9; k++) post[k] /= s2;
    for (int k = 0; k < 9; k++) sfs[k] = post[k];

    tmp = 0.0;
    inc = 0;
    for (int x = 0; x < 3; x++)
      for (int y = 0; y < 3; y++) {
        tmp += sfs[inc] * a[x] * b[y];
        inc++;
      }
    double lik = log(tmp);
    if (fabs(lik - oldLik) < 0.001) break;
    oldLik = lik;
  }
}

typedef struct {
  const double *P; /* [n_ind][n_sites][3] normal-space */
  int64_t n_ind, n_sites;
  const int64_t *site_map; /* NULL => identity over n_used sites */
  int64_t n_used;
  const double *score; /* [9] row-major score[g1][g2] */
  int indep, pairwise_del;
  int64_t tot_sites;
  int evol_model;
  double *out; /* [n_ind][n_ind] */
  double *raw_out; /* optional [n_ind][n_ind] pre-correction sums */
  double *cnt_out; /* optional [n_ind][n_ind] valid-site counts */
  int64_t pair_lo, pair_hi; /* this worker's comb_id range */
  int bad_model; /* set if an unsupported model was requested */
} nd_pair_job;

/* Distance for one pair, accumulating per-site in the same operation
 * order as the reference hot loop (ngsDist.cpp:333-364,372-401). */
static double nd_pair_dist(const nd_pair_job *j, int64_t i1, int64_t i2) {
  const double *P = j->P;
  int64_t S = j->n_sites;
  uint64_t cnt = 0;
  double dist = 0.0;
  const double *base1 = P + i1 * S * 3;
  const double *base2 = P + i2 * S * 3;

  for (int64_t t = 0; t < j->n_used; t++) {
    int64_t s = j->site_map ? j->site_map[t] : t;
    const double *p1 = base1 + s * 3;
    const double *p2 = base2 + s * 3;
    if (j->pairwise_del && (nd_miss3(p1) || nd_miss3(p2))) continue;

    if (j->indep) {
      for (int g1 = 0; g1 < 3; g1++)
        for (int g2 = 0; g2 < 3; g2++)
          dist += j->score[g1 * 3 + g2] * (p1[g1] * p2[g2]);
    } else {
      double sfs[9];
      for (int k = 0; k < 9; k++) sfs[k] = (double)1 / 9;
      nd_em2_site(sfs, p1, p2);
      for (int g1 = 0; g1 < 3; g1++)
        for (int g2 = 0; g2 < 3; g2++)
          dist += j->score[g1 * 3 + g2] * sfs[3 * g1 + g2];
    }
    cnt++;
  }

  /* Pre-override statistics for the verbose>=3 per-pair report and the
   * throughput meter (reference prints cnt BEFORE the --tot_sites
   * override, ngsDist.cpp:366-373). */
  if (j->raw_out) {
    int64_t n = j->n_ind;
    j->raw_out[i1 * n + i2] = j->raw_out[i2 * n + i1] = dist;
    j->cnt_out[i1 * n + i2] = j->cnt_out[i2 * n + i1] = (double)cnt;
  }

  if (j->tot_sites > 0) cnt = (uint64_t)j->tot_sites;
  dist /= (double)cnt;

  switch (j->evol_model) {
    case 0:
      break;
    case 1:
      dist = -log(1 - dist);
      break;
    case 2:
      dist = -log(1 - (dist * 4 / 3)) * 3 / 4;
      break;
    default:
      ((nd_pair_job *)j)->bad_model = 1;
      dist = NAN;
      break;
  }
  return dist;
}

static void *nd_pair_worker(void *arg) {
  nd_pair_job *j = (nd_pair_job *)arg;
  int64_t n = j->n_ind;
  int64_t comb = 0;
  for (int64_t i1 = 0; i1 < n; i1++)
    for (int64_t i2 = i1 + 1; i2 < n; i2++, comb++) {
      if (comb < j->pair_lo || comb >= j->pair_hi) continue;
      double d = nd_pair_dist(j, i1, i2);
      j->out[i1 * n + i2] = d;
      j->out[i2 * n + i1] = d;
    }
  return NULL;
}

/* Compute the full symmetric distance matrix (diagonal zero).  Returns 0
 * on success; 2 if an unsupported evolutionary model (3-6) was hit. */
/* Expose the single-site EM for the verbose>=9 per-genotype debug dump
 * (runner-side Python loop) and for oracle tests. */
ND_EXPORT void nd_em2_site_run(double *sfs, const double *gl1,
                               const double *gl2) {
  nd_em2_site(sfs, gl1, gl2);
}

ND_EXPORT int nd_pair_dists(const double *P, int64_t n_ind, int64_t n_sites,
                            const int64_t *site_map, int64_t n_used,
                            const double *score, int indep, int pairwise_del,
                            int64_t tot_sites, int evol_model, int n_threads,
                            double *out, double *raw_out, double *cnt_out) {
  for (int64_t i = 0; i < n_ind * n_ind; i++) out[i] = 0.0;
  int64_t n_comb = n_ind * (n_ind - 1) / 2;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_comb) n_threads = (int)(n_comb > 0 ? n_comb : 1);

  nd_pair_job *jobs =
      (nd_pair_job *)malloc((size_t)n_threads * sizeof(nd_pair_job));
  pthread_t *tids = (pthread_t *)malloc((size_t)n_threads * sizeof(pthread_t));
  int64_t chunk = (n_comb + n_threads - 1) / n_threads;
  for (int w = 0; w < n_threads; w++) {
    jobs[w] = (nd_pair_job){P, n_ind, n_sites, site_map, n_used, score,
                            indep, pairwise_del, tot_sites, evol_model, out,
                            raw_out, cnt_out, w * chunk, (w + 1) * chunk, 0};
    if (jobs[w].pair_hi > n_comb) jobs[w].pair_hi = n_comb;
  }
  if (n_threads == 1) {
    nd_pair_worker(&jobs[0]);
  } else {
    int nw = 0;
    for (int w = 0; w < n_threads; w++) {
      if (pthread_create(&tids[nw], NULL, nd_pair_worker, &jobs[w]))
        nd_pair_worker(&jobs[w]);
      else
        nw++;
    }
    for (int w = 0; w < nw; w++) pthread_join(tids[w], NULL);
  }
  int bad = 0;
  for (int w = 0; w < n_threads; w++) bad |= jobs[w].bad_model;
  free(jobs);
  free(tids);
  return bad ? 2 : 0;
}
