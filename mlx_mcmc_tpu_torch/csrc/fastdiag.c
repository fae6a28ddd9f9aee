/* fastdiag: batched split R-hat and effective sample size on the host.
 *
 * The port's copy of the two routines of the repository's
 * src/fastdiag/fastdiag.c, with a plain C interface (pointers and sizes,
 * no Python.h) for ctypes. OpenMP over parameters; ESS by direct
 * autocovariance with Geyer's initial-positive-sequence cut per lag (the
 * cut is usually far below the chain length, so O(n * lag_cut) beats a
 * full FFT and allocates only a per-thread scratch). Semantics match the
 * numpy path of mlx_mcmc_tpu_torch/diagnostics/stats.py.
 *
 *   fastdiag_ess(x, chains, draws, params, out)
 *   fastdiag_rhat(x, chains, draws, params, out)   (split R-hat)
 *
 * x: C-contiguous float64 (chains, draws, params); out: float64 (params,).
 * Both return 0, or -1 if a scratch allocation failed (out then holds NaN
 * where it did).
 *
 * Build: gcc -O3 -fopenmp -shared -fPIC -o libfastdiag.so fastdiag.c -lm
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>

/* ESS of one parameter column: value(c, t) = col[(c * draws + t) * params]. */
static double ess_one(const double *col, int64_t chains, int64_t draws, int64_t params,
                      double *scratch) {
  const int64_t m = chains, n = draws;
  if (n < 4) return NAN;

  /* scratch: demeaned draws (m*n), chain means (m), chain variances (m) */
  double *d = scratch;
  double *cmean = scratch + m * n;
  double *cvar = cmean + m;

  for (int64_t c = 0; c < m; ++c) {
    const double *row = col + (size_t)c * n * params;
    double s = 0.0;
    for (int64_t t = 0; t < n; ++t) s += row[(size_t)t * params];
    double mu = s / (double)n;
    cmean[c] = mu;
    double v = 0.0;
    for (int64_t t = 0; t < n; ++t) {
      double dv = row[(size_t)t * params] - mu;
      d[c * n + t] = dv;
      v += dv * dv;
    }
    cvar[c] = v / (double)(n - 1);
  }

  double W = 0.0;
  for (int64_t c = 0; c < m; ++c) W += cvar[c];
  W /= (double)m;

  double var_plus = W * (double)(n - 1) / (double)n;
  if (m > 1) {
    double gm = 0.0;
    for (int64_t c = 0; c < m; ++c) gm += cmean[c];
    gm /= (double)m;
    double B = 0.0;
    for (int64_t c = 0; c < m; ++c) {
      double dm = cmean[c] - gm;
      B += dm * dm;
    }
    var_plus += B / (double)(m - 1);
  }
  if (!(var_plus > 0.0)) return NAN;

  /* rho_t on demand; Geyer pairs with early termination and the monotone
   * rule. rho_0 = 1 by construction. */
  double tau_acc = 0.0;
  double prev_pair = INFINITY;
  const int64_t max_pairs = n / 2;
  for (int64_t k = 0; k < max_pairs; ++k) {
    double pair = 0.0;
    for (int half = 0; half < 2; ++half) {
      const int64_t t = 2 * k + half;
      double rho;
      if (t == 0) {
        rho = 1.0;
      } else if (t >= n) {
        rho = 0.0;
      } else {
        double acov = 0.0;
        for (int64_t c = 0; c < m; ++c) {
          const double *dc = d + c * n;
          double s = 0.0;
          for (int64_t i = 0; i + t < n; ++i) s += dc[i] * dc[i + t];
          acov += s / (double)n;
        }
        acov /= (double)m;
        rho = 1.0 - (W - acov) / var_plus;
      }
      pair += rho;
    }
    if (pair <= 0.0) break;
    if (pair > prev_pair) pair = prev_pair; /* monotone non-increasing */
    prev_pair = pair;
    tau_acc += pair;
  }
  double tau = -1.0 + 2.0 * tau_acc;
  if (tau < 1e-12) tau = 1e-12;
  const double total = (double)(m * n);
  const double ess = total / tau;
  const double cap = total * log10(total < 10.0 ? 10.0 : total);
  return ess < cap ? ess : cap;
}

/* Split R-hat of one parameter column (each chain cut in halves). */
static double rhat_one(const double *col, int64_t chains, int64_t draws, int64_t params,
                       double *means) {
  const int64_t half = draws / 2;
  const int64_t m = chains * 2, n = half;
  if (n < 2) return NAN;

  double W = 0.0, gmean = 0.0;
  for (int64_t s = 0; s < m; ++s) {
    const int64_t c = s % chains;
    const int64_t off = (s / chains) * half; /* 0 or half */
    const double *row = col + (size_t)c * draws * params;
    double mu = 0.0;
    for (int64_t t = 0; t < n; ++t) mu += row[(size_t)(off + t) * params];
    mu /= (double)n;
    means[s] = mu;
    gmean += mu;
    double v = 0.0;
    for (int64_t t = 0; t < n; ++t) {
      double dv = row[(size_t)(off + t) * params] - mu;
      v += dv * dv;
    }
    W += v / (double)(n - 1);
  }
  W /= (double)m;
  gmean /= (double)m;
  double B = 0.0;
  for (int64_t s = 0; s < m; ++s) {
    double dm = means[s] - gmean;
    B += dm * dm;
  }
  B = B * (double)n / (double)(m - 1);
  if (!(W > 0.0)) return NAN;
  const double var_plus = ((double)(n - 1) / (double)n) * W + B / (double)n;
  return sqrt(var_plus / W);
}

int fastdiag_ess(const double *x, int64_t chains, int64_t draws, int64_t params, double *out) {
  int failed = 0;
#pragma omp parallel reduction(| : failed)
  {
    double *scratch = (double *)malloc(sizeof(double) * (size_t)(chains * draws + 2 * chains));
    failed |= scratch == NULL;
#pragma omp for schedule(dynamic)
    for (int64_t p = 0; p < params; ++p)
      out[p] = scratch ? ess_one(x + p, chains, draws, params, scratch) : NAN;
    free(scratch);
  }
  return failed ? -1 : 0;
}

int fastdiag_rhat(const double *x, int64_t chains, int64_t draws, int64_t params, double *out) {
  int failed = 0;
#pragma omp parallel reduction(| : failed)
  {
    double *means = (double *)malloc(sizeof(double) * (size_t)(2 * chains));
    failed |= means == NULL;
#pragma omp for schedule(dynamic)
    for (int64_t p = 0; p < params; ++p)
      out[p] = means ? rhat_one(x + p, chains, draws, params, means) : NAN;
    free(means);
  }
  return failed ? -1 : 0;
}
