// Fused hierarchical Poisson regression log-likelihood and gradient for a
// batch of chains, in one pass over the counts, for Hopper (sm_90a).
//
// Replaces the TPU kernel mlx_mcmc_tpu/ops/pallas/poisson.py:_poisson_kernel.
// For y_gi ~ Poisson(exp(theta_g + x_gi . beta)), with X (G, n, K) f32,
// y (G, n) f32, the per-group centering constants shat, lamhat (G,), and
// per chain theta (C, G) and beta (C, K), it computes
//
//   s_gi     = theta_g + sum_k x_gik beta_k     exact f32, on the CUDA cores
//   lam_gi   = exp(s_gi),  r_gi = y_gi - lam_gi
//   ll_c     = sum_gi y_gi (s_gi - shat_g) - (lam_gi - lamhat_g)
//   r_theta  = sum_i r_gi            (C, G)
//   g_beta   = sum_gi r_gi x_gik     (C, K)
//
// The caller adds c0 (which holds -sum log y! and the centering constant),
// the non-centered chain rule and the priors. No tensor cores and no bf16 or
// TF32: rounding s to bf16-class precision injected ~7 nats of ll noise in
// the reference and collapsed adaptation. The per-row terms are centered on
// the group's baseline rate, so the partial sums stay small (~1e-2 nats of
// f32 noise in all, as in the reference). The gradient stays f32 too: at
// K = 4 there is no product for tensor cores to take.
//
// Bound. Per (row, chain): K FMAs for s, one exp, about seven f32 operations
// for ll, r and r_theta, and K FMAs for g_beta: (4K + 8) operations counting
// the exp as one. At C = 512, N = G n = 100K, K = 4 that is 1.2e9, 18 us at
// the H100's 67 TFLOP/s of float32; the bytes (X, y, theta in; r_theta out:
// ~6 MB) take ~2 us at 3.35 TB/s. So the kernel is bound by operations.
//
// Design (first version: simple and right). One thread per chain, a block
// of 128 chains and a contiguous run of at most 32 groups; the grid is
// (chain tiles x group splits), sized to fill the SMs. Every chain reads the
// same counts, so the block stages its rows of X and y through shared memory
// in chunks of 256 rows and every thread reads them as broadcasts. Each
// thread keeps beta and its g_beta and ll accumulators in registers, walks
// its block's rows in order, and closes a group's r_theta sum where the next
// group starts. theta comes in and r_theta goes out through a shared tile, so
// both are read and written coalesced. Per-split ll and g_beta partials are
// summed by a second small kernel in a fixed order: no float atomics, so
// results are reproducible run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 128;    // chains per block, one per thread
constexpr int kRowChunk = 256;  // rows staged in shared memory at a time
constexpr int kMaxGroups = 32;  // groups per block at most
constexpr int kMaxK = 8;        // covariates at most

template <int K>
__global__ void __launch_bounds__(kChains)
poisson_fused_kernel(const float* __restrict__ X, const float* __restrict__ y,
                     const float* __restrict__ shat,
                     const float* __restrict__ lamhat,
                     const float* __restrict__ theta,
                     const float* __restrict__ beta,
                     float* __restrict__ ll_part, float* __restrict__ gb_part,
                     float* __restrict__ r_theta, int C, int G, int n,
                     int groups_per_block) {
  __shared__ __align__(16) float xs[kRowChunk * K];
  __shared__ float ys[kRowChunk];
  __shared__ float tile[kMaxGroups][kChains + 1];  // theta in, r_theta out

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kChains, c = c0 + tid;
  const int nc = min(kChains, C - c0);
  const int split = blockIdx.y;
  const int g0 = split * groups_per_block;
  const int ng = min(groups_per_block, G - g0);

  // Consecutive threads take consecutive groups of one chain: coalesced.
  for (int i = tid; i < ng * kChains; i += kChains) {
    const int cl = i / ng, g = i - cl * ng;
    tile[g][cl] = cl < nc ? theta[(size_t)(c0 + cl) * G + g0 + g] : 0.f;
  }
  float b[K], gb[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    b[k] = c < C ? beta[(size_t)c * K + k] : 0.f;
    gb[k] = 0.f;
  }
  float ll = 0.f, rs = 0.f;
  __syncthreads();

  int gl = 0, next = n;  // local group of the current row; where gl + 1 starts
  float th = tile[0][tid], sh = shat[g0], lh = lamhat[g0];
  const long long row_begin = (long long)g0 * n;
  const int total = ng * n;
  for (int base = 0; base < total; base += kRowChunk) {
    const int rows = min(kRowChunk, total - base);
    __syncthreads();  // the previous chunk is consumed
    const float* xsrc = X + (row_begin + base) * K;
    for (int i = tid; i < rows * K; i += kChains) xs[i] = xsrc[i];
    for (int i = tid; i < rows; i += kChains) ys[i] = y[row_begin + base + i];
    __syncthreads();
    for (int i = 0; i < rows; ++i) {
      if (base + i == next) {  // the same row for every thread: no divergence
        tile[gl][tid] = rs;
        ++gl;
        next += n;
        th = tile[gl][tid];
        sh = shat[g0 + gl];
        lh = lamhat[g0 + gl];
        rs = 0.f;
      }
      const float* xr = xs + i * K;
      float s = th;
#pragma unroll
      for (int k = 0; k < K; ++k) s = fmaf(xr[k], b[k], s);
      const float lam = expf(s);
      const float yv = ys[i];
      const float res = yv - lam;
      ll += yv * (s - sh) - (lam - lh);
      rs += res;
#pragma unroll
      for (int k = 0; k < K; ++k) gb[k] = fmaf(res, xr[k], gb[k]);
    }
  }
  tile[gl][tid] = rs;
  __syncthreads();

  for (int i = tid; i < ng * kChains; i += kChains) {
    const int cl = i / ng, g = i - cl * ng;
    if (cl < nc) r_theta[(size_t)(c0 + cl) * G + g0 + g] = tile[g][cl];
  }
  if (c < C) {
    ll_part[(size_t)split * C + c] = ll;
#pragma unroll
    for (int k = 0; k < K; ++k) gb_part[((size_t)split * C + c) * K + k] = gb[k];
  }
}

// out[i] = sum over splits of part[s][i], always in split order.
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = part[i];
  for (int s = 1; s < splits; ++s) v += part[(size_t)s * n + i];
  out[i] = v;
}

template <int K>
void launch(dim3 grid, cudaStream_t st, const float* X, const float* y,
            const float* shat, const float* lamhat, const float* theta,
            const float* beta, float* ll_part, float* gb_part, float* r_theta,
            int C, int G, int n, int gpb) {
  poisson_fused_kernel<K><<<grid, kChains, 0, st>>>(
      X, y, shat, lamhat, theta, beta, ll_part, gb_part, r_theta, C, G, n, gpb);
}

}  // namespace

extern "C" int poisson_fused(const void* X, const void* y, const void* shat,
                             const void* lamhat, const void* theta,
                             const void* beta, void* ll_part, void* gb_part,
                             void* ll, void* g_beta, void* r_theta, int C,
                             int G, int n, int K, int groups_per_block,
                             void* stream) {
  if (C <= 0 || G <= 0 || n <= 0 || K < 1 || K > kMaxK ||
      groups_per_block < 1 || groups_per_block > kMaxGroups)
    return (int)cudaErrorInvalidValue;
  const int splits = (G + groups_per_block - 1) / groups_per_block;
  if (splits > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((C + kChains - 1) / kChains, splits);
  const float* args_in[6] = {
      static_cast<const float*>(X),     static_cast<const float*>(y),
      static_cast<const float*>(shat),  static_cast<const float*>(lamhat),
      static_cast<const float*>(theta), static_cast<const float*>(beta)};
  float* lp = static_cast<float*>(ll_part);
  float* gp = static_cast<float*>(gb_part);
  float* rt = static_cast<float*>(r_theta);
#define POISSON_CASE(KK)                                                     \
  case KK:                                                                   \
    launch<KK>(grid, st, args_in[0], args_in[1], args_in[2], args_in[3],     \
               args_in[4], args_in[5], lp, gp, rt, C, G, n, groups_per_block); \
    break;
  switch (K) {
    POISSON_CASE(1)
    POISSON_CASE(2)
    POISSON_CASE(3)
    POISSON_CASE(4)
    POISSON_CASE(5)
    POISSON_CASE(6)
    POISSON_CASE(7)
    POISSON_CASE(8)
  }
#undef POISSON_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_splits_kernel<<<(C + 255) / 256, 256, 0, st>>>(lp, static_cast<float*>(ll), C, splits);
  const int nb = C * K;
  sum_splits_kernel<<<(nb + 255) / 256, 256, 0, st>>>(gp, static_cast<float*>(g_beta), nb, splits);
  return (int)cudaGetLastError();
}
