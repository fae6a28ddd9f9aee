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
// ~6 MB) take ~2 us at 3.35 TB/s. What the SMs really issue is ~20 warp
// instructions per (row, chain) with the accurate expf (its range reduction
// is four of them): at 4 warp instructions per clock per SM that is ~0.03 ms.
//
// Design. One thread per chain, a block of 256 chains and a fixed slab of
// whole groups, set by G, n and the SM count only (the wrapper's
// launch_plan: about one group split per SM, 8 groups at G = 1000), so a
// chain's sums are taken in the same order whatever the number of chains
// in the call. The block stages its slab of X and y into
// shared memory once (in chunks of at most 1024 rows where a slab is larger)
// and every thread reads the rows as broadcasts, an X row of K = 4 as one
// float4. The loop runs group by group: a group's boundary is handled
// between the unrolled runs of its rows, not inside them. theta comes in and
// r_theta goes out through one shared tile, both coalesced. Per-split ll and
// g_beta partials are stored output-major ([output][split]) and summed by a
// second kernel, one warp per output: lane l adds splits l, l + 32, ... in
// order, then a fixed shuffle tree. No float atomics, so results are
// reproducible run to run and do not depend on C.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 256;         // chains per block, one per thread
constexpr int kMaxChunkRows = 1024;  // rows of the slab staged at a time
constexpr int kMaxGroups = 16;       // groups per block at most (the shared tile)
constexpr int kMaxK = 8;             // covariates at most

// Row r of the staged chunk: float4 loads where K allows (the chunk starts
// 16-byte aligned), else scalars.
template <int K>
__device__ __forceinline__ void load_row(const float* xs, int r, float (&x)[K]) {
  const float* p = xs + r * K;
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + k);
      x[k] = v.x;
      x[k + 1] = v.y;
      x[k + 2] = v.z;
      x[k + 3] = v.w;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + k);
      x[k] = v.x;
      x[k + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = p[k];
  }
}

template <int K>
__global__ void __launch_bounds__(kChains)
poisson_fused_kernel(const float* __restrict__ X, const float* __restrict__ y,
                     const float* __restrict__ shat,
                     const float* __restrict__ lamhat,
                     const float* __restrict__ theta,
                     const float* __restrict__ beta, float* __restrict__ part,
                     float* __restrict__ r_theta, int C, int G, int n,
                     int groups_per_block, int chunk_rows, int splits) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                    // [chunk row][k]
  float* ys = xs + chunk_rows * K;     // [chunk row]
  float* tile = ys + chunk_rows;       // [group][chain]: theta in, r_theta out

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kChains, c = c0 + tid;
  const int nc = min(kChains, C - c0);
  const int split = blockIdx.y;
  const int g0 = split * groups_per_block;
  const int ng = min(groups_per_block, G - g0);

  // Consecutive threads take consecutive groups of one chain: coalesced.
  for (int i = tid; i < ng * kChains; i += kChains) {
    const int cl = i / ng, g = i - cl * ng;
    tile[g * kChains + cl] = cl < nc ? theta[(size_t)(c0 + cl) * G + g0 + g] : 0.f;
  }
  float b[K], gb[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    b[k] = c < C ? beta[(size_t)c * K + k] : 0.f;
    gb[k] = 0.f;
  }
  float ll = 0.f, rs = 0.f, th = 0.f, sh = 0.f, lh = 0.f;

  auto row = [&](int r) {
    float x[K];
    load_row<K>(xs, r, x);
    float s = th;
#pragma unroll
    for (int k = 0; k < K; ++k) s = fmaf(x[k], b[k], s);
    const float lam = expf(s);
    const float yv = ys[r];
    const float res = yv - lam;
    ll += yv * (s - sh) - (lam - lh);
    rs += res;
#pragma unroll
    for (int k = 0; k < K; ++k) gb[k] = fmaf(res, x[k], gb[k]);
  };

  const size_t row_begin = (size_t)g0 * n;
  const int total = ng * n;
  int gl = 0;  // local group of the next row
  for (int base = 0; base < total; base += chunk_rows) {
    const int rows = min(chunk_rows, total - base);
    if (base > 0) __syncthreads();  // the previous chunk is consumed
    const float* xsrc = X + (row_begin + base) * K;
    for (int i = tid; i < rows * K; i += kChains) xs[i] = xsrc[i];
    for (int i = tid; i < rows; i += kChains) ys[i] = y[row_begin + base + i];
    __syncthreads();
    for (int i = 0; i < rows;) {
      if (base + i == gl * n) {  // a group starts: the same row for every thread
        th = tile[gl * kChains + tid];
        sh = shat[g0 + gl];
        lh = lamhat[g0 + gl];
        rs = 0.f;
      }
      const int group_end = (gl + 1) * n - base;
      const int end = min(rows, group_end);
      int r = i;
      for (; r + 4 <= end; r += 4) {
        row(r);
        row(r + 1);
        row(r + 2);
        row(r + 3);
      }
      for (; r < end; ++r) row(r);
      if (end == group_end) {
        tile[gl * kChains + tid] = rs;  // this thread's own entry
        ++gl;
      }
      i = end;
    }
  }
  __syncthreads();

  for (int i = tid; i < ng * kChains; i += kChains) {
    const int cl = i / ng, g = i - cl * ng;
    if (cl < nc) r_theta[(size_t)(c0 + cl) * G + g0 + g] = tile[g * kChains + cl];
  }
  if (c < C) {
    part[(size_t)c * splits + split] = ll;
#pragma unroll
    for (int k = 0; k < K; ++k) part[((size_t)C + (size_t)c * K + k) * splits + split] = gb[k];
  }
}

// One warp per output o of part[o][split]: lane l sums splits l, l + 32, ...
// in order, then a fixed shuffle tree; outputs [0, C) go to ll, the rest to
// g_beta.
__global__ void sum_splits_warp_kernel(const float* __restrict__ part, float* __restrict__ ll,
                                       float* __restrict__ g_beta, int C, int outputs,
                                       int splits) {
  const int o = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (o >= outputs) return;
  const float* p = part + (size_t)o * splits;
  float v = 0.f;
  for (int s = lane; s < splits; s += 32) v += p[s];
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  if (lane == 0) {
    if (o < C)
      ll[o] = v;
    else
      g_beta[o - C] = v;
  }
}

size_t shared_bytes(int K, int groups_per_block, int chunk_rows) {
  return ((size_t)chunk_rows * (K + 1) + (size_t)groups_per_block * kChains) * sizeof(float);
}

template <int K>
int launch(dim3 grid, cudaStream_t st, const float* X, const float* y, const float* shat,
           const float* lamhat, const float* theta, const float* beta, float* part,
           float* r_theta, int C, int G, int n, int gpb, int chunk_rows, int splits) {
  const size_t smem = shared_bytes(K, gpb, chunk_rows);
  cudaError_t err = cudaFuncSetAttribute(poisson_fused_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  poisson_fused_kernel<K><<<grid, kChains, smem, st>>>(X, y, shat, lamhat, theta, beta, part,
                                                        r_theta, C, G, n, gpb, chunk_rows, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// part holds (C + C K) x splits floats, splits = ceil(G / groups_per_block).
// Returns a CUDA error code, 0 on success.
extern "C" int poisson_fused(const void* X, const void* y, const void* shat,
                             const void* lamhat, const void* theta,
                             const void* beta, void* part, void* ll, void* g_beta,
                             void* r_theta, int C, int G, int n, int K,
                             int groups_per_block, void* stream) {
  if (C <= 0 || G <= 0 || n <= 0 || K < 1 || K > kMaxK ||
      groups_per_block < 1 || groups_per_block > kMaxGroups)
    return (int)cudaErrorInvalidValue;
  const int splits = (G + groups_per_block - 1) / groups_per_block;
  if (splits > 65535) return (int)cudaErrorInvalidValue;
  const long long slab = (long long)groups_per_block * n;
  const int chunk_rows = (int)(slab < kMaxChunkRows ? slab : kMaxChunkRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((C + kChains - 1) / kChains, splits);
  const float* in[6] = {
      static_cast<const float*>(X),     static_cast<const float*>(y),
      static_cast<const float*>(shat),  static_cast<const float*>(lamhat),
      static_cast<const float*>(theta), static_cast<const float*>(beta)};
  float* pp = static_cast<float*>(part);
  float* rt = static_cast<float*>(r_theta);
  int err = (int)cudaErrorInvalidValue;
#define POISSON_CASE(KK)                                                                    \
  case KK:                                                                                  \
    err = launch<KK>(grid, st, in[0], in[1], in[2], in[3], in[4], in[5], pp, rt, C, G, n, \
                     groups_per_block, chunk_rows, splits);                                 \
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
  if (err != 0) return err;
  const int outputs = C + C * K;
  sum_splits_warp_kernel<<<(outputs + 7) / 8, 256, 0, st>>>(
      pp, static_cast<float*>(ll), static_cast<float*>(g_beta), C, outputs, splits);
  return (int)cudaGetLastError();
}
