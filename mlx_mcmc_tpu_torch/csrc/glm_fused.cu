// Fused GLM log-likelihood and gradient for a batch of chains, in one pass
// over a bf16 design matrix, for Hopper (sm_90a). One kernel template, two
// likelihoods that differ only in the per-element epilogue.
//
// Replaces two TPU kernels of mlx_mcmc_tpu/ops/pallas/glm.py: _fused_kernel
// (logistic, entry glm_fused_logistic) and _fused_linear_kernel (Gaussian,
// entry glm_fused_linear). For X (N, Dp) bf16, y (N,) f32 and Z (C, D) f32
// (cast to bf16), both compute
//
//   s      = X Z^T                        f32 accumulation
//   ll_c   = sum_i term(y_i, s_ic)
//   g      = X^T bf16(res(y, s))          f32 accumulation
//
// with, for the logistic likelihood (h = tanh(s / 2)),
//   term = y s - [max(s, 0) - log(0.5 + 0.5 |h|)],  res = y - (0.5 + 0.5 h)
// and, for the Gaussian one (unit noise; the caller scales by 1/sigma^2),
//   term = -0.5 (y - s)^2,                          res = y - s.
//
// Likelihood only: the caller adds the prior. Rows past N are masked inside
// the kernel (they contribute nothing), so unpadded data needs no pad
// constant. Columns D..Dp-1 of X must be zero.
//
// Bound. At the main shape (N = 10,000, D = 100, C = 4096) the two products
// are 4 N D C = 1.6e10 flop, about 17 us of bf16 tensor-core time at the
// H100's 989 TFLOP/s; the logistic epilogue is 2 N C = 8.2e7 transcendentals
// plus about ten f32 operations per element (the Gaussian one about four);
// the bytes are about 4.5 MB (X once, Z, g), 1.4 us at 3.35 TB/s. So both
// are bound by operations.
//
// Design (first version: simple and right). A block owns 64 chains and one
// contiguous range of rows; the grid is (chain tiles x row splits), sized to
// fill the SMs. The block keeps its Z tile resident in shared memory as bf16
// and walks its rows in 64-row tiles: each X tile is loaded once (plus a
// transposed copy), s comes from mma.sync m16n8k16 bf16 with f32
// accumulators, the epilogue runs in f32 (the logistic one with the
// accurate tanhf and logf, no fast math: the one-pass y*s - softplus sum
// must stay within about 1e-2 nats at N = 10K), per-chain ll accumulates in
// registers, the residual is written to shared memory rounded to bf16, and
// g += X_tile^T r runs from the same resident tile with accumulators kept in
// registers across all row tiles. Per-split partial sums are reduced by a
// second small kernel in a fixed order: no float atomics, so results are
// reproducible run to run. wgmma, TMA and a persistent schedule are left for
// later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;     // rows of X per tile
constexpr int kChains = 64;   // chains per block
constexpr int kThreads = 128; // four warps
constexpr int kPad = 8;       // bf16 elements of padding per shared-memory row
constexpr int kMaxDp = 128;   // step 2 keeps at most 2 m-tiles per warp

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A B for one m16n8k16 tile: A row-major bf16, B column-major bf16.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

size_t shared_bytes(int Dp) {
  const size_t ldz = Dp + kPad, ldt = kRows + kPad;
  return (kChains * ldz + kRows * ldz + Dp * ldt + kChains * ldt) * 2 +
         (kRows + 4 * kChains) * 4;
}

// The per-element epilogue: ll term and residual (d term / d s).
struct Logistic {
  __device__ __forceinline__ static void apply(float y, float s, float& term, float& res) {
    const float th = tanhf(0.5f * s);
    res = y - (0.5f + 0.5f * th);
    term = y * s - (fmaxf(s, 0.f) - logf(0.5f + 0.5f * fabsf(th)));
  }
};

struct Gaussian {
  __device__ __forceinline__ static void apply(float y, float s, float& term, float& res) {
    res = y - s;
    term = -0.5f * res * res;
  }
};

template <class Epilogue>
__global__ void __launch_bounds__(kThreads)
glm_fused_kernel(const __nv_bfloat16* __restrict__ X,
                 const float* __restrict__ y, const float* __restrict__ Z,
                 float* __restrict__ ll_part, float* __restrict__ g_part,
                 int N, int Dp, int D, int C, int rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldz = Dp + kPad;   // row stride of Zs and Xs
  const int ldt = kRows + kPad;  // row stride of XsT and Rt
  __nv_bfloat16* Zs = reinterpret_cast<__nv_bfloat16*>(smem);  // [chain][d]
  __nv_bfloat16* Xs = Zs + kChains * ldz;                      // [row][d]
  __nv_bfloat16* XsT = Xs + kRows * ldz;                       // [d][row]
  __nv_bfloat16* Rt = XsT + Dp * ldt;                          // [chain][row]
  float* ys = reinterpret_cast<float*>(Rt + kChains * ldt);    // [row]
  float* red = ys + kRows;                                     // [warp][chain]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, t4 = lane & 3;
  const int c0 = blockIdx.x * kChains;
  const int split = blockIdx.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);
  const int dsteps = Dp / 16;

  for (int i = tid; i < kChains * Dp; i += kThreads) {
    const int n = i / Dp, d = i - n * Dp, c = c0 + n;
    const float v = (c < C && d < D) ? Z[(size_t)c * D + d] : 0.f;
    Zs[n * ldz + d] = __float2bfloat16_rn(v);
  }

  float ll_acc[8][2];
  float g_acc[2][8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ll_acc[j][0] = ll_acc[j][1] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) g_acc[0][j][q] = g_acc[1][j][q] = 0.f;
  }

  for (int r0 = row_begin; r0 < row_end; r0 += kRows) {
    // X tile: 16-byte loads, stored row-major and transposed.
    const int chunks = Dp / 8;
    for (int i = tid; i < kRows * chunks; i += kThreads) {
      const int r = i % kRows, q = i / kRows, row = r0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < row_end)
        v = *reinterpret_cast<const uint4*>(X + (size_t)row * Dp + q * 8);
      *reinterpret_cast<uint4*>(Xs + r * ldz + q * 8) = v;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k) XsT[(q * 8 + k) * ldt + r] = e[k];
    }
    if (tid < kRows) ys[tid] = (r0 + tid < row_end) ? y[r0 + tid] : 0.f;
    __syncthreads();

    // Step 1: s for rows [16 warp, 16 warp + 16) x all 64 chains.
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const int ra = warp * 16 + grp;
    for (int ks = 0; ks < dsteps; ++ks) {
      const int k0 = ks * 16 + 2 * t4;
      const uint32_t a0 = ld_pair(Xs + ra * ldz + k0);
      const uint32_t a1 = ld_pair(Xs + (ra + 8) * ldz + k0);
      const uint32_t a2 = ld_pair(Xs + ra * ldz + k0 + 8);
      const uint32_t a3 = ld_pair(Xs + (ra + 8) * ldz + k0 + 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* zb = Zs + (j * 8 + grp) * ldz + k0;
        mma_bf16(acc[j], a0, a1, a2, a3, ld_pair(zb), ld_pair(zb + 8));
      }
    }

    // Epilogue: ll in registers, bf16 residual to shared memory.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ra + 8 * h;
      const bool valid = r0 + r < row_end;
      const float yv = ys[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float term, res;
          Epilogue::apply(yv, acc[j][2 * h + e], term, res);
          if (!valid) {
            term = 0.f;
            res = 0.f;
          }
          ll_acc[j][e] += term;
          Rt[(j * 8 + 2 * t4 + e) * ldt + r] = __float2bfloat16_rn(res);
        }
      }
    }
    __syncthreads();

    // Step 2: g (Dp x 64 chains) += X_tile^T r; warp w owns m-tiles w, w+4.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int mt = warp + 4 * i;
      if (mt < dsteps) {
        const int da = mt * 16 + grp;
#pragma unroll
        for (int ks = 0; ks < kRows / 16; ++ks) {
          const int k0 = ks * 16 + 2 * t4;
          const uint32_t a0 = ld_pair(XsT + da * ldt + k0);
          const uint32_t a1 = ld_pair(XsT + (da + 8) * ldt + k0);
          const uint32_t a2 = ld_pair(XsT + da * ldt + k0 + 8);
          const uint32_t a3 = ld_pair(XsT + (da + 8) * ldt + k0 + 8);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const __nv_bfloat16* rb = Rt + (j * 8 + grp) * ldt + k0;
            mma_bf16(g_acc[i][j], a0, a1, a2, a3, ld_pair(rb), ld_pair(rb + 8));
          }
        }
      }
    }
    __syncthreads();
  }

  // ll: sum the eight row groups of a warp, then the four warps, in a fixed
  // order.
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = ll_acc[j][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (grp == 0) red[warp * kChains + j * 8 + 2 * t4 + e] = v;
    }
  }
  __syncthreads();
  if (tid < kChains && c0 + tid < C) {
    const float v = ((red[tid] + red[kChains + tid]) + red[2 * kChains + tid]) +
                    red[3 * kChains + tid];
    ll_part[(size_t)split * C + c0 + tid] = v;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int mt = warp + 4 * i;
    if (mt < dsteps) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int d = mt * 16 + grp + 8 * (q >> 1);
          const int c = c0 + j * 8 + 2 * t4 + (q & 1);
          if (c < C && d < D) g_part[((size_t)split * C + c) * D + d] = g_acc[i][j][q];
        }
      }
    }
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

template <class Epilogue>
int launch(const void* X, const void* y, const void* Z, void* ll_part,
           void* g_part, void* ll, void* g, int N, int Dp, int D, int C,
           int splits, int rows_per_split, void* stream) {
  if (Dp <= 0 || Dp % 16 != 0 || Dp > kMaxDp || D > Dp || N <= 0 || C <= 0 ||
      splits <= 0 || rows_per_split % kRows != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = shared_bytes(Dp);
  cudaError_t err = cudaFuncSetAttribute(
      glm_fused_kernel<Epilogue>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((C + kChains - 1) / kChains, splits);
  glm_fused_kernel<Epilogue><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(X), static_cast<const float*>(y),
      static_cast<const float*>(Z), static_cast<float*>(ll_part),
      static_cast<float*>(g_part), N, Dp, D, C, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_splits_kernel<<<(C + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(ll_part), static_cast<float*>(ll), C, splits);
  const int ng = C * D;
  sum_splits_kernel<<<(ng + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(g_part), static_cast<float*>(g), ng, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int glm_fused_logistic(const void* X, const void* y, const void* Z,
                                  void* ll_part, void* g_part, void* ll, void* g,
                                  int N, int Dp, int D, int C, int splits,
                                  int rows_per_split, void* stream) {
  return launch<Logistic>(X, y, Z, ll_part, g_part, ll, g, N, Dp, D, C, splits,
                          rows_per_split, stream);
}

extern "C" int glm_fused_linear(const void* X, const void* y, const void* Z,
                                void* ll_part, void* g_part, void* ll, void* g,
                                int N, int Dp, int D, int C, int splits,
                                int rows_per_split, void* stream) {
  return launch<Gaussian>(X, y, Z, ll_part, g_part, ll, g, N, Dp, D, C, splits,
                          rows_per_split, stream);
}
