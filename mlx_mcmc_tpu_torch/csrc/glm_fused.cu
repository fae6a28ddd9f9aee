// Fused GLM log-likelihood and gradient for a batch of chains, for Hopper
// (sm_90a). One kernel template per path, three likelihood epilogues that
// differ only in the per-element step, bf16 or int8 X.
//
// Replaces three TPU kernels of mlx_mcmc_tpu/ops/pallas/glm.py:
// _fused_kernel (logistic, entry glm_fused_logistic), _fused_linear_kernel
// (Gaussian, entry glm_fused_linear) and _fused_hoisted_kernel (the
// rejected hoisted-outcome variant, entry glm_fused_hoisted). For X (N, Dp)
// bf16 or int8, y (N,) f32 and Z (C, D) f32 (cast to bf16), all compute
//
//   s      = X Z^T                        f32 accumulation
//   ll_c   = sum_i term(y_i, s_ic)
//   g      = X^T bf16(res(y, s))          f32 accumulation
//
// with, for the logistic likelihood (h = tanh(s / 2)),
//   term = y s - [max(s, 0) - log(0.5 + 0.5 |h|)],  res = y - (0.5 + 0.5 h),
// for the Gaussian one (unit noise; the caller scales by 1/sigma^2),
//   term = -0.5 (y - s)^2,                          res = y - s,
// and for the hoisted one (y unused; the caller rebuilds ll and g from
// X^T y, which subtracts two O(N) sums and is why the reference rejected it
// for sampling),
//   term = max(s, 0) - log(0.5 + 0.5 |h|),          res = 0.5 + 0.5 h.
//
// int8 X (symmetric per-column quantization, as the reference stores it) is
// read at half the bytes of bf16 and widened to bf16 in shared memory, exact
// for -127..127; the caller folds the column scales into Z and out of g.
//
// Likelihood only: the caller adds the prior. Rows past N are masked inside
// the kernels (they contribute nothing), so unpadded data needs no pad
// constant. Columns D..Dp-1 of X must be zero.
//
// Two paths, chosen by Dp:
//
// Narrow (Dp <= 128), one pass over X. At glm100's shape (N = 10,000,
// D = 100, C = 4096) the two products are 4 N D C = 1.6e10 flop, about
// 17 us of bf16 tensor-core time at the H100's 989 TFLOP/s; the logistic
// epilogue is 2 N C = 8.2e7 transcendentals plus about ten f32 operations
// per element; the bytes are about 4.5 MB, 1.4 us at 3.35 TB/s. So it is
// bound by operations. A block owns 64 chains and one contiguous range of
// rows; the grid is (chain tiles x row splits), sized to fill the SMs. The
// block keeps its Z tile resident in shared memory as bf16 and walks its
// rows in 64-row tiles: each X tile is loaded once (plus a transposed copy),
// s comes from mma.sync m16n8k16 bf16 with f32 accumulators, the epilogue
// runs in f32 (with the accurate tanhf and logf, no fast math: the one-pass
// y*s - softplus sum must stay within about 1e-2 nats), per-chain ll
// accumulates in registers, the residual is written to shared memory
// rounded to bf16, and g += X_tile^T r runs from the same resident tile
// with accumulators kept in registers across all row tiles: at most two
// 16-row m-tiles of g per warp, hence Dp <= 128.
//
// Wide (Dp > 128, any multiple of 16), two kernels. At glm1000's shape
// (N = 100,000, D = 1000, C = 256) the products are 1.02e11 flop, 0.104 ms
// at 989 TFLOP/s, against 0.060 ms to read bf16 X once: bound by
// operations. g (Dp x 64 chains) no longer fits a block's registers, so
//   A) glm_wide_value_kernel: a block owns 64 chains and a row range, walks
//      it in 128-row tiles, contracts s over Dp in 32-deep chunks of X and
//      of bf16 Z streamed through shared memory (the next chunk is loaded
//      into registers while the current one is multiplied), applies the
//      epilogue, keeps per-chain ll in registers and writes the bf16
//      residual R^T (C_pad x N_pad) to device memory, coalesced through a
//      shared tile;
//   B) glm_wide_grad_kernel: g^T = R^T X as a tiled bf16 tensor-core
//      product, a block per (64 chains, 64 columns, row split), X fragments
//      through ldmatrix.trans.
// X is read twice and R (51 MB at glm1000) written and read once: ~0.5 GB,
// ~0.15 ms at 3.35 TB/s, above the one-pass bound; a one-pass design is
// later work.
//
// Both paths reduce per-split partial sums with a small kernel in a fixed
// order: no float atomics, so results are reproducible run to run. wgmma,
// TMA and a persistent schedule are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;     // rows of X per tile (narrow)
constexpr int kChains = 64;   // chains per block (both paths)
constexpr int kThreads = 128; // four warps (narrow; wide gradient)
constexpr int kPad = 8;       // bf16 elements of padding per shared-memory row
constexpr int kMaxDp = 128;   // narrow step 2 keeps at most 2 m-tiles per warp

constexpr int kARows = 128;            // wide value kernel: rows per tile
constexpr int kAThreads = 256;         // eight warps of 16 rows
constexpr int kAK = 32;                // depth of one staged chunk
constexpr int kALd = kAK + kPad;       // row stride of the staged chunks
constexpr int kALdR = kARows + kPad;   // row stride of the residual tile

constexpr int kGK = 32;                // wide gradient kernel: rows per chunk
constexpr int kGD = 64;                // columns of g per block
constexpr int kGLdR = kGK + kPad;      // row stride of the residual chunk
constexpr int kGLdX = kGD + kPad;      // row stride of the X chunk

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

// Four 8x8 bf16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8 and receives, of each matrix, the
// elements (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Bytes k and k + 1 of w, sign-extended, as a bf16 pair (exact: |v| <= 128).
__device__ __forceinline__ uint32_t widen_pair(uint32_t w, int k) {
  const int lo = static_cast<int>(w << (24 - 8 * k)) >> 24;
  const int hi = static_cast<int>(w << (16 - 8 * k)) >> 24;
  __nv_bfloat162 p = __floats2bfloat162_rn(static_cast<float>(lo), static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&p);
}

// Eight consecutive elements of X: one 16-byte load for bf16, one 8-byte
// load for int8, widened to eight bf16 values.
template <class XT>
struct XPiece;

template <>
struct XPiece<__nv_bfloat16> {
  using Raw = uint4;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ static uint4 widen(Raw v) { return v; }
};

template <>
struct XPiece<int8_t> {
  using Raw = uint2;
  __device__ __forceinline__ static Raw load(const int8_t* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ static Raw zero() { return make_uint2(0u, 0u); }
  __device__ __forceinline__ static uint4 widen(Raw v) {
    return make_uint4(widen_pair(v.x, 0), widen_pair(v.x, 2), widen_pair(v.y, 0),
                      widen_pair(v.y, 2));
  }
};

size_t shared_bytes(int Dp) {
  const size_t ldz = Dp + kPad, ldt = kRows + kPad;
  return (kChains * ldz + kRows * ldz + Dp * ldt + kChains * ldt) * 2 +
         (kRows + 4 * kChains) * 4;
}

// The per-element epilogue: ll term and residual (d term / d s).
struct Logistic {
  static constexpr bool kUsesY = true;
  __device__ __forceinline__ static void apply(float y, float s, float& term, float& res) {
    const float th = tanhf(0.5f * s);
    res = y - (0.5f + 0.5f * th);
    term = y * s - (fmaxf(s, 0.f) - logf(0.5f + 0.5f * fabsf(th)));
  }
};

struct Gaussian {
  static constexpr bool kUsesY = true;
  __device__ __forceinline__ static void apply(float y, float s, float& term, float& res) {
    res = y - s;
    term = -0.5f * res * res;
  }
};

// Softplus and sigmoid of s; y is not read.
struct Hoisted {
  static constexpr bool kUsesY = false;
  __device__ __forceinline__ static void apply(float, float s, float& term, float& res) {
    const float th = tanhf(0.5f * s);
    res = 0.5f + 0.5f * th;
    term = fmaxf(s, 0.f) - logf(0.5f + 0.5f * fabsf(th));
  }
};

template <class Epilogue, class XT>
__global__ void __launch_bounds__(kThreads)
glm_fused_kernel(const XT* __restrict__ X,
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
    // X tile: 16-byte loads (8 bytes for int8), stored row-major and
    // transposed.
    const int chunks = Dp / 8;
    for (int i = tid; i < kRows * chunks; i += kThreads) {
      const int r = i % kRows, q = i / kRows, row = r0 + r;
      typename XPiece<XT>::Raw raw = XPiece<XT>::zero();
      if (row < row_end) raw = XPiece<XT>::load(X + (size_t)row * Dp + q * 8);
      const uint4 v = XPiece<XT>::widen(raw);
      *reinterpret_cast<uint4*>(Xs + r * ldz + q * 8) = v;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k) XsT[(q * 8 + k) * ldt + r] = e[k];
    }
    if (tid < kRows) ys[tid] = (Epilogue::kUsesY && r0 + tid < row_end) ? y[r0 + tid] : 0.f;
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

// Zb (Cp x Dp) = bf16(Z), zero past C and D: the wide path's Z operand,
// rounded once per call instead of once per block.
__global__ void round_z_kernel(const float* __restrict__ Z, __nv_bfloat16* __restrict__ Zb,
                               int C, int D, int Cp, int Dp) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)Cp * Dp) return;
  const int c = static_cast<int>(i / Dp), d = static_cast<int>(i - (size_t)c * Dp);
  Zb[i] = __float2bfloat16_rn((c < C && d < D) ? Z[(size_t)c * D + d] : 0.f);
}

// Wide path, kernel A: s = X Z^T over the full depth, the epilogue, per-split
// ll partials and the bf16 residual Rt[chain][row] (row stride ldr).
template <class Epilogue, class XT>
__global__ void __launch_bounds__(kAThreads)
glm_wide_value_kernel(const XT* __restrict__ X, const float* __restrict__ y,
                      const __nv_bfloat16* __restrict__ Zb, float* __restrict__ ll_part,
                      __nv_bfloat16* __restrict__ Rt, int N, int Dp, int C, int ldr,
                      int rows_per_split) {
  __shared__ __align__(16) __nv_bfloat16 Xs[kARows * kALd];    // [row][k]
  __shared__ __align__(16) __nv_bfloat16 Zs[kChains * kALd];   // [chain][k]
  __shared__ __align__(16) __nv_bfloat16 Rs[kChains * kALdR];  // [chain][row]
  __shared__ float ys[kARows];
  __shared__ float red[(kAThreads / 32) * kChains];
  using L = XPiece<XT>;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, t4 = lane & 3;
  const int c0 = blockIdx.x * kChains;
  const int split = blockIdx.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);
  const int nk = (Dp + kAK - 1) / kAK;
  const int ra = warp * 16 + grp;

  float ll_acc[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) ll_acc[j][0] = ll_acc[j][1] = 0.f;

  for (int r0 = row_begin; r0 < row_end; r0 += kARows) {
    if (tid < kARows) ys[tid] = (Epilogue::kUsesY && r0 + tid < row_end) ? y[r0 + tid] : 0.f;

    // Chunk kc: X rows [r0, r0 + 128) x columns [32 kc, 32 kc + 32), two
    // 8-column pieces per thread; Z chains [c0, c0 + 64), one piece.
    typename L::Raw xr[2];
    uint4 zr;
    auto fetch = [&](int kc) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = tid + i * kAThreads, r = p >> 2, col = kc * kAK + (p & 3) * 8;
        const int row = r0 + r;
        xr[i] = (row < row_end && col < Dp) ? L::load(X + (size_t)row * Dp + col) : L::zero();
      }
      const int col = kc * kAK + (tid & 3) * 8;
      zr = col < Dp ? *reinterpret_cast<const uint4*>(Zb + (size_t)(c0 + (tid >> 2)) * Dp + col)
                    : make_uint4(0u, 0u, 0u, 0u);
    };

    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    fetch(0);
    for (int kc = 0; kc < nk; ++kc) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = tid + i * kAThreads;
        *reinterpret_cast<uint4*>(Xs + (p >> 2) * kALd + (p & 3) * 8) = L::widen(xr[i]);
      }
      *reinterpret_cast<uint4*>(Zs + (tid >> 2) * kALd + (tid & 3) * 8) = zr;
      __syncthreads();
      if (kc + 1 < nk) fetch(kc + 1);  // in flight during the products
#pragma unroll
      for (int ks = 0; ks < kAK / 16; ++ks) {
        const int k0 = ks * 16 + 2 * t4;
        const uint32_t a0 = ld_pair(Xs + ra * kALd + k0);
        const uint32_t a1 = ld_pair(Xs + (ra + 8) * kALd + k0);
        const uint32_t a2 = ld_pair(Xs + ra * kALd + k0 + 8);
        const uint32_t a3 = ld_pair(Xs + (ra + 8) * kALd + k0 + 8);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat16* zb = Zs + (j * 8 + grp) * kALd + k0;
          mma_bf16(acc[j], a0, a1, a2, a3, ld_pair(zb), ld_pair(zb + 8));
        }
      }
      __syncthreads();
    }

    // Epilogue: ll in registers, bf16 residual to the shared tile.
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
          Rs[(j * 8 + 2 * t4 + e) * kALdR + r] = __float2bfloat16_rn(res);
        }
      }
    }
    __syncthreads();

    // Residual tile to Rt, 16 bytes a thread, rows contiguous per chain.
#pragma unroll
    for (int i = 0; i < (kChains * kARows / 8) / kAThreads; ++i) {
      const int p = tid + i * kAThreads, cl = p >> 4, q = p & 15;
      *reinterpret_cast<uint4*>(Rt + (size_t)(c0 + cl) * ldr + r0 + q * 8) =
          *reinterpret_cast<const uint4*>(Rs + cl * kALdR + q * 8);
    }
    __syncthreads();
  }

  // ll: sum the eight row groups of a warp, then the eight warps, in a fixed
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
    float v = red[tid];
#pragma unroll
    for (int w = 1; w < kAThreads / 32; ++w) v += red[w * kChains + tid];
    ll_part[(size_t)split * C + c0 + tid] = v;
  }
}

// Wide path, kernel B: g^T (chains x Dp) = R^T X over one row split, for 64
// chains and 64 columns of g. Warp w owns chains [16 w, 16 w + 16) and all
// 64 columns: A = Rt rows from shared memory, B = X chunk [row][d] through
// ldmatrix.trans.
template <class XT>
__global__ void __launch_bounds__(kThreads)
glm_wide_grad_kernel(const XT* __restrict__ X, const __nv_bfloat16* __restrict__ Rt,
                     float* __restrict__ g_part, int N, int Dp, int D, int C, int ldr,
                     int rows_per_split) {
  __shared__ __align__(16) __nv_bfloat16 Rs[kChains * kGLdR];  // [chain][row]
  __shared__ __align__(16) __nv_bfloat16 Xs[kGK * kGLdX];      // [row][d]
  using L = XPiece<XT>;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, t4 = lane & 3;
  const int c0 = blockIdx.x * kChains, d0 = blockIdx.y * kGD, split = blockIdx.z;
  const int row_begin = split * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);
  const int ma = warp * 16 + grp;

  // Chunk at row r0: X rows [r0, r0 + 32) x columns [d0, d0 + 64) and Rt
  // chains [c0, c0 + 64) x rows [r0, r0 + 32), two pieces of each per
  // thread. Rt holds zeros past N up to ldr, so its loads need no mask.
  typename L::Raw xr[2];
  uint4 rr[2];
  auto fetch = [&](int r0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = tid + i * kThreads;
      const int row = r0 + (p >> 3), col = d0 + (p & 7) * 8;
      xr[i] = (row < row_end && col < Dp) ? L::load(X + (size_t)row * Dp + col) : L::zero();
      rr[i] = *reinterpret_cast<const uint4*>(Rt + (size_t)(c0 + (p >> 2)) * ldr + r0 +
                                              (p & 3) * 8);
    }
  };

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (row_begin < row_end) fetch(row_begin);
  for (int r0 = row_begin; r0 < row_end; r0 += kGK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = tid + i * kThreads;
      *reinterpret_cast<uint4*>(Xs + (p >> 3) * kGLdX + (p & 7) * 8) = L::widen(xr[i]);
      *reinterpret_cast<uint4*>(Rs + (p >> 2) * kGLdR + (p & 3) * 8) = rr[i];
    }
    __syncthreads();
    if (r0 + kGK < row_end) fetch(r0 + kGK);  // in flight during the products
#pragma unroll
    for (int ks = 0; ks < kGK / 16; ++ks) {
      const int k0 = ks * 16 + 2 * t4;
      const uint32_t a0 = ld_pair(Rs + ma * kGLdR + k0);
      const uint32_t a1 = ld_pair(Rs + (ma + 8) * kGLdR + k0);
      const uint32_t a2 = ld_pair(Rs + ma * kGLdR + k0 + 8);
      const uint32_t a3 = ld_pair(Rs + (ma + 8) * kGLdR + k0 + 8);
      const int mi = lane >> 3;  // this lane's row address: matrix mi, row lane % 8
      const __nv_bfloat16* xb = Xs + (ks * 16 + (mi & 1) * 8 + (lane & 7)) * kGLdX + (mi >> 1) * 8;
#pragma unroll
      for (int jj = 0; jj < kGD / 16; ++jj) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, xb + jj * 16);
        mma_bf16(acc[2 * jj], a0, a1, a2, a3, b[0], b[1]);
        mma_bf16(acc[2 * jj + 1], a0, a1, a2, a3, b[2], b[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + ma + 8 * (q >> 1);
      const int d = d0 + j * 8 + 2 * t4 + (q & 1);
      if (c < C && d < D) g_part[((size_t)split * C + c) * D + d] = acc[j][q];
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

int round_up(int x, int m) { return (x + m - 1) / m * m; }

bool covers(int N, int splits, int rows_per_split, int tile) {
  return splits > 0 && rows_per_split > 0 && rows_per_split % tile == 0 &&
         (long long)splits * rows_per_split >= N &&
         (long long)(splits - 1) * rows_per_split < N;
}

template <class Epilogue, class XT>
int launch(const void* X, const void* y, const void* Z, void* ll_part, void* g_part,
           void* ll, void* g, void* zb, void* rt, int N, int Dp, int D, int C,
           int splits, int rows_per_split, int g_splits, int g_rows_per_split,
           void* stream) {
  if (Dp <= 0 || Dp % 16 != 0 || D <= 0 || D > Dp || N <= 0 || C <= 0 ||
      (Epilogue::kUsesY && y == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const XT* Xt = static_cast<const XT*>(X);
  const float* yf = static_cast<const float*>(y);
  cudaError_t err;
  if (Dp <= kMaxDp) {
    if (!covers(N, splits, rows_per_split, kRows) || g_splits != splits)
      return (int)cudaErrorInvalidValue;
    const size_t smem = shared_bytes(Dp);
    err = cudaFuncSetAttribute(glm_fused_kernel<Epilogue, XT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((C + kChains - 1) / kChains, splits);
    glm_fused_kernel<Epilogue, XT><<<grid, kThreads, smem, st>>>(
        Xt, yf, static_cast<const float*>(Z), static_cast<float*>(ll_part),
        static_cast<float*>(g_part), N, Dp, D, C, rows_per_split);
  } else {
    if (!covers(N, splits, rows_per_split, kARows) ||
        !covers(N, g_splits, g_rows_per_split, kGK) || zb == nullptr || rt == nullptr)
      return (int)cudaErrorInvalidValue;
    const int Cp = round_up(C, kChains), ldr = round_up(N, kARows);
    __nv_bfloat16* Zb = static_cast<__nv_bfloat16*>(zb);
    __nv_bfloat16* R = static_cast<__nv_bfloat16*>(rt);
    const size_t nz = (size_t)Cp * Dp;
    round_z_kernel<<<(unsigned)((nz + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(Z), Zb, C, D, Cp, Dp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    glm_wide_value_kernel<Epilogue, XT><<<dim3(Cp / kChains, splits), kAThreads, 0, st>>>(
        Xt, yf, Zb, static_cast<float*>(ll_part), R, N, Dp, C, ldr, rows_per_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    glm_wide_grad_kernel<XT><<<dim3(Cp / kChains, (Dp + kGD - 1) / kGD, g_splits), kThreads, 0,
                               st>>>(Xt, R, static_cast<float*>(g_part), N, Dp, D, C, ldr,
                                     g_rows_per_split);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_splits_kernel<<<(C + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(ll_part), static_cast<float*>(ll), C, splits);
  const int ng = C * D;
  sum_splits_kernel<<<(ng + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(g_part), static_cast<float*>(g), ng, g_splits);
  return (int)cudaGetLastError();
}

template <class Epilogue>
int dispatch(const void* X, int x_int8, const void* y, const void* Z, void* ll_part,
             void* g_part, void* ll, void* g, void* zb, void* rt, int N, int Dp, int D,
             int C, int splits, int rows_per_split, int g_splits, int g_rows_per_split,
             void* stream) {
  if (x_int8)
    return launch<Epilogue, int8_t>(X, y, Z, ll_part, g_part, ll, g, zb, rt, N, Dp, D, C,
                                    splits, rows_per_split, g_splits, g_rows_per_split,
                                    stream);
  return launch<Epilogue, __nv_bfloat16>(X, y, Z, ll_part, g_part, ll, g, zb, rt, N, Dp, D,
                                         C, splits, rows_per_split, g_splits,
                                         g_rows_per_split, stream);
}

}  // namespace

// One signature for the three entries. ll_part is (splits, C) and g_part
// (g_splits, C, D); the narrow path (Dp <= 128) takes g_splits == splits and
// ignores zb and rt. The wide path needs zb (round_up(C, 64), Dp) bf16 and
// rt (round_up(C, 64), round_up(N, 128)) bf16 as scratch. Returns a CUDA
// error code, 0 on success.
extern "C" int glm_fused_logistic(const void* X, int x_int8, const void* y, const void* Z,
                                  void* ll_part, void* g_part, void* ll, void* g, void* zb,
                                  void* rt, int N, int Dp, int D, int C, int splits,
                                  int rows_per_split, int g_splits, int g_rows_per_split,
                                  void* stream) {
  return dispatch<Logistic>(X, x_int8, y, Z, ll_part, g_part, ll, g, zb, rt, N, Dp, D, C,
                            splits, rows_per_split, g_splits, g_rows_per_split, stream);
}

extern "C" int glm_fused_linear(const void* X, int x_int8, const void* y, const void* Z,
                                void* ll_part, void* g_part, void* ll, void* g, void* zb,
                                void* rt, int N, int Dp, int D, int C, int splits,
                                int rows_per_split, int g_splits, int g_rows_per_split,
                                void* stream) {
  if (x_int8) return (int)cudaErrorInvalidValue;  // no scale folding for residuals
  return dispatch<Gaussian>(X, 0, y, Z, ll_part, g_part, ll, g, zb, rt, N, Dp, D, C, splits,
                            rows_per_split, g_splits, g_rows_per_split, stream);
}

extern "C" int glm_fused_hoisted(const void* X, int x_int8, const void* y, const void* Z,
                                 void* ll_part, void* g_part, void* ll, void* g, void* zb,
                                 void* rt, int N, int Dp, int D, int C, int splits,
                                 int rows_per_split, int g_splits, int g_rows_per_split,
                                 void* stream) {
  return dispatch<Hoisted>(X, x_int8, y, Z, ll_part, g_part, ll, g, zb, rt, N, Dp, D, C,
                           splits, rows_per_split, g_splits, g_rows_per_split, stream);
}
