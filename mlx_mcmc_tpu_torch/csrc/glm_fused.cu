// Fused GLM log-likelihood and gradient for a batch of chains, for Hopper
// (sm_90a). One kernel template per path, three likelihood epilogues that
// differ only in the per-element step, bf16, int8 or f32 X.
//
// Replaces three TPU kernels of mlx_mcmc_tpu/ops/pallas/glm.py:
// _fused_kernel (logistic, entry glm_fused_logistic), _fused_linear_kernel
// (Gaussian, entry glm_fused_linear) and _fused_hoisted_kernel (the
// rejected hoisted-outcome variant, entry glm_fused_hoisted). For X (N, Dp)
// bf16, int8 or f32, y (N,) f32 and Z (C, D) f32 (cast to bf16 unless X is
// f32), all compute
//
//   s      = X Z^T                        f32 accumulation
//   ll_c   = sum_i term(y_i, s_ic)
//   g      = X^T xdtype(res(y, s))        f32 accumulation
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
// TMA cannot convert types, so the int8 X boxes land as bytes in a raw ring
// beside the bf16 stages, and three warps of the producer warpgroup widen
// each into the 128-byte-swizzled bf16 layout that TMA writes for bf16 X
// (widen_box); the consumers are the same for both types. This is the
// counterpart of the reference's in-register dequantization of the int8
// tile (glm.py:87-91).
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
// epilogue is 2 N C = 8.2e7 transcendentals, 20 us at the special-function
// units' 16 per clock per SM (132 SMs, 1.98 GHz); the bytes are about
// 4.5 MB, 1.4 us at 3.35 TB/s. So the epilogue bounds it. bf16 and int8 X
// go through glm_onepass_kernel: FlashAttention-3's pattern with X as both K
// and V. A TMA producer keeps a ring of X stages in flight, bf16 Z is
// resident in shared memory, two consumer warpgroups (64 chains each)
// compute S^T = Zb X^T with wgmma, run the epilogue on the accumulators,
// round the residual to bf16 into the A fragments of R^T in registers, and
// add G^T += R^T X with wgmma from those registers and the same X stage
// (read MN-major through the transpose bit). G^T (64 chains x 128 columns)
// stays in registers across all the block's rows: hence Dp <= 128. The
// epilogue runs on the special-function unit (ex2, lg2, rcp .approx; the
// Mufu structs below), within ~1e-7 nats of the accurate tanhf/logf form
// per element. int8 X goes through the same kernel with the widening stage.
//
// Wide (Dp > 128, any multiple of 16), bf16 or int8 X: two Hopper kernels. At
// glm1000's shape (N = 100,000, D = 1000, C = 256) the two products are
// 1.02e11 flop, 0.1035 ms at 989 TFLOP/s, against 0.060 ms to read bf16 X
// once: the function is bound by operations. A one-pass design would keep
// g (Dp x chains) resident: 1008 x 64 chains of f32 is 258 KB, more than a
// block's 256 KB of registers or 227 KB of shared memory. So the work stays
// in two kernels, and X is read twice while the bf16 residual R^T (C_pad x
// N_pad, 51 MB at glm1000) is written once and read once: ~0.51 GB, a
// design floor of ~0.151 ms at 3.35 TB/s. Both kernels are warp-specialised:
// one producer thread keeps a ring of TMA loads (128-byte swizzle, mbarrier
// completion) in flight; two consumer warpgroups run wgmma on the stages
// that have arrived, with registers moved to them by setmaxnreg.
//   A) glm_hopper_value_kernel: S^T = Zb X^T, M = chains, N = rows, K = Dp.
//      A block owns 256 chains (each warpgroup 128 of them as two m64
//      slices, so X is read once per call up to C = 256) and a range of 128-row
//      tiles; its producer streams X (128 x 64) and Zb (256 x 64) stages
//      through a 4-deep ring across tile boundaries, so the next tile's
//      first loads overlap an epilogue. With chains as M, a thread's
//      accumulators hold 4 chains over 32 rows: the epilogue masks rows past
//      N, sums ll in registers across all its tiles (two shuffles at the
//      very end, a fixed order), and rounds the residual to bf16 in row
//      pairs into a swizzled shared tile that TMA stores to R^T [chain][row].
//   B) glm_hopper_grad_kernel: G^T = R^T X, M = chains (256 per block, two
//      m64 slices per warpgroup), N = 128 columns of g, K = rows in 64-row
//      stages. X is the MN-major B operand through the transpose bit of the
//      wgmma descriptor, so it needs no transposed copy and is read once
//      per call up to C = 256. The rows are cut into a fixed number of
//      splits to fill the SMs.
// On every path the row splits depend on N, Dp and the SM count only (the
// wrapper's launch_plan), never on C: a chain's ll and g are the same bits
// whatever the number of chains in the call.
// int8 X takes the same two kernels with the widening stage (the value
// kernel then keeps three ring stages instead of four, for shared memory).
//
// f32 X (any Dp): two simple kernels in exact f32 on the CUDA cores, no
// tensor cores (TF32 is off on every value path, and a bf16 split would not
// give f32 accuracy): glm_f32_value_kernel (s through shared-memory tiles
// and 4x4 FFMA micro-tiles per thread, the epilogue, ll partials and the f32
// residual R^T) and glm_f32_grad_kernel (g^T = R^T X the same way). Bound at
// glm100's shape: 4 N D C flop / 67 TFLOP/s = 0.24 ms.
//
// Every path reduces per-split partial sums with a small kernel in a fixed
// order: no float atomics, so results are reproducible run to run.

#include <cuda.h>  // CUtensorMap; the encoder comes from the driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kMaxDp = 128;  // one-pass kernel: G^T (64 chains x Dp) stays in registers

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

// The one-pass bf16 kernel's form of the logistic and hoisted epilogues:
// softplus(s) = max(s, 0) + log1p(exp(-|s|)) and the sigmoid from the same
// exp(-|s|), on the special-function unit (ex2, lg2 and rcp .approx, about
// 22 bits each): three MUFU operations and ~10 f32 operations per element
// where tanhf and logf take ~40. Per element the ll term moves by ~1e-7
// absolute against the accurate form (1 + e rounds to half an ulp of 1; lg2
// is good to ~2^-22 there), far below the f32 noise of a 10K-row sum.
__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float lg2_approx(float x) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// softplus(s) and sigmoid(s).
__device__ __forceinline__ void softplus_sigmoid_mufu(float s, float& sp, float& sig) {
  const float e = ex2_approx(-1.4426950408889634f * fabsf(s));  // exp(-|s|)
  const float one_e = 1.f + e;
  const float r = rcp_approx(one_e);
  sp = fmaxf(s, 0.f) + 0.6931471805599453f * lg2_approx(one_e);
  sig = s >= 0.f ? r : e * r;
}

template <class Epilogue>
struct Mufu;  // the MUFU form of an epilogue (the Gaussian one has no transcendentals)

template <>
struct Mufu<Logistic> {
  static constexpr bool kUsesY = true;
  __device__ __forceinline__ static void apply(float y, float s, float& term, float& res) {
    float sp, sig;
    softplus_sigmoid_mufu(s, sp, sig);
    res = y - sig;
    term = y * s - sp;
  }
};

template <>
struct Mufu<Gaussian> : Gaussian {};

template <>
struct Mufu<Hoisted> {
  static constexpr bool kUsesY = false;
  __device__ __forceinline__ static void apply(float, float s, float& term, float& res) {
    softplus_sigmoid_mufu(s, term, res);
  }
};

// Zb (Cp x Dp) = bf16(Z), zero past C and D: the wide path's Z operand,
// rounded once per call instead of once per block.
__global__ void round_z_kernel(const float* __restrict__ Z, __nv_bfloat16* __restrict__ Zb,
                               int C, int D, int Cp, int Dp) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)Cp * Dp) return;
  const int c = static_cast<int>(i / Dp), d = static_cast<int>(i - (size_t)c * Dp);
  Zb[i] = __float2bfloat16_rn((c < C && d < D) ? Z[(size_t)c * D + d] : 0.f);
}

// ---- f32 X: exact f32 on the CUDA cores ------------------------------------

constexpr int kFT = 64;         // rows (value) or columns of g (gradient), and chains, per block tile
constexpr int kFK = 16;         // depth of one staged chunk
constexpr int kFLd = kFT + 4;   // row stride of the staged chunks: float4-aligned, at most
                                // 2-way bank conflicts on the transposing stores
constexpr int kFThreads = 256;  // 16 x 16 threads, a 4 x 4 micro-tile each

// f32 value kernel: s = X Z^T for 64 chains and one row range walked in
// 64-row tiles, the epilogue, per-split ll partials and the f32 residual
// Rt[chain][row] (row stride ldr, a multiple of 64). Thread (tr, tc) owns
// rows 4 tr + i and chains 4 tc + j of a tile.
template <class Epilogue>
__global__ void __launch_bounds__(kFThreads)
glm_f32_value_kernel(const float* __restrict__ X, const float* __restrict__ y,
                     const float* __restrict__ Z, float* __restrict__ ll_part,
                     float* __restrict__ Rt, int N, int Dp, int D, int C, int ldr,
                     int rows_per_split) {
  __shared__ __align__(16) float Xs[kFK * kFLd];  // [k][row]
  __shared__ __align__(16) float Zs[kFK * kFLd];  // [k][chain]
  __shared__ float red[16 * kFT];                 // [tr][chain]
  const int tid = threadIdx.x, tr = tid & 15, tc = tid >> 4;
  const int c0 = blockIdx.x * kFT, split = blockIdx.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);

  float ll_acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r0 = row_begin; r0 < row_end; r0 += kFT) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int k0 = 0; k0 < Dp; k0 += kFK) {
      // 64 rows of X and 64 chains of Z, 16 deep; consecutive threads read
      // consecutive k of one row.
#pragma unroll
      for (int p = tid; p < kFT * kFK; p += kFThreads) {
        const int r = p / kFK, k = p % kFK, row = r0 + r, c = c0 + r;
        Xs[k * kFLd + r] = row < row_end ? X[(size_t)row * Dp + k0 + k] : 0.f;
        Zs[k * kFLd + r] = (c < C && k0 + k < D) ? Z[(size_t)c * D + k0 + k] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kFK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(Xs + k * kFLd + 4 * tr);
        const float4 b = *reinterpret_cast<const float4*>(Zs + k * kFLd + 4 * tc);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // Epilogue: ll in registers, the residual to Rt, four rows per 16-byte
    // store.
    float yv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 4 * tr + i;
      yv[i] = (Epilogue::kUsesY && row < row_end) ? y[row] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float r4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float term, res;
        Epilogue::apply(yv[i], acc[i][j], term, res);
        if (r0 + 4 * tr + i >= row_end) term = res = 0.f;
        ll_acc[j] += term;
        r4[i] = res;
      }
      *reinterpret_cast<float4*>(Rt + (size_t)(c0 + 4 * tc + j) * ldr + r0 + 4 * tr) =
          make_float4(r4[0], r4[1], r4[2], r4[3]);
    }
  }

  // ll: the 16 row groups of the block, in a fixed order.
#pragma unroll
  for (int j = 0; j < 4; ++j) red[tr * kFT + 4 * tc + j] = ll_acc[j];
  __syncthreads();
  if (tid < kFT && c0 + tid < C) {
    float v = red[tid];
    for (int t = 1; t < 16; ++t) v += red[t * kFT + tid];
    ll_part[(size_t)split * C + c0 + tid] = v;
  }
}

// f32 gradient kernel: g^T = R^T X for 64 chains and 64 columns of g over one
// row split, in 16-row chunks. Thread (td, tc) owns chains 4 tc + i and
// columns 4 td + j.
__global__ void __launch_bounds__(kFThreads)
glm_f32_grad_kernel(const float* __restrict__ X, const float* __restrict__ Rt,
                    float* __restrict__ g_part, int N, int Dp, int D, int C, int ldr,
                    int rows_per_split) {
  __shared__ __align__(16) float Rs[kFK * kFLd];  // [row][chain]
  __shared__ __align__(16) float Xs[kFK * kFLd];  // [row][d]
  const int tid = threadIdx.x, td = tid & 15, tc = tid >> 4;
  const int c0 = blockIdx.x * kFT, d0 = blockIdx.y * kFT, split = blockIdx.z;
  const int row_begin = split * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int r0 = row_begin; r0 < row_end; r0 += kFK) {
#pragma unroll
    for (int p = tid; p < kFT * kFK; p += kFThreads) {
      // R^T: consecutive threads read consecutive rows of one chain; X:
      // consecutive columns of one row.
      const int cl = p / kFK, kr = p % kFK, kx = p / kFT, dl = p % kFT;
      Rs[kr * kFLd + cl] = r0 + kr < row_end ? Rt[(size_t)(c0 + cl) * ldr + r0 + kr] : 0.f;
      Xs[kx * kFLd + dl] =
          (r0 + kx < row_end && d0 + dl < Dp) ? X[(size_t)(r0 + kx) * Dp + d0 + dl] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(Rs + k * kFLd + 4 * tc);
      const float4 b = *reinterpret_cast<const float4*>(Xs + k * kFLd + 4 * td);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 4 * tc + i, d = d0 + 4 * td + j;
      if (c < C && d < D) g_part[((size_t)split * C + c) * D + d] = acc[i][j];
    }
  }
}

// ---- Hopper wide path for bf16 and int8 X: TMA rings and wgmma -------------

constexpr int kHRows = 128;     // value kernel: rows per tile, the wgmma N
constexpr int kHChains = 256;   // chains per block: the wgmma M of both kernels, two m64
                                // slices per consumer warpgroup
constexpr int kHK = 64;         // depth of a ring stage: 64 bf16, one 128-byte swizzle line
constexpr int kHCols = 128;     // gradient kernel: columns of g per block
constexpr int kHThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2

// One box of 128 chains x 64 bf16 (a Zb half of a value stage, an R^T half of
// a gradient stage, a warpgroup's residual staging tile): 16 KB.
constexpr uint32_t kHalfBoxBytes = (kHChains / 2) * kHK * 2;

// int8 X: TMA cannot convert types, so each X box arrives as bytes (no
// swizzle, one line of 64 or 128 bytes a row) in a raw ring with one slot a
// stage, and warps 1-3 of the producer warpgroup widen it into the stage's
// bf16 boxes (widen_box). A raw slot is refilled only once its stage has
// been consumed, and so widened.
constexpr uint32_t kRawBytes = 8192;  // one raw X box: 128 rows x 64 or 64 rows x 128 bytes
constexpr int kWidenWarps = 3;
constexpr uint32_t kMaxSmem = 232448;  // a block's shared memory on the H100

constexpr uint32_t kVXBytes = kHRows * kHK * 2;                  // X stage, 16 KB
constexpr uint32_t kVStageBytes = kVXBytes + 2 * kHalfBoxBytes;  // + Zb stage, 48 KB in all

// The value kernel's ring: four stages for bf16 X, three for int8 X (its
// raw ring does not fit beside four); then the residual staging tiles, the
// raw ring, and the full, empty and raw barriers.
__host__ __device__ constexpr int v_stages(bool int8) { return int8 ? 3 : 4; }
__host__ __device__ constexpr uint32_t v_raw_off(bool int8) {
  return v_stages(int8) * kVStageBytes + 2 * kHalfBoxBytes;
}
__host__ __device__ constexpr uint32_t v_bar_off(bool int8) {
  return v_raw_off(int8) + (int8 ? v_stages(int8) * kRawBytes : 0);
}
__host__ __device__ constexpr uint32_t v_smem(bool int8) {  // + 1024-byte alignment slack
  return v_bar_off(int8) + 3 * v_stages(int8) * 8 + 1024;
}
static_assert(v_smem(false) <= kMaxSmem && v_smem(true) <= kMaxSmem, "value kernel smem");

constexpr int kGStages = 4;
constexpr uint32_t kGRBytes = kHChains * kHK * 2;  // R^T stage: 256 chains x 64 rows, 32 KB
constexpr uint32_t kGXBytes = kHK * kHCols * 2;    // X stage: 64 rows x two 64-column boxes
constexpr uint32_t kGStageBytes = kGRBytes + kGXBytes;
constexpr uint32_t kGRawOff = kGStages * kGStageBytes;
__host__ __device__ constexpr uint32_t g_bar_off(bool int8) {
  return kGRawOff + (int8 ? kGStages * kRawBytes : 0);
}
__host__ __device__ constexpr uint32_t g_smem(bool int8) {
  return g_bar_off(int8) + 3 * kGStages * 8 + 1024;
}
static_assert(g_smem(false) <= kMaxSmem && g_smem(true) <= kMaxSmem, "gradient kernel smem");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of ``bar`` with the given parity has completed. A
// ring that never fills (a fault in the schedule) traps after ~2^36 cycles
// (tens of seconds) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 36)) {
      __trap();
    }
  }
}

// One 2-D box of ``map`` at (c0 inner, c1 outer) into shared memory; its
// bytes complete a transaction on ``bar``. Out-of-bounds elements are zero.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Shared-memory matrix descriptor of a wgmma operand in the 128-byte swizzle
// layout (the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B): start
// address, leading byte offset (between 64-element swizzle atoms along M or
// N, for an MN-major operand; unused for K-major), stride byte offset 1024
// (between groups of eight 128-byte lines), layout type 1 (128B swizzle).
// The start must lie in a 1024-byte aligned tile; stepping K by 16 bf16 adds
// 2 (32 bytes) for K-major and 128 (16 lines) for MN-major.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define WG_F8(d, i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_F32(d, i) WG_F8(d, i), WG_F8(d, i + 8), WG_F8(d, i + 16), WG_F8(d, i + 24)

// D (64 x 128, f32) += A (64 x 16) B, bf16 in shared memory. A is K-major;
// B is 128 x 16 K-major (kTransB = 0) or 16 x 128 MN-major (kTransB = 1, the
// transpose bit). acc[4 j + q] of thread (warp w, lane l) of the warpgroup
// is row 16 w + l / 4 + 8 (q / 2), column 8 j + 2 (l % 4) + q % 2.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : WG_F32(d, 0), WG_F32(d, 32)
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// Bytes k and k + 1 of the int8 word w as a bf16 pair, exact for -128..127
// (``sel`` is 0x4140 for bytes 0-1, 0x4342 for bytes 2-3). A byte permute
// puts each byte b under the bf16 exponent of 128 (0x43): masking b's sign
// bit out leaves 128 + (b & 127), and the sign bit alone selects -128 or
// -256; one bf16x2 fused multiply-add adds the two, which is b exactly.
__device__ __forceinline__ uint32_t s8_pair_to_bf16(uint32_t w, uint32_t sel) {
  const uint32_t p = __byte_perm(w, 0x43u, sel);
  const uint32_t x = p & 0x437F437Fu;                    // 128 + (b & 127)
  const uint32_t neg = (p & 0x00800080u) | 0xC300C300u;  // -128 or -256
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(0x3F803F80u), "r"(neg));
  return r;
}

// Widens one raw int8 box (kLines lines of kLineBytes bytes) into bf16 boxes
// of 64 columns in the layout that TMA's 128-byte swizzle writes and the
// wgmma descriptors read: line r at 128 r, its 16-byte chunk c at
// 16 (c ^ r % 8); the second box (columns 64-127) starts box_stride bytes
// after the first. Each step takes 16 values (one 16-byte load) to two
// chunks. ``wt`` is the thread's index among the 32 x kWidenWarps widening
// threads. Then fences its stores for the async proxy (wgmma reads them
// there) and, lane 0 of each warp, arrives on ``full``.
template <int kLines, int kLineBytes>
__device__ __forceinline__ void widen_box(const unsigned char* raw, unsigned char* dst,
                                          uint32_t box_stride, int wt, uint64_t* full) {
  constexpr int kSteps = kLineBytes / 16;
#pragma unroll 2
  for (int p = wt; p < kLines * kSteps; p += 32 * kWidenWarps) {
    const int r = p / kSteps, cc = 2 * (p % kSteps);  // chunks cc and cc + 1 of line r
    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * kLineBytes + 8 * cc);
    unsigned char* line = dst + (cc >> 3) * box_stride + r * 128;
    *reinterpret_cast<uint4*>(line + (((cc & 7) ^ (r & 7)) << 4)) =
        make_uint4(s8_pair_to_bf16(v.x, 0x4140), s8_pair_to_bf16(v.x, 0x4342),
                   s8_pair_to_bf16(v.y, 0x4140), s8_pair_to_bf16(v.y, 0x4342));
    *reinterpret_cast<uint4*>(line + ((((cc + 1) & 7) ^ (r & 7)) << 4)) =
        make_uint4(s8_pair_to_bf16(v.z, 0x4140), s8_pair_to_bf16(v.z, 0x4342),
                   s8_pair_to_bf16(v.w, 0x4140), s8_pair_to_bf16(v.w, 0x4342));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(full);
}

// Value kernel of the wide bf16 path: S^T = Zb X^T with M = chains and N =
// rows, so that each thread's accumulators hold a few chains over many rows
// (ll sums stay in registers, residual row pairs pack into 32-bit stores).
// Grid (row splits, chain tiles of 256); warpgroup w owns chains [128 w,
// 128 w + 128) of the tile as two m64 slices, both over the same 128-row X
// stage. Maps: X (N x Dp, box 64 x 128 rows), Zb (Cp x Dp, box 64 x 128
// chains), Rt (Cp x ldr, box 64 rows x 128 chains; stored to). Writes
// ll_part[split][c] and, through TMA stores, Rt[chain][row] = bf16(res),
// zero past N. int8 X (kInt8): the X map is of bytes (box 64 x 128 rows, no
// swizzle), its boxes land in the raw ring and are widened into the stages.
template <class Epilogue, bool kInt8>
__global__ void __launch_bounds__(kHThreads, 1)
glm_hopper_value_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap z_map,
                        const __grid_constant__ CUtensorMap rs_map, const float* __restrict__ y,
                        float* __restrict__ ll_part, int N, int Dp, int C, int tiles_per_split) {
  constexpr int kVStages = v_stages(kInt8);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* raw = smem + v_raw_off(kInt8);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + v_bar_off(kInt8));
  uint64_t* empty = full + kVStages;
  uint64_t* rawf = empty + kVStages;
  const int split = blockIdx.x, ct = blockIdx.y;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, (N + kHRows - 1) / kHRows);
  const int nk = (Dp + kHK - 1) / kHK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&full[s], kInt8 ? 1 + kWidenWarps : 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
      mbar_init(&rawf[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: one thread streams the X and Zb stages of every tile, across
    // tile boundaries, so the next tile's first stages load during an
    // epilogue. int8 X: the X box goes to the stage's raw slot, and warps 1-3
    // widen it and arrive on the stage's full barrier beside Zb's bytes.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = tile_begin; t < tile_end; ++t) {
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * kVStageBytes;
          if constexpr (kInt8) {
            mbar_expect_tx(&rawf[stage], kRawBytes);
            tma_load_2d(raw + stage * kRawBytes, &x_map, &rawf[stage], kc * kHK, t * kHRows);
          }
          mbar_expect_tx(&full[stage], kInt8 ? 2 * kHalfBoxBytes : kVStageBytes);
          if constexpr (!kInt8) tma_load_2d(st, &x_map, &full[stage], kc * kHK, t * kHRows);
          tma_load_2d(st + kVXBytes, &z_map, &full[stage], kc * kHK, ct * kHChains);
          tma_load_2d(st + kVXBytes + kHalfBoxBytes, &z_map, &full[stage], kc * kHK,
                      ct * kHChains + 128);
          if (++stage == kVStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (kInt8 && threadIdx.x >= 2 * 128 + 32) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = tile_begin; t < tile_end; ++t) {
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(&rawf[stage], phase);
          widen_box<kHRows, kHK>(raw + stage * kRawBytes, smem + stage * kVStageBytes, 0,
                                 threadIdx.x - (2 * 128 + 32), &full[stage]);
          if (++stage == kVStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tw = threadIdx.x & 127, warp = tw >> 5, lane = tw & 31;
    unsigned char* stg = smem + kVStages * kVStageBytes + wg * kHalfBoxBytes;
    // This thread's chains: 16 warp + lane / 4 + 8 h in slice s (+ 64 s).
    const int cl = warp * 16 + (lane >> 2);
    float acc0[64], acc1[64];
    float ll[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [slice][h], over the thread's rows
    int stage = 0;
    uint32_t phase = 0;
    for (int t = tile_begin; t < tile_end; ++t) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
      for (int kc = 0; kc < nk; ++kc) {
        mbar_wait(&full[stage], phase);
        unsigned char* st = smem + stage * kVStageBytes;
        const uint64_t da0 = sw128_desc(st + kVXBytes + (wg * 128) * 128, 16);
        const uint64_t da1 = sw128_desc(st + kVXBytes + (wg * 128 + 64) * 128, 16);
        const uint64_t db = sw128_desc(st, 16);
        fence_acc(acc0);
        fence_acc(acc1);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kHK / 16; ++k) {
          wgmma_m64n128k16<0>(acc0, da0 + 2 * k, db + 2 * k);
          wgmma_m64n128k16<0>(acc1, da1 + 2 * k, db + 2 * k);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(acc0);
        fence_acc(acc1);
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == kVStages) {
          stage = 0;
          phase ^= 1;
        }
      }

      // Epilogue on the accumulators, one 64-row half at a time: rows past N
      // masked, ll summed in registers, the residual rounded to bf16 in row
      // pairs into the swizzled staging tile of the Rt store box (line =
      // chain, 16-byte chunk = (row % 64) / 8 ^ chain % 8), then a TMA store.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (tw == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        named_barrier(2 + wg, 128);  // the staging tile is free
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * half + jj;
          const int row = t * kHRows + 8 * j + 2 * (lane & 3);
          const bool va = row < N, vb = row + 1 < N;
          const float ya = (Epilogue::kUsesY && va) ? __ldg(y + row) : 0.f;
          const float yb = (Epilogue::kUsesY && vb) ? __ldg(y + row + 1) : 0.f;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float sa = s ? acc1[4 * j + 2 * h] : acc0[4 * j + 2 * h];
              const float sb = s ? acc1[4 * j + 2 * h + 1] : acc0[4 * j + 2 * h + 1];
              float ta, ra, tb, rb;
              Epilogue::apply(ya, sa, ta, ra);
              Epilogue::apply(yb, sb, tb, rb);
              if (!va) ta = ra = 0.f;
              if (!vb) tb = rb = 0.f;
              ll[s][h] += ta;
              ll[s][h] += tb;
              const int chain = 64 * s + cl + 8 * h;  // within the warpgroup's 128
              __nv_bfloat162 pair = __floats2bfloat162_rn(ra, rb);
              *reinterpret_cast<__nv_bfloat162*>(stg + chain * 128 + ((jj ^ (chain & 7)) << 4) +
                                                 4 * (lane & 3)) = pair;
            }
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_barrier(2 + wg, 128);
        if (tw == 0)
          tma_store_2d(&rs_map, stg, t * kHRows + 64 * half, ct * kHChains + wg * 128);
      }
    }

    // ll: the four lanes that share a chain, then one partial per split.
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = ll[s][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const int c = ct * kHChains + wg * 128 + 64 * s + cl + 8 * h;
        if ((lane & 3) == 0 && c < C) ll_part[(size_t)split * C + c] = v;
      }
    }
    if (tw == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// Gradient kernel of the wide bf16 path: g^T = R^T X over one split of
// 64-row chunks. Grid (column tiles of 128, row splits, chain tiles of 256);
// maps: Rt (box 64 rows x 128 chains), X (box 64 columns x 64 rows; int8
// X: bytes, box 128 columns x 64 rows, widened as in the value kernel).
// Warpgroup w owns chains [128 w, 128 w + 128) of the tile as two m64 slices.
template <bool kInt8>
__global__ void __launch_bounds__(kHThreads, 1)
glm_hopper_grad_kernel(const __grid_constant__ CUtensorMap r_map,
                       const __grid_constant__ CUtensorMap xg_map, float* __restrict__ g_part,
                       int N, int D, int C, int chunks_per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* raw = smem + kGRawOff;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g_bar_off(kInt8));
  uint64_t* empty = full + kGStages;
  uint64_t* rawf = empty + kGStages;
  const int dt = blockIdx.x, split = blockIdx.y, ct = blockIdx.z;
  const int chunk_begin = split * chunks_per_split;
  const int chunk_end = min(chunk_begin + chunks_per_split, (N + kHK - 1) / kHK);
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGStages; ++s) {
      mbar_init(&full[s], kInt8 ? 1 + kWidenWarps : 1);
      mbar_init(&empty[s], 8);
      mbar_init(&rawf[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int ch = chunk_begin; ch < chunk_end; ++ch) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + stage * kGStageBytes;
        if constexpr (kInt8) {
          mbar_expect_tx(&rawf[stage], kRawBytes);
          tma_load_2d(raw + stage * kRawBytes, &xg_map, &rawf[stage], dt * kHCols, ch * kHK);
        }
        mbar_expect_tx(&full[stage], kInt8 ? kGRBytes : kGStageBytes);
        tma_load_2d(st, &r_map, &full[stage], ch * kHK, ct * kHChains);
        tma_load_2d(st + kHalfBoxBytes, &r_map, &full[stage], ch * kHK, ct * kHChains + 128);
        if constexpr (!kInt8) {
          tma_load_2d(st + kGRBytes, &xg_map, &full[stage], dt * kHCols, ch * kHK);
          tma_load_2d(st + kGRBytes + kGXBytes / 2, &xg_map, &full[stage], dt * kHCols + 64,
                      ch * kHK);
        }
        if (++stage == kGStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else if (kInt8 && threadIdx.x >= 2 * 128 + 32) {
      int stage = 0;
      uint32_t phase = 0;
      for (int ch = chunk_begin; ch < chunk_end; ++ch) {
        mbar_wait(&rawf[stage], phase);
        widen_box<kHK, kHCols>(raw + stage * kRawBytes, smem + stage * kGStageBytes + kGRBytes,
                               kGXBytes / 2, threadIdx.x - (2 * 128 + 32), &full[stage]);
        if (++stage == kGStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tw = threadIdx.x & 127, warp = tw >> 5, lane = tw & 31;
    float acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    for (int ch = chunk_begin; ch < chunk_end; ++ch) {
      mbar_wait(&full[stage], phase);
      unsigned char* st = smem + stage * kGStageBytes;
      const uint64_t da0 = sw128_desc(st + (wg * 128) * 128, 16);
      const uint64_t da1 = sw128_desc(st + (wg * 128 + 64) * 128, 16);
      const uint64_t db = sw128_desc(st + kGRBytes, kGXBytes / 2);
      fence_acc(acc0);
      fence_acc(acc1);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kHK / 16; ++k) {
        wgmma_m64n128k16<1>(acc0, da0 + 2 * k, db + 128 * k);
        wgmma_m64n128k16<1>(acc1, da1 + 2 * k, db + 128 * k);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc0);
      fence_acc(acc1);
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kGStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    const int cb = ct * kHChains + wg * 128 + warp * 16 + (lane >> 2);
    const int db0 = dt * kHCols + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = cb + 8 * (q >> 1), d = db0 + 8 * j + (q & 1);
        if (d < D) {
          if (c < C) g_part[((size_t)split * C + c) * D + d] = acc0[4 * j + q];
          if (c + 64 < C) g_part[((size_t)split * C + c + 64) * D + d] = acc1[4 * j + q];
        }
      }
    }
  }
}

// ---- one-pass bf16 kernel for Dp <= 128 on Hopper ---------------------------

constexpr int kORows = 64;       // rows per X stage: the N of S^T = Zb X^T, the K of G^T += R^T X
constexpr int kOChains = 128;    // chains per block: one m64 slice per consumer warpgroup
constexpr int kOStages = 4;
constexpr uint32_t kOXBox = kORows * kHK * 2;           // one 64-column box of an X stage: 8 KB
constexpr uint32_t kOStageBytes = 2 * kOXBox;           // columns 0-63 and 64-127
constexpr uint32_t kOZBox = kOChains * kHK * 2;         // Zb box: 128 chains x 64 columns, 16 KB
constexpr uint32_t kOZOff = kOStages * kOStageBytes;
constexpr uint32_t kORawOff = kOZOff + 2 * kOZBox;  // int8 X: the raw ring, one slot a stage
__host__ __device__ constexpr uint32_t o_bar_off(bool int8) {
  return kORawOff + (int8 ? kOStages * kRawBytes : 0);
}
__host__ __device__ constexpr uint32_t o_smem(bool int8) {  // full, empty, raw, Zb barriers
  return o_bar_off(int8) + (3 * kOStages + 1) * 8 + 1024;
}
static_assert(o_smem(true) <= kMaxSmem, "one-pass kernel smem");

// D (64 x 64, f32) += A (64 x 16) B, A and B K-major bf16 in shared memory;
// the accumulator layout of wgmma_m64n128k16 with j < 8.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_F32(d, 0)
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16) B with A from registers (four bf16 pairs
// in the m16n8k16 A layout of each warp's 16 rows) and B 16 x 128 MN-major
// in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_F32(d, 0), WG_F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// One pass over bf16 X (Dp <= 128) for 128 chains and one row split, FA3's
// pattern with X in the roles of both K and V. Grid (row splits, chain tiles
// of 128). The producer thread loads the block's Zb (128 chains x Dp, once)
// and keeps a 4-deep ring of X stages (64 rows x 128 columns as two
// 128-byte-swizzled boxes; TMA zero-fills columns past Dp and rows past N)
// in flight. Consumer warpgroup w owns chains [64 w, 64 w + 64): per stage it
// computes S^T = Zb X^T (M = 64 chains, N = 64 rows, K = Dp) into 32
// registers, runs the epilogue there (rows past N masked, ll summed in
// registers), rounds the residual to bf16 straight into the A fragments of
// R^T (the accumulator layout of two n8 column groups is the A layout of one
// k16 slice), and adds G^T += R^T X (M = 64 chains, N = 128 columns, K = 64
// rows) with B the same X stage read MN-major. G^T stays in 64 registers a
// thread across all the block's stages. The two warpgroups work on
// different chains, so one's epilogue overlaps the other's products. Writes
// ll_part[split][c] and g_part[split][c][d]. int8 X (kInt8): the X map is
// of bytes (box 64 or 128 columns x 64 rows, no swizzle); each box lands in
// the stage's raw slot and warps 1-3 of the producer warpgroup widen it into
// the stage's two bf16 boxes, which the consumers read as for bf16 X.
// kGT = false leaves the G^T product out (g = 0) and kLLSum = false the ll
// sum (ll = 0): the microbenchmark variants of the body
// (csrc/glm_variants.cu); the production entries keep both.
template <class Epilogue, bool kInt8, bool kGT = true, bool kLLSum = true>
__global__ void __launch_bounds__(kHThreads, 1)
glm_onepass_kernel(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap z_map, const float* __restrict__ y,
                   float* __restrict__ ll_part, float* __restrict__ g_part, int N, int Dp, int D,
                   int C, int tiles_per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* raw = smem + kORawOff;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + o_bar_off(kInt8));
  uint64_t* empty = full + kOStages;
  uint64_t* rawf = empty + kOStages;
  uint64_t* zfull = rawf + kOStages;
  const int split = blockIdx.x, ct = blockIdx.y;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, (N + kORows - 1) / kORows);
  const int nbox = Dp > kHK ? 2 : 1;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kOStages; ++s) {
      mbar_init(&full[s], kInt8 ? kWidenWarps : 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
      mbar_init(&rawf[s], 1);
    }
    mbar_init(zfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(zfull, nbox * kOZBox);
      for (int b = 0; b < nbox; ++b)
        tma_load_2d(smem + kOZOff + b * kOZBox, &z_map, zfull, b * kHK, ct * kOChains);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = tile_begin; t < tile_end; ++t) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + stage * kOStageBytes;
        if constexpr (kInt8) {
          mbar_expect_tx(&rawf[stage], nbox * kORows * kHK);
          tma_load_2d(raw + stage * kRawBytes, &x_map, &rawf[stage], 0, t * kORows);
        } else {
          mbar_expect_tx(&full[stage], nbox * kOXBox);
          for (int b = 0; b < nbox; ++b)
            tma_load_2d(st + b * kOXBox, &x_map, &full[stage], b * kHK, t * kORows);
        }
        if (++stage == kOStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else if (kInt8 && threadIdx.x >= 2 * 128 + 32) {
      const int wt = threadIdx.x - (2 * 128 + 32);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = tile_begin; t < tile_end; ++t) {
        mbar_wait(&rawf[stage], phase);
        const unsigned char* r = raw + stage * kRawBytes;
        unsigned char* st = smem + stage * kOStageBytes;
        if (nbox == 2)
          widen_box<kORows, 2 * kHK>(r, st, kOXBox, wt, &full[stage]);
        else
          widen_box<kORows, kHK>(r, st, kOXBox, wt, &full[stage]);
        if (++stage == kOStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tw = threadIdx.x & 127, warp = tw >> 5, lane = tw & 31;
    const int cl = warp * 16 + (lane >> 2);  // this thread's chains: cl and cl + 8 of the slice
    const unsigned char* zs = smem + kOZOff + wg * 64 * 128;
    const int ksteps = Dp / 16;
    float g[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) g[i] = 0.f;
    float ll[2] = {0.f, 0.f};
    mbar_wait(zfull, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = tile_begin; t < tile_end; ++t) {
      // y of this thread's 16 rows: 8 j + 2 (lane % 4) + e.
      float yv[8][2];
      const int row0 = t * kORows + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = row0 + 8 * j + e;
          yv[j][e] = (Epilogue::kUsesY && row < N) ? __ldg(y + row) : 0.f;
        }
      mbar_wait(&full[stage], phase);
      const unsigned char* st = smem + stage * kOStageBytes;

      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      fence_acc(s);
      wgmma_fence();
      for (int k = 0; k < ksteps; ++k) {
        const int b = k >> 2, kk = k & 3;
        wgmma_m64n64k16(s, sw128_desc(zs + b * kOZBox, 16) + 2 * kk,
                        sw128_desc(st + b * kOXBox, 16) + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(s);

      // Epilogue: s[4 j + 2 h + e] is chain cl + 8 h, row 8 j + 2 (lane % 4) + e.
      uint32_t a[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = row0 + 8 * j;
        const bool va = row < N, vb = row + 1 < N;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float ta, ra, tb, rb;
          Epilogue::apply(yv[j][0], s[4 * j + 2 * h], ta, ra);
          Epilogue::apply(yv[j][1], s[4 * j + 2 * h + 1], tb, rb);
          if (!va) ta = ra = 0.f;
          if (!vb) tb = rb = 0.f;
          if constexpr (kLLSum) {
            ll[h] += ta;
            ll[h] += tb;
          }
          a[j >> 1][2 * (j & 1) + h] = bf16_pair(ra, rb);
        }
      }

      // G^T += R^T X: K = the stage's 64 rows in four k16 slices.
      if constexpr (kGT) {
        fence_acc(g);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16_rs(g, a[kk], sw128_desc(st, kOXBox) + 128 * kk);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(g);
      }
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kOStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // ll: the four lanes that share a chain, in a fixed order.
    const int cb = ct * kOChains + wg * 64 + cl;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = ll[h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((lane & 3) == 0 && cb + 8 * h < C) ll_part[(size_t)split * C + cb + 8 * h] = v;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = cb + 8 * (q >> 1), d = 8 * j + 2 * (lane & 3) + (q & 1);
        if (c < C && d < D) g_part[((size_t)split * C + c) * D + d] = g[4 * j + q];
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

int round_up(int x, int m) { return (x + m - 1) / m * m; }

bool covers(int N, int splits, int rows_per_split, int tile) {
  return splits > 0 && rows_per_split > 0 && rows_per_split % tile == 0 &&
         (long long)splits * rows_per_split >= N &&
         (long long)(splits - 1) * rows_per_split < N;
}

enum XDtype { kXBf16 = 0, kXInt8 = 1, kXF32 = 2 };

struct Args {
  const void* X;
  const float* y;
  const float* Z;
  float* ll_part;
  float* g_part;
  void* zb;
  void* rt;
  const void* maps;
  int N, Dp, D, C, splits, rows_per_split, g_splits, g_rows_per_split;
  cudaStream_t st;
};

// Dp <= 128, bf16 or int8 X: the TMA + wgmma one-pass kernel. Scratch: zb
// (round_up(C, 128), Dp) bf16, reached with X through the tensor maps of
// glm_onepass_tensor_maps (made for X's type). launch_onepass_as takes the
// epilogue E as given (and the kernel's kGT and kLLSum); launch_onepass
// takes the MUFU form of the epilogue unless kOnePassAccurate.
constexpr bool kOnePassAccurate = false;

template <class E, bool kInt8, bool kGT = true, bool kLLSum = true>
int launch_onepass_as(const Args& a) {
  if (!covers(a.N, a.splits, a.rows_per_split, kORows) || a.g_splits != a.splits ||
      a.zb == nullptr || a.maps == nullptr || a.Dp > kMaxDp)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[2];
  memcpy(m, a.maps, sizeof m);
  const int Cp = round_up(a.C, kOChains);
  const size_t nz = (size_t)Cp * a.Dp;
  round_z_kernel<<<(unsigned)((nz + 255) / 256), 256, 0, a.st>>>(
      a.Z, static_cast<__nv_bfloat16*>(a.zb), a.C, a.D, Cp, a.Dp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr uint32_t smem = o_smem(kInt8);
  err = cudaFuncSetAttribute(glm_onepass_kernel<E, kInt8, kGT, kLLSum>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  glm_onepass_kernel<E, kInt8, kGT, kLLSum>
      <<<dim3(a.splits, Cp / kOChains), kHThreads, smem, a.st>>>(
          m[0], m[1], a.y, a.ll_part, a.g_part, a.N, a.Dp, a.D, a.C, a.rows_per_split / kORows);
  return (int)cudaGetLastError();
}

template <class Epilogue, bool kInt8>
int launch_onepass(const Args& a) {
  using E = typename std::conditional<kOnePassAccurate, Epilogue, Mufu<Epilogue>>::type;
  return launch_onepass_as<E, kInt8>(a);
}

// Dp > 128, bf16 or int8 X: the two Hopper kernels. Scratch: zb
// (round_up(C, 256), Dp) bf16 and rt (round_up(C, 256), round_up(N, 128))
// bf16, both reached through the tensor maps (glm_hopper_tensor_maps, made
// for X's type).
template <class Epilogue, bool kInt8>
int launch_hopper(const Args& a) {
  if (!covers(a.N, a.splits, a.rows_per_split, kHRows) ||
      !covers(a.N, a.g_splits, a.g_rows_per_split, kHK) || a.zb == nullptr ||
      a.maps == nullptr)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[4];
  memcpy(m, a.maps, sizeof m);
  const int Cp = round_up(a.C, kHChains);
  const size_t nz = (size_t)Cp * a.Dp;
  round_z_kernel<<<(unsigned)((nz + 255) / 256), 256, 0, a.st>>>(
      a.Z, static_cast<__nv_bfloat16*>(a.zb), a.C, a.D, Cp, a.Dp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr uint32_t vsmem = v_smem(kInt8), gsmem = g_smem(kInt8);
  err = cudaFuncSetAttribute(glm_hopper_value_kernel<Epilogue, kInt8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)vsmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(glm_hopper_grad_kernel<kInt8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gsmem);
  if (err != cudaSuccess) return (int)err;
  glm_hopper_value_kernel<Epilogue, kInt8>
      <<<dim3(a.splits, Cp / kHChains), kHThreads, vsmem, a.st>>>(
          m[0], m[1], m[3], a.y, a.ll_part, a.N, a.Dp, a.C, a.rows_per_split / kHRows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  glm_hopper_grad_kernel<kInt8><<<dim3((a.Dp + kHCols - 1) / kHCols, a.g_splits, Cp / kHChains),
                                  kHThreads, gsmem, a.st>>>(m[3], m[2], a.g_part, a.N, a.D, a.C,
                                                            a.g_rows_per_split / kHK);
  return (int)cudaGetLastError();
}

// f32 X, any Dp: the two FFMA kernels. Scratch: rt (round_up(C, 64),
// round_up(N, 64)) f32.
template <class Epilogue>
int launch_f32(const Args& a) {
  if (!covers(a.N, a.splits, a.rows_per_split, kFT) ||
      !covers(a.N, a.g_splits, a.g_rows_per_split, kFK) || a.rt == nullptr)
    return (int)cudaErrorInvalidValue;
  const int chain_tiles = (a.C + kFT - 1) / kFT, ldr = round_up(a.N, kFT);
  const float* X = static_cast<const float*>(a.X);
  float* R = static_cast<float*>(a.rt);
  glm_f32_value_kernel<Epilogue><<<dim3(chain_tiles, a.splits), kFThreads, 0, a.st>>>(
      X, a.y, a.Z, a.ll_part, R, a.N, a.Dp, a.D, a.C, ldr, a.rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  glm_f32_grad_kernel<<<dim3(chain_tiles, (a.Dp + kFT - 1) / kFT, a.g_splits), kFThreads, 0,
                        a.st>>>(X, R, a.g_part, a.N, a.Dp, a.D, a.C, ldr, a.g_rows_per_split);
  return (int)cudaGetLastError();
}

template <class Epilogue>
int launch(int x_dtype, const Args& a, void* ll, void* g) {
  if (a.Dp <= 0 || a.Dp % 16 != 0 || a.D <= 0 || a.D > a.Dp || a.N <= 0 || a.C <= 0 ||
      (Epilogue::kUsesY && a.y == nullptr) || x_dtype < kXBf16 || x_dtype > kXF32)
    return (int)cudaErrorInvalidValue;
  int err;
  const bool int8 = x_dtype == kXInt8;
  if (x_dtype == kXF32)
    err = launch_f32<Epilogue>(a);
  else if (a.Dp <= kMaxDp)
    err = int8 ? launch_onepass<Epilogue, true>(a) : launch_onepass<Epilogue, false>(a);
  else
    err = int8 ? launch_hopper<Epilogue, true>(a) : launch_hopper<Epilogue, false>(a);
  if (err != 0) return err;
  sum_splits_kernel<<<(a.C + 255) / 256, 256, 0, a.st>>>(a.ll_part, static_cast<float*>(ll), a.C,
                                                          a.splits);
  const int ng = a.C * a.D;
  sum_splits_kernel<<<(ng + 255) / 256, 256, 0, a.st>>>(a.g_part, static_cast<float*>(g), ng,
                                                        a.g_splits);
  return (int)cudaGetLastError();
}

Args make_args(const void* X, const void* y, const void* Z, void* ll_part, void* g_part,
               void* zb, void* rt, const void* maps, int N, int Dp, int D, int C, int splits,
               int rows_per_split, int g_splits, int g_rows_per_split, void* stream) {
  return Args{X,      static_cast<const float*>(y), static_cast<const float*>(Z),
              static_cast<float*>(ll_part), static_cast<float*>(g_part), zb, rt, maps, N, Dp, D,
              C,      splits, rows_per_split, g_splits, g_rows_per_split,
              static_cast<cudaStream_t>(stream)};
}

// cuTensorMapEncodeTiled, taken from the driver that the process has loaded,
// so the library links against the runtime only.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A row-major matrix (outer x inner, row stride ``ld`` elements of
// ``elem`` bytes) read or written in boxes of box_inner x box_outer; out of
// bounds reads give zeros.
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base, int inner,
               int outer, int ld, int box_inner, int box_outer, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16 with the 128-byte swizzle: the layout the wgmma descriptors read.
bool encode_bf16_2d(CUtensorMap* map, const void* base, int inner, int outer, int ld,
                    int box_inner, int box_outer) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, inner, outer, ld, box_inner,
                   box_outer, CU_TENSOR_MAP_SWIZZLE_128B);
}

// int8 X as bytes, no swizzle: the raw boxes the producer widens.
bool encode_bytes_2d(CUtensorMap* map, const void* base, int inner, int outer, int box_inner,
                     int box_outer) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, inner, outer, inner, box_inner,
                   box_outer, CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace

// The four tensor maps of the wide path, written to ``out`` (4 x 128
// bytes): X (N x Dp) for the value kernel's B (bf16: 64 x 128-row boxes;
// int8: bytes in 64 x 128-row boxes), Zb (Cp x Dp) in 64 x 128-chain boxes
// (value kernel A, two per stage), X for the gradient kernel's B (bf16:
// 64 x 64-row boxes; int8: bytes in 128 x 64-row boxes) and Rt (Cp x ldr)
// in 64-row x 128-chain boxes (value kernel store; gradient kernel A, two
// per stage). x_dtype: 0 bf16, 1 int8. The caller keeps them with its
// scratch, so they are encoded once per (X, scratch) and not on every call.
// Returns a CUDA error code, 0 on success.
extern "C" int glm_hopper_tensor_maps(const void* X, int x_dtype, const void* zb, const void* rt,
                                      int N, int Dp, int Cp, int ldr, void* out) {
  CUtensorMap m[4];
  const bool int8 = x_dtype == kXInt8;
  const bool ok = (int8 || x_dtype == kXBf16) && Dp % 16 == 0 && Cp % kHChains == 0 &&
                  ldr % kHRows == 0 && ldr >= N &&
                  (int8 ? encode_bytes_2d(&m[0], X, Dp, N, kHK, kHRows)
                        : encode_bf16_2d(&m[0], X, Dp, N, Dp, kHK, kHRows)) &&
                  encode_bf16_2d(&m[1], zb, Dp, Cp, Dp, kHK, kHChains / 2) &&
                  (int8 ? encode_bytes_2d(&m[2], X, Dp, N, kHCols, kHK)
                        : encode_bf16_2d(&m[2], X, Dp, N, Dp, kHK, kHK)) &&
                  encode_bf16_2d(&m[3], rt, ldr, Cp, ldr, kHK, kHChains / 2);
  if (!ok) return (int)cudaErrorInvalidValue;
  memcpy(out, m, sizeof m);
  return 0;
}

// The two tensor maps of the one-pass kernel, written to ``out`` (2 x 128
// bytes): X (N x Dp; bf16: 64-column x 64-row boxes; int8: bytes in 64- or
// 128-column x 64-row boxes, as Dp <= 64 or not) and Zb (Cp x Dp) in
// 64-column x 128-chain boxes. x_dtype: 0 bf16, 1 int8. Returns a CUDA
// error code, 0 on success.
extern "C" int glm_onepass_tensor_maps(const void* X, int x_dtype, const void* zb, int N, int Dp,
                                       int Cp, void* out) {
  CUtensorMap m[2];
  const bool int8 = x_dtype == kXInt8;
  const bool ok = (int8 || x_dtype == kXBf16) && Dp % 16 == 0 && Dp <= kMaxDp &&
                  Cp % kOChains == 0 &&
                  (int8 ? encode_bytes_2d(&m[0], X, Dp, N, Dp > kHK ? 2 * kHK : kHK, kORows)
                        : encode_bf16_2d(&m[0], X, Dp, N, Dp, kHK, kORows)) &&
                  encode_bf16_2d(&m[1], zb, Dp, Cp, Dp, kHK, kOChains);
  if (!ok) return (int)cudaErrorInvalidValue;
  memcpy(out, m, sizeof m);
  return 0;
}

// One signature for the three entries. x_dtype: 0 bf16, 1 int8, 2 f32.
// ll_part is (splits, C) and g_part (g_splits, C, D); the narrow path
// (Dp <= 128) takes g_splits == splits, zb and the tensor maps of
// glm_onepass_tensor_maps, the wide path zb and the tensor maps of
// glm_hopper_tensor_maps (which name zb and rt), both made for X's type;
// the f32 path takes rt (shapes at each launch function). Returns a CUDA
// error code, 0 on success.
#define GLM_ENTRY(name, Epilogue, refuse_int8)                                                  \
  extern "C" int name(const void* X, int x_dtype, const void* y, const void* Z, void* ll_part,  \
                      void* g_part, void* ll, void* g, void* zb, void* rt, const void* maps,    \
                      int N, int Dp, int D, int C, int splits, int rows_per_split, int g_splits, \
                      int g_rows_per_split, void* stream) {                                     \
    if (refuse_int8 && x_dtype == kXInt8) return (int)cudaErrorInvalidValue;                    \
    return launch<Epilogue>(x_dtype,                                                            \
                            make_args(X, y, Z, ll_part, g_part, zb, rt, maps, N, Dp, D, C,      \
                                      splits, rows_per_split, g_splits, g_rows_per_split,       \
                                      stream),                                                  \
                            ll, g);                                                             \
  }

GLM_ENTRY(glm_fused_logistic, Logistic, false)
GLM_ENTRY(glm_fused_linear, Gaussian, true)  // no scale folding for residuals
GLM_ENTRY(glm_fused_hoisted, Hoisted, false)
