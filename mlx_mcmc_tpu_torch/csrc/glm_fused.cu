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
//   B) glm_hopper_grad_kernel: G^T = R^T X, M = chains, N = 128 columns of
//      g, K = rows in 64-row stages. X is the MN-major B operand through
//      the transpose bit of the wgmma descriptor, so it needs no transposed
//      copy. The rows are cut into a fixed number of splits, enough for one
//      chain tile's column tiles to fill the SMs, and a chain's g is its
//      split partials added in split order, ((p0 + p1) + p2) + ..., in f32.
//      Two schedules of those sums (the wrapper's launch_plan picks one by
//      C; g_part null selects the walk):
//      - one block a (column tile, split, 256 chains: two m64 slices a
//        consumer warpgroup) writes its partial to g_part, and
//        sum_splits_kernel adds them: g_splits x C x D x 4 bytes written and
//        read again, 168 MB at C = 4096, Dp = 1024, N = 1280 (10 splits),
//        0.27 of that call's 0.32 ms on the H100; right for few chains
//        (glm1000_fused's 256: 16 MB), where it spreads one chain tile's
//        rows over the SMs;
//      - the walk, for many chains: one block a (column tile, 128 chains:
//        one m64 slice a consumer warpgroup) runs every split in order, each
//        into a fresh accumulator then added to a running total in
//        registers (64 + 64 floats a thread, beside the 232 that setmaxnreg
//        gives; a second slice would need 256), and writes g once: no
//        partials, no sum_splits_kernel. A block holds the walk of all N
//        rows, so where the chain tiles leave SMs idle for a whole walk the
//        partials are cheaper (glm._walk_is_faster).
//      A chain's split partial comes from the same wgmma sequence over the
//      same chunks and the same row of an m64 slice in both, and both add
//      the partials in the same order, so they give the same bits: C picks
//      the schedule but never a chain's bits.
// On every path the row splits depend on N, Dp and the SM count only (the
// wrapper's launch_plan), never on C: a chain's ll and g are the same bits
// whatever the number of chains in the call.
// int8 X takes the same two kernels with the widening stage (the value
// kernel then keeps three ring stages instead of four, for shared memory).
//
// f32 X (any Dp), the reference's f32 input (x_ref "f32, bf16, or int8",
// glm.py:87): the same two products at float32-class accuracy, which TF32
// is not (TF32 stays off on every value path) and a bf16 split is not
// either. The CUDA cores' float32 rate bounds an FFMA design at 4 N D C /
// 67 TFLOP/s = 0.24 ms at glm100's shape; the tensor cores beat that only
// through a split, 3xTF32: x = x_hi + x_lo with x_hi = tf32(x) (rounded to
// nearest, low 13 bits zero) and x_lo = tf32(x - x_hi), and a b ~ a_hi b_hi
// + a_hi b_lo + a_lo b_hi, ~22 bits of each product, every product exact
// in the tensor core. Six TF32 passes: 12 N D C flop / 495 TFLOP/s = 0.10
// ms at glm100, 0.62 ms at glm1000. Two kernels with the wide path's
// structure (TMA producer, a 4-deep ring, two consumer warpgroups) on
// persistent grids, both D = A B^T with A split by the consumers into
// registers (register-A wgmma) and B split in shared memory by three warps
// of the producer warpgroup, as int8's widening stage does; every operand
// arrives raw, at its own 4 bytes (split copies would double the bytes, and
// at glm1000 they would outweigh the tensor work):
//   A) glm_tf32_value_kernel: S^T = Z X^T (M = 128 chains a block, N = 128
//      rows, K = Dp in 32-float stages; A = Z padded once per call by
//      pad_z_kernel, B = X), the MUFU epilogue, ll partials and the f32
//      residual R^T by TMA store.
//   B) glm_tf32_grad_kernel: G^T = R^T X (N = 128 columns of g, K = rows in
//      32-row stages; A = R^T). A tf32 wgmma takes B K-major only (no
//      transpose bit), so B is X^T, made once with the data (XpT).
// The tensor core truncates as it accumulates, so each ring stage's twelve
// product groups go into a fresh accumulator that is then added to a
// register total in round-to-nearest f32 (tf32x3_stage). The f32 residual
// R^T makes one round trip through device memory (165 MB at glm100).
//
// Every path reduces its per-split partial sums the same way (sum_outputs:
// ll by sum_splits_ll_kernel in double, g by sum_splits_kernel or, in the
// wide gradient's walk, by the kernel itself in the same order), in a fixed
// order: no float atomics, so results are reproducible run to run.

#include <cuda.h>  // CUtensorMap; the encoder comes from the driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

#include <mutex>
#include <set>
#include <type_traits>
#include <utility>

namespace {

// Raises a kernel's dynamic shared memory limit once per device and kernel
// (each template instantiation is a kernel of its own), so that launches
// make no attribute call: an eager launch skips the host work, and a launch
// captured into a CUDA graph relies on no call made during the capture.
// The first launch of each kernel is an eager one (graphs warm up first).
cudaError_t max_dynamic_smem_once(const void* kernel, int bytes) {
  static std::mutex mu;
  static std::set<std::pair<int, const void*>> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({dev, kernel})) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.insert({dev, kernel});
  return err;
}

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

// The gradient kernel's two schedules (kWalk): one block a split with 256
// chains (two m64 slices a consumer warpgroup), or one block walking every
// split with 128 chains (one m64 slice and its running total). The walk's
// stages are half as large, so its ring is deeper.
constexpr uint32_t kGXBytes = kHK * kHCols * 2;  // X stage: 64 rows x two 64-column boxes
__host__ __device__ constexpr int g_chains(bool walk) { return walk ? kHChains / 2 : kHChains; }
__host__ __device__ constexpr uint32_t g_r_bytes(bool walk) {  // R^T stage: chains x 64 rows
  return g_chains(walk) * kHK * 2;
}
__host__ __device__ constexpr uint32_t g_stage_bytes(bool walk) {
  return g_r_bytes(walk) + kGXBytes;
}
__host__ __device__ constexpr int g_stages(bool int8, bool walk) {
  return walk ? (int8 ? 5 : 6) : 4;
}
__host__ __device__ constexpr uint32_t g_raw_off(bool int8, bool walk) {
  return g_stages(int8, walk) * g_stage_bytes(walk);
}
__host__ __device__ constexpr uint32_t g_bar_off(bool int8, bool walk) {
  return g_raw_off(int8, walk) + (int8 ? g_stages(int8, walk) * kRawBytes : 0);
}
__host__ __device__ constexpr uint32_t g_smem(bool int8, bool walk) {
  return g_bar_off(int8, walk) + 3 * g_stages(int8, walk) * 8 + 1024;
}
static_assert(g_smem(false, false) <= kMaxSmem && g_smem(true, false) <= kMaxSmem &&
                  g_smem(false, true) <= kMaxSmem && g_smem(true, true) <= kMaxSmem,
              "gradient kernel smem");

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

// Gradient kernel of the wide bf16 path: g^T = R^T X in 64-row chunks, the
// chunks cut into ``splits`` row splits of chunks_per_split. Maps: Rt (box
// 64 rows x 128 chains), X (box 64 columns x 64 rows; int8 X: bytes, box 128
// columns x 64 rows, widened as in the value kernel). Two schedules of the
// same products and sums:
// - kWalk false: grid (column tiles of 128, row splits, chain tiles of 256);
//   warpgroup w owns chains [128 w, 128 w + 128) of the tile as two m64
//   slices, and the block writes its split's partial to out = g_part
//   [split][c][d], which sum_splits_kernel adds in split order.
// - kWalk true: grid (column tiles of 128, chain tiles of 128); warpgroup w
//   owns chains [64 w, 64 w + 64) as one m64 slice and walks every split in
//   order: each split's chunks go into a fresh accumulator, which is then
//   added to a running total in registers, and the block writes out = g.
// A chain's element of a split's accumulator comes from the same wgmma
// sequence on the same data in both (the same row of an m64 slice, since
// slices start at multiples of 64 chains), and its g is ((p0 + p1) + p2) +
// ... in float32 in both, so the two schedules give the same bits.
template <bool kInt8, bool kWalk>
__global__ void __launch_bounds__(kHThreads, 1)
glm_hopper_grad_kernel(const __grid_constant__ CUtensorMap r_map,
                       const __grid_constant__ CUtensorMap xg_map, float* __restrict__ out,
                       int N, int D, int C, int splits, int chunks_per_split) {
  constexpr int kStages = g_stages(kInt8, kWalk), kChains = g_chains(kWalk);
  constexpr uint32_t kRBytes = g_r_bytes(kWalk), kStageBytes = g_stage_bytes(kWalk);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* raw = smem + g_raw_off(kInt8, kWalk);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g_bar_off(kInt8, kWalk));
  uint64_t* empty = full + kStages;
  uint64_t* rawf = empty + kStages;
  const int dt = blockIdx.x, split = kWalk ? 0 : blockIdx.y, ct = kWalk ? blockIdx.y : blockIdx.z;
  const int n_chunks = (N + kHK - 1) / kHK;
  const int chunk_begin = split * chunks_per_split;
  const int chunk_end = kWalk ? n_chunks : min(chunk_begin + chunks_per_split, n_chunks);
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kInt8 ? 1 + kWidenWarps : 1);
      mbar_init(&empty[s], 8);
      mbar_init(&rawf[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: one thread streams the chunks' R^T and X stages (across
    // split boundaries in the walk); int8 X as in the value kernel.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int ch = chunk_begin; ch < chunk_end; ++ch) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + stage * kStageBytes;
        if constexpr (kInt8) {
          mbar_expect_tx(&rawf[stage], kRawBytes);
          tma_load_2d(raw + stage * kRawBytes, &xg_map, &rawf[stage], dt * kHCols, ch * kHK);
        }
        mbar_expect_tx(&full[stage], kInt8 ? kRBytes : kStageBytes);
#pragma unroll
        for (int b = 0; b < kChains / 128; ++b)
          tma_load_2d(st + b * kHalfBoxBytes, &r_map, &full[stage], ch * kHK,
                      ct * kChains + 128 * b);
        if constexpr (!kInt8) {
          tma_load_2d(st + kRBytes, &xg_map, &full[stage], dt * kHCols, ch * kHK);
          tma_load_2d(st + kRBytes + kGXBytes / 2, &xg_map, &full[stage], dt * kHCols + 64,
                      ch * kHK);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else if (kInt8 && threadIdx.x >= 2 * 128 + 32) {
      int stage = 0;
      uint32_t phase = 0;
      for (int ch = chunk_begin; ch < chunk_end; ++ch) {
        mbar_wait(&rawf[stage], phase);
        widen_box<kHK, kHCols>(raw + stage * kRawBytes, smem + stage * kStageBytes + kRBytes,
                               kGXBytes / 2, threadIdx.x - (2 * 128 + 32), &full[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else if constexpr (kWalk) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tw = threadIdx.x & 127, warp = tw >> 5, lane = tw & 31;
    // -0 + p0 is p0 bit for bit (a +0 start would turn a -0 partial to +0),
    // so the total is sum_splits_kernel's ((p0 + p1) + p2) + ...
    float acc[64], tot[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) tot[i] = -0.f;
    int stage = 0;
    uint32_t phase = 0;
    for (int sp = 0; sp < splits; ++sp) {
      const int ce = min((sp + 1) * chunks_per_split, n_chunks);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int ch = sp * chunks_per_split; ch < ce; ++ch) {
        mbar_wait(&full[stage], phase);
        unsigned char* st = smem + stage * kStageBytes;
        const uint64_t da = sw128_desc(st + (wg * 64) * 128, 16);
        const uint64_t db = sw128_desc(st + kRBytes, kGXBytes / 2);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kHK / 16; ++k) wgmma_m64n128k16<1>(acc, da + 2 * k, db + 128 * k);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(acc);
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] += acc[i];
    }

    const int cb = ct * kChains + wg * 64 + warp * 16 + (lane >> 2);
    const int db0 = dt * kHCols + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = cb + 8 * (q >> 1), d = db0 + 8 * j + (q & 1);
        if (c < C && d < D) out[(size_t)c * D + d] = tot[4 * j + q];
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
      unsigned char* st = smem + stage * kStageBytes;
      const uint64_t da0 = sw128_desc(st + (wg * 128) * 128, 16);
      const uint64_t da1 = sw128_desc(st + (wg * 128 + 64) * 128, 16);
      const uint64_t db = sw128_desc(st + kRBytes, kGXBytes / 2);
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
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    const int cb = ct * kChains + wg * 128 + warp * 16 + (lane >> 2);
    const int db0 = dt * kHCols + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = cb + 8 * (q >> 1), d = db0 + 8 * j + (q & 1);
        if (d < D) {
          if (c < C) out[((size_t)split * C + c) * D + d] = acc0[4 * j + q];
          if (c + 64 < C) out[((size_t)split * C + c + 64) * D + d] = acc1[4 * j + q];
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

// ---- f32 X on Hopper: the 3xTF32 pair on TMA rings ---------------------------

constexpr int kTRows = 128;    // value kernel: rows per tile, the wgmma N
constexpr int kTChains = 128;  // chains per block: one m64 slice per consumer warpgroup
constexpr int kTCols = 128;    // gradient kernel: columns of g per block, the wgmma N
constexpr int kTK = 32;        // depth of a ring stage: 32 floats, one 128-byte swizzle line
constexpr int kTStages = 4;
constexpr int kSplitWarps = 3;  // warps 1-3 of the producer warpgroup split the B boxes
constexpr uint32_t kTBox = 128 * kTK * 4;     // one operand box: 128 lines of 128 bytes, 16 KB
constexpr uint32_t kTStageBytes = 3 * kTBox;  // A raw, B hi (raw as loaded), B lo
constexpr uint32_t kTStgBytes = 64 * kTK * 4;  // one R^T store box: 64 chains x 32 rows, 8 KB
// The value kernel's ring, then two store boxes per consumer warpgroup, then
// the full, empty and raw barriers; the gradient kernel's ring, then its
// barriers.
constexpr uint32_t kTValueBarOff = kTStages * kTStageBytes + 2 * 2 * kTStgBytes;
constexpr uint32_t kTValueSmem = kTValueBarOff + 3 * kTStages * 8 + 1024;
constexpr uint32_t kTGradBarOff = kTStages * kTStageBytes;
constexpr uint32_t kTGradSmem = kTGradBarOff + 3 * kTStages * 8 + 1024;
static_assert(kTValueSmem <= kMaxSmem && kTGradSmem <= kMaxSmem, "3xTF32 kernels smem");

// x rounded to nearest with 11 significant bits (a tf32 value: its low 13
// bits are zero), by Veltkamp's split in round-to-nearest float32: c = x
// (2^13 + 1), hi = c - (c - x). Three float32 operations at the full FP32
// rate, where cvt.rna.tf32.f32 issues at the conversion rate (16 a clock
// per SM) and bounded the splitting warps (measured on the H100). The
// intrinsics keep the compiler from contracting them into an FMA. |x| <
// 4e34 (no overflow of c).
__device__ __forceinline__ float tf32_round(float x) {
  const float c = __fmul_rn(x, 8193.f);
  return __fsub_rn(c, __fsub_rn(c, x));
}

// x = hi + lo to ~2^-22 of x: hi = tf32_round(x), lo = tf32_round(x - hi)
// (x - hi is exact).
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_round(x);
  lo = tf32_round(__fsub_rn(x, hi));
}

// Splits a stage's raw B box (as TMA wrote it, 128-byte swizzled) into
// B_hi, in place, and B_lo in the next box, element by element, so both
// keep the swizzled layout the descriptors read; then fences the stores for
// the async proxy (wgmma reads them there) and, lane 0 of each warp, arrives
// on ``full``. ``wt`` is the thread's index among the 32 x kSplitWarps
// splitting threads.
__device__ __forceinline__ void split_b_box(unsigned char* hi, int wt, uint64_t* full) {
  unsigned char* lo = hi + kTBox;
#pragma unroll 2
  for (int p = wt; p < (int)(kTBox / 16); p += 32 * kSplitWarps) {
    float4 v = *reinterpret_cast<const float4*>(hi + 16 * p), l;
    split_tf32(v.x, v.x, l.x);
    split_tf32(v.y, v.y, l.y);
    split_tf32(v.z, v.z, l.z);
    split_tf32(v.w, v.w, l.w);
    *reinterpret_cast<float4*>(hi + 16 * p) = v;
    *reinterpret_cast<float4*>(lo + 16 * p) = l;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(full);
}

// D (64 x 128, f32) = (scale_d ? D : 0) + A (64 x 8) B with A from
// registers (tf32, the m16n8k8 A layout of each warp's 16 rows: a[0] row
// lane / 4, column lane % 4; a[1] row + 8; a[2] column + 4; a[3] both) and
// B (128 x 8) K-major tf32 in shared memory: a tf32 wgmma has no transpose
// bit. The accumulator layout of wgmma_m64n128k16.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WG_F32(d, 0), WG_F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// tot += A B^T over one ring stage (K = 32) for the warpgroup's 64 lines of
// A, in 3xTF32. A (the raw f32 box, 128-byte swizzled, as TMA wrote it) is
// loaded in the A fragment layout and split into hi and lo in registers
// (register-A wgmma; measured faster than splitting it in shared memory);
// B_hi and B_lo are the split warps'. acc = A_hi B_lo + A_lo B_hi + A_hi
// B_hi over the stage's four k8 slices into a fresh accumulator, the small
// products first, then tot += acc in round-to-nearest f32. The tensor core
// truncates as it accumulates, so a sum kept there across the whole depth
// would drift towards zero by ~1 ulp of itself per product group; here only
// the four large groups of one stage truncate, at the size of that stage's
// partial sum, whose sign hardly follows the total's.
__device__ __forceinline__ void tf32x3_stage(float (&acc)[64], float (&tot)[64],
                                             const unsigned char* st, int wg) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int line = wg * 64 + warp * 16 + (lane >> 2);  // and line + 8; line % 8 = lane / 4
  uint32_t ah[kTK / 8][4], al[kTK / 8][4];
#pragma unroll
  for (int k = 0; k < kTK / 8; ++k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int l = line + 8 * (q & 1), chunk = 2 * k + (q >> 1);
      const float x = *reinterpret_cast<const float*>(st + l * 128 + ((chunk ^ (l & 7)) << 4) +
                                                      4 * (lane & 3));
      float h, lo;
      split_tf32(x, h, lo);
      ah[k][q] = __float_as_uint(h);
      al[k][q] = __float_as_uint(lo);
    }
  }
  const uint64_t bh = sw128_desc(st + kTBox, 16);
  const uint64_t bl = sw128_desc(st + 2 * kTBox, 16);
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < kTK / 8; ++k) wgmma_m64n128k8_tf32(acc, ah[k], bl + 2 * k, k > 0);
#pragma unroll
  for (int k = 0; k < kTK / 8; ++k) wgmma_m64n128k8_tf32(acc, al[k], bh + 2 * k, 1);
#pragma unroll
  for (int k = 0; k < kTK / 8; ++k) wgmma_m64n128k8_tf32(acc, ah[k], bh + 2 * k, 1);
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(acc);
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] += acc[i];
}

// Zp (C x Dp) = Z padded with zeros past D: the value kernel's A operand,
// at a row stride TMA can take.
__global__ void pad_z_kernel(const float* __restrict__ Z, float* __restrict__ zp, int C, int D,
                             int Dp) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)C * Dp) return;
  const int c = static_cast<int>(i / Dp), d = static_cast<int>(i - (size_t)c * Dp);
  zp[i] = d < D ? Z[(size_t)c * D + d] : 0.f;
}

// Value kernel of the f32 path: S^T = Z X^T in 3xTF32 (M = chains, N =
// rows, K = Dp), the epilogue, per-split ll partials and the f32 residual
// R^T[chain][row]. A persistent grid walks the work items (row split, chain
// tile of 128) in the order item = split * chain_tiles + ct; a block's
// producer streams every stage of its items through one ring, so the next
// tile's loads overlap an epilogue. Consumer warpgroup w owns chains [64 w,
// 64 w + 64) of the tile; a thread's accumulators hold 2 chains over 32 rows
// (ll in registers, two shuffles per item). Maps (raw f32, box 32 columns x
// 128 lines): X (N x Dp; B, split in shared memory by warps 1-3 of the
// producer warpgroup), Zp (C x Dp; A, split by the consumers) and Rt (C x
// ldr, box 32 rows x 64 chains; stored to, TMA clips rows past N and chains
// past C).
template <class Epilogue>
__global__ void __launch_bounds__(kHThreads, 1)
glm_tf32_value_kernel(const __grid_constant__ CUtensorMap x_map,
                      const __grid_constant__ CUtensorMap z_map,
                      const __grid_constant__ CUtensorMap rt_map, const float* __restrict__ y,
                      float* __restrict__ ll_part, int N, int Dp, int C, int splits,
                      int tiles_per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kTValueBarOff);
  uint64_t* empty = full + kTStages;
  uint64_t* rawf = empty + kTStages;
  const int chain_tiles = (C + kTChains - 1) / kTChains;
  const int items = splits * chain_tiles;
  const int n_tiles = (N + kTRows - 1) / kTRows;
  const int nk = (Dp + kTK - 1) / kTK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTStages; ++s) {
      mbar_init(&full[s], kSplitWarps);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
      mbar_init(&rawf[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const bool loader = threadIdx.x == 2 * 128, splitter = threadIdx.x >= 2 * 128 + 32;
    if (!loader && !splitter) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int ct = item % chain_tiles, sp = item / chain_tiles;
      const int tile_end = min((sp + 1) * tiles_per_split, n_tiles);
      for (int t = sp * tiles_per_split; t < tile_end; ++t) {
        for (int kc = 0; kc < nk; ++kc) {
          unsigned char* st = smem + stage * kTStageBytes;
          if (loader) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&rawf[stage], 2 * kTBox);
            tma_load_2d(st, &z_map, &rawf[stage], kc * kTK, ct * kTChains);
            tma_load_2d(st + kTBox, &x_map, &rawf[stage], kc * kTK, t * kTRows);
          } else {
            mbar_wait(&rawf[stage], phase);
            split_b_box(st + kTBox, threadIdx.x - (2 * 128 + 32), &full[stage]);
          }
          if (++stage == kTStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tw = threadIdx.x & 127, warp = tw >> 5, lane = tw & 31;
    const int cl = warp * 16 + (lane >> 2);  // this thread's chains: cl and cl + 8 of the 64
    unsigned char* stg = smem + kTStages * kTStageBytes + wg * 2 * kTStgBytes;
    float acc[64], tot[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int ct = item % chain_tiles, sp = item / chain_tiles;
      const int tile_end = min((sp + 1) * tiles_per_split, n_tiles);
      float ll[2] = {0.f, 0.f};  // [h], over the item's rows
      for (int t = sp * tiles_per_split; t < tile_end; ++t) {
#pragma unroll
        for (int i = 0; i < 64; ++i) tot[i] = 0.f;
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(&full[stage], phase);
          mbar_wait(&rawf[stage], phase);  // the raw A box, read here by generic loads
          tf32x3_stage(acc, tot, smem + stage * kTStageBytes, wg);
          if (lane == 0) mbar_arrive(&empty[stage]);
          if (++stage == kTStages) {
            stage = 0;
            phase ^= 1;
          }
        }


        // Epilogue, one 64-row half at a time: tot[4 j + 2 h + e] is chain
        // cl + 8 h, row 8 j + 2 (lane % 4) + e. Rows past N masked, ll summed
        // per tile in registers, the residual in row pairs into the two
        // swizzled store boxes (line = chain, 16-byte chunk = (row % 32) / 4
        // ^ chain % 8), then TMA stores.
        float tl[2] = {0.f, 0.f};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (tw == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          named_barrier(2 + wg, 128);  // the store boxes are free
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * half + jj;
            const int row = t * kTRows + 8 * j + 2 * (lane & 3);
            const bool va = row < N, vb = row + 1 < N;
            const float ya = (Epilogue::kUsesY && va) ? __ldg(y + row) : 0.f;
            const float yb = (Epilogue::kUsesY && vb) ? __ldg(y + row + 1) : 0.f;
            const int chunk = 2 * (jj & 3) + ((lane & 3) >> 1);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float ta, ra, tb, rb;
              Epilogue::apply(ya, tot[4 * j + 2 * h], ta, ra);
              Epilogue::apply(yb, tot[4 * j + 2 * h + 1], tb, rb);
              if (!va) ta = ra = 0.f;
              if (!vb) tb = rb = 0.f;
              tl[h] += ta;
              tl[h] += tb;
              const int line = cl + 8 * h;
              *reinterpret_cast<float2*>(stg + (jj >> 2) * kTStgBytes + line * 128 +
                                         ((chunk ^ (line & 7)) << 4) + (lane & 1) * 8) =
                  make_float2(ra, rb);
            }
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          named_barrier(2 + wg, 128);
          if (tw == 0) {
            const int r0 = t * kTRows + 64 * half, c0 = ct * kTChains + 64 * wg;
            tma_store_2d(&rt_map, stg, r0, c0);
            tma_store_2d(&rt_map, stg + kTStgBytes, r0 + 32, c0);
          }
        }
        ll[0] += tl[0];
        ll[1] += tl[1];
      }

      // ll: the four lanes that share a chain, then one partial per split.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = ll[h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const int c = ct * kTChains + wg * 64 + cl + 8 * h;
        if ((lane & 3) == 0 && c < C) ll_part[(size_t)sp * C + c] = v;
      }
    }
    if (tw == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// Gradient kernel of the f32 path: G^T = R^T X in 3xTF32 (M = chains, N =
// 128 columns of g, K = rows in 32-row stages) over one row split. A
// persistent grid walks the work items (row split, column tile, chain tile)
// in the order item = (split * col_tiles + dt) * chain_tiles + ct. Maps
// (raw f32): Rt (box 32 rows x 64 chains, two per stage; A, split by the
// consumers) and XT (X^T, Dp x ldx, box 32 rows x 128 columns; B, split in
// shared memory by warps 1-3 of the producer warpgroup): B must be K-major,
// and X^T makes it so. Writes g_part[split][c][d].
__global__ void __launch_bounds__(kHThreads, 1)
glm_tf32_grad_kernel(const __grid_constant__ CUtensorMap rt_map,
                     const __grid_constant__ CUtensorMap xt_map, float* __restrict__ g_part,
                     int N, int Dp, int D, int C, int g_splits, int chunks_per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kTGradBarOff);
  uint64_t* empty = full + kTStages;
  uint64_t* rawf = empty + kTStages;
  const int chain_tiles = (C + kTChains - 1) / kTChains;
  const int col_tiles = (Dp + kTCols - 1) / kTCols;
  const int items = g_splits * col_tiles * chain_tiles;
  const int n_chunks = (N + kTK - 1) / kTK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTStages; ++s) {
      mbar_init(&full[s], kSplitWarps);
      mbar_init(&empty[s], 8);
      mbar_init(&rawf[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const bool loader = threadIdx.x == 2 * 128, splitter = threadIdx.x >= 2 * 128 + 32;
    if (!loader && !splitter) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int ct = item % chain_tiles, dt = (item / chain_tiles) % col_tiles;
      const int sp = item / chain_tiles / col_tiles;
      const int chunk_end = min((sp + 1) * chunks_per_split, n_chunks);
      for (int ch = sp * chunks_per_split; ch < chunk_end; ++ch) {
        unsigned char* st = smem + stage * kTStageBytes;
        if (loader) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&rawf[stage], 2 * kTBox);
          tma_load_2d(st, &rt_map, &rawf[stage], ch * kTK, ct * kTChains);
          tma_load_2d(st + kTBox / 2, &rt_map, &rawf[stage], ch * kTK, ct * kTChains + 64);
          tma_load_2d(st + kTBox, &xt_map, &rawf[stage], ch * kTK, dt * kTCols);
        } else {
          mbar_wait(&rawf[stage], phase);
          split_b_box(st + kTBox, threadIdx.x - (2 * 128 + 32), &full[stage]);
        }
        if (++stage == kTStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tw = threadIdx.x & 127, warp = tw >> 5, lane = tw & 31;
    float acc[64], tot[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int ct = item % chain_tiles, dt = (item / chain_tiles) % col_tiles;
      const int sp = item / chain_tiles / col_tiles;
      const int chunk_end = min((sp + 1) * chunks_per_split, n_chunks);
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] = 0.f;
      for (int ch = sp * chunks_per_split; ch < chunk_end; ++ch) {
        mbar_wait(&full[stage], phase);
        mbar_wait(&rawf[stage], phase);  // the raw A box, read here by generic loads
        tf32x3_stage(acc, tot, smem + stage * kTStageBytes, wg);
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == kTStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      const int cb = ct * kTChains + wg * 64 + warp * 16 + (lane >> 2);
      const int db0 = dt * kTCols + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = cb + 8 * (q >> 1), d = db0 + 8 * j + (q & 1);
          if (c < C && d < D) g_part[((size_t)sp * C + c) * D + d] = tot[4 * j + q];
        }
      }
    }
  }
}

// out[i] = sum over splits of part[s][i], always in split order: g.
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = part[i];
  for (int s = 1; s < splits; ++s) v += part[(size_t)s * n + i];
  out[i] = v;
}

// ll: out[c] = sum over splits of part[s][c] in double, rounded once, one
// warp per chain: lane l sums splits l, l + 32, ..., then a fixed xor
// butterfly (the order set by the split count alone). The f32 value kernel
// writes one partial per row split (up to one per SM), all of one sign, and
// a float sum of ~100 of them would add ~1 ulp of |ll|, beside ~0.3 ulp for
// a tree sum over the rows. A thread per chain summing 132 partials in
// double was 0.003 ms slower at glm1000 (one block of 256 chains; H100).
__global__ void sum_splits_ll_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     int n, int splits) {
  const int i = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= n) return;  // i is the warp's, so whole warps leave
  double v = 0.0;
  for (int s = lane; s < splits; s += 32) v += part[(size_t)s * n + i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) out[i] = static_cast<float>(v);
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
  int grid;  // blocks of the persistent f32 grids (the SM count); unused elsewhere
  cudaStream_t st;
};

// ll (C,) and g (C, D) from their per-split partials, on every path; no g
// partials (g_part null) when the wide gradient kernel walked its splits
// and wrote g itself.
int sum_outputs(const Args& a, void* ll, void* g) {
  sum_splits_ll_kernel<<<(a.C + 7) / 8, 256, 0, a.st>>>(a.ll_part, static_cast<float*>(ll),
                                                        a.C, a.splits);
  if (a.g_part != nullptr) {
    const int ng = a.C * a.D;
    sum_splits_kernel<<<(ng + 255) / 256, 256, 0, a.st>>>(a.g_part, static_cast<float*>(g), ng,
                                                          a.g_splits);
  }
  return (int)cudaGetLastError();
}

// Dp <= 128, bf16 or int8 X: the TMA + wgmma one-pass kernel. Scratch: zb
// (round_up(C, 128), Dp) bf16, reached with X through the tensor maps of
// glm_onepass_tensor_maps (made for X's type). launch_onepass_as takes the
// epilogue E as given (and the kernel's kGT and kLLSum); launch_onepass
// takes the MUFU form of the epilogue unless kOnePassAccurate.
constexpr bool kOnePassAccurate = false;

template <class E, bool kInt8, bool kGT = true, bool kLLSum = true>
int launch_onepass_as(const Args& a) {
  if (!covers(a.N, a.splits, a.rows_per_split, kORows) || a.g_splits != a.splits ||
      a.g_part == nullptr || a.zb == nullptr || a.maps == nullptr || a.Dp > kMaxDp)
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
  err = max_dynamic_smem_once(
      reinterpret_cast<const void*>(glm_onepass_kernel<E, kInt8, kGT, kLLSum>), (int)smem);
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
// for X's type). The gradient kernel writes g_part, one partial a split,
// or, with g_part null, walks the splits and writes g (launch_plan's
// g_walk; the same bits).
template <class Epilogue, bool kInt8>
int launch_hopper(const Args& a, void* g) {
  if (!covers(a.N, a.splits, a.rows_per_split, kHRows) ||
      !covers(a.N, a.g_splits, a.g_rows_per_split, kHK) || a.zb == nullptr ||
      a.maps == nullptr || g == nullptr)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[4];
  memcpy(m, a.maps, sizeof m);
  const int Cp = round_up(a.C, kHChains);
  const size_t nz = (size_t)Cp * a.Dp;
  round_z_kernel<<<(unsigned)((nz + 255) / 256), 256, 0, a.st>>>(
      a.Z, static_cast<__nv_bfloat16*>(a.zb), a.C, a.D, Cp, a.Dp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr uint32_t vsmem = v_smem(kInt8);
  err = max_dynamic_smem_once(
      reinterpret_cast<const void*>(glm_hopper_value_kernel<Epilogue, kInt8>), (int)vsmem);
  if (err != cudaSuccess) return (int)err;
  glm_hopper_value_kernel<Epilogue, kInt8>
      <<<dim3(a.splits, Cp / kHChains), kHThreads, vsmem, a.st>>>(
          m[0], m[1], m[3], a.y, a.ll_part, a.N, a.Dp, a.C, a.rows_per_split / kHRows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int col_tiles = (a.Dp + kHCols - 1) / kHCols, cps = a.g_rows_per_split / kHK;
  if (a.g_part == nullptr) {
    constexpr uint32_t gsmem = g_smem(kInt8, true);
    err = max_dynamic_smem_once(reinterpret_cast<const void*>(glm_hopper_grad_kernel<kInt8, true>),
                                (int)gsmem);
    if (err != cudaSuccess) return (int)err;
    glm_hopper_grad_kernel<kInt8, true>
        <<<dim3(col_tiles, (a.C + g_chains(true) - 1) / g_chains(true)), kHThreads, gsmem, a.st>>>(
            m[3], m[2], static_cast<float*>(g), a.N, a.D, a.C, a.g_splits, cps);
  } else {
    constexpr uint32_t gsmem = g_smem(kInt8, false);
    err = max_dynamic_smem_once(
        reinterpret_cast<const void*>(glm_hopper_grad_kernel<kInt8, false>), (int)gsmem);
    if (err != cudaSuccess) return (int)err;
    glm_hopper_grad_kernel<kInt8, false>
        <<<dim3(col_tiles, a.g_splits, Cp / kHChains), kHThreads, gsmem, a.st>>>(
            m[3], m[2], a.g_part, a.N, a.D, a.C, a.g_splits, cps);
  }
  return (int)cudaGetLastError();
}

// The f32 value kernel's epilogue: its MUFU form (kTF32Accurate false; as
// close to ll and g in float64 as the accurate tanhf/logf form, measured on
// the H100, and 0.06 ms faster at glm100's shape).
constexpr bool kTF32Accurate = false;

// f32 X, any Dp: pad_z_kernel, then the 3xTF32 pair on persistent grids
// (a.grid blocks, the caller's SM count, at most one per work item).
// Scratch: zb (C, Dp) f32 for the padded Z and rt (C, ldr) f32; with the
// caller's X^T (Dp, ldx) f32, all reached through the tensor maps of
// glm_tf32_tensor_maps.
template <class Epilogue>
int launch_tf32(const Args& a) {
  if (!covers(a.N, a.splits, a.rows_per_split, kTRows) ||
      !covers(a.N, a.g_splits, a.g_rows_per_split, kTK) || a.g_part == nullptr ||
      a.zb == nullptr || a.maps == nullptr || a.grid <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[4];
  memcpy(m, a.maps, sizeof m);
  const size_t nz = (size_t)a.C * a.Dp;
  pad_z_kernel<<<(unsigned)((nz + 255) / 256), 256, 0, a.st>>>(a.Z, static_cast<float*>(a.zb), a.C,
                                                               a.D, a.Dp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  using E = typename std::conditional<kTF32Accurate, Epilogue, Mufu<Epilogue>>::type;
  err = max_dynamic_smem_once(reinterpret_cast<const void*>(glm_tf32_value_kernel<E>),
                              (int)kTValueSmem);
  if (err != cudaSuccess) return (int)err;
  err = max_dynamic_smem_once(reinterpret_cast<const void*>(glm_tf32_grad_kernel),
                              (int)kTGradSmem);
  if (err != cudaSuccess) return (int)err;
  const int sms = a.grid;
  const int chain_tiles = (a.C + kTChains - 1) / kTChains;
  const int v_items = a.splits * chain_tiles;
  glm_tf32_value_kernel<E><<<v_items < sms ? v_items : sms, kHThreads, kTValueSmem, a.st>>>(
      m[0], m[1], m[3], a.y, a.ll_part, a.N, a.Dp, a.C, a.splits, a.rows_per_split / kTRows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int g_items = a.g_splits * ((a.Dp + kTCols - 1) / kTCols) * chain_tiles;
  glm_tf32_grad_kernel<<<g_items < sms ? g_items : sms, kHThreads, kTGradSmem, a.st>>>(
      m[3], m[2], a.g_part, a.N, a.Dp, a.D, a.C, a.g_splits, a.g_rows_per_split / kTK);
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
    err = launch_tf32<Epilogue>(a);
  else if (a.Dp <= kMaxDp)
    err = int8 ? launch_onepass<Epilogue, true>(a) : launch_onepass<Epilogue, false>(a);
  else
    err = int8 ? launch_hopper<Epilogue, true>(a, g) : launch_hopper<Epilogue, false>(a, g);
  if (err != 0) return err;
  return sum_outputs(a, ll, g);
}

Args make_args(const void* X, const void* y, const void* Z, void* ll_part, void* g_part,
               void* zb, void* rt, const void* maps, int N, int Dp, int D, int C, int splits,
               int rows_per_split, int g_splits, int g_rows_per_split, int grid,
               void* stream) {
  return Args{X,      static_cast<const float*>(y), static_cast<const float*>(Z),
              static_cast<float*>(ll_part), static_cast<float*>(g_part), zb, rt, maps, N, Dp, D,
              C,      splits, rows_per_split, g_splits, g_rows_per_split, grid,
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

// f32 with the 128-byte swizzle (32 floats a line): the 3xTF32 kernels'
// operands.
bool encode_f32_2d(CUtensorMap* map, const void* base, int inner, int outer, int ld, int box_inner,
                   int box_outer) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, inner, outer, ld, box_inner,
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

// The four tensor maps of the f32 path, written to ``out`` (4 x 128
// bytes), all f32 in 32-element (128-byte) lines with the 128-byte swizzle:
// X (N x Dp) in 32-column x 128-row boxes (value kernel B), Zp (C x Dp,
// pad_z_kernel's output) in 32-column x 128-chain boxes (value kernel A),
// X^T (Dp x ldx, its first N columns used) in 32-row x 128-column boxes
// (gradient kernel B) and Rt (C x ldr, its first N columns used) in 32-row
// x 64-chain boxes (value kernel store; gradient kernel A, two per stage).
// The caller keeps them with X^T and its scratch. Returns a CUDA error
// code, 0 on success.
extern "C" int glm_tf32_tensor_maps(const void* X, const void* xt, const void* zp, const void* rt,
                                    int N, int Dp, int C, int ldx, int ldr, void* out) {
  CUtensorMap m[4];
  const bool ok = Dp % 16 == 0 && ldx >= N && ldx % 4 == 0 && ldr >= N && ldr % 4 == 0 &&
                  encode_f32_2d(&m[0], X, Dp, N, Dp, kTK, kTRows) &&
                  encode_f32_2d(&m[1], zp, Dp, C, Dp, kTK, kTChains) &&
                  encode_f32_2d(&m[2], xt, N, Dp, ldx, kTK, kTCols) &&
                  encode_f32_2d(&m[3], rt, N, C, ldr, kTK, 64);
  if (!ok) return (int)cudaErrorInvalidValue;
  memcpy(out, m, sizeof m);
  return 0;
}

// One signature for the three entries. x_dtype: 0 bf16, 1 int8, 2 f32.
// ll_part is (splits, C) and g_part (g_splits, C, D); the narrow path
// (Dp <= 128) takes g_splits == splits, zb and the tensor maps of
// glm_onepass_tensor_maps, the wide path zb and the tensor maps of
// glm_hopper_tensor_maps (which name zb and rt), both made for X's type;
// the f32 path zb (the padded Z), the tensor maps of glm_tf32_tensor_maps
// and grid, the persistent grids' block count (shapes at each launch
// function; grid is unused on the other paths). Returns a CUDA error code,
// 0 on success.
#define GLM_ENTRY(name, Epilogue, refuse_int8)                                                  \
  extern "C" int name(const void* X, int x_dtype, const void* y, const void* Z, void* ll_part,  \
                      void* g_part, void* ll, void* g, void* zb, void* rt, const void* maps,    \
                      int N, int Dp, int D, int C, int splits, int rows_per_split, int g_splits, \
                      int g_rows_per_split, int grid, void* stream) {                           \
    if (refuse_int8 && x_dtype == kXInt8) return (int)cudaErrorInvalidValue;                    \
    return launch<Epilogue>(x_dtype,                                                            \
                            make_args(X, y, Z, ll_part, g_part, zb, rt, maps, N, Dp, D, C,      \
                                      splits, rows_per_split, g_splits, g_rows_per_split,       \
                                      grid, stream),                                            \
                            ll, g);                                                             \
  }

GLM_ENTRY(glm_fused_logistic, Logistic, false)
GLM_ENTRY(glm_fused_linear, Gaussian, true)  // no scale folding for residuals
GLM_ENTRY(glm_fused_hoisted, Hoisted, false)
