// One NUTS step's random inputs for a batch of chains, from Philox4x32-10,
// for Hopper (sm_90a).
//
// Replaces the reference's per-chain threefry streams
// (jax.random.fold_in(chain_key, t) and the draws of one step,
// mlx_mcmc_tpu/inference/engine.py:390 and mlx_mcmc_tpu/kernels/nuts.py:187-211).
// The plain version is mlx_mcmc_tpu_torch/ops/random.py: for the same seed,
// chains and step the words agree bit for bit, the uniforms exactly, and the
// normals to the last ulp of logf/sincosf.
//
// Philox4x32-10 (Salmon et al., SC'11): key = the 64-bit seed as (low, high);
// counter = (chain, step, block, stream). Block b of a stream holds values
// 4b .. 4b+3. Normals (stream 0) come from Box-Muller on the word pairs
// (x0, x1) and (x2, x3) with u1 = ((x >> 8) + 1) 2^-24 in (0, 1] and
// u2 = (x >> 8) 2^-24; uniforms (stream 1) are (x >> 8) 2^-24 in [0, 1).
//
// Bound. At the glm100 step shape (C = 4096, D = 100, a 32-row uniform
// table) the outputs are 3.7 MB (1.1 us at 3.35 TB/s); the 237K Philox calls
// are about 100 integer operations each (2.4e7, under 1 us at the card's
// 32-bit integer rate). So the kernel is bound by bytes. One thread computes
// one Philox call and stores its four floats; the uniform table goes out as
// 16-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // round multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // key increments
constexpr uint32_t kStreamNormal = 0u, kStreamUniform = 1u;
constexpr float kInv2p24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float kTwoPi = 6.283185307179586f;         // float32(2 pi)
constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float to_unit(uint32_t x) {
  return (float)(x >> 8) * kInv2p24;
}

__device__ __forceinline__ float2 box_muller(uint32_t a, uint32_t b) {
  const float u1 = (float)((a >> 8) + 1u) * kInv2p24;
  const float radius = sqrtf(-2.f * logf(u1));
  float s, c;
  sincosf(to_unit(b) * kTwoPi, &s, &c);
  return make_float2(radius * c, radius * s);
}

// Thread i serves chain i / per_chain and, within it, normal block b < nb or
// uniform-table row b - nb. The wrapper keeps C * per_chain below 2^31.
__global__ void __launch_bounds__(kThreads)
philox_step_kernel(const int64_t* __restrict__ chains, int C, uint32_t k0,
                   uint32_t k1, uint32_t step, int dim, int n_slots,
                   float* __restrict__ z, float4* __restrict__ u) {
  const int nb = (dim + 3) / 4;
  const int per_chain = nb + n_slots;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= C * per_chain) return;
  const int c = i / per_chain, b = i - c * per_chain;
  const uint32_t chain = (uint32_t)chains[c];
  if (b < nb) {
    const uint4 w = philox4x32_10(make_uint4(chain, step, (uint32_t)b, kStreamNormal), k0, k1);
    const float2 p = box_muller(w.x, w.y), q = box_muller(w.z, w.w);
    float* out = z + (size_t)c * dim + 4 * b;
    const int left = dim - 4 * b;  // >= 1
    out[0] = p.x;
    if (left > 1) out[1] = p.y;
    if (left > 2) out[2] = q.x;
    if (left > 3) out[3] = q.y;
  } else {
    const uint32_t row = (uint32_t)(b - nb);
    const uint4 w = philox4x32_10(make_uint4(chain, step, row, kStreamUniform), k0, k1);
    u[(size_t)c * n_slots + row] =
        make_float4(to_unit(w.x), to_unit(w.y), to_unit(w.z), to_unit(w.w));
  }
}

// The raw words of one stream: out (C, blocks, 4).
__global__ void __launch_bounds__(kThreads)
philox_words_kernel(const int64_t* __restrict__ chains, int C, uint32_t k0,
                    uint32_t k1, uint32_t step, uint32_t stream, int blocks,
                    uint4* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= C * blocks) return;
  const int c = i / blocks, b = i - c * blocks;
  out[i] = philox4x32_10(make_uint4((uint32_t)chains[c], step, (uint32_t)b, stream), k0, k1);
}

}  // namespace

extern "C" int philox_step_draws(const void* chains, int C, uint64_t seed,
                                 uint32_t step, int dim, int n_slots, void* z,
                                 void* u, void* stream) {
  const long long total = (long long)C * ((dim + 3) / 4 + n_slots);
  if (C <= 0 || dim <= 0 || n_slots < 0 || total >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((total + kThreads - 1) / kThreads);
  philox_step_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(chains), C, (uint32_t)seed,
      (uint32_t)(seed >> 32), step, dim, n_slots, static_cast<float*>(z),
      static_cast<float4*>(u));
  return (int)cudaGetLastError();
}

extern "C" int philox_words(const void* chains, int C, uint64_t seed,
                            uint32_t step, uint32_t stream_id, int blocks,
                            void* out, void* stream) {
  const long long total = (long long)C * blocks;
  if (C <= 0 || blocks <= 0 || total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((total + kThreads - 1) / kThreads);
  philox_words_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(chains), C, (uint32_t)seed,
      (uint32_t)(seed >> 32), step, stream_id, blocks, static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}
