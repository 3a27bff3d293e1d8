// Dropout with counter-keyed Philox bits for Hopper (sm_90a), plain C
// interface.
//
// Replaces no TPU kernel: the JAX package's dropout
// (paddle_tpu/ops/nn.py:51-70) is jax.random.bernoulli, which XLA fuses
// into its neighbours. The port's plain version of the same draw
// (ops/dropout.py, _dropout_plain) is Philox4x32-10 in int64 tensor ops,
// some two hundred elementwise passes: at the flagship's widths that is
// tens of milliseconds a step, so the draw gets a kernel of its own.
//
// With x of n elements (f32 or bf16), the run's seed s (an int64 in
// device memory, so that a CUDA graph replays whatever seed was staged
// there) and the op's key k, element i takes 32-bit word i % 4 of
//   Philox4x32-10(counter = (i / 4 low word, i / 4 high word, 0, 0),
//                 key = (s mod 2^32, k))
// and is kept when the word's top 24 bits are below `thr` (the caller's
// ceil((1 - p) 2^24)). Then
//   mask[i] = kept ? 1 : 0                     (x's type, when asked)
//   out[i]  = x[i] * mask[i]   [* scale]       (f32 arithmetic, rounded
//                                               once to x's type)
// with scale = f32(1 / f32(1 - p)) for upscale_in_train (the JAX
// package's x * mask / keep as XLA compiles it). The bits are integers
// and the arithmetic is IEEE f32 products, so the kernel equals the plain
// version bit for bit. The backward is this function applied
// to the incoming gradient with the same seed and key: the mask is drawn
// again, never stored.
//
// Bound: bytes. Each element reads 4 (or 2) bytes of x and writes as many
// of out (and of mask); the ten Philox rounds are ~100 integer operations
// per four elements, well under the card's integer rate at these byte
// counts. At the flagship's attention-weight shape [32, 8, 256, 256]
// (16.8M f32) the bound is 40 us at 3.35 TB/s without the mask.
//
// Design: one thread per Philox counter (four elements), the rounds in
// registers; 16-byte loads and stores of four f32 (8 bytes of four bf16);
// a grid-stride loop over counters with enough blocks to fill every SM;
// the ragged tail (n not a multiple of 4) elementwise by the last thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;   // multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;   // key steps
constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(c.x, kM0), lo0 = c.x * kM0;
    const uint32_t hi1 = __umulhi(c.z, kM1), lo1 = c.z * kM1;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

template <typename T>
struct Pack4;  // four elements as one vector load
template <>
struct Pack4<float> {
  using V = float4;  // 16 bytes
};
template <>
struct Pack4<__nv_bfloat16> {
  using V = uint2;  // 8 bytes
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, bool UPSCALE, bool MASK>
__device__ __forceinline__ void one(T xv, uint32_t word, uint32_t thr,
                                    float scale, T& ov, T& mv) {
  const float m = (word >> 8) < thr ? 1.0f : 0.0f;
  float o = to_f32(xv) * m;
  if (UPSCALE) o = o * scale;
  ov = from_f32<T>(o);
  if (MASK) mv = from_f32<T>(m);
}

template <typename T, bool UPSCALE, bool MASK>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
                   T* __restrict__ mask, long long n,
                   const long long* __restrict__ seed, uint32_t key,
                   uint32_t thr, float scale) {
  using V = typename Pack4<T>::V;
  const uint32_t k0 =
      static_cast<uint32_t>(static_cast<unsigned long long>(*seed));
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < groups; g += stride) {
    const uint4 w = philox(
        make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32),
                   0u, 0u),
        k0, key);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    const long long base = g * 4;
    if (base + 4 <= n) {
      const V raw = *reinterpret_cast<const V*>(x + base);
      const T* xv = reinterpret_cast<const T*>(&raw);
      V oraw, mraw;
      T* ov = reinterpret_cast<T*>(&oraw);
      T* mv = reinterpret_cast<T*>(&mraw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        one<T, UPSCALE, MASK>(xv[j], words[j], thr, scale, ov[j], mv[j]);
      }
      *reinterpret_cast<V*>(out + base) = oraw;
      if (MASK) *reinterpret_cast<V*>(mask + base) = mraw;
    } else {
      for (int j = 0; base + j < n; ++j) {
        T o, m;
        one<T, UPSCALE, MASK>(x[base + j], words[j], thr, scale, o, m);
        out[base + j] = o;
        if (MASK) mask[base + j] = m;
      }
    }
  }
}

int g_blocks_per_card = 0;  // resident blocks that fill every SM

template <typename T, bool UPSCALE, bool MASK>
cudaError_t launch(const void* x, void* out, void* mask, long long n,
                   const long long* seed, uint32_t key, uint32_t thr,
                   float scale, cudaStream_t st) {
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > g_blocks_per_card) blocks = g_blocks_per_card;
  dropout_kernel<T, UPSCALE, MASK><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(mask),
      n, seed, key, thr, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, void* out, void* mask, long long n,
                const long long* seed, uint32_t key, uint32_t thr,
                float scale, bool upscale, cudaStream_t st) {
  if (upscale) {
    return mask ? launch<T, true, true>(x, out, mask, n, seed, key, thr,
                                        scale, st)
                : launch<T, true, false>(x, out, mask, n, seed, key, thr,
                                         scale, st);
  }
  return mask ? launch<T, false, true>(x, out, mask, n, seed, key, thr,
                                       scale, st)
              : launch<T, false, false>(x, out, mask, n, seed, key, thr,
                                        scale, st);
}

}  // namespace

// x, out and (when not null) mask: n elements of one type (kind 0 = f32,
// 1 = bf16), 16-byte aligned; seed: one int64 in device memory. Returns
// the cudaError_t of the launch (0 = launched); it is asynchronous on
// `stream`.
extern "C" int ptt_dropout(const void* x, void* out, void* mask,
                           long long n, const void* seed, unsigned key,
                           unsigned thr, float scale, int upscale, int kind,
                           void* stream) {
  if (n < 1 || thr > (1u << 24)) return (int)cudaErrorInvalidValue;
  if (g_blocks_per_card == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(
          &per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
    }
    if (err != cudaSuccess) return (int)err;
    g_blocks_per_card = sms * (per_sm / kThreads);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* s = static_cast<const long long*>(seed);
  if (kind == 0) {
    return (int)run<float>(x, out, mask, n, s, key, thr, scale, upscale != 0,
                           st);
  }
  if (kind == 1) {
    return (int)run<__nv_bfloat16>(x, out, mask, n, s, key, thr, scale,
                                   upscale != 0, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ptt_dropout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
