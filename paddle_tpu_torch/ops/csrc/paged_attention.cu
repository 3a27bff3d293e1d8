// Block-chain paged attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel paddle_tpu/ops/paged_attention.py::_paged_kernel
// (launched by _attend_pallas). It computes, for pre-scaled queries
// q [S, H, C, dk] (f32), the online-softmax attention over the KV blocks a
// slot holds in a shared paged pool:
//
//   pool_k / pool_v  [NB, L, H, bs, dk]  f32, bf16, or int8 codes
//   k_scale/v_scale  [NB, L, H, bs]      f32 (int8 pools only)
//   btab             [S, NBmax]          int32 block table
//   qpos             [S, C]              int32; keys at cache positions
//                                        <= qpos[s, c] attend
//   nblk             [1]                 int32 device scalar; caps the walk
//   out              [S, H, C, dk]       f32 = acc / max(l, 1e-30)
//
// Bound: memory. Each (slot, head) reads its chain's K and V once
// (2 * chain * bs * dk elements) and does 2 flops per element read for
// each query row: 0.5 flop/byte at decode (C = 1), far below the card's
// ~20 flop/byte fp32 balance point (67 TFLOP/s over 3.35 TB/s). The design keeps
// what the TPU kernel kept out of device memory (scores, the running max,
// denominator and accumulator) in shared memory and registers, and reads
// the full 5-D pool through the strides it is given, so no per-layer copy
// of the pool is made.
//
// Design (first version: simple and right):
//   * one thread block per (slot, head, tile of QT query rows); the TPU's
//     sequential (S, H, NBmax) grid with its scratch carry becomes a loop
//     over the chain inside the block;
//   * the block loads its own btab row and qpos, and walks
//     chain = min(max(qpos of its rows) / bs + 1, clamp(nblk, 1, NBmax))
//     blocks, so slots with short chains stop early;
//   * each K/V block is loaded into shared memory as f32, int8 codes
//     dequantized by their per-position scale as they land;
//   * fp32 scores with the kpos <= qpos mask at -1e30 (finite, so rows
//     whose keys are all masked never turn into NaN), and one running
//     max / denominator / accumulator per query row.
// Left for a later version: wgmma for the two products, TMA loads with a
// ring of stages, and split-K over long chains (flash-decoding).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int QT = 16;       // query rows per thread block
constexpr int NT = 128;      // threads per block
constexpr int MAX_DK = 256;  // largest head width the accumulator holds
constexpr int ACC = QT * MAX_DK / NT;
constexpr float NEG_INF = -1e30f;

// Load 8 consecutive pool elements (16, 16 or 8 bytes) as f32.
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ void load8(const int8_t* p, float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(c[i]);
}

template <typename T, bool QUANT>
__global__ void __launch_bounds__(NT) paged_attention_kernel(
    const float* __restrict__ q, const T* __restrict__ pool_k,
    const T* __restrict__ pool_v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ btab,
    const int* __restrict__ qpos, const int* __restrict__ nblk,
    float* __restrict__ out, int H, int C, int dk, int bs, int nbmax,
    int layer, int p_sb, int p_sl, int p_sh, int p_sp, int s_sb, int s_sl,
    int s_sh) {
  extern __shared__ float smem[];
  const int ks = dk + 1;               // padded K row: no bank conflicts
  float* k_t = smem;                   // [bs][dk + 1]
  float* v_t = k_t + bs * ks;          // [bs][dk]
  float* q_t = v_t + bs * dk;          // [QT][dk]
  float* p_t = q_t + QT * dk;          // [QT][bs] scores, then weights
  float* m_r = p_t + QT * bs;          // [QT] running max
  float* l_r = m_r + QT;               // [QT] running denominator
  float* a_r = l_r + QT;               // [QT] this block's rescale
  int* qp_r = reinterpret_cast<int*>(a_r + QT);  // [QT] key bound
  __shared__ int chain_s;

  const int s = blockIdx.z, h = blockIdx.y, c0 = blockIdx.x * QT;
  const int rows = min(QT, C - c0);
  const int tid = threadIdx.x;
  const long long qrow0 = ((long long)s * H + h) * C + c0;

  for (int e = tid; e < rows * dk; e += NT) q_t[e] = q[qrow0 * dk + e];
  if (tid < QT) {
    qp_r[tid] = tid < rows ? qpos[(long long)s * C + c0 + tid] : -1;
    m_r[tid] = NEG_INF;
    l_r[tid] = 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    int mx = 0;
    for (int r = 0; r < rows; ++r) mx = max(mx, qp_r[r]);
    const int cap = min(max(*nblk, 1), nbmax);
    chain_s = min(mx / bs + 1, cap);
  }
  __syncthreads();
  const int chain = chain_s;

  float acc[ACC];
#pragma unroll
  for (int k = 0; k < ACC; ++k) acc[k] = 0.f;

  const int* trow = btab + (long long)s * nbmax;
  const int n8 = bs * dk / 8;
  for (int b = 0; b < chain; ++b) {
    const long long phys = trow[b];
    const long long base =
        phys * p_sb + (long long)layer * p_sl + (long long)h * p_sh;
    for (int v8 = tid; v8 < n8; v8 += NT) {
      const int j = (v8 * 8) / dk, d = (v8 * 8) % dk;
      float kk[8], vv[8];
      load8(pool_k + base + (long long)j * p_sp + d, kk);
      load8(pool_v + base + (long long)j * p_sp + d, vv);
      float kscl = 1.f, vscl = 1.f;
      if (QUANT) {
        const long long si = phys * s_sb + (long long)layer * s_sl +
                             (long long)h * s_sh + j;
        kscl = k_scale[si];
        vscl = v_scale[si];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        k_t[j * ks + d + i] = QUANT ? kk[i] * kscl : kk[i];
        v_t[j * dk + d + i] = QUANT ? vv[i] * vscl : vv[i];
      }
    }
    __syncthreads();
    for (int e = tid; e < rows * bs; e += NT) {
      const int r = e / bs, j = e % bs;
      const float* qr = q_t + r * dk;
      const float* kr = k_t + j * ks;
      float sc = 0.f;
      for (int d = 0; d < dk; ++d) sc = fmaf(qr[d], kr[d], sc);
      p_t[r * bs + j] = (b * bs + j <= qp_r[r]) ? sc : NEG_INF;
    }
    __syncthreads();
    if (tid < rows) {
      float* pr = p_t + tid * bs;
      float mx = NEG_INF;
      for (int j = 0; j < bs; ++j) mx = fmaxf(mx, pr[j]);
      const float m_prev = m_r[tid];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int j = 0; j < bs; ++j) {
        const float p = expf(pr[j] - m_new);
        pr[j] = p;
        sum += p;
      }
      l_r[tid] = alpha * l_r[tid] + sum;
      m_r[tid] = m_new;
      a_r[tid] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ACC; ++k) {
      const int e = tid + k * NT;
      if (e < rows * dk) {
        const int r = e / dk, d = e % dk;
        const float* pr = p_t + r * bs;
        float o = acc[k] * a_r[r];
        for (int j = 0; j < bs; ++j) o = fmaf(pr[j], v_t[j * dk + d], o);
        acc[k] = o;
      }
    }
    __syncthreads();   // the next block overwrites the tiles
  }
#pragma unroll
  for (int k = 0; k < ACC; ++k) {
    const int e = tid + k * NT;
    if (e < rows * dk) {
      const int r = e / dk;
      out[qrow0 * dk + e] = acc[k] / fmaxf(l_r[r], 1e-30f);
    }
  }
}

template <typename T, bool QUANT>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* k_scale, const void* v_scale,
                   const void* btab, const void* qpos, const void* nblk,
                   void* out, int S, int H, int C, int dk, int bs,
                   int nbmax, int layer, int p_sb, int p_sl, int p_sh,
                   int p_sp, int s_sb, int s_sl, int s_sh,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)bs * (dk + 1) + (size_t)bs * dk + (size_t)QT * dk +
       (size_t)QT * bs + 4 * QT);
  auto fn = paged_attention_kernel<T, QUANT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((C + QT - 1) / QT, H, S);
  fn<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(btab),
      static_cast<const int*>(qpos), static_cast<const int*>(nblk),
      static_cast<float*>(out), H, C, dk, bs, nbmax, layer, p_sb, p_sl,
      p_sh, p_sp, s_sb, s_sl, s_sh);
  return cudaGetLastError();
}

}  // namespace

// kind: 0 = f32 pool, 1 = bf16 pool, 2 = int8 codes + f32 scales.
// Pool strides p_* and scale strides s_* are in elements. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int ptt_paged_attention(
    const void* q, const void* pool_k, const void* pool_v,
    const void* k_scale, const void* v_scale, const void* btab,
    const void* qpos, const void* nblk, void* out, int S, int H, int C,
    int dk, int bs, int nbmax, int layer, int p_sb, int p_sl, int p_sh,
    int p_sp, int s_sb, int s_sl, int s_sh, int kind, void* stream) {
  if (dk % 8 != 0 || dk > MAX_DK || S < 1 || H < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return (int)launch<float, false>(
          q, pool_k, pool_v, k_scale, v_scale, btab, qpos, nblk, out, S, H,
          C, dk, bs, nbmax, layer, p_sb, p_sl, p_sh, p_sp, s_sb, s_sl, s_sh,
          st);
    case 1:
      return (int)launch<__nv_bfloat16, false>(
          q, pool_k, pool_v, k_scale, v_scale, btab, qpos, nblk, out, S, H,
          C, dk, bs, nbmax, layer, p_sb, p_sl, p_sh, p_sp, s_sb, s_sl, s_sh,
          st);
    case 2:
      return (int)launch<int8_t, true>(
          q, pool_k, pool_v, k_scale, v_scale, btab, qpos, nblk, out, S, H,
          C, dk, bs, nbmax, layer, p_sb, p_sl, p_sh, p_sp, s_sb, s_sl, s_sh,
          st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
