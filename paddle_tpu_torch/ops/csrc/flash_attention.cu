// Flash attention forward and backward for Hopper (sm_90a), plain C
// interface.
//
// Replaces the three TPU kernels of paddle_tpu/ops/flash_attention.py:
//   _fwd_kernel     (launched by _fwd_pallas)  -> flash_fwd_kernel
//   _bwd_dq_kernel  (launched by _bwd_pallas)  -> flash_bwd_dq_kernel
//   _bwd_dkv_kernel (launched by _bwd_pallas)  -> flash_bwd_dkv_kernel
//
// Shapes: q, k, v, o, do, dq, dk, dv are [BH, T, D] (B*H heads of one
// sequence length, row-major, contiguous), f32 or bf16; lse and delta
// are [BH, T] f32. With scale s and the causal mask (key j attends to
// query r iff j <= r), masked scores set to -1e30:
//   forward:  S = s Q K^T, O = softmax(S) V, LSE = m + log l per row
//   backward: P = exp(S - LSE), dP = dO V^T, dS = P (dP - delta) s,
//             dQ = dS K, dK = dS^T Q, dV = P^T dO,
// where delta = rowsum(dO * O) - dLSE is computed by the caller (plain
// PyTorch, where the JAX package computes it in jnp).
//
// Bound: at the flagship's training shape (B=32, H=8, T=256, D=64,
// causal, fp32 with TF32 off) the work is arithmetic, not bytes: the
// forward does 4 * T(T+1)/2 * D flops per head over 4 * T * D * 4 bytes
// of q/k/v/o, about 64 flop/byte against the card's fp32 balance point
// of ~20 flop/byte (67 TFLOP/s over 3.35 TB/s); the backward more. So
// the design keeps every product in fp32 FMA units fed from shared
// memory, skips the tiles the causal mask empties, and keeps the score
// matrix, the running softmax statistics and the accumulators on chip,
// as the TPU kernels kept them in VMEM.
//
// Design (first version: simple and right):
//   * 128 threads per block as 16 row groups x 8 column groups; a row
//     group is 8 consecutive lanes of one warp, so row reductions are
//     three xor shuffles and the score tile each warp writes to shared
//     memory is read back only by that warp (a __syncwarp, not a block
//     barrier);
//   * forward and dQ: one block per (head, tile of ROWS query rows),
//     looping over tiles of 64 keys; with causal the loop stops at the
//     tile holding the diagonal and masks inside it. The TPU's
//     sequential grid with its scratch carry becomes this loop;
//   * dK/dV: one block per (head, tile of ROWS keys), looping over
//     tiles of 64 queries from the diagonal to the end; dK and dV
//     accumulate in registers and are written once;
//   * no atomics anywhere: the backward is deterministic run to run;
//   * tiles are staged in shared memory as f32 (bf16 converted on
//     load), rows padded to D+1 floats against bank conflicts; products
//     and softmax run in f32 for both input types;
//   * T is any length (ragged edges masked, padded rows zero); D is any
//     multiple of 8 up to 256, with ROWS shrinking as D grows (64, 32,
//     16 rows for D <= 64, 128, 256) so registers and shared memory fit.
// Left for a later version: mma.sync / wgmma tensor-core products for
// bf16, TMA loads with a ring of stages, warp specialisation, and
// launching the two backward kernels as one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;      // threads per block
constexpr int RG = 16;       // row groups
constexpr int CG = 8;        // column groups (lanes of one row group)
constexpr int COLS = 64;     // columns (keys, or queries in dK/dV) per tile
constexpr int CN = COLS / CG;
constexpr float NEG_INF = -1e30f;

// rows per thread (RM) for each head-width class DC
template <int DC> struct Cfg;
template <> struct Cfg<64> { static constexpr int RM = 4; };
template <> struct Cfg<128> { static constexpr int RM = 2; };
template <> struct Cfg<256> { static constexpr int RM = 1; };

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Stage rows row0 .. row0+n-1 of one head's [T, D] slab into dst
// (row stride ld floats); rows at or past T read as zero.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int row0, int n, int t, int d,
                                          float* dst, int ld) {
  const int nv = n * d / 4;
  for (int e = threadIdx.x; e < nv; e += NT) {
    const int r = (e * 4) / d, c = (e * 4) % d;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < t) load4(src + (long long)(row0 + r) * d + c, v);
    float* o = dst + r * ld + c;
    o[0] = v[0]; o[1] = v[1]; o[2] = v[2]; o[3] = v[3];
  }
}

// Stage per-row statistics (lse or delta) of rows row0 .. row0+n-1.
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          int row0, int n, int t,
                                          float* dst) {
  for (int e = threadIdx.x; e < n; e += NT)
    dst[e] = row0 + e < t ? src[row0 + e] : 0.f;
}

__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// ---------------------------------------------------------------------
template <typename T, int DC>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int t, int d, float scale, int causal) {
  constexpr int RM = Cfg<DC>::RM, ROWS = RG * RM, DN = DC / CG;
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* q_s = smem;                   // [ROWS][d + 1]
  float* k_s = q_s + ROWS * ld;        // [COLS][d + 1]
  float* v_s = k_s + COLS * ld;        // [COLS][d + 1]
  float* p_s = v_s + COLS * ld;        // [ROWS][COLS + 1] probabilities
  const int bh = blockIdx.y, q0 = blockIdx.x * ROWS;
  const long long base = (long long)bh * t * d;
  const int ty = threadIdx.x / CG, tx = threadIdx.x % CG;
  const int nd = d / CG;

  load_tile(q + base, q0, ROWS, t, d, q_s, ld);
  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DN; ++c) acc[i][c] = 0.f;
  }
  const int last = min(q0 + ROWS, t) - 1;
  const int ntiles = causal ? last / COLS + 1 : (t + COLS - 1) / COLS;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * COLS;
    __syncthreads();   // the previous tile is consumed; q_s is staged
    load_tile(k + base, k0, COLS, t, d, k_s, ld);
    load_tile(v + base, k0, COLS, t, d, v_s, ld);
    __syncthreads();
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < CN; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int e = 0; e < d; ++e) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = q_s[(ty * RM + i) * ld + e];
#pragma unroll
      for (int c = 0; c < CN; ++c) kv[c] = k_s[(tx + CG * c) * ld + e];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = q0 + ty * RM + i;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int j = k0 + tx + CG * c;
        float x = s[i][c] * scale;
        if (j >= t || (causal && j > r)) x = NEG_INF;
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const float p = expf(s[i][c] - m_new);
        p_s[(ty * RM + i) * (COLS + 1) + tx + CG * c] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DN; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();      // each warp reads back only its own rows of p_s
    for (int j = 0; j < COLS; ++j) {
      float pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = p_s[(ty * RM + i) * (COLS + 1) + j];
#pragma unroll
      for (int c = 0; c < DN; ++c) {
        if (c < nd) {
          const float vv = v_s[j * ld + tx + CG * c];
#pragma unroll
          for (int i = 0; i < RM; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty * RM + i;
    if (r < t) {
      const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < DN; ++c)
        if (c < nd) store1(o + base + (long long)r * d + tx + CG * c,
                           acc[i][c] / li);
      if (tx == 0) lse[(long long)bh * t + r] = m[i] + logf(li);
    }
  }
}

// ---------------------------------------------------------------------
template <typename T, int DC>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int t, int d, float scale, int causal) {
  constexpr int RM = Cfg<DC>::RM, ROWS = RG * RM, DN = DC / CG;
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* q_s = smem;                   // [ROWS][d + 1]
  float* do_s = q_s + ROWS * ld;       // [ROWS][d + 1]
  float* k_s = do_s + ROWS * ld;       // [COLS][d + 1]
  float* v_s = k_s + COLS * ld;        // [COLS][d + 1]
  float* ds_s = v_s + COLS * ld;       // [ROWS][COLS + 1]
  float* lse_s = ds_s + ROWS * (COLS + 1);  // [ROWS]
  float* dl_s = lse_s + ROWS;               // [ROWS]
  const int bh = blockIdx.y, q0 = blockIdx.x * ROWS;
  const long long base = (long long)bh * t * d;
  const int ty = threadIdx.x / CG, tx = threadIdx.x % CG;
  const int nd = d / CG;

  load_tile(q + base, q0, ROWS, t, d, q_s, ld);
  load_tile(dout + base, q0, ROWS, t, d, do_s, ld);
  load_rows(lse + (long long)bh * t, q0, ROWS, t, lse_s);
  load_rows(delta + (long long)bh * t, q0, ROWS, t, dl_s);
  float acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < DN; ++c) acc[i][c] = 0.f;
  const int last = min(q0 + ROWS, t) - 1;
  const int ntiles = causal ? last / COLS + 1 : (t + COLS - 1) / COLS;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * COLS;
    __syncthreads();
    load_tile(k + base, k0, COLS, t, d, k_s, ld);
    load_tile(v + base, k0, COLS, t, d, v_s, ld);
    __syncthreads();
    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < CN; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 2
    for (int e = 0; e < d; ++e) {
      float qv[RM], dv[RM], kv[CN], vv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        qv[i] = q_s[(ty * RM + i) * ld + e];
        dv[i] = do_s[(ty * RM + i) * ld + e];
      }
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        kv[c] = k_s[(tx + CG * c) * ld + e];
        vv[c] = v_s[(tx + CG * c) * ld + e];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(dv[i], vv[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int ri = ty * RM + i, r = q0 + ri;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int j = k0 + tx + CG * c;
        const bool live = j < t && !(causal && j > r);
        const float p = live ? expf(s[i][c] * scale - lse_s[ri]) : 0.f;
        ds_s[ri * (COLS + 1) + tx + CG * c] =
            p * (dp[i][c] - dl_s[ri]) * scale;
      }
    }
    __syncwarp();
    for (int j = 0; j < COLS; ++j) {
      float dsv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        dsv[i] = ds_s[(ty * RM + i) * (COLS + 1) + j];
#pragma unroll
      for (int c = 0; c < DN; ++c) {
        if (c < nd) {
          const float kk = k_s[j * ld + tx + CG * c];
#pragma unroll
          for (int i = 0; i < RM; ++i) acc[i][c] = fmaf(dsv[i], kk, acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty * RM + i;
    if (r < t) {
#pragma unroll
      for (int c = 0; c < DN; ++c)
        if (c < nd) store1(dq + base + (long long)r * d + tx + CG * c,
                           acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------
// Here the block's rows are KEYS and the tile columns are queries.
template <typename T, int DC>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int t, int d, float scale,
    int causal) {
  constexpr int RM = Cfg<DC>::RM, ROWS = RG * RM, DN = DC / CG;
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* k_s = smem;                   // [ROWS][d + 1]
  float* v_s = k_s + ROWS * ld;        // [ROWS][d + 1]
  float* q_s = v_s + ROWS * ld;        // [COLS][d + 1]
  float* do_s = q_s + COLS * ld;       // [COLS][d + 1]
  float* pt_s = do_s + COLS * ld;      // [ROWS][COLS + 1]  P^T
  float* dst_s = pt_s + ROWS * (COLS + 1);   // [ROWS][COLS + 1]  dS^T
  float* lse_s = dst_s + ROWS * (COLS + 1);  // [COLS]
  float* dl_s = lse_s + COLS;                // [COLS]
  const int bh = blockIdx.y, k0 = blockIdx.x * ROWS;
  const long long base = (long long)bh * t * d;
  const int ty = threadIdx.x / CG, tx = threadIdx.x % CG;
  const int nd = d / CG;

  load_tile(k + base, k0, ROWS, t, d, k_s, ld);
  load_tile(v + base, k0, ROWS, t, d, v_s, ld);
  float gk[RM][DN], gv[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < DN; ++c) gk[i][c] = gv[i][c] = 0.f;
  const int first = causal ? k0 / COLS : 0;
  const int ntiles = (t + COLS - 1) / COLS;
  for (int qt = first; qt < ntiles; ++qt) {
    const int q0 = qt * COLS;
    __syncthreads();
    load_tile(q + base, q0, COLS, t, d, q_s, ld);
    load_tile(dout + base, q0, COLS, t, d, do_s, ld);
    load_rows(lse + (long long)bh * t, q0, COLS, t, lse_s);
    load_rows(delta + (long long)bh * t, q0, COLS, t, dl_s);
    __syncthreads();
    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < CN; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 2
    for (int e = 0; e < d; ++e) {
      float kv[RM], vv[RM], qv[CN], dov[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        kv[i] = k_s[(ty * RM + i) * ld + e];
        vv[i] = v_s[(ty * RM + i) * ld + e];
      }
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        qv[c] = q_s[(tx + CG * c) * ld + e];
        dov[c] = do_s[(tx + CG * c) * ld + e];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          s[i][c] = fmaf(kv[i], qv[c], s[i][c]);
          dp[i][c] = fmaf(vv[i], dov[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int ji = ty * RM + i, j = k0 + ji;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int rc = tx + CG * c, r = q0 + rc;
        const bool live = r < t && j < t && !(causal && j > r);
        const float p = live ? expf(s[i][c] * scale - lse_s[rc]) : 0.f;
        pt_s[ji * (COLS + 1) + rc] = p;
        dst_s[ji * (COLS + 1) + rc] = p * (dp[i][c] - dl_s[rc]) * scale;
      }
    }
    __syncwarp();
    for (int rc = 0; rc < COLS; ++rc) {
      float pv[RM], dsv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        pv[i] = pt_s[(ty * RM + i) * (COLS + 1) + rc];
        dsv[i] = dst_s[(ty * RM + i) * (COLS + 1) + rc];
      }
#pragma unroll
      for (int c = 0; c < DN; ++c) {
        if (c < nd) {
          const float g = do_s[rc * ld + tx + CG * c];
          const float x = q_s[rc * ld + tx + CG * c];
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            gv[i][c] = fmaf(pv[i], g, gv[i][c]);
            gk[i][c] = fmaf(dsv[i], x, gk[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int j = k0 + ty * RM + i;
    if (j < t) {
#pragma unroll
      for (int c = 0; c < DN; ++c) {
        if (c < nd) {
          const long long at = base + (long long)j * d + tx + CG * c;
          store1(dk + at, gk[i][c]);
          store1(dv + at, gv[i][c]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------
// Raise a kernel's dynamic shared-memory cap to `smem` bytes, once per
// kernel and size: `granted` remembers the largest cap set so far
// (each template instantiation has its own).
template <typename F>
cudaError_t prepare(F fn, size_t smem, size_t& granted) {
  if (smem <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) granted = smem;
  return err;
}

template <typename T, int DC>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int bh, int t, int d, float scale, int causal,
                cudaStream_t st) {
  constexpr int ROWS = RG * Cfg<DC>::RM;
  const size_t ld = d + 1;
  const size_t smem = sizeof(float) *
      ((ROWS + 2 * COLS) * ld + (size_t)ROWS * (COLS + 1));
  auto fn = flash_fwd_kernel<T, DC>;
  static size_t granted = 0;
  cudaError_t err = prepare(fn, smem, granted);
  if (err != cudaSuccess) return err;
  fn<<<dim3((t + ROWS - 1) / ROWS, bh), NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), t, d, scale, causal);
  return cudaGetLastError();
}

template <typename T, int DC>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int bh, int t, int d, float scale, int causal,
                   cudaStream_t st) {
  constexpr int ROWS = RG * Cfg<DC>::RM;
  const size_t ld = d + 1;
  const size_t smem = sizeof(float) *
      ((2 * ROWS + 2 * COLS) * ld + (size_t)ROWS * (COLS + 1) + 2 * ROWS);
  auto fn = flash_bwd_dq_kernel<T, DC>;
  static size_t granted = 0;
  cudaError_t err = prepare(fn, smem, granted);
  if (err != cudaSuccess) return err;
  fn<<<dim3((t + ROWS - 1) / ROWS, bh), NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), t, d, scale, causal);
  return cudaGetLastError();
}

template <typename T, int DC>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int bh, int t, int d, float scale,
                    int causal, cudaStream_t st) {
  constexpr int ROWS = RG * Cfg<DC>::RM;
  const size_t ld = d + 1;
  const size_t smem = sizeof(float) *
      ((2 * ROWS + 2 * COLS) * ld + 2 * (size_t)ROWS * (COLS + 1) +
       2 * COLS);
  auto fn = flash_bwd_dkv_kernel<T, DC>;
  static size_t granted = 0;
  cudaError_t err = prepare(fn, smem, granted);
  if (err != cudaSuccess) return err;
  fn<<<dim3((t + ROWS - 1) / ROWS, bh), NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), t, d, scale, causal);
  return cudaGetLastError();
}

bool bad_shape(int bh, int t, int d) {
  return bh < 1 || bh > 65535 || t < 1 || d < 8 || d > 256 || d % 8 != 0;
}

}  // namespace

// kind: 0 = f32, 1 = bf16. Each returns the cudaError_t of its launch
// (0 = launched); the launch is asynchronous on `stream`.
#define PTT_DISPATCH(FN, ...)                                             \
  do {                                                                    \
    if (kind == 0) {                                                      \
      if (d <= 64) return (int)FN<float, 64>(__VA_ARGS__);                \
      if (d <= 128) return (int)FN<float, 128>(__VA_ARGS__);              \
      return (int)FN<float, 256>(__VA_ARGS__);                            \
    }                                                                     \
    if (kind == 1) {                                                      \
      if (d <= 64) return (int)FN<__nv_bfloat16, 64>(__VA_ARGS__);        \
      if (d <= 128) return (int)FN<__nv_bfloat16, 128>(__VA_ARGS__);      \
      return (int)FN<__nv_bfloat16, 256>(__VA_ARGS__);                    \
    }                                                                     \
    return (int)cudaErrorInvalidValue;                                    \
  } while (0)

extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int t, int d,
                             float scale, int causal, int kind,
                             void* stream) {
  if (bad_shape(bh, t, d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH(fwd, q, k, v, o, lse, bh, t, d, scale, causal, st);
}

extern "C" int ptt_flash_bwd_dq(const void* q, const void* k,
                                const void* v, const void* dout,
                                const void* lse, const void* delta,
                                void* dq, int bh, int t, int d,
                                float scale, int causal, int kind,
                                void* stream) {
  if (bad_shape(bh, t, d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH(bwd_dq, q, k, v, dout, lse, delta, dq, bh, t, d, scale,
               causal, st);
}

extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 void* dk, void* dv, int bh, int t, int d,
                                 float scale, int causal, int kind,
                                 void* stream) {
  if (bad_shape(bh, t, d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, bh, t, d, scale,
               causal, st);
}

extern "C" const char* ptt_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
