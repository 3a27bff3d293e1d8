// Matmul with fused shifted column statistics for Hopper (sm_90a), plain
// C interface.
//
// Replaces the TPU kernel paddle_tpu/ops/matmul_stats.py:_kernel (launched
// by _fwd_pallas), the epilogue of the 1x1-conv + train-BN fusion
// (ops/conv.py _maybe_conv1x1_bn_fused). With x [M, K], w [N, K] (a 1x1
// conv filter in its own [Co, Ci] layout, so no transposed copy is made),
// c [N] f32:
//   y[m, n]  = sum_k x[m, k] w[n, k]        (f32 accumulation, written in
//                                             x's dtype)
//   s1[n]    = sum_m (y[m, n] - c[n])        (f32)
//   s2[n]    = sum_m (y[m, n] - c[n])^2      (f32)
// The sums are taken from the f32 accumulator, before y is rounded to
// x's dtype, as the TPU kernel takes them. x and w are f32 or bf16 and of
// one type; y is of that type.
//
// Bound: over the 36 launches of one ResNet-50 training step (batch 32,
// 224x224, fp32) the work is 121 GFLOP against 1.96 GB of x, w, c and y
// read or written once: 1.8 ms of fp32 arithmetic (67 TFLOP/s, SIMT)
// against 0.59 ms of bytes (3.35 TB/s), so the step's sum is bound by
// operations; the narrowest shapes (K = N = 64 at M = 100,352) are bound
// by bytes. The design therefore keeps every product in fp32 FMA units
// fed from shared memory by register micro-tiles, and takes the
// statistics from the accumulator registers: y is written once and never
// read again, which is the pass over the conv output that the fusion
// removes.
//
// Design (first version: simple and right):
//   * a shared-memory-tiled SIMT GEMM: one 256-thread block per 128 x 128
//     tile of y, K walked 16 at a time through two shared-memory stages
//     (the next tile is fetched into registers while the current one is
//     multiplied); each thread holds an 8 x 8 micro-tile of accumulators
//     (rows ty*4..+3 and 64+ty*4..+3, columns likewise with tx), so every
//     shared-memory read is a conflict-free float4;
//   * operands are staged as f32 (bf16 converted on load), transposed to
//     [k][row] in shared memory; rows, columns and K past the edges are
//     read as 0 and masked on write, so any M, K and N is taken;
//   * the cross-block reduction differs from the TPU's. There the grid
//     runs in order and s1/s2 carry across row blocks in scratch memory;
//     here row blocks run in parallel, so each block writes its column
//     partials (summed in a fixed order over its 128 rows) to a scratch
//     buffer [2][ceil(M/128)][N] and a second small kernel sums them per
//     column in a fixed order. No atomics: the result is bitwise
//     repeatable run to run.
// Left for a later version: wgmma / mma.sync tensor-core products (TF32
// or bf16, where the numerics contract allows), TMA loads with a deeper
// ring of stages, a persistent grid, and the statistics folded into the
// last block of each column instead of a second launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // rows of y per block
constexpr int BN = 128;      // columns of y per block
constexpr int BK = 16;       // K per shared-memory stage
constexpr int NT = 256;      // threads per block: 16 x 16, 8 x 8 each
constexpr int RC = 8;        // columns per block of the column-sum kernel
constexpr int RG = 32;       // row groups per block of the column-sum kernel

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Eight consecutive elements row[k..k+7] as f32; those at or past kmax
// read as 0. `vec`: 16-byte aligned rows whose length is a multiple of
// 16 bytes, so a whole group inside the row is one or two vector loads.
__device__ __forceinline__ void load8(const float* row, int k, int kmax,
                                      bool vec, float* o) {
  if (vec && k + 8 <= kmax) {
    const float4 a = *reinterpret_cast<const float4*>(row + k);
    const float4 b = *reinterpret_cast<const float4*>(row + k + 4);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = k + j < kmax ? row[k + j] : 0.f;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* row, int k,
                                      int kmax, bool vec, float* o) {
  if (vec && k + 8 <= kmax) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + k);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      o[2 * j] = f.x;
      o[2 * j + 1] = f.y;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[j] = k + j < kmax ? __bfloat162float(row[k + j]) : 0.f;
  }
}

// Four consecutive outputs p[0..3] (columns col..col+3 of one row), the
// ones at or past nmax dropped. `vec`: 16-byte aligned rows whose length
// is a multiple of 4 elements.
__device__ __forceinline__ void store4(float* p, int col, int nmax, bool vec,
                                       const float* v) {
  if (vec && col + 4 <= nmax) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (col + j < nmax) p[j] = v[j];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, int col, int nmax,
                                       bool vec, const float* v) {
  if (vec && col + 4 <= nmax) {
    __nv_bfloat162 pr[2] = {__floats2bfloat162_rn(v[0], v[1]),
                            __floats2bfloat162_rn(v[2], v[3])};
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(pr);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (col + j < nmax) p[j] = __float2bfloat16(v[j]);
  }
}

// One block per 128 x 128 tile of y: the tile, and its column partials of
// s1 and s2 over the tile's (valid) rows into part[0][blockIdx.x][:] and
// part[1][blockIdx.x][:].
template <typename T>
__global__ void __launch_bounds__(NT, 2)
matmul_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ c, T* __restrict__ y,
                    float* __restrict__ part, int m, int k, int n,
                    bool vec_in, bool vec_out) {
  extern __shared__ float smem[];
  float* xs = smem;                     // [2][BK][BM]
  float* ws = smem + 2 * BK * BM;       // [2][BK][BN]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // loader: thread tid fetches row lr of both operand tiles, k-half lh
  const int lr = tid % BM, lh = tid / BM;
  const bool xok = m0 + lr < m, wok = n0 + lr < n;
  const T* xrow = x + (long long)(xok ? m0 + lr : 0) * k;
  const T* wrow = w + (long long)(wok ? n0 + lr : 0) * k;
  float rx[8], rw[8];

  auto fetch = [&](int k0) {
    const int kk = k0 + lh * 8;
    if (xok) {
      load8(xrow, kk, k, vec_in, rx);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) rx[j] = 0.f;
    }
    if (wok) {
      load8(wrow, kk, k, vec_in, rw);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) rw[j] = 0.f;
    }
  };
  auto stage = [&](int s) {
    float* xt = xs + s * BK * BM;
    float* wt = ws + s * BK * BN;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      xt[(lh * 8 + j) * BM + lr] = rx[j];
      wt[(lh * 8 + j) * BN + lr] = rw[j];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int nk = (k + BK - 1) / BK;
  fetch(0);
  stage(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int s = t & 1;
    if (t + 1 < nk) fetch((t + 1) * BK);
    const float* xt = xs + s * BK * BM;
    const float* wt = ws + s * BK * BN;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(xt + kk * BM + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(xt + kk * BM + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(wt + kk * BN + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(wt + kk * BN + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    // the other stage was last read before the previous barrier
    if (t + 1 < nk) stage(s ^ 1);
    __syncthreads();
  }

  // epilogue: y written once; the shifted sums over this thread's valid
  // rows, from the f32 accumulators
  float cv[8], p1[8], p2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
    cv[j] = col < n ? c[col] : 0.f;
    p1[j] = 0.f;
    p2[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row < m) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = acc[i][j] - cv[j];
        p1[j] += d;
        p2[j] = fmaf(d, d, p2[j]);
      }
      T* yrow = y + (long long)row * n;
      const int c0 = n0 + tx * 4, c1 = n0 + 64 + tx * 4;
      if (c0 < n) store4(yrow + c0, c0, n, vec_out, acc[i]);
      if (c1 < n) store4(yrow + c1, c1, n, vec_out, acc[i] + 4);
    }
  }

  // per-column partials across the block's 16 row groups, in order; the
  // operand stages are free again (the loop ended on a barrier)
  float* r1 = smem;                     // [16][BN]
  float* r2 = smem + 16 * BN;           // [16][BN]
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int cl = j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4;
    r1[ty * BN + cl] = p1[j];
    r2[ty * BN + cl] = p2[j];
  }
  __syncthreads();
  const int cl = tid % BN;
  const float* r = tid < BN ? r1 : r2;
  float total = 0.f;
#pragma unroll
  for (int g = 0; g < 16; ++g) total += r[g * BN + cl];
  if (n0 + cl < n) {
    const long long at =
        ((long long)(tid / BN) * gridDim.x + blockIdx.x) * n + n0 + cl;
    part[at] = total;
  }
}

// s[0][col] = sum over row blocks of part[0][:][col], s[1] likewise for
// part[1]; each column summed in one fixed order (32 strided row groups,
// then the groups in turn).
__global__ void __launch_bounds__(RG * RC)
colsum_kernel(const float* __restrict__ part, float* __restrict__ s,
              int gm, int n) {
  __shared__ float red[2][RG][RC];
  const int cl = threadIdx.x % RC, g = threadIdx.x / RC;
  const int col = blockIdx.x * RC + cl;
  float a1 = 0.f, a2 = 0.f;
  if (col < n) {
    for (int r = g; r < gm; r += RG) {
      a1 += part[(long long)r * n + col];
      a2 += part[((long long)gm + r) * n + col];
    }
  }
  red[0][g][cl] = a1;
  red[1][g][cl] = a2;
  __syncthreads();
  if (threadIdx.x < 2 * RC) {
    const int which = threadIdx.x / RC, c2 = threadIdx.x % RC;
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < RG; ++i) total += red[which][i][c2];
    const int oc = blockIdx.x * RC + c2;
    if (oc < n) s[(long long)which * n + oc] = total;
  }
}

// Raise a kernel's dynamic shared-memory cap to `smem` bytes, once per
// kernel and size: `granted` remembers the largest cap set so far (each
// template instantiation has its own).
template <typename F>
cudaError_t prepare(F fn, size_t smem, size_t& granted) {
  if (smem <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) granted = smem;
  return err;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t run(const void* x, const void* w, const void* c, void* y,
                void* part, void* s, int m, int k, int n, cudaStream_t st) {
  const int gm = (m + BM - 1) / BM, gn = (n + BN - 1) / BN;
  const size_t smem = sizeof(float) * 2 * BK * (BM + BN);
  auto fn = matmul_stats_kernel<T>;
  static size_t granted = 0;
  cudaError_t err = prepare(fn, smem, granted);
  if (err != cudaSuccess) return err;
  const bool vec_in = k % (16 / (int)sizeof(T)) == 0 && aligned16(x) &&
                      aligned16(w);
  const bool vec_out = n % 4 == 0 && aligned16(y);
  fn<<<dim3(gm, gn), NT, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(c), static_cast<T*>(y),
      static_cast<float*>(part), m, k, n, vec_in, vec_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum_kernel<<<(n + RC - 1) / RC, RG * RC, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(s), gm, n);
  return cudaGetLastError();
}

}  // namespace

// x [m, k], w [n, k] (kind 0 = f32, 1 = bf16, both one type), c [n] f32;
// writes y [m, n] (x's type), the scratch part [2][ceil(m/128)][n] f32
// and s [2][n] f32 (s1, s2). Returns the cudaError_t of the launches
// (0 = launched); they are asynchronous on `stream`.
extern "C" int ptt_matmul_stats(const void* x, const void* w, const void* c,
                                void* y, void* part, void* s, int m, int k,
                                int n, int kind, void* stream) {
  if (m < 1 || k < 1 || n < 1 || (n + BN - 1) / BN > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) return (int)run<float>(x, w, c, y, part, s, m, k, n, st);
  if (kind == 1) {
    return (int)run<__nv_bfloat16>(x, w, c, y, part, s, m, k, n, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ptt_matmul_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
