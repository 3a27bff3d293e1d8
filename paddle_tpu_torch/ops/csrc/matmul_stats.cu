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
// read or written once. On the TF32 tensor cores (495 TFLOP/s) the
// operations take 0.24 ms and the bytes 0.59 ms at 3.35 TB/s, so the
// step's sum is bound by bytes (the first, fp32-SIMT version was bound by
// its 1.8 ms of fp32 arithmetic at 67 TFLOP/s); the 3xTF32 emulation's
// extra MMAs are not counted as work. The statistics come from the
// accumulator registers: y is written once and never read again, which
// is the pass over the conv output that the fusion removes.
// Measured there (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py and
// paddle_tpu_torch/tools/kernel_trials.py, device time alone): ~3.49 ms
// per step, 5.9x the bound, against ~3.56 ms for torch.matmul's fp32
// product alone (with the host's gaps between calls ~3.56 against
// ~3.57); the first version took 5.08 ms timed the same way. By the
// tool's diagnostic builds, the two extra 3xTF32 MMAs take ~0.9 ms, the
// zeroed fragments ~0.4 and the splits ~0.4; truncating big and leaving
// small to the MMA would save 0.2 ms and keep x only to 2^-20, and
// splitting each element once per block instead of per warp measured
// slower (4.32 ms).
//
// Design:
//   * products on the tensor cores with mma.sync. f32 runs 3xTF32
//     m16n8k8 at fp32 accuracy: as a warp loads its fragments, each
//     operand x splits into big = tf32(x) and small = tf32(x - big), both
//     rounded to nearest (x kept to 2^-22), and c += a b is taken as
//     small*big + big*small, then big*big, into a zeroed fragment that an
//     f32 add carries into the accumulator each k8 step (the tensor core
//     truncates as it accumulates; chained over K = 2,048 that biased y
//     by ~4e-5). bf16 runs one m16n8k16 bf16 MMA, whose products are
//     exact in f32;
//   * both operands are K-major (x [M, K], w [N, K]), so each fragment is
//     read along a staged row. K goes through a three-stage ring of
//     16-byte cp.async copies, 128 bytes of K per stage (32 f32 or 64
//     bf16), slices i+1 and i+2 loading while slice i multiplies; rows
//     padded by 16 bytes (36 floats = 72 bf16 = 4 mod 8 words) keep every
//     fragment read conflict-free. Rows past M or N, and K past its end,
//     land as zeros (src-size 0); a K that is not a multiple of 16 bytes
//     (or unaligned storage) is staged element by element instead;
//   * tiles that fill the card: 128 x 128 (8 warps of 64 x 32), 128 x 64
//     or 64 x 64 (4 warps of 64 x 32 or 32 x 32) per block, the largest
//     whose grid has a block for every SM, chosen per (M, N) on the host
//     (pick_tile); at ResNet-50's M = 6,272 and 1,568 the 128 x 128 grid
//     has 98 and 52 blocks;
//   * the epilogue works from the C fragments (a lane holds rows g, g+8,
//     columns 2t, 2t+1 of each 16 x 8 tile): y written once, s1 and s2
//     summed over the lane's rows, then over the warp's row groups by
//     shuffles, then over the block's warp rows through shared memory;
//   * the cross-block reduction differs from the TPU's. There the grid
//     runs in order and s1/s2 carry across row blocks in scratch memory;
//     here row blocks run in parallel, so each block writes its column
//     partials to a scratch buffer [2][ceil(M/BM)][N] and a second small
//     kernel sums them per column. Every sum runs in a fixed order and
//     there are no atomics: the result is bitwise repeatable run to run.
// Left for a later version: wgmma (both operands are K-major, so TF32
// wgmma takes them as staged), TMA loads, a persistent grid, the
// statistics folded into the last block of each column instead of a
// second launch, and reading x straight from NCHW.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NS = 3;        // stages of the cp.async ring
constexpr int WN = 32;       // columns of y per warp
constexpr int RC = 8;        // columns per block of the column-sum kernel
constexpr int RG = 32;       // row groups per block of the column-sum kernel

// Tile classes: BM x BN of y per block, WM rows per warp (warps are laid
// out (BM / WM) x (BN / WN)), MINB blocks per SM for ptxas's register cap.
template <int BM, int BN> struct Tile;
template <> struct Tile<128, 128> { static constexpr int WM = 64, MINB = 2; };
template <> struct Tile<128, 64> { static constexpr int WM = 64, MINB = 2; };
template <> struct Tile<64, 64> { static constexpr int WM = 32, MINB = 3; };

template <int BM, int BN>
__host__ __device__ constexpr int threads() { return 32 * (BM / Tile<BM, BN>::WM) * (BN / WN); }

// ---------------------------------------------------------------------
// cp.async staging, the TF32 split and mma.sync (the same building
// blocks as flash_attention.cu's).

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, cached in L2 only; src_bytes = 0 reads
// nothing and zero-fills the 16 bytes.
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x = big + small, both rounded to nearest TF32 (ties away from zero) as
// flash_attention.cu's to_tf32 rounds them, so x is carried to 2^-22 of
// |x|: big = x with half a TF32 ulp added to its magnitude bits and the
// 13 low bits cleared; small = x - big (exact in f32) with half a TF32
// ulp added. The MMA reads only the top 19 bits of a TF32 operand, so it
// clears small's low bits itself: four operations per element (clearing
// them here as well gives bitwise-equal y, s1 and s2 on the card; the
// trials tool's "small masked" build).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

struct FragA { uint32_t big[4], small[4]; };   // 16 x 8, row-major
struct FragB { uint32_t big[2], small[2]; };   // 8 x 8, column-major

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b at fp32 accuracy: small*big and big*small, then big*big, into
// a zeroed fragment that one f32 add per element (rounded to nearest)
// carries into c. The tensor core truncates as it accumulates, so three
// MMAs a k8 step into c itself bias y by ~0.5 ulp each: at K = 2,048 that
// is ~4e-5 of |y|, past the fp32 tolerance.
__device__ __forceinline__ void mma3(float* c, const FragA& a,
                                     const FragB& b) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e];
}

// bf16 products are exact in f32: one m16n8k16 MMA.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16(a);
}

// One K-slice of the warp's WM x WN product: xs holds the warp's WM rows
// of x, ws its WN rows of w (= columns of y), each [rows][LD], K along
// the row. A lane holds rows g, g+8 and columns 2t, 2t+1 of each 16 x 8
// tile of y.
template <int MI, int NI, int BK, int LD>
__device__ __forceinline__ void slice_mma(float (&acc)[MI][NI][4],
                                          const float* xs, const float* ws,
                                          int g, int tq) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    FragB b[NI];
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const float* p = ws + (8 * ni + g) * LD + 8 * kk + tq;
      split(p[0], b[ni].big[0], b[ni].small[0]);
      split(p[4], b[ni].big[1], b[ni].small[1]);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const float* p = xs + (16 * mi + g) * LD + 8 * kk + tq;
      FragA a;
      split(p[0], a.big[0], a.small[0]);
      split(p[8 * LD], a.big[1], a.small[1]);
      split(p[4], a.big[2], a.small[2]);
      split(p[8 * LD + 4], a.big[3], a.small[3]);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma3(acc[mi][ni], a, b[ni]);
    }
  }
}

template <int MI, int NI, int BK, int LD>
__device__ __forceinline__ void slice_mma(float (&acc)[MI][NI][4],
                                          const __nv_bfloat16* xs,
                                          const __nv_bfloat16* ws, int g,
                                          int tq) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const __nv_bfloat16* p = xs + (16 * mi + g) * LD + 16 * kk + 2 * tq;
      a[mi][0] = ld32(p);
      a[mi][1] = ld32(p + 8 * LD);
      a[mi][2] = ld32(p + 8);
      a[mi][3] = ld32(p + 8 * LD + 8);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const __nv_bfloat16* p = ws + (8 * ni + g) * LD + 16 * kk + 2 * tq;
      const uint32_t b[2] = {ld32(p), ld32(p + 8)};
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) mma_bf16(acc[mi][ni], a[mi], b);
    }
  }
}

// One block per BM x BN tile of y: the tile, and its column partials of
// s1 and s2 over the tile's (valid) rows into part[0][blockIdx.x][:] and
// part[1][blockIdx.x][:]. vec_in: x and w 16-byte aligned with K a
// multiple of 16 bytes (every 16-byte chunk of a row lies wholly inside
// or outside K); vec_out: y 8-byte aligned (4 for bf16) with N even.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(threads<BM, BN>(), Tile<BM, BN>::MINB)
matmul_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ c, T* __restrict__ y,
                    float* __restrict__ part, int m, int k, int n,
                    bool vec_in, bool vec_out) {
  constexpr int WM = Tile<BM, BN>::WM, MI = WM / 16, NI = WN / 8;
  constexpr int NWM = BM / WM, NWN = BN / WN, NTH = threads<BM, BN>();
  // K per stage: 32 f32 or 64 bf16 (128 bytes a row), rows padded by 16
  // bytes (LD = 36 floats = 72 bf16 = 4 mod 8 words: conflict-free
  // fragment reads)
  constexpr int BK = 128 / sizeof(T), LD = BK + 16 / sizeof(T);
  constexpr int STAGE = (BM + BN) * LD;      // elements per stage
  extern __shared__ float4 mm_smem[];
  T* smem = reinterpret_cast<T*>(mm_smem);   // NS x {x [BM], w [BN]} x LD
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int warp = threadIdx.x / 32, wm = warp / NWN, wn = warp % NWN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (k + BK - 1) / BK;

  // rows 0..BM-1 of a stage are x's rows m0.., rows BM.. are w's n0..;
  // rows past M or N and K past its end land as zeros. The loops stay
  // rolled: unrolled, ptxas holds every chunk's address across the K loop
  // and spills the accumulators
  auto stage = [&](int kt, int buf) {
    T* dst = smem + buf * STAGE;
    const int k0 = kt * BK;
    if (vec_in) {
      constexpr int V = 16 / sizeof(T), PER = BK / V;
#pragma unroll 1
      for (int e = threadIdx.x; e < (BM + BN) * PER; e += NTH) {
        const int r = e / PER, cc = (e % PER) * V;
        const bool is_x = r < BM;
        const int row = is_x ? m0 + r : n0 + r - BM;
        const bool in = row < (is_x ? m : n) && k0 + cc < k;
        const T* src = (is_x ? x : w) + (in ? (long long)row * k + k0 + cc
                                            : 0);
        cp16(dst + r * LD + cc, src, in ? 16 : 0);
      }
    } else {
#pragma unroll 1
      for (int e = threadIdx.x; e < (BM + BN) * BK; e += NTH) {
        const int r = e / BK, cc = e % BK;
        const bool is_x = r < BM;
        const int row = is_x ? m0 + r : n0 + r - BM;
        const bool in = row < (is_x ? m : n) && k0 + cc < k;
        dst[r * LD + cc] = in ? (is_x ? x : w)[(long long)row * k + k0 + cc]
                              : zero_of(T());
      }
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nk) stage(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<NS - 2>();   // slice kt has landed
    __syncthreads();     // ... for every thread; slice kt-1 is consumed
    if (kt + NS - 1 < nk) stage(kt + NS - 1, (kt + NS - 1) % NS);
    cp_commit();
    const T* xs = smem + (kt % NS) * STAGE;
    slice_mma<MI, NI, BK, LD>(acc, xs + wm * WM * LD,
                              xs + (BM + wn * WN) * LD, g, tq);
  }
  cp_wait<0>();
  __syncthreads();       // the stages are free for the reduction below

  // epilogue: y written once; the shifted sums over the lane's valid
  // rows from the f32 accumulators, then over the warp's 8 row groups by
  // shuffles, then over the block's NWM warp rows in order
  float* red = reinterpret_cast<float*>(mm_smem);   // [2][NWM][BN]
  const int rw = m0 + wm * WM;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int cl = wn * WN + 8 * ni + 2 * tq, col = n0 + cl;
    const float c0 = col < n ? c[col] : 0.f;
    const float c1 = col + 1 < n ? c[col + 1] : 0.f;
    float s1a = 0.f, s1b = 0.f, s2a = 0.f, s2b = 0.f;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rw + 16 * mi + 8 * h + g;
        if (row < m) {
          const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
          const float d0 = v0 - c0, d1 = v1 - c1;
          s1a += d0;
          s1b += d1;
          s2a = fmaf(d0, d0, s2a);
          s2b = fmaf(d1, d1, s2b);
          T* yp = y + (long long)row * n + col;
          if (vec_out && col + 1 < n) {
            store2(yp, v0, v1);
          } else {
            if (col < n) store1(yp, v0);
            if (col + 1 < n) store1(yp + 1, v1);
          }
        }
      }
#pragma unroll
    for (int xo = 4; xo <= 16; xo *= 2) {
      s1a += __shfl_xor_sync(0xffffffffu, s1a, xo);
      s1b += __shfl_xor_sync(0xffffffffu, s1b, xo);
      s2a += __shfl_xor_sync(0xffffffffu, s2a, xo);
      s2b += __shfl_xor_sync(0xffffffffu, s2b, xo);
    }
    if (g == 0) {
      red[wm * BN + cl] = s1a;
      red[wm * BN + cl + 1] = s1b;
      red[(NWM + wm) * BN + cl] = s2a;
      red[(NWM + wm) * BN + cl + 1] = s2b;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * BN; e += NTH) {
    const int which = e / BN, cl = e % BN;
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < NWM; ++i) total += red[(which * NWM + i) * BN + cl];
    if (n0 + cl < n) {
      part[((long long)which * gridDim.x + blockIdx.x) * n + n0 + cl] =
          total;
    }
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

int sm_count() {
  static int sms = 0;
  if (sms <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0) {
      sms = 132;
    }
  }
  return sms;
}

long long blocks(int m, int n, int bm, int bn) {
  return (long long)((m + bm - 1) / bm) * ((n + bn - 1) / bn);
}

// The tile of y per block for an (M, N): 128 x 128 when it fills every SM
// (and N > 64, which would leave half of each tile empty), else 128 x 64
// when that does, else 64 x 64.
void pick_tile(int m, int n, int& bm, int& bn) {
  const int sms = sm_count();
  if (n > 64 && blocks(m, n, 128, 128) >= sms) {
    bm = 128; bn = 128;
  } else if (blocks(m, n, 128, 64) >= sms) {
    bm = 128; bn = 64;
  } else {
    bm = 64; bn = 64;
  }
}

template <typename T, int BM, int BN>
cudaError_t launch(const void* x, const void* w, const void* c, void* y,
                   void* part, int m, int k, int n, bool vec_in,
                   bool vec_out, cudaStream_t st) {
  constexpr int LD = 128 / sizeof(T) + 16 / sizeof(T);
  const size_t smem = sizeof(T) * NS * (BM + BN) * LD;
  auto fn = matmul_stats_kernel<T, BM, BN>;
  static size_t granted = 0;
  cudaError_t err = prepare(fn, smem, granted);
  if (err != cudaSuccess) return err;
  fn<<<dim3((m + BM - 1) / BM, (n + BN - 1) / BN), threads<BM, BN>(), smem,
       st>>>(static_cast<const T*>(x), static_cast<const T*>(w),
             static_cast<const float*>(c), static_cast<T*>(y),
             static_cast<float*>(part), m, k, n, vec_in, vec_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, const void* w, const void* c, void* y,
                void* part, void* s, int m, int k, int n, cudaStream_t st) {
  const bool vec_in = k % (16 / (int)sizeof(T)) == 0 && aligned16(x) &&
                      aligned16(w);
  const bool vec_out = n % 2 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % (2 * sizeof(T)) == 0;
  int bm, bn;
  pick_tile(m, n, bm, bn);
  cudaError_t err;
  if (bm == 128 && bn == 128) {
    err = launch<T, 128, 128>(x, w, c, y, part, m, k, n, vec_in, vec_out, st);
  } else if (bm == 128) {
    err = launch<T, 128, 64>(x, w, c, y, part, m, k, n, vec_in, vec_out, st);
  } else {
    err = launch<T, 64, 64>(x, w, c, y, part, m, k, n, vec_in, vec_out, st);
  }
  if (err != cudaSuccess) return err;
  colsum_kernel<<<(n + RC - 1) / RC, RG * RC, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(s),
      (m + bm - 1) / bm, n);
  return cudaGetLastError();
}

}  // namespace

// x [m, k], w [n, k] (kind 0 = f32, 1 = bf16, both one type), c [n] f32;
// writes y [m, n] (x's type), the scratch part [2][ceil(m/64)][n] f32
// (the rows of it that the chosen tile needs) and s [2][n] f32 (s1, s2).
// Returns the cudaError_t of the launches (0 = launched); they are
// asynchronous on `stream`.
extern "C" int ptt_matmul_stats(const void* x, const void* w, const void* c,
                                void* y, void* part, void* s, int m, int k,
                                int n, int kind, void* stream) {
  if (m < 1 || k < 1 || n < 1 || (n + 63) / 64 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) return (int)run<float>(x, w, c, y, part, s, m, k, n, st);
  if (kind == 1) {
    return (int)run<__nv_bfloat16>(x, w, c, y, part, s, m, k, n, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The tile ptt_matmul_stats picks for an (m, n) on the current card:
// writes its rows and columns, returns its number of blocks.
extern "C" long long ptt_matmul_stats_tile(int m, int n, int* bm, int* bn) {
  pick_tile(m, n, *bm, *bn);
  return blocks(m, n, *bm, *bn);
}

extern "C" const char* ptt_matmul_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
