// Flash attention forward and backward for Hopper (sm_90a), plain C
// interface.
//
// Replaces the three TPU kernels of paddle_tpu/ops/flash_attention.py:
//   _fwd_kernel     (:68, launched by _fwd_pallas)  -> flash_fwd_kernel
//   _bwd_dq_kernel  (:163, launched by _bwd_pallas) -> flash_bwd_dq_kernel
//   _bwd_dkv_kernel (:202, launched by _bwd_pallas) -> flash_bwd_dkv_kernel
// The dQ kernel also takes the place of the jnp prologue of _bwd_pallas
// that computes delta.
//
// Shapes: q, k, v, o, do, dq, dk, dv are [BH, T, D] (B*H heads of one
// sequence length, row-major, contiguous), f32 or bf16; lse, dlse and
// delta are [BH, T] f32. With scale s and the causal mask (key j attends
// to query r iff j <= r), masked scores set to -1e30:
//   forward:  S = s Q K^T, O = softmax(S) V, LSE = m + log l per row
//   backward: delta = rowsum(dO * O) - dLSE, P = exp(S - LSE),
//             dP = dO V^T, dS = P (dP - delta) s,
//             dQ = dS K, dK = dS^T Q, dV = P^T dO.
// The backward is two launches on one stream: dQ (which writes delta),
// then dK/dV (which reads it). No atomics: bitwise repeatable.
//
// Bounds on an H100 SXM at the LM's training shape (B=32, H=8, T=256,
// D=64, causal, fp32):
//   * forward: fp32 arithmetic (4 T(T+1)/2 D flops per head at 67
//     TFLOP/s, 0.032 ms), since its products run on the fp32 FMA units;
//   * dQ and dK/dV: bytes (each reads and writes ~101 MB: 0.030 ms at
//     3.35 TB/s). Their products run on the TF32 tensor cores, where the
//     algorithm's 3 (dQ) and 4 (dK/dV) products take 0.0065 / 0.0087 ms
//     at 495 TFLOP/s.
// Measured there (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py and
// paddle_tpu_torch/tools/flash_bwd_trials.py): dQ ~0.137 ms and dK/dV
// ~0.155 ms, 4.5x / 5.1x the bound, down from 0.27 / 0.39 ms for the
// first (fp32-SIMT) version. By the trials tool's diagnostic builds, the
// TF32 splits take about a quarter of that and the two extra MMAs of
// 3xTF32 with their splits about two fifths.
//
// Forward design (first version, still SIMT): 128 threads as 16 row
// groups x 8 column groups; one block per (head, tile of 64/32/16 query
// rows for D <= 64/128/256), looping over tiles of 64 keys up to the
// diagonal with an online softmax; tiles staged in shared memory as f32,
// rows padded to D+1 floats; every product a scalar fmaf. Left for a
// later version: tensor-core products and staged copies, as the backward
// has them.
//
// Backward design:
//   * every product on the tensor cores with mma.sync m16n8k8 TF32 at
//     fp32 accuracy (3xTF32): each f32 operand x splits into
//     big = tf32(x) and small = tf32(x - big), both rounded to nearest
//     with ties away (cvt.rna's rounding, done in integer operations),
//     and c += a b is taken as
//     small*big + big*small, then big*big, into f32 accumulators (the
//     small*small term is below fp32's rounding). bf16 data is exact in
//     TF32, so an operand read from bf16 has no small part and its term
//     is skipped: S and dP are one MMA for bf16 inputs, the products with
//     the in-kernel P and dS two. mma.sync, not wgmma: wgmma takes TF32
//     operands only K-major, which P^T dO and dS^T Q are not;
//   * each warp owns 16 rows of the block's tile (query rows in dQ, key
//     rows in dK/dV); its accumulators and its S/dP fragments stay in
//     registers. The C fragment of S/dP becomes the A fragment of the
//     next product in place: a thread holds columns 2t and 2t+1 of each
//     8-column slab, so those play k slots t and t+4, and the B operand
//     reads rows 2t and 2t+1 in their place. No shared-memory round trip;
//   * staging: 16-byte cp.async (.cg) loads into shared memory, rows past
//     T zero-filled by the src-size operand; the resident tile (Q and dO,
//     or K and V) loads once; the streamed tiles (K/V, or Q/dO with lse
//     and delta) go through a two-stage ring, tile i+1 loading while tile
//     i computes. Rows are padded by 16 bytes (ld = D+4 f32, D+8 bf16;
//     row starts stay 16-byte aligned for cp.async). With ld = 4 mod 8
//     floats every fragment read is conflict-free: the A and n-major B
//     reads (row g, column t) hit bank 4g'+t with 4g' = g ld mod 32, all
//     distinct; the k-major B reads (rows 2t, column g) hit 2t ld + g with
//     2 ld = 8 mod 16, also all distinct. In bf16 two lanes share each
//     32-bit word, and the same reckoning holds for words where D is a
//     multiple of 16;
//   * delta is computed by the dQ block for its own query rows (it holds
//     those dO rows already; O and dLSE are read once) and written to a
//     [BH, T] buffer for the dK/dV kernel;
//   * P = exp2(S s log2e - LSE log2e): one FMA and one exp2 per element;
//   * dQ: one block per (head, query tile), walking key tiles up to the
//     diagonal; dK/dV: one block per (head, key tile), walking query
//     tiles from the diagonal. blockIdx.x is the head and blockIdx.y the
//     tile rank, so the whole grid launches its longest blocks first (dQ:
//     the query tiles nearest T; dK/dV: the key tiles nearest 0), and a
//     warp skips a tile the causal mask empties for its 16 rows;
//   * D is any multiple of 8 up to 256, three register classes: dQ 4
//     warps x 16 rows with 32-key tiles (D <= 128), 2 warps with 16-key
//     tiles (D <= 256); dK/dV 4 warps x 16 keys with 32-query tiles
//     (D <= 128), and for D <= 256 two warps per 16 keys with 16-query
//     tiles, each warp accumulating half of D (both compute the shared S
//     and dP). At D = 64, fp32, that is ~70 KB of shared memory and 147
//     (dQ) / 166 (dK/dV) registers: 3 blocks of 4 warps per SM.
// Left for a later version: splitting each staged element once per block
// instead of once per warp that reads it (it costs shared memory, and
// with it a block per SM), wgmma with K-major staging of the transposed
// operands, TMA loads, warp specialisation, a persistent grid.

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
constexpr float LOG2E = 1.4426950408889634f;   // the backward's exp2 base

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
// Building blocks of the backward kernels: cp.async staging and 3xTF32
// tensor-core products.

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

__device__ __forceinline__ void cp4(void* dst, const void* src,
                                    int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
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

// Stage rows row0 .. row0+n-1 of one head's [T, D] slab into dst (row
// stride ld elements), 16 bytes per cp.async; rows at or past T read
// nothing and land as zeros.
template <typename T, int NTH>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src,
                                           int row0, int n, int t, int d,
                                           T* dst, int ld) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = d / V;
  for (int e = threadIdx.x; e < n * per_row; e += NTH) {
    const int r = e / per_row, c = (e % per_row) * V;
    const bool in = row0 + r < t;
    cp16(dst + r * ld + c, src + (long long)(in ? row0 + r : 0) * d + c,
         in ? 16 : 0);
  }
}

// Stage per-row statistics (lse or delta) of rows row0 .. row0+n-1.
template <int NTH>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int row0, int n, int t,
                                           float* dst) {
  for (int e = threadIdx.x; e < n; e += NTH) {
    const bool in = row0 + e < t;
    cp4(dst + e, src + (in ? row0 + e : 0), in ? 4 : 0);
  }
}

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// cvt.rna.tf32.f32 (nearest, ties away from zero) as two integer
// operations: add half a TF32 ulp to the magnitude bits, clear the 13
// bits TF32 drops. The same bits as cvt for every finite x, on the
// integer pipe instead of the slower conversion unit (dQ + dK/dV at the
// LM training shape on an H100 80GB HBM3, 700 W: 0.288 ms so, 0.369
// with cvt; paddle_tpu_torch/tools/flash_bwd_trials.py).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small to ~2^-22 of x: both TF32 (round to nearest, ties away).
// EXACT: x is already a TF32 value (read from bf16), small is zero and
// unused.
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  if (EXACT) {
    big = __float_as_uint(x);
  } else {
    big = to_tf32(x);
    small = to_tf32(x - __uint_as_float(big));
  }
}

struct FragA { uint32_t big[4], small[4]; };   // 16 x 8, row-major
struct FragB { uint32_t big[2], small[2]; };   // 8 x 8, column-major

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b at fp32 accuracy: small*big and big*small first, then big*big.
// An EXACT operand has no small part, so its term is skipped.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float* c, const FragA& a,
                                     const FragB& b) {
  if (!A_EXACT) mma(c, a.small, b.big);
  if (!B_EXACT) mma(c, a.big, b.small);
  mma(c, a.big, b.big);
}

// A fragment of rows row, row+8 and columns col, col+4 of a shared tile
// (row = the warp's first row + g, col = 8 kk + t).
template <bool EXACT, typename T>
__device__ __forceinline__ void frag_a(FragA& f, const T* s, int ld,
                                       int row, int col) {
  const T* p = s + row * ld + col;
  split<EXACT>(ldf(p), f.big[0], f.small[0]);
  split<EXACT>(ldf(p + 8 * ld), f.big[1], f.small[1]);
  split<EXACT>(ldf(p + 4), f.big[2], f.small[2]);
  split<EXACT>(ldf(p + 8 * ld + 4), f.big[3], f.small[3]);
}

// B fragment whose n index runs over the tile's rows: B(k, n) =
// s[n][k], n = nrow (+ g), k = kcol, kcol + 4 (kcol = 8 kk + t).
template <bool EXACT, typename T>
__device__ __forceinline__ void frag_b_nrows(FragB& f, const T* s, int ld,
                                             int nrow, int kcol) {
  const T* p = s + nrow * ld + kcol;
  split<EXACT>(ldf(p), f.big[0], f.small[0]);
  split<EXACT>(ldf(p + 4), f.big[1], f.small[1]);
}

// B fragment whose k index runs over the tile's rows, for an A fragment
// made from a C fragment (frag_a_from_c): k slots t and t+4 are rows
// krow = 8 j + 2t and krow + 1; n = ncol (= 8 nt + g).
template <bool EXACT, typename T>
__device__ __forceinline__ void frag_b_krows(FragB& f, const T* s, int ld,
                                             int krow, int ncol) {
  const T* p = s + krow * ld + ncol;
  split<EXACT>(ldf(p), f.big[0], f.small[0]);
  split<EXACT>(ldf(p + ld), f.big[1], f.small[1]);
}

// The C fragment of one 16 x 8 slab (columns 2t, 2t+1 of rows g, g+8) as
// the A fragment of a k8 step whose slots t, t+4 are those columns.
__device__ __forceinline__ void frag_a_from_c(FragA& f, const float* c) {
  split<false>(c[0], f.big[0], f.small[0]);
  split<false>(c[2], f.big[1], f.small[1]);
  split<false>(c[1], f.big[2], f.small[2]);
  split<false>(c[3], f.big[3], f.small[3]);
}

// dQ: NW warps of 16 query rows, COLS keys per streamed tile; MINB
// blocks per SM, as many as the shared memory admits (it caps ptxas's
// registers at 64K / (MINB * 32 NW), with no spills at these shapes).
template <int DC> struct DqCfg;
template <> struct DqCfg<64> {
  static constexpr int NW = 4, COLS = 32, MINB = 3;
};
template <> struct DqCfg<128> {
  static constexpr int NW = 4, COLS = 32, MINB = 1;
};
template <> struct DqCfg<256> {
  static constexpr int NW = 2, COLS = 16, MINB = 1;
};

// dK/dV: NW warps; each 16 key rows are shared by DSPLIT warps, each
// accumulating DC / DSPLIT columns of dK and dV; COLS queries per tile.
template <int DC> struct DkvCfg;
template <> struct DkvCfg<64> {
  static constexpr int NW = 4, DSPLIT = 1, COLS = 32, MINB = 3;
};
template <> struct DkvCfg<128> {
  static constexpr int NW = 4, DSPLIT = 1, COLS = 32, MINB = 1;
};
template <> struct DkvCfg<256> {
  static constexpr int NW = 4, DSPLIT = 2, COLS = 16, MINB = 1;
};

// ---------------------------------------------------------------------
template <typename T, int DC>
__global__ void __launch_bounds__(32 * DqCfg<DC>::NW, DqCfg<DC>::MINB)
flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ o,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dlse, float* __restrict__ delta,
    T* __restrict__ dq, int t, int d, float scale, int causal) {
  constexpr int NW = DqCfg<DC>::NW, NTH = 32 * NW, ROWS = 16 * NW;
  constexpr int COLS = DqCfg<DC>::COLS, NJ = COLS / 8, DN = DC / 8;
  constexpr bool EXACT = sizeof(T) == 2;   // bf16: exact in TF32
  extern __shared__ float4 bwd_smem[];
  const int ld = d + 16 / (int)sizeof(T);
  T* q_s = reinterpret_cast<T*>(bwd_smem);  // [ROWS][ld]   resident
  T* do_s = q_s + ROWS * ld;                // [ROWS][ld]   resident
  T* kv_s = do_s + ROWS * ld;               // 2 x {K, V} x [COLS][ld]
  float* dl_s = reinterpret_cast<float*>(kv_s + 4 * COLS * ld);  // [ROWS]
  const int bh = blockIdx.x;
  const int nqt = (t + ROWS - 1) / ROWS;
  const int q0 = (causal ? nqt - 1 - (int)blockIdx.y : (int)blockIdx.y) *
                 ROWS;
  const long long base = (long long)bh * t * d, rbase = (long long)bh * t;
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;   // the warp's first row
  const int nd8 = d / 8;

  stage_tile<T, NTH>(q + base, q0, ROWS, t, d, q_s, ld);
  stage_tile<T, NTH>(dout + base, q0, ROWS, t, d, do_s, ld);
  cp_commit();
  const int last = min(q0 + ROWS, t) - 1;
  const int nkt = causal ? last / COLS + 1 : (t + COLS - 1) / COLS;
  auto stage_kv = [&](int kt, int buf) {
    T* ks = kv_s + buf * 2 * COLS * ld;
    stage_tile<T, NTH>(k + base, kt * COLS, COLS, t, d, ks, ld);
    stage_tile<T, NTH>(v + base, kt * COLS, COLS, t, d, ks + COLS * ld, ld);
  };
  stage_kv(0, 0);
  cp_commit();
  cp_wait<1>();        // Q and dO have landed; K/V tile 0 is in flight
  __syncthreads();

  // delta = rowsum(dO * O) - dLSE for the warp's 16 rows: two lanes per
  // row, each summing half of D with 4-wide loads issued back to back
  {
    const int row = wr + lane / 2, r = q0 + row;
    const int half = d / 2, c0 = (lane & 1) * half;
    float sum = 0.f;
    if (r < t) {
      const T* orow = o + base + (long long)r * d;
#pragma unroll 4
      for (int c = c0; c < c0 + half; c += 4) {
        float x[4], y[4];
        load4(do_s + row * ld + c, x);
        load4(orow + c, y);
#pragma unroll
        for (int i = 0; i < 4; ++i) sum = fmaf(x[i], y[i], sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((lane & 1) == 0) {
      float dl = 0.f;
      if (r < t) {
        dl = sum - (dlse ? dlse[rbase + r] : 0.f);
        delta[rbase + r] = dl;
      }
      dl_s[row] = dl;
    }
  }
  __syncwarp();
  const int r_lo = q0 + wr + g, r_hi = r_lo + 8;   // the fragment rows
  const float dl_lo = dl_s[wr + g], dl_hi = dl_s[wr + g + 8];
  // P = exp(S s - LSE) = exp2(S s log2e - LSE log2e)
  const float sl2 = scale * LOG2E;
  const float lse_lo = r_lo < t ? lse[rbase + r_lo] * LOG2E : 0.f;
  const float lse_hi = r_hi < t ? lse[rbase + r_hi] * LOG2E : 0.f;

  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) stage_kv(kt + 1, (kt + 1) & 1);
    cp_commit();
    cp_wait<1>();      // tile kt has landed; tile kt+1 is in flight
    __syncthreads();
    const T* ks = kv_s + (kt & 1) * 2 * COLS * ld;
    const T* vs = ks + COLS * ld;
    const int k0 = kt * COLS;
    // a tile whose keys all lie above the warp's rows adds nothing
    if (!(causal && k0 > q0 + wr + 15)) {
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DN; ++kk) {
        if (kk < nd8) {
          FragA aq, ado;
          frag_a<EXACT>(aq, q_s, ld, wr + g, 8 * kk + tq);
          frag_a<EXACT>(ado, do_s, ld, wr + g, 8 * kk + tq);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            FragB bk, bv;
            frag_b_nrows<EXACT>(bk, ks, ld, 8 * j + g, 8 * kk + tq);
            frag_b_nrows<EXACT>(bv, vs, ld, 8 * j + g, 8 * kk + tq);
            mma3<EXACT, EXACT>(s[j], aq, bk);
            mma3<EXACT, EXACT>(dp[j], ado, bv);
          }
        }
      }
      // dS in place of S
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? r_lo : r_hi;
          const int key = k0 + 8 * j + 2 * tq + (e & 1);
          const bool live = key < t && r < t && !(causal && key > r);
          const float p = live ? exp2f(fmaf(s[j][e], sl2,
                                            -(e < 2 ? lse_lo : lse_hi)))
                               : 0.f;
          s[j][e] = p * (dp[j][e] - (e < 2 ? dl_lo : dl_hi)) * scale;
        }
      // dQ += dS K
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        FragA a;
        frag_a_from_c(a, s[j]);
#pragma unroll
        for (int n = 0; n < DN; ++n) {
          if (n < nd8) {
            FragB b;
            frag_b_krows<EXACT>(b, ks, ld, 8 * j + 2 * tq, 8 * n + g);
            mma3<false, EXACT>(acc[n], a, b);
          }
        }
      }
    }
    __syncthreads();   // tile kt is consumed before its buffer refills
  }
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    if (n < nd8) {
      const int c = 8 * n + 2 * tq;
      if (r_lo < t) store2(dq + base + (long long)r_lo * d + c, acc[n][0],
                           acc[n][1]);
      if (r_hi < t) store2(dq + base + (long long)r_hi * d + c, acc[n][2],
                           acc[n][3]);
    }
  }
}

// ---------------------------------------------------------------------
// Here the block's rows are KEYS and the streamed tiles are queries.
template <typename T, int DC>
__global__ void __launch_bounds__(32 * DkvCfg<DC>::NW, DkvCfg<DC>::MINB)
flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int t, int d, float scale,
    int causal) {
  using C = DkvCfg<DC>;
  constexpr int NTH = 32 * C::NW, ROWS = 16 * C::NW / C::DSPLIT;
  constexpr int COLS = C::COLS, NJ = COLS / 8, KK = DC / 8;
  constexpr int DN = DC / 8 / C::DSPLIT;
  constexpr bool EXACT = sizeof(T) == 2;
  extern __shared__ float4 bwd_smem[];
  const int ld = d + 16 / (int)sizeof(T);
  T* k_s = reinterpret_cast<T*>(bwd_smem);  // [ROWS][ld]   resident
  T* v_s = k_s + ROWS * ld;                 // [ROWS][ld]   resident
  T* qd_s = v_s + ROWS * ld;                // 2 x {Q, dO} x [COLS][ld]
  float* st_s = reinterpret_cast<float*>(qd_s + 4 * COLS * ld);
                                            // 2 x {lse, delta} x [COLS]
  const int bh = blockIdx.x, k0 = blockIdx.y * ROWS;   // key tile 0 first
  const long long base = (long long)bh * t * d, rbase = (long long)bh * t;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wr = (warp / C::DSPLIT) * 16;   // the warp's first key row
  const int n0 = (warp % C::DSPLIT) * DN;   // its first 8-column slab of D
  const int nd8 = d / 8;

  stage_tile<T, NTH>(k + base, k0, ROWS, t, d, k_s, ld);
  stage_tile<T, NTH>(v + base, k0, ROWS, t, d, v_s, ld);
  cp_commit();
  const int first = causal ? k0 / COLS : 0;
  const int nqt = (t + COLS - 1) / COLS;
  auto stage_q = [&](int qt, int buf) {
    T* qs = qd_s + buf * 2 * COLS * ld;
    float* ss = st_s + buf * 2 * COLS;
    stage_tile<T, NTH>(q + base, qt * COLS, COLS, t, d, qs, ld);
    stage_tile<T, NTH>(dout + base, qt * COLS, COLS, t, d, qs + COLS * ld,
                       ld);
    stage_rows<NTH>(lse + rbase, qt * COLS, COLS, t, ss);
    stage_rows<NTH>(delta + rbase, qt * COLS, COLS, t, ss + COLS);
  };
  stage_q(first, 0);
  cp_commit();

  const int j_lo = k0 + wr + g, j_hi = j_lo + 8;   // the fragment rows
  const float sl2 = scale * LOG2E;   // P = exp2(S s log2e - LSE log2e)
  float gk[DN][4], gv[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[n][e] = gv[n][e] = 0.f;

  for (int qt = first; qt < nqt; ++qt) {
    const int buf = (qt - first) & 1;
    if (qt + 1 < nqt) stage_q(qt + 1, buf ^ 1);
    cp_commit();
    cp_wait<1>();      // K/V and tile qt have landed; qt+1 is in flight
    __syncthreads();
    const T* qs = qd_s + buf * 2 * COLS * ld;
    const T* dos = qs + COLS * ld;
    const float* lse_c = st_s + buf * 2 * COLS;
    const float* dl_c = lse_c + COLS;
    const int c0 = qt * COLS;
    // a tile whose queries all precede the warp's keys adds nothing
    if (!(causal && c0 + COLS - 1 < k0 + wr)) {
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        if (kk < nd8) {
          FragA ak, av;
          frag_a<EXACT>(ak, k_s, ld, wr + g, 8 * kk + tq);
          frag_a<EXACT>(av, v_s, ld, wr + g, 8 * kk + tq);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            FragB bq, bdo;
            frag_b_nrows<EXACT>(bq, qs, ld, 8 * j + g, 8 * kk + tq);
            frag_b_nrows<EXACT>(bdo, dos, ld, 8 * j + g, 8 * kk + tq);
            mma3<EXACT, EXACT>(s[j], ak, bq);       // S^T = K Q^T
            mma3<EXACT, EXACT>(dp[j], av, bdo);     // dP^T = V dO^T
          }
        }
      }
      // P^T in place of S^T, dS^T in place of dP^T
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? j_lo : j_hi;
          const int col = 8 * j + 2 * tq + (e & 1), r = c0 + col;
          const bool live = r < t && key < t && !(causal && key > r);
          const float p =
              live ? exp2f(fmaf(s[j][e], sl2, -lse_c[col] * LOG2E)) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dl_c[col]) * scale;
        }
      // dV += P^T dO, dK += dS^T Q
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        FragA ap, ads;
        frag_a_from_c(ap, s[j]);
        frag_a_from_c(ads, dp[j]);
#pragma unroll
        for (int n = 0; n < DN; ++n) {
          if (n0 + n < nd8) {
            FragB bdo, bq;
            frag_b_krows<EXACT>(bdo, dos, ld, 8 * j + 2 * tq,
                                8 * (n0 + n) + g);
            frag_b_krows<EXACT>(bq, qs, ld, 8 * j + 2 * tq,
                                8 * (n0 + n) + g);
            mma3<false, EXACT>(gv[n], ap, bdo);
            mma3<false, EXACT>(gk[n], ads, bq);
          }
        }
      }
    }
    __syncthreads();   // tile qt is consumed before its buffer refills
  }
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    if (n0 + n < nd8) {
      const int c = 8 * (n0 + n) + 2 * tq;
      if (j_lo < t) {
        const long long at = base + (long long)j_lo * d + c;
        store2(dk + at, gk[n][0], gk[n][1]);
        store2(dv + at, gv[n][0], gv[n][1]);
      }
      if (j_hi < t) {
        const long long at = base + (long long)j_hi * d + c;
        store2(dk + at, gk[n][2], gk[n][3]);
        store2(dv + at, gv[n][2], gv[n][3]);
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
                   const void* o, const void* dout, const void* lse,
                   const void* dlse, void* delta, void* dq, int bh, int t,
                   int d, float scale, int causal, cudaStream_t st) {
  using C = DqCfg<DC>;
  constexpr int ROWS = 16 * C::NW;
  const size_t ld = d + 16 / sizeof(T);
  const size_t smem = sizeof(T) * (2 * ROWS + 4 * C::COLS) * ld +
                      sizeof(float) * ROWS;
  auto fn = flash_bwd_dq_kernel<T, DC>;
  static size_t granted = 0;
  cudaError_t err = prepare(fn, smem, granted);
  if (err != cudaSuccess) return err;
  fn<<<dim3(bh, (t + ROWS - 1) / ROWS), 32 * C::NW, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dlse), static_cast<float*>(delta),
      static_cast<T*>(dq), t, d, scale, causal);
  return cudaGetLastError();
}

template <typename T, int DC>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int bh, int t, int d, float scale,
                    int causal, cudaStream_t st) {
  using C = DkvCfg<DC>;
  constexpr int ROWS = 16 * C::NW / C::DSPLIT;
  const size_t ld = d + 16 / sizeof(T);
  const size_t smem = sizeof(T) * (2 * ROWS + 4 * C::COLS) * ld +
                      sizeof(float) * 4 * C::COLS;
  auto fn = flash_bwd_dkv_kernel<T, DC>;
  static size_t granted = 0;
  cudaError_t err = prepare(fn, smem, granted);
  if (err != cudaSuccess) return err;
  fn<<<dim3(bh, (t + ROWS - 1) / ROWS), 32 * C::NW, smem, st>>>(
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

// dlse may be null (no LSE cotangent); delta [BH, T] f32 is written here
// and read by ptt_flash_bwd_dkv, which must follow on the same stream.
extern "C" int ptt_flash_bwd_dq(const void* q, const void* k,
                                const void* v, const void* o,
                                const void* dout, const void* lse,
                                const void* dlse, void* delta, void* dq,
                                int bh, int t, int d, float scale,
                                int causal, int kind, void* stream) {
  if (bad_shape(bh, t, d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH(bwd_dq, q, k, v, o, dout, lse, dlse, delta, dq, bh, t, d,
               scale, causal, st);
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
