// Block-chain paged attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel paddle_tpu/ops/paged_attention.py:185
// (_paged_kernel, launched by _attend_pallas). For pre-scaled queries
// q [S, H, C, dk] (f32) it computes the online-softmax attention over the
// KV blocks each slot holds in a shared paged pool:
//
//   pool_k / pool_v  [NB, L, H, bs, dk]  f32, bf16, int8 or fp8-e4m3 codes
//   k_scale/v_scale  [NB, L, H, bs]      f32 (int8 / fp8 pools only)
//   btab             [S, NBmax]          int32 block table
//   qpos             [S, C]              int32; keys at cache positions
//                                        <= qpos[s, c] attend
//   nblk             [1]                 int32 device scalar; caps the walk
//   out              [S, H, C, dk]       f32 = acc / max(l, 1e-30)
//
// Bound: bytes. Every K/V element of a live chain is read once and serves
// 4C flops (2C for Q K^T, 2C for P V): 1 flop per byte of an f32 pool at
// decode (C = 1), 16 at a prefill chunk of 16, both below the card's fp32
// SIMT balance point of ~20 flops per byte (67 TFLOP/s over 3.35 TB/s).
// At the serving decode shape (S=32, H=8, C=1, dk 64, 256 positions, f32)
// a call moves 33.5 MB: 0.0101 ms at 3.35 TB/s. Tensor cores would not
// help; what the kernel needs is enough copies in flight to cover the
// memory latency (Little's law: ~18 KB per SM at ~0.7 us).
//
// Design:
//   * flash-decoding: the grid is (splits x ceil(C / QT), H, S). The host
//     picks `splits` from the shapes (ops/paged_attention.py, _splits).
//     A block walks its own share of its tile's chain,
//     chain = min(max(qpos of its rows) / bs + 1, clamp(nblk, 1, NBmax)),
//     cut into `splits` ranges of ceil(chain / splits) blocks; a range
//     that starts past the chain leaves an empty partial (m = -1e30,
//     l = 0, acc = 0). With splits > 1 each block writes its partial
//     (m, l, acc) to a scratch the wrapper owns and counts itself in on
//     a per-tile counter; the last block of the tile to arrive merges
//     the partials of its rows in split order (per row the splits'
//     weights exp(m_i - max m) into shared memory, then one read of each
//     split's acc per element), writes `out` and resets the counter. With one split the block writes `out` itself. One
//     launch per call either way; no atomics touch the output, and the
//     merge order does not depend on which block arrives last: two
//     launches on the same inputs are bitwise equal.
//   * a ring of NS stages of 16-byte cp.async copies (8-byte copies
//     where a K/V tile is not a multiple of 16 bytes) holds each
//     (block, layer, head) K and V tile and, for quantized pools, their
//     scales; NS - 1 tiles are in flight while one is consumed. Codes
//     land as stored and are widened (and scaled) as they are read.
//   * all four warps work at C = 1: each warp owns every fourth key of a
//     tile, its lanes split dk (two elements per lane per 64 of dk) and
//     reduce each score with shuffles; (m, l, acc) stay in registers per
//     warp and merge across warps through shared memory at the end of
//     the range. Up to 4 rows every warp takes every row; above 4 rows
//     (prefill chunks, speculative widths) the rows are spread over the
//     warps and each warp walks all keys. fp32 SIMT throughout.
//   * masking as the reference: a key at cache position > qpos scores
//     -1e30 (finite, so a row whose keys are all masked never turns NaN).
// Graph-safe: no host read of a device value, no allocation, one stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;          // threads per block
constexpr int NW = NT / 32;      // warps per block
constexpr int QT = 16;           // query rows per block tile
constexpr int NS = 3;            // cp.async ring stages
constexpr int KG = 4;            // keys a warp scores per softmax update
constexpr int SLOTS = 16;        // (warp, row) partials merged per block
constexpr int MAX_SPLITS = 64;   // blocks a row tile's chain is split over
constexpr int MAX_DK = 256;
constexpr float NEG_INF = -1e30f;

struct Args {
  const float* q;
  const void* pool_k;
  const void* pool_v;
  const float* k_scale;
  const float* v_scale;
  const int* btab;
  const int* qpos;
  const int* nblk;
  float* out;
  float* part;     // splits > 1: acc [splits][S*H*C][dk], then (m, l)
  int* count;      // splits > 1: [S*H*ceil(C/QT)] arrivals, left at zero
  int S, H, C, dk, bs, nbmax, layer, splits, granule;
  long long p_sb, p_sl, p_sh;   // pool strides in elements
  long long s_sb, s_sl, s_sh;   // scale strides in elements
};

__host__ __device__ __forceinline__ int align16(int x) {
  return (x + 15) & ~15;
}

// Shared-memory layout, the same on host and device: NS stages of
// [K tile | V tile | K scales | V scales], reused after the walk for
// SLOTS partial rows of dk accumulators and (m, l), then the split
// merge's weights [QT][MAX_SPLITS] and 1 / l per row.
struct Layout {
  int tile, scl, stage, total;
  __host__ __device__ Layout(int bs, int dk, int isz, bool quant) {
    tile = align16(bs * dk * isz);
    scl = quant ? align16(bs * 4) : 0;
    stage = 2 * tile + 2 * scl;
    const int merge = (SLOTS * (dk + 2) + QT * (MAX_SPLITS + 1)) * 4;
    total = NS * stage > merge ? NS * stage : merge;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Two consecutive pool elements (already in shared memory) as f32.
__device__ __forceinline__ float2 widen2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 widen2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 widen2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}

__device__ __forceinline__ float2 widen2(const __nv_fp8_e4m3* p) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      *reinterpret_cast<const __nv_fp8x2_storage_t*>(p), __NV_E4M3);
  return __half22float2(__half2(h));
}

// Sum over the warp; the xor butterfly leaves the same bits in every lane.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int RW, int NC>
struct Occupancy {   // blocks per SM the register budget is cut for
  static constexpr int MINB = RW == 1 ? (NC == 1 ? 8 : 4) : (NC == 4 ? 2 : 4);
};

// One block per (split, tile of QT query rows, head, slot). T is the
// pool's element type, QUANT whether per-vector scales ride along, NC the
// number of 64-wide dk chunks a lane covers (dk <= 64 NC, two elements
// each), RW the rows a warp holds (1 at C = 1, else 4).
template <typename T, bool QUANT, int NC, int RW>
__global__ void __launch_bounds__(NT, (Occupancy<RW, NC>::MINB))
paged_attention_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(a.bs, a.dk, sizeof(T), QUANT);
  const int ctiles = (a.C + QT - 1) / QT;
  const int split = blockIdx.x / ctiles, c0 = (blockIdx.x % ctiles) * QT;
  const int h = blockIdx.y, s = blockIdx.z;
  const int rows = min(QT, a.C - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bs = a.bs, dk = a.dk;

  // up to RW rows: every warp holds every row and owns every NW-th key;
  // more rows: warp w holds rows w, w + NW, ... and walks every key
  const bool ksplit = rows <= RW;
  const int kfirst = ksplit ? warp : 0, kstep = ksplit ? NW : 1;
  const int* qrow = a.qpos + (long long)s * a.C + c0;
  int qmax = 0;
  for (int r = 0; r < rows; ++r) qmax = max(qmax, __ldg(qrow + r));
  const int cap = min(max(__ldg(a.nblk), 1), a.nbmax);
  const int chain = min(qmax / bs + 1, cap);
  const int per = (chain + a.splits - 1) / a.splits;
  const int b0 = split * per;
  const int ntiles = max(0, min(chain, b0 + per) - b0);

  const long long row0 = ((long long)s * a.H + h) * a.C + c0;
  int rid[RW], qp[RW];
  float2 qv[RW][NC], acc[RW][NC];
  float m[RW], l[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    rid[i] = ksplit ? i : warp + NW * i;
    const bool live = rid[i] < rows;
    qp[i] = live ? __ldg(qrow + rid[i]) : -1;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = 64 * c + 2 * lane;
      qv[i][c] = live && d < dk
          ? *reinterpret_cast<const float2*>(a.q + (row0 + rid[i]) * dk + d)
          : make_float2(0.f, 0.f);
      acc[i][c] = make_float2(0.f, 0.f);
    }
  }

  const T* pk = static_cast<const T*>(a.pool_k);
  const T* pv = static_cast<const T*>(a.pool_v);
  const int* trow = a.btab + (long long)s * a.nbmax + b0;
  const int nchunk = lay.tile / a.granule;   // copies per K (or V) tile
  const int tile_bytes = bs * dk * (int)sizeof(T);

  // stage tile t of the range (chain block b0 + t) into ring slot t % NS
  unsigned char* ring = smem;
  auto stage_tile = [&](int t) {
    unsigned char* st = ring + (t % NS) * lay.stage;
    const long long phys = __ldg(trow + t);
    const long long e0 = phys * a.p_sb + (long long)a.layer * a.p_sl +
                         (long long)h * a.p_sh;
    const unsigned char* gk = reinterpret_cast<const unsigned char*>(pk + e0);
    const unsigned char* gv = reinterpret_cast<const unsigned char*>(pv + e0);
    if (a.granule == 16) {
      for (int i = threadIdx.x; i < nchunk; i += NT) {
        if (16 * i < tile_bytes) {
          cp16(st + 16 * i, gk + 16 * i);
          cp16(st + lay.tile + 16 * i, gv + 16 * i);
        }
      }
    } else {
      for (int i = threadIdx.x; i < nchunk; i += NT) {
        if (8 * i < tile_bytes) {
          cp8(st + 8 * i, gk + 8 * i);
          cp8(st + lay.tile + 8 * i, gv + 8 * i);
        }
      }
    }
    if (QUANT) {
      const long long se = phys * a.s_sb + (long long)a.layer * a.s_sl +
                           (long long)h * a.s_sh;
      for (int j = threadIdx.x; j < bs; j += NT) {
        cp4(st + 2 * lay.tile + 4 * j, a.k_scale + se + j);
        cp4(st + 2 * lay.tile + lay.scl + 4 * j, a.v_scale + se + j);
      }
    }
  };

#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < ntiles) stage_tile(t);
    cp_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_wait<NS - 2>();     // this thread's copies of tile t have landed
    __syncthreads();       // everyone's have; everyone is done with t - 1
    if (t + NS - 1 < ntiles) stage_tile(t + NS - 1);
    cp_commit();
    const unsigned char* st = smem + (t % NS) * lay.stage;
    const T* kt = reinterpret_cast<const T*>(st);
    const T* vt = reinterpret_cast<const T*>(st + lay.tile);
    const float* ksc = reinterpret_cast<const float*>(st + 2 * lay.tile);
    const float* vsc = reinterpret_cast<const float*>(st + 2 * lay.tile +
                                                      lay.scl);
    const int kbase = (b0 + t) * bs;   // cache position of the tile's key 0
    for (int j0 = kfirst; j0 < bs; j0 += kstep * KG) {
      float sc[RW][KG];
#pragma unroll
      for (int u = 0; u < KG; ++u) {
        const int j = j0 + u * kstep;
        float2 kk[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = 64 * c + 2 * lane;
          kk[c] = j < bs && d < dk ? widen2(kt + j * dk + d)
                                   : make_float2(0.f, 0.f);
          if (QUANT && j < bs) {
            const float g = ksc[j];
            kk[c].x *= g;
            kk[c].y *= g;
          }
        }
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          float part = 0.f;
#pragma unroll
          for (int c = 0; c < NC; ++c)
            part = fmaf(qv[i][c].y, kk[c].y, fmaf(qv[i][c].x, kk[c].x, part));
          part = warp_sum(part);
          sc[i][u] = j < bs && kbase + j <= qp[i] ? part : NEG_INF;
        }
      }
      float p[RW][KG];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        float mx = m[i];
#pragma unroll
        for (int u = 0; u < KG; ++u) mx = fmaxf(mx, sc[i][u]);
        const float alpha = expf(m[i] - mx);
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < KG; ++u) {
          p[i][u] = j0 + u * kstep < bs ? expf(sc[i][u] - mx) : 0.f;
          sum += p[i][u];
        }
        l[i] = alpha * l[i] + sum;
        m[i] = mx;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[i][c].x *= alpha;
          acc[i][c].y *= alpha;
        }
      }
#pragma unroll
      for (int u = 0; u < KG; ++u) {
        const int j = j0 + u * kstep;
        if (j >= bs) break;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = 64 * c + 2 * lane;
          if (d >= dk) continue;
          float2 vv = widen2(vt + j * dk + d);
          if (QUANT) {
            const float g = vsc[j];
            vv.x *= g;
            vv.y *= g;
          }
#pragma unroll
          for (int i = 0; i < RW; ++i) {
            acc[i][c].x = fmaf(p[i][u], vv.x, acc[i][c].x);
            acc[i][c].y = fmaf(p[i][u], vv.y, acc[i][c].y);
          }
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();         // the ring is free: it holds the merge now

  // slot of (warp, row): warp * 4 + row when warps split the keys, the
  // row itself when they split the rows
  float* macc = reinterpret_cast<float*>(smem);   // [SLOTS][dk]
  float* mml = macc + SLOTS * dk;                 // [SLOTS][2]
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    if (rid[i] >= rows) continue;
    const int slot = ksplit ? warp * 4 + rid[i] : rid[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = 64 * c + 2 * lane;
      if (d < dk) *reinterpret_cast<float2*>(macc + slot * dk + d) = acc[i][c];
    }
    if (lane == 0) {
      mml[2 * slot] = m[i];
      mml[2 * slot + 1] = l[i];
    }
  }
  __syncthreads();
  const int nsrc = ksplit ? NW : 1;
  const long long nrow = (long long)a.S * a.H * a.C;
  float* ml = a.part + (long long)a.splits * nrow * dk;   // [splits][nrow][2]
  for (int e = threadIdx.x; e < rows * dk; e += NT) {
    const int r = e / dk, d = e - r * dk;
    float mx = NEG_INF;
    for (int w = 0; w < nsrc; ++w) mx = fmaxf(mx, mml[2 * (r + 4 * w)]);
    float lsum = 0.f, o = 0.f;
    for (int w = 0; w < nsrc; ++w) {
      const int sl = r + 4 * w;
      const float g = expf(mml[2 * sl] - mx);
      lsum = fmaf(mml[2 * sl + 1], g, lsum);
      o = fmaf(macc[sl * dk + d], g, o);
    }
    const long long row = row0 + r;
    if (a.splits == 1) {
      a.out[row * dk + d] = o / fmaxf(lsum, 1e-30f);
    } else {
      const long long prow = split * nrow + row;
      a.part[prow * dk + d] = o;
      if (d == 0) {
        ml[2 * prow] = mx;
        ml[2 * prow + 1] = lsum;
      }
    }
  }
  if (a.splits == 1) return;

  // count this block in; the tile's last block merges every split's
  // partial, in split order
  __shared__ int last;
  __threadfence();         // this block's partial is visible device-wide
  __syncthreads();
  int* cnt = a.count + ((long long)s * a.H + h) * ctiles + blockIdx.x % ctiles;
  if (threadIdx.x == 0) last = atomicAdd(cnt, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // each split's weight exp(m_i - max m) per row, and 1 / sum l_i w_i,
  // one thread per row; then each thread sums the splits' acc for up
  // to MG elements at once, their loads in flight together
  float* wts = mml + 2 * SLOTS;           // [QT][MAX_SPLITS]
  float* inv = wts + QT * MAX_SPLITS;     // [QT]
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    const float* mr = ml + 2 * (row0 + r);
    float mx = NEG_INF;
    for (int i = 0; i < a.splits; ++i)
      mx = fmaxf(mx, __ldcg(mr + 2 * i * nrow));
    float lsum = 0.f;
    for (int i = 0; i < a.splits; ++i) {
      const float g = expf(__ldcg(mr + 2 * i * nrow) - mx);
      wts[r * MAX_SPLITS + i] = g;
      lsum = fmaf(__ldcg(mr + 2 * i * nrow + 1), g, lsum);
    }
    inv[r] = 1.f / fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  constexpr int MG = 4;
  for (int e0 = threadIdx.x; e0 < rows * dk; e0 += MG * NT) {
    float o[MG];
    const float* pr[MG];
    const float* wr[MG];
#pragma unroll
    for (int u = 0; u < MG; ++u) {
      const int e = min(e0 + u * NT, rows * dk - 1), r = e / dk;
      pr[u] = a.part + (row0 + r) * dk + (e - r * dk);
      wr[u] = wts + r * MAX_SPLITS;
      o[u] = 0.f;
    }
    for (int i = 0; i < a.splits; ++i) {
#pragma unroll
      for (int u = 0; u < MG; ++u)
        o[u] = fmaf(__ldcg(pr[u] + i * nrow * dk), wr[u][i], o[u]);
    }
#pragma unroll
    for (int u = 0; u < MG; ++u) {
      const int e = e0 + u * NT;
      if (e < rows * dk) {
        const int r = e / dk;
        a.out[(row0 + r) * dk + (e - r * dk)] = o[u] * inv[r];
      }
    }
  }
  if (threadIdx.x == 0) *cnt = 0;   // ready for the next call
}

// Raise a kernel's dynamic shared-memory cap to `smem` bytes, once per
// kernel and size: `granted` remembers the largest cap set so far.
template <typename F>
cudaError_t prepare(F fn, size_t smem, size_t& granted) {
  if (smem <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) granted = smem;
  return err;
}

template <typename T, bool QUANT, int NC, int RW>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const Layout lay(a.bs, a.dk, sizeof(T), QUANT);
  auto fn = paged_attention_kernel<T, QUANT, NC, RW>;
  static size_t granted = 0;   // the kernel has static shared memory too
  cudaError_t err = prepare(fn, lay.total, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.splits * ((a.C + QT - 1) / QT), a.H, a.S);
  fn<<<grid, NT, lay.total, st>>>(a);
  return cudaGetLastError();
}

template <typename T, bool QUANT>
cudaError_t by_width(const Args& a, cudaStream_t st) {
  const bool one = a.C == 1;
  if (a.dk <= 64)
    return one ? launch<T, QUANT, 1, 1>(a, st) : launch<T, QUANT, 1, 4>(a, st);
  if (a.dk <= 128)
    return one ? launch<T, QUANT, 2, 1>(a, st) : launch<T, QUANT, 2, 4>(a, st);
  return one ? launch<T, QUANT, 4, 1>(a, st) : launch<T, QUANT, 4, 4>(a, st);
}

}  // namespace

// dims: S, H, C, dk, bs, NBmax, layer, splits, granule, the pool strides
// (block, layer, head), the scale strides (block, layer, head), kind; all
// in elements. kind: 0 = f32 pool, 1 = bf16 pool, 2 = int8 codes, 3 =
// fp8-e4m3 codes (2 and 3 with f32 scales). A K/V row is dk contiguous
// elements. When splits > 1, `part` holds splits * S*H*C * (dk + 2)
// floats and `count` S*H*ceil(C/QT) ints, zero before the call and zero
// after it (calls that share them must be ordered, as on one stream);
// `granule` (16 or 8) is the cp.async size, dividing bs * dk * itemsize.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int ptt_paged_attention(
    const void* q, const void* pool_k, const void* pool_v,
    const void* k_scale, const void* v_scale, const void* btab,
    const void* qpos, const void* nblk, void* out, void* part, void* count,
    const long long* dims, void* stream) {
  Args a;
  a.S = (int)dims[0]; a.H = (int)dims[1]; a.C = (int)dims[2];
  a.dk = (int)dims[3]; a.bs = (int)dims[4]; a.nbmax = (int)dims[5];
  a.layer = (int)dims[6]; a.splits = (int)dims[7]; a.granule = (int)dims[8];
  a.p_sb = dims[9]; a.p_sl = dims[10]; a.p_sh = dims[11];
  a.s_sb = dims[12]; a.s_sl = dims[13]; a.s_sh = dims[14];
  const long long kind = dims[15];
  if (a.dk % 8 != 0 || a.dk > MAX_DK || a.S < 1 || a.H < 1 || a.C < 1 ||
      a.bs < 1 || a.nbmax < 1 || a.splits < 1 || a.splits > MAX_SPLITS ||
      (a.splits > 1 && (part == nullptr || count == nullptr)) ||
      (a.granule != 16 && a.granule != 8))
    return (int)cudaErrorInvalidValue;
  a.q = static_cast<const float*>(q);
  a.pool_k = pool_k;
  a.pool_v = pool_v;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.btab = static_cast<const int*>(btab);
  a.qpos = static_cast<const int*>(qpos);
  a.nblk = static_cast<const int*>(nblk);
  a.out = static_cast<float*>(out);
  a.part = static_cast<float*>(part);
  a.count = static_cast<int*>(count);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return (int)by_width<float, false>(a, st);
    case 1: return (int)by_width<__nv_bfloat16, false>(a, st);
    case 2: return (int)by_width<int8_t, true>(a, st);
    case 3: return (int)by_width<__nv_fp8_e4m3, true>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
