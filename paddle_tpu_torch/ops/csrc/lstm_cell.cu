// One step of the LSTM scan, forward and backward, for Hopper (sm_90a):
// the recurrent product on the tensor cores with the cell in its
// epilogue. The port's `lstm` lowering (paddle_tpu_torch/ops/rnn_ops.py,
// through ops/lstm_cell.py's _LSTMScan) launches the forward once per time
// step and the backward once per step in reverse order.
//
// Replaces: no Pallas kernel. The JAX package's `lstm` is one lax.scan
// whose body (paddle_tpu/ops/rnn_ops.py:111-131) is
//   gates = x_t + h @ W + b        [B, 4D], packed [i, f, c~, o]
// and the cell with its masked carry, fused by XLA into the loop body.
// Here the bias is added to x once before the scan, and each launch does
// the body, product included.
//
// Forward (lstm_cell_fwd_kernel), for the rows live at step t:
//   g  = x_t + h_prev W               (the pre-activations, saved: `gates`)
//   i  = ga(g_i + c_prev w_ic)   f = ga(g_f + c_prev w_fc)   c~ = ca(g_c)
//   c  = f c_prev + i c~         o = ga(g_o + c w_oc)        h = o ha(c)
// (H, C, Out) = (h, c, h); a dead row (t >= its length) keeps its carry
// and writes a zero output: (h_prev, c_prev, 0).
//
// Backward (lstm_cell_bwd_kernel), for step t, given the gate gradients
// of the step the forward ran next (dg_next, step t_next):
//   dh  = dg_next W^T  for rows live at t_next, else the carried dh
//         (a dead row hands its carry's gradient back unchanged)
//   then the cell's backward from the saved pre-activations, with
//   dh + dOut_t and dc + dC_t: the gate gradients dg_t [B, 4D] (zero for
//   rows dead at t), dc_prev, and the peephole gradients added per row
//   into dpeep [B, 3D] (summed over rows once, by the caller).
// dh and dc are carried in place: a block reads and writes only its own
// (row, unit) elements of them. The weight gradient is not computed
// here: the caller takes it after the scan as one product per layer,
// H_prev^T [D, T B] @ dG [T B, 4D].
//
// Bound (B 64, D 512, f32): the forward moves W (4 MB) plus x_t, h, c,
// the three outputs and the saved gates, ~5.9 MB a launch, 1.8 us at
// 3.35 TB/s; its 134 MFLOP take 0.27 us on the TF32 tensor cores. So a
// step is bound by bytes, and by the L2 in practice: W stays resident in
// the 50 MB L2 from step to step, while every block reads its own slice
// of W and the rows of h it needs (16 MB from the L2 a forward step at
// the tile below). At the benchmark's lengths 48 of a layer's 128 steps
// have no live row: the function needs no W there, and the kernels read
// none (the dead-block skip below). Over the 128 steps the mean bound is
// 3.77 MB, 1.12 us forward and 4.05 MB, 1.21 us backward (chip_smoke.py
// _step_bounds).
// Measured there (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 15
// and paddle_tpu_torch/tools/kernel_trials.py lstm, a call's mean over
// the 128 steps of a layer at the benchmark's lengths): 0.0111 ms
// forward and 0.0129 backward launched alone, 0.0070 and 0.0086 back to
// back in a CUDA graph, as the main path runs them (9.9x and 10.7x the
// mean bound alone, 6.2x and 7.1x back to back); the first version (8
// warps a block, no skip) took 0.0166 and 0.0204 alone. By the tool's
// diagnostic builds, back to back, the forward takes 0.0053 ms with no
// staging and 0.0053 with no MMA: a launch's fixed cost, the L2's rate
// and the mma.sync chains each hold a share, and neither more stages,
// other row tiles nor a staggered K walk helped.
//
// Design:
//   * the tile is the cell's, not the GEMM's: a forward block owns FU = 8
//     hidden units and FR = 32 rows and computes their four gate columns
//     {g D + u}: four n8 tiles of m16n8k8, one per gate. A lane of the C
//     fragment holds columns 2t, 2t+1 of every n8 tile, so i, f, c~ and o
//     of one (row, unit) land in one thread's accumulators and the cell
//     runs on them: [B, 4D] never goes through device memory between the
//     product and the cell. At B 64, D 512 that is 64 x 2 = 128 blocks;
//   * a backward block owns BU = 16 units and BR = 16 rows: dh[rows,
//     units] = dg_next[rows, :] W[units, :]^T over K = 4D (two n8 tiles),
//     then the cell's backward for the same (row, unit) pairs, so dh never
//     crosses blocks within a step (128 blocks at B 64, D 512);
//   * both products run 3xTF32 mma.sync m16n8k8 at fp32 accuracy, with
//     matmul_stats.cu's building blocks: each operand splits into big =
//     tf32(x) and small = tf32(x - big), both rounded to nearest, and each
//     k8 step takes small*big + big*small, then big*big, into a zeroed
//     fragment that one f32 add carries into the accumulator;
//   * K is staged through a ring of NS stages of 16-byte cp.async copies
//     (64 of K a stage forward, 128 backward), rows padded so that every
//     fragment read is free of bank conflicts; rows past B, units past D
//     and K past its end land as zeros. An unaligned operand (D not a
//     multiple of 4) is staged element by element instead;
//   * a block's 16 warps split each staged slice's k8 steps among them
//     (one each); the partial fragments meet in shared memory and are
//     summed in warp order, one (row, unit) per thread of the first
//     warps: no split-K across blocks and no atomics, so every result is
//     the same bitwise launch to launch and a CUDA graph replays bitwise;
//   * data-dependent work: a forward block whose rows are all dead at t,
//     and a backward block with no row live at the next step, skip the
//     product (at the benchmark's lengths every row is dead at 48 of the
//     128 steps); each thread loads its epilogue's operands before the
//     product, so their latency hides under it;
//   * the cell's products and sums round one at a time (__fmul_rn,
//     __fadd_rn: no contraction into FMA) and its activations use expf
//     and tanhf, as PyTorch's elementwise kernels compute the plain
//     version.
// Left for a later version: W resident in shared memory across steps (a
// persistent whole-scan kernel with a grid barrier a step), thread block
// clusters sharing the staged h and W slices, and wgmma.
//
// Activation codes: 0 identity, 1 sigmoid, 2 tanh, 3 relu.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------
// cp.async staging, the TF32 split and mma.sync (matmul_stats.cu's).

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

// x = big + small, both rounded to nearest TF32 (x kept to 2^-22 of
// |x|); the MMA reads only the top 19 bits of small.
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
// a zeroed fragment that one f32 add per element carries into c.
__device__ __forceinline__ void mma3(float* c, const FragA& a,
                                     const FragB& b) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e];
}

// The A fragment of rows g, g+8 and columns tq, tq+4 of a 16 x 8 tile at
// p (row stride ld), split.
__device__ __forceinline__ void load_a(FragA& a, const float* p, int ld) {
  split(p[0], a.big[0], a.small[0]);
  split(p[8 * ld], a.big[1], a.small[1]);
  split(p[4], a.big[2], a.small[2]);
  split(p[8 * ld + 4], a.big[3], a.small[3]);
}

// ---------------------------------------------------------------------
// The cell.

__device__ __forceinline__ float act(float x, int code) {
  switch (code) {
    case 1:
      return 1.0f / (1.0f + expf(-x));
    case 2:
      return tanhf(x);
    case 3:
      return x > 0.0f ? x : 0.0f;
    default:
      return x;
  }
}

// the derivative of the activation, from its output y
__device__ __forceinline__ float dact(float y, int code) {
  switch (code) {
    case 1:
      return __fmul_rn(__fsub_rn(1.0f, y), y);
    case 2:
      return __fsub_rn(1.0f, __fmul_rn(y, y));
    case 3:
      return y > 0.0f ? 1.0f : 0.0f;
    default:
      return 1.0f;
  }
}

struct Cell {
  float i, f, cc, o;   // the gate activations
};

// The activations from the pre-activations g[4] (before the peepholes),
// the previous cell cp and the new cell c (the output gate's peephole
// reads it); peep is w_ic, w_fc, w_oc at u, D + u, 2D + u.
__device__ __forceinline__ Cell gates_of(const float* g, float cp, float c,
                                         const float* __restrict__ peep,
                                         int u, int D, int ga, int ca) {
  float gi = g[0], gf = g[1], go = g[3];
  if (peep != nullptr) {
    gi = __fadd_rn(gi, __fmul_rn(cp, peep[u]));
    gf = __fadd_rn(gf, __fmul_rn(cp, peep[D + u]));
    go = __fadd_rn(go, __fmul_rn(c, peep[2 * D + u]));
  }
  return Cell{act(gi, ga), act(gf, ga), act(g[2], ca), act(go, ga)};
}

// ---------------------------------------------------------------------
// The forward step.

constexpr int FR = 32;             // rows of a forward block
constexpr int FU = 8;              // hidden units of a forward block
constexpr int FBK = 64;            // K per stage
constexpr int FNS = 6;             // stages of the cp.async ring
constexpr int FLDA = FBK + 4;      // h rows [FR][FLDA]: 4 mod 32 words
constexpr int FLDB = 4 * FU + 8;   // W rows [FBK][FLDB]: 8 mod 32 words
constexpr int FMW = FR / 16;       // m16 tiles of a block
constexpr int FKW = FBK / 8;       // warps along K: one k8 step a slice
constexpr int FTH = 32 * FMW * FKW;
constexpr int FSTAGE = FR * FLDA + FBK * FLDB;   // floats a stage
constexpr size_t FSMEM = sizeof(float) * FNS * FSTAGE;
static_assert(FU == 8, "one n8 tile per gate");
static_assert(FMW * FKW * 16 * 32 <= FNS * FSTAGE, "reduction fits");
static_assert(FKW >= 4 && FR * FU == FMW * 4 * 32,
              "a (row, unit) for each thread of the first 4 K warps");

__global__ void __launch_bounds__(FTH)
lstm_cell_fwd_kernel(const float* __restrict__ xt,
                     const float* __restrict__ h_prev,
                     const float* __restrict__ c_prev,
                     const float* __restrict__ w,
                     const float* __restrict__ peep,
                     const int* __restrict__ lens, int t, int B, int D,
                     int ga, int ca, int ha, bool vec,
                     float* __restrict__ h_out, float* __restrict__ c_out,
                     float* __restrict__ out, float* __restrict__ gates) {
  extern __shared__ float4 lstm_smem[];
  float* smem = reinterpret_cast<float*>(lstm_smem);
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int warp = threadIdx.x / 32, mw = warp % FMW, kw = warp / FMW;
  const int u0 = blockIdx.x * FU, r0 = blockIdx.y * FR;
  const int nk = (D + FBK - 1) / FBK;

  // a stage: h[r0.., k0..k0+FBK) as rows [FR][FLDA], then W[k0.., the
  // block's 4 x FU gate columns] as rows [FBK][FLDB], gate-major:
  // column gate * FU + j is W's column gate * D + u0 + j
  auto stage = [&](int kt, int buf) {
    float* a = smem + buf * FSTAGE;
    float* b = a + FR * FLDA;
    const int k0 = kt * FBK;
    if (vec) {
      constexpr int NA = FR * FBK / 4, NB = FBK * FU;
#pragma unroll 1
      for (int e = threadIdx.x; e < NA + NB; e += FTH) {
        if (e < NA) {
          const int r = e / (FBK / 4), cc = (e % (FBK / 4)) * 4;
          const int row = r0 + r, k = k0 + cc;
          const bool in = row < B && k < D;
          cp16(a + r * FLDA + cc, in ? h_prev + (long long)row * D + k
                                     : h_prev, in ? 16 : 0);
        } else {
          const int e2 = e - NA, kr = e2 / FU, j = e2 % FU;
          const int gate = j / (FU / 4), cc = (j % (FU / 4)) * 4;
          const int k = k0 + kr, u = u0 + cc;
          const bool in = k < D && u < D;
          cp16(b + kr * FLDB + gate * FU + cc,
               in ? w + (long long)k * 4 * D + gate * D + u : w,
               in ? 16 : 0);
        }
      }
    } else {
#pragma unroll 1
      for (int e = threadIdx.x; e < FR * FBK + FBK * 4 * FU; e += FTH) {
        if (e < FR * FBK) {
          const int r = e / FBK, cc = e % FBK;
          const int row = r0 + r, k = k0 + cc;
          a[r * FLDA + cc] = row < B && k < D
                                 ? h_prev[(long long)row * D + k] : 0.f;
        } else {
          const int e2 = e - FR * FBK, kr = e2 / (4 * FU);
          const int gate = (e2 % (4 * FU)) / FU, j = e2 % FU;
          const int k = k0 + kr, u = u0 + j;
          b[kr * FLDB + gate * FU + j] =
              k < D && u < D ? w[(long long)k * 4 * D + gate * D + u] : 0.f;
        }
      }
    }
  };

  // This thread's (row, unit) in the epilogue: element e = kw of its
  // lane's C fragment (rows g, g+8 x columns 2tq, 2tq+1); warps past the
  // fragment's four elements only multiply. Its operands are loaded
  // first, so that their latency hides under the product.
  const int e = kw;
  const int row = r0 + 16 * mw + g + 8 * (e >> 1);
  const int u = u0 + 2 * tq + (e & 1);
  const bool mine = e < 4 && row < B && u < D;
  const long long gx = (long long)row * 4 * D + u;
  const long long idx = (long long)row * D + u;
  float xg[4] = {0.f, 0.f, 0.f, 0.f}, cp = 0.f, hp = 0.f;
  bool alive = false;
  if (mine) {
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) xg[gate] = xt[gx + gate * D];
    cp = c_prev[idx];
    hp = h_prev[idx];
    alive = t < lens[row];
  }
  // a block whose rows are all dead at t skips the product
  const int rr = r0 + threadIdx.x;
  const bool live = __syncthreads_or(threadIdx.x < FR && rr < B &&
                                     t < lens[rr]);

  float acc[4][4];
#pragma unroll
  for (int gate = 0; gate < 4; ++gate)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[gate][x] = 0.f;
  float* red = smem;   // the warps' partial fragments [warp][16][lane]
  if (live) {
#pragma unroll
    for (int s = 0; s < FNS - 1; ++s) {
      if (s < nk) stage(s, s);
      cp_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_wait<FNS - 2>();   // slice kt has landed
      __syncthreads();      // ... for every thread; slice kt-1 is consumed
      if (kt + FNS - 1 < nk) stage(kt + FNS - 1, (kt + FNS - 1) % FNS);
      cp_commit();
      const float* a = smem + (kt % FNS) * FSTAGE;
      const float* b = a + FR * FLDA;
      const int kk = 8 * kw;   // this warp's k8 step of the slice
      FragA fa;
      load_a(fa, a + (16 * mw + g) * FLDA + kk + tq, FLDA);
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        const float* p = b + (kk + tq) * FLDB + gate * FU + g;
        FragB fb;
        split(p[0], fb.big[0], fb.small[0]);
        split(p[4 * FLDB], fb.big[1], fb.small[1]);
        mma3(acc[gate], fa, fb);
      }
    }
    cp_wait<0>();
    __syncthreads();        // the stages are free for the reduction
#pragma unroll
    for (int gate = 0; gate < 4; ++gate)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        red[(warp * 16 + gate * 4 + x) * 32 + lane] = acc[gate][x];
    __syncthreads();
  }
  if (!mine) return;
  if (!alive) {
    h_out[idx] = hp;
    c_out[idx] = cp;
    out[idx] = 0.0f;
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) gates[gx + gate * D] = 0.0f;
    return;
  }
  // the four gates summed over the K warps in order
  float pre[4];
#pragma unroll
  for (int gate = 0; gate < 4; ++gate) {
    float sum = 0.f;
#pragma unroll
    for (int k2 = 0; k2 < FKW; ++k2)
      sum += red[((k2 * FMW + mw) * 16 + gate * 4 + e) * 32 + lane];
    pre[gate] = __fadd_rn(xg[gate], sum);
    gates[gx + gate * D] = pre[gate];
  }
  float gi = pre[0], gf = pre[1];
  if (peep != nullptr) {
    gi = __fadd_rn(gi, __fmul_rn(cp, peep[u]));
    gf = __fadd_rn(gf, __fmul_rn(cp, peep[D + u]));
  }
  const float i = act(gi, ga), f = act(gf, ga), cc = act(pre[2], ca);
  const float c = __fadd_rn(__fmul_rn(f, cp), __fmul_rn(i, cc));
  float go = pre[3];
  if (peep != nullptr) go = __fadd_rn(go, __fmul_rn(c, peep[2 * D + u]));
  const float h = __fmul_rn(act(go, ga), act(c, ha));
  h_out[idx] = h;
  c_out[idx] = c;
  out[idx] = h;
}

// ---------------------------------------------------------------------
// The backward step.

constexpr int BR = 16;             // rows of a backward block
constexpr int BU = 16;             // hidden units of a backward block
constexpr int BBK = 128;           // K (of 4D) per stage
constexpr int BNS = 6;             // stages of the cp.async ring
constexpr int BLD = BBK + 4;       // rows [..][BLD]: 4 mod 32 words
constexpr int BNT = BU / 8;        // n8 tiles of a block
constexpr int BKW = BBK / 8;       // warps along K: one k8 step a slice
constexpr int BTH = 32 * BKW;
constexpr int BSTAGE = (BR + BU) * BLD;   // floats a stage
constexpr size_t BSMEM = sizeof(float) * BNS * BSTAGE;
static_assert(BR == 16, "one m16 tile");
static_assert(BKW * BNT * 4 * 32 <= BNS * BSTAGE, "reduction fits");
static_assert(BKW >= BNT * 4, "a (row, unit) for each thread of the "
              "first BNT * 4 K warps");

__global__ void __launch_bounds__(BTH)
lstm_cell_bwd_kernel(const float* __restrict__ dg_next,
                     const float* __restrict__ w,
                     const int* __restrict__ lens, int t_next,
                     const float* __restrict__ gates,
                     const float* __restrict__ c_prev,
                     const float* __restrict__ c_new,
                     const float* __restrict__ peep, int t, int B, int D,
                     int ga, int ca, int ha, bool vec,
                     const float* __restrict__ dout,
                     const float* __restrict__ dcell,
                     float* __restrict__ dh, float* __restrict__ dc,
                     float* __restrict__ dpeep, float* __restrict__ dg) {
  extern __shared__ float4 lstm_smem[];
  float* smem = reinterpret_cast<float*>(lstm_smem);
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int warp = threadIdx.x / 32;
  const int u0 = blockIdx.x * BU, r0 = blockIdx.y * BR;
  const int K = 4 * D;
  // This thread's (row, unit): element e of n8 tile nt of its lane's C
  // fragment (rows g, g+8 x columns 2tq, 2tq+1); warps past the
  // fragment's elements only multiply. Its operands are loaded first,
  // so that their latency hides under the product.
  const int nt = warp / 4, e = warp % 4;
  const int row = r0 + g + 8 * (e >> 1);
  const int u = u0 + 8 * nt + 2 * tq + (e & 1);
  const bool mine = nt < BNT && row < B && u < D;
  const bool cell = gates != nullptr;
  const long long idx = (long long)row * D + u;
  const long long gx = (long long)row * 4 * D + u;
  float dhv = 0.f, dcv = 0.f, dov = 0.f, cp = 0.f, c = 0.f;
  float pre[4] = {0.f, 0.f, 0.f, 0.f};
  bool alive = false, alive_next = false;
  if (mine) {
    dhv = dh[idx];
    alive_next = dg_next != nullptr && t_next < lens[row];
    if (cell) {
      alive = t < lens[row];
      dcv = dcell != nullptr ? __fadd_rn(dc[idx], dcell[idx]) : dc[idx];
      if (alive) {
        dov = dout != nullptr ? dout[idx] : 0.f;
        cp = c_prev[idx];
        c = c_new[idx];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) pre[gate] = gates[gx + gate * D];
      }
    }
  }

  // the product, unless no row of the block is live at t_next (or there
  // is no step after this one): uniform over the block
  const int rr = r0 + threadIdx.x;
  if (dg_next != nullptr &&
      __syncthreads_or(threadIdx.x < BR && rr < B && t_next < lens[rr])) {
    const int nk = (K + BBK - 1) / BBK;
    // a stage: dg_next[r0.., k0..k0+BBK) as rows [BR][BLD], then
    // W[u0.., k0..) as rows [BU][BLD]
    auto stage = [&](int kt, int buf) {
      float* s = smem + buf * BSTAGE;
      const int k0 = kt * BBK;
      if (vec) {
        constexpr int PER = BBK / 4;
#pragma unroll 1
        for (int x = threadIdx.x; x < (BR + BU) * PER; x += BTH) {
          const int r = x / PER, cc = (x % PER) * 4;
          const bool is_a = r < BR;
          const int ro = is_a ? r0 + r : u0 + r - BR;
          const bool in = ro < (is_a ? B : D) && k0 + cc < K;
          const float* base = is_a ? dg_next : w;
          cp16(s + r * BLD + cc, in ? base + (long long)ro * K + k0 + cc
                                    : base, in ? 16 : 0);
        }
      } else {
#pragma unroll 1
        for (int x = threadIdx.x; x < (BR + BU) * BBK; x += BTH) {
          const int r = x / BBK, cc = x % BBK;
          const bool is_a = r < BR;
          const int ro = is_a ? r0 + r : u0 + r - BR;
          const bool in = ro < (is_a ? B : D) && k0 + cc < K;
          s[r * BLD + cc] =
              in ? (is_a ? dg_next : w)[(long long)ro * K + k0 + cc] : 0.f;
        }
      }
    };

    float acc[BNT][4];
#pragma unroll
    for (int n = 0; n < BNT; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[n][x] = 0.f;

#pragma unroll
    for (int s = 0; s < BNS - 1; ++s) {
      if (s < nk) stage(s, s);
      cp_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_wait<BNS - 2>();
      __syncthreads();
      if (kt + BNS - 1 < nk) stage(kt + BNS - 1, (kt + BNS - 1) % BNS);
      cp_commit();
      const float* a = smem + (kt % BNS) * BSTAGE;
      const float* b = a + BR * BLD;
      const int kk = 8 * warp;
      FragA fa;
      load_a(fa, a + g * BLD + kk + tq, BLD);
#pragma unroll
      for (int n = 0; n < BNT; ++n) {
        const float* p = b + (8 * n + g) * BLD + kk + tq;
        FragB fb;
        split(p[0], fb.big[0], fb.small[0]);
        split(p[4], fb.big[1], fb.small[1]);
        mma3(acc[n], fa, fb);
      }
    }
    cp_wait<0>();
    __syncthreads();

    float* red = smem;   // [warp][n * 4 + x][lane]
#pragma unroll
    for (int n = 0; n < BNT; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        red[(warp * BNT * 4 + n * 4 + x) * 32 + lane] = acc[n][x];
    __syncthreads();
    if (mine && alive_next) {
      float sum = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < BKW; ++k2)
        sum += red[(k2 * BNT * 4 + nt * 4 + e) * 32 + lane];
      dhv = sum;
      dh[idx] = sum;
    }
  }
  if (!mine || !cell) return;

  if (!alive) {
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) dg[gx + gate * D] = 0.0f;
    dc[idx] = dcv;
    return;
  }
  const float dht = __fadd_rn(dhv, dov);
  const Cell s = gates_of(pre, cp, c, peep, u, D, ga, ca);
  const float hc = act(c, ha);
  const float dgo = __fmul_rn(__fmul_rn(dht, hc), dact(s.o, ga));
  float dcn = __fadd_rn(dcv, __fmul_rn(__fmul_rn(dht, s.o), dact(hc, ha)));
  if (peep != nullptr) dcn = __fadd_rn(dcn, __fmul_rn(dgo, peep[2 * D + u]));
  const float dgi = __fmul_rn(__fmul_rn(dcn, s.cc), dact(s.i, ga));
  const float dgf = __fmul_rn(__fmul_rn(dcn, cp), dact(s.f, ga));
  const float dgc = __fmul_rn(__fmul_rn(dcn, s.i), dact(s.cc, ca));
  float dcp = __fmul_rn(dcn, s.f);
  if (peep != nullptr) {
    dcp = __fadd_rn(__fadd_rn(dcp, __fmul_rn(dgi, peep[u])),
                    __fmul_rn(dgf, peep[D + u]));
    const long long p = (long long)row * 3 * D + u;
    dpeep[p] = __fadd_rn(dpeep[p], __fmul_rn(dgi, cp));
    dpeep[p + D] = __fadd_rn(dpeep[p + D], __fmul_rn(dgf, cp));
    dpeep[p + 2 * D] = __fadd_rn(dpeep[p + 2 * D], __fmul_rn(dgo, c));
  }
  dg[gx] = dgi;
  dg[gx + D] = dgf;
  dg[gx + 2 * D] = dgc;
  dg[gx + 3 * D] = dgo;
  dc[idx] = dcp;
}

// Raise a kernel's dynamic shared-memory cap to `smem` bytes, once.
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

}  // namespace

extern "C" {

// One forward step: xt [B, 4D] (bias added), h_prev, c_prev [B, D],
// w [D, 4D], peep [3D] or null, lens int32 [B]; writes h_out, c_out,
// out [B, D] and gates [B, 4D] (x_t + h_prev W). Returns the launch's
// cudaError_t (0 = launched).
int ptt_lstm_step_fwd(const float* xt, const float* h_prev,
                      const float* c_prev, const float* w, const float* peep,
                      const int* lens, int t, int B, int D, int ga, int ca,
                      int ha, float* h_out, float* c_out, float* out,
                      float* gates, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if ((B + FR - 1) / FR > 65535) return (int)cudaErrorInvalidValue;
  static size_t granted = 0;
  cudaError_t err = prepare(lstm_cell_fwd_kernel, FSMEM, granted);
  if (err != cudaSuccess) return (int)err;
  const bool vec = D % 4 == 0 && aligned16(h_prev) && aligned16(w);
  lstm_cell_fwd_kernel<<<dim3((D + FU - 1) / FU, (B + FR - 1) / FR), FTH,
                         FSMEM, static_cast<cudaStream_t>(stream)>>>(
      xt, h_prev, c_prev, w, peep, lens, t, B, D, ga, ca, ha, vec, h_out,
      c_out, out, gates);
  return (int)cudaGetLastError();
}

// One backward step (see the head of this file): dg_next [B, 4D] of step
// t_next or null (the first backward step: dh kept as it is), w [D, 4D];
// gates [B, 4D] (the forward's), c_prev, c_new [B, D], peep [3D] or null,
// for step t, or gates null to update dh alone; dout, dcell [B, D] or
// null (zero); dh, dc [B, D] carried in place; dpeep [B, 3D] added to in
// place (null without peepholes); writes dg [B, 4D].
int ptt_lstm_step_bwd(const float* dg_next, const float* w, const int* lens,
                      int t_next, const float* gates, const float* c_prev,
                      const float* c_new, const float* peep, int t, int B,
                      int D, int ga, int ca, int ha, const float* dout,
                      const float* dcell, float* dh, float* dc, float* dpeep,
                      float* dg, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if ((B + BR - 1) / BR > 65535) return (int)cudaErrorInvalidValue;
  static size_t granted = 0;
  cudaError_t err = prepare(lstm_cell_bwd_kernel, BSMEM, granted);
  if (err != cudaSuccess) return (int)err;
  const bool vec = dg_next == nullptr || (aligned16(dg_next) && aligned16(w));
  lstm_cell_bwd_kernel<<<dim3((D + BU - 1) / BU, (B + BR - 1) / BR), BTH,
                         BSMEM, static_cast<cudaStream_t>(stream)>>>(
      dg_next, w, lens, t_next, gates, c_prev, c_new, peep, t, B, D, ga, ca,
      ha, vec, dout, dcell, dh, dc, dpeep, dg);
  return (int)cudaGetLastError();
}

const char* ptt_lstm_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
