// The LSTM cell's pointwise step, forward and backward, for the port's
// `lstm` lowering (paddle_tpu_torch/ops/rnn_ops.py), one launch each per
// time step.
//
// Replaces: no Pallas kernel. The JAX package's `lstm` is one lax.scan
// whose body (paddle_tpu/ops/rnn_ops.py:111-131) is a [B, 4D] gate GEMM
// and about a dozen elementwise ops that XLA fuses into the loop body.
// Run eagerly, the same body costs one GEMM and some fourteen small
// kernels a step forward and twice that backward; this file is the
// fused pointwise part. The recurrent GEMM h @ W stays torch.matmul.
//
// Bound: each launch moves about 1 MB at the main path's shape (B 64,
// D 512: the gate inputs 2 x [B, 4D] f32 read, three [B, D] written), a
// third of a microsecond at the card's memory rate, far below one
// launch's own cost: the step is bound by launches, and a CUDA graph
// (Executor.run_steps) removes the host's share of that cost.
//
// Design: one thread per (b, d) element reads its four gate columns
// i, f, c~, o at d, D + d, 2D + d, 3D + d (neighbouring threads on
// neighbouring addresses), so nothing is shared and no block
// synchronises. The backward recomputes the gate activations from the
// forward's inputs (x_t + h W, c_prev, the peepholes) instead of
// reading stored ones: the forward writes only h, c and the output, and
// the backward reads what the forward read. Products and sums round
// one at a time (__fmul_rn, __fadd_rn: no contraction into FMA) and
// the activations use expf and tanhf, as PyTorch's own elementwise
// kernels compute the plain version, so the two agree to a few ulp.
// The peephole gradients are written per row ([B, 3D]) and summed by
// the caller: no float atomics, so a CUDA graph replays bitwise.
//
// Activation codes: 0 identity, 1 sigmoid, 2 tanh, 3 relu.

#include <cuda_runtime.h>

namespace {

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

struct Gates {
  float i, f, cc, o, c, hc;   // activations, the new cell, ha(c)
  float gi, gf, go;           // pre-activations after the peepholes
};

// The forward of one element: the JAX step body.
__device__ __forceinline__ Gates cell(const float* __restrict__ xt,
                                      const float* __restrict__ hw,
                                      const float* __restrict__ peep,
                                      long long g, int d, int D, float cp,
                                      int ga, int ca, int ha) {
  Gates s;
  float gi = __fadd_rn(xt[g], hw[g]);
  float gf = __fadd_rn(xt[g + D], hw[g + D]);
  float gc = __fadd_rn(xt[g + 2 * D], hw[g + 2 * D]);
  float go = __fadd_rn(xt[g + 3 * D], hw[g + 3 * D]);
  if (peep != nullptr) {
    gi = __fadd_rn(gi, __fmul_rn(cp, peep[d]));
    gf = __fadd_rn(gf, __fmul_rn(cp, peep[D + d]));
  }
  s.i = act(gi, ga);
  s.f = act(gf, ga);
  s.cc = act(gc, ca);
  s.c = __fadd_rn(__fmul_rn(s.f, cp), __fmul_rn(s.i, s.cc));
  if (peep != nullptr) go = __fadd_rn(go, __fmul_rn(s.c, peep[2 * D + d]));
  s.o = act(go, ga);
  s.hc = act(s.c, ha);
  s.gi = gi;
  s.gf = gf;
  s.go = go;
  return s;
}

__global__ void __launch_bounds__(256)
lstm_cell_fwd_kernel(const float* __restrict__ xt,
                     const float* __restrict__ hw,
                     const float* __restrict__ c_prev,
                     const float* __restrict__ h_prev,
                     const float* __restrict__ peep,
                     const int* __restrict__ lens, int t, int B, int D,
                     int ga, int ca, int ha, float* __restrict__ h_out,
                     float* __restrict__ c_out, float* __restrict__ out) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * D) return;
  int b = (int)(idx / D);
  int d = (int)(idx - (long long)b * D);
  long long g = (long long)b * 4 * D + d;
  float cp = c_prev[idx];
  Gates s = cell(xt, hw, peep, g, d, D, cp, ga, ca, ha);
  float h = __fmul_rn(s.o, s.hc);
  bool alive = t < lens[b];
  h_out[idx] = alive ? h : h_prev[idx];
  c_out[idx] = alive ? s.c : cp;
  out[idx] = alive ? h : 0.0f;
}

// From the gradients of the step's three outputs (dh: the carried h,
// dc: the carried c, dout: the masked output): d(gates) [B, 4D] (the
// gradient of both x_t and h W), dc_prev, the pass-through part of
// dh_prev (a dead row hands its carry's gradient back unchanged; a live
// row's h_prev reaches the step only through h W) and, with peepholes,
// the per-row peephole gradients [B, 3D].
__global__ void __launch_bounds__(256)
lstm_cell_bwd_kernel(const float* __restrict__ xt,
                     const float* __restrict__ hw,
                     const float* __restrict__ c_prev,
                     const float* __restrict__ peep,
                     const int* __restrict__ lens, int t, int B, int D,
                     int ga, int ca, int ha,
                     const float* __restrict__ dh_in,
                     const float* __restrict__ dc_in,
                     const float* __restrict__ dout,
                     float* __restrict__ dgates,
                     float* __restrict__ dc_prev,
                     float* __restrict__ dh_prev,
                     float* __restrict__ dpeep) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * D) return;
  int b = (int)(idx / D);
  int d = (int)(idx - (long long)b * D);
  long long g = (long long)b * 4 * D + d;
  long long p = (long long)b * 3 * D + d;
  if (!(t < lens[b])) {
    dgates[g] = 0.0f;
    dgates[g + D] = 0.0f;
    dgates[g + 2 * D] = 0.0f;
    dgates[g + 3 * D] = 0.0f;
    dc_prev[idx] = dc_in[idx];
    dh_prev[idx] = dh_in[idx];
    if (dpeep != nullptr) {
      dpeep[p] = 0.0f;
      dpeep[p + D] = 0.0f;
      dpeep[p + 2 * D] = 0.0f;
    }
    return;
  }
  float cp = c_prev[idx];
  Gates s = cell(xt, hw, peep, g, d, D, cp, ga, ca, ha);
  float dh = __fadd_rn(dh_in[idx], dout[idx]);
  float dgo = __fmul_rn(__fmul_rn(dh, s.hc), dact(s.o, ga));
  float dc = __fadd_rn(dc_in[idx],
                       __fmul_rn(__fmul_rn(dh, s.o), dact(s.hc, ha)));
  if (peep != nullptr) dc = __fadd_rn(dc, __fmul_rn(dgo, peep[2 * D + d]));
  float dgi = __fmul_rn(__fmul_rn(dc, s.cc), dact(s.i, ga));
  float dgf = __fmul_rn(__fmul_rn(dc, cp), dact(s.f, ga));
  float dgc = __fmul_rn(__fmul_rn(dc, s.i), dact(s.cc, ca));
  float dcp = __fmul_rn(dc, s.f);
  if (peep != nullptr) {
    dcp = __fadd_rn(dcp, __fadd_rn(__fmul_rn(dgi, peep[d]),
                                   __fmul_rn(dgf, peep[D + d])));
    dpeep[p] = __fmul_rn(dgi, cp);
    dpeep[p + D] = __fmul_rn(dgf, cp);
    dpeep[p + 2 * D] = __fmul_rn(dgo, s.c);
  }
  dgates[g] = dgi;
  dgates[g + D] = dgf;
  dgates[g + 2 * D] = dgc;
  dgates[g + 3 * D] = dgo;
  dc_prev[idx] = dcp;
  dh_prev[idx] = 0.0f;
}

constexpr int kThreads = 256;

int blocks(int B, int D) {
  long long n = (long long)B * D;
  return (int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int ptt_lstm_cell_fwd(const float* xt, const float* hw, const float* c_prev,
                      const float* h_prev, const float* peep,
                      const int* lens, int t, int B, int D, int ga, int ca,
                      int ha, float* h_out, float* c_out, float* out,
                      void* stream) {
  if (B <= 0 || D <= 0) return 0;
  lstm_cell_fwd_kernel<<<blocks(B, D), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      xt, hw, c_prev, h_prev, peep, lens, t, B, D, ga, ca, ha, h_out, c_out,
      out);
  return static_cast<int>(cudaGetLastError());
}

int ptt_lstm_cell_bwd(const float* xt, const float* hw, const float* c_prev,
                      const float* peep, const int* lens, int t, int B,
                      int D, int ga, int ca, int ha, const float* dh_in,
                      const float* dc_in, const float* dout, float* dgates,
                      float* dc_prev, float* dh_prev, float* dpeep,
                      void* stream) {
  if (B <= 0 || D <= 0) return 0;
  lstm_cell_bwd_kernel<<<blocks(B, D), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      xt, hw, c_prev, peep, lens, t, B, D, ga, ca, ha, dh_in, dc_in, dout,
      dgates, dc_prev, dh_prev, dpeep);
  return static_cast<int>(cudaGetLastError());
}

const char* ptt_lstm_cell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
