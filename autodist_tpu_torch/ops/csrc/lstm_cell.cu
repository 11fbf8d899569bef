// The LSTM cell's elementwise step, forward and backward, for Hopper
// (sm_90a): one launch a time step each way, where the same arithmetic in
// PyTorch's own ops is a dozen launches forward and twenty backward.
//
// No TPU kernel: the JAX package runs flax's OptimizedLSTMCell under
// lax.scan, which XLA fuses. The products stay cuBLAS calls (the
// hidden-side [B, H] x [H, 4H] a step, in autodist_tpu_torch/ops/lstm_cell.py);
// these kernels take everything between them.
//
// Forward, per element (b, j) of [B, H], gate k in (i, f, g, o) at column
// j + k H, T the compute dtype and rd() its rounding (flax's promote_dtype:
// the products, the bias add and the gates are in T; the carry is f32):
//   y_k = rd(rd(yh_k + bh_k) + xg_k)
//   i = rd(sig(y_i)), f = rd(sig(y_f)), g = rd(tanh(y_g)), o = rd(sig(y_o))
//   c = f * c_prev + rd(i * g),  h = o * tanh(c)           (f32)
// It writes c and h (f32), h rounded to T (the next step's product
// operand), and the gates (i, f, g, o) in T for the backward.
//
// Backward, per element, with dh = dh_out + dh_rec (the output's gradient
// and the next step's product dy_{t+1} wh^T) and dc the carry's gradient:
//   dc' = dc + dh * o * (1 - tanh(c)^2)
//   dy_i = dc' g i (1 - i), dy_f = dc' c_prev f (1 - f),
//   dy_g = dc' i (1 - g^2), dy_o = dh tanh(c) o (1 - o)
//   dc <- dc' f
// dy is written in T ([B, 4H], the products' operand); dc stays f32.
//
// Rows are strided (ld in elements) so that a time step's slice of a
// [B, T, ...] tensor is read and written in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and back.
template <typename T>
__device__ __forceinline__ float rd(float x) { return to_f(from_f<T>(x)); }
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

template <typename T>
__global__ void lstm_fwd_kernel(const T* __restrict__ yh, const T* __restrict__ bh,
                                const T* __restrict__ xg, int ld_xg,
                                const float* __restrict__ c_prev, int ld_c,
                                float* __restrict__ c, float* __restrict__ h, int ld_h,
                                T* __restrict__ h_t, T* __restrict__ act, int ld_act, int batch,
                                int hidden) {
  const int n = batch * hidden;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
    const int b = e / hidden, j = e % hidden;
    float y[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int col = j + k * hidden;
      const float p = yh != nullptr ? to_f(yh[size_t(b) * 4 * hidden + col]) : 0.f;
      y[k] = rd<T>(rd<T>(p + to_f(bh[col])) + to_f(xg[size_t(b) * ld_xg + col]));
    }
    const float gi = rd<T>(sigmoid(y[0])), gf = rd<T>(sigmoid(y[1]));
    const float gg = rd<T>(tanhf(y[2])), go = rd<T>(sigmoid(y[3]));
    const float cp = c_prev != nullptr ? c_prev[size_t(b) * ld_c + j] : 0.f;
    const float cn = gf * cp + rd<T>(gi * gg);
    const float hn = go * tanhf(cn);
    c[size_t(b) * ld_c + j] = cn;
    h[size_t(b) * ld_h + j] = hn;
    h_t[size_t(b) * hidden + j] = from_f<T>(hn);
    T* a = act + size_t(b) * ld_act + j;
    a[0] = from_f<T>(gi);
    a[hidden] = from_f<T>(gf);
    a[2 * hidden] = from_f<T>(gg);
    a[3 * hidden] = from_f<T>(go);
  }
}

template <typename T>
__global__ void lstm_bwd_kernel(const float* __restrict__ dh_out, int ld_dh,
                                const T* __restrict__ dh_rec, float* __restrict__ dc,
                                const T* __restrict__ act, int ld_act,
                                const float* __restrict__ c, const float* __restrict__ c_prev,
                                int ld_c, T* __restrict__ dy, int ld_dy, int batch, int hidden) {
  const int n = batch * hidden;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
    const int b = e / hidden, j = e % hidden;
    const T* a = act + size_t(b) * ld_act + j;
    const float gi = to_f(a[0]), gf = to_f(a[hidden]), gg = to_f(a[2 * hidden]);
    const float go = to_f(a[3 * hidden]);
    float dh = dh_out[size_t(b) * ld_dh + j];
    if (dh_rec != nullptr) dh += to_f(dh_rec[size_t(b) * hidden + j]);
    const float tc = tanhf(c[size_t(b) * ld_c + j]);
    const float cp = c_prev != nullptr ? c_prev[size_t(b) * ld_c + j] : 0.f;
    const float dcn = dc[size_t(b) * hidden + j] + dh * go * (1.f - tc * tc);
    T* d = dy + size_t(b) * ld_dy + j;
    d[0] = from_f<T>(dcn * gg * gi * (1.f - gi));
    d[hidden] = from_f<T>(dcn * cp * gf * (1.f - gf));
    d[2 * hidden] = from_f<T>(dcn * gi * (1.f - gg * gg));
    d[3 * hidden] = from_f<T>(dh * tc * go * (1.f - go));
    dc[size_t(b) * hidden + j] = dcn * gf;
  }
}

int blocks_for(int n) { return (n + 255) / 256 < 132 * 8 ? (n + 255) / 256 : 132 * 8; }

}  // namespace

// Plain C interface, loaded with ctypes; each returns a cudaError_t. bf16 is
// 1 for a bf16 compute dtype, 0 for f32. Pointers may be null where the
// wrapper says (yh and c_prev at the first step, dh_rec at the last, c_prev
// at the first in the backward).

extern "C" int lstm_cell_fwd(const void* yh, const void* bh, const void* xg, int ld_xg,
                             const float* c_prev, int ld_c, float* c, float* h, int ld_h,
                             void* h_t, void* act, int ld_act, int batch, int hidden, int bf16,
                             void* stream) {
  if (batch <= 0 || hidden <= 0) return int(cudaErrorInvalidValue);
  const int n = batch * hidden;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    typedef __nv_bfloat16 T;
    lstm_fwd_kernel<T><<<blocks_for(n), 256, 0, s>>>(
        static_cast<const T*>(yh), static_cast<const T*>(bh), static_cast<const T*>(xg), ld_xg,
        c_prev, ld_c, c, h, ld_h, static_cast<T*>(h_t), static_cast<T*>(act), ld_act, batch,
        hidden);
  } else {
    lstm_fwd_kernel<float><<<blocks_for(n), 256, 0, s>>>(
        static_cast<const float*>(yh), static_cast<const float*>(bh),
        static_cast<const float*>(xg), ld_xg, c_prev, ld_c, c, h, ld_h,
        static_cast<float*>(h_t), static_cast<float*>(act), ld_act, batch, hidden);
  }
  return int(cudaGetLastError());
}

extern "C" int lstm_cell_bwd(const float* dh_out, int ld_dh, const void* dh_rec, float* dc,
                             const void* act, int ld_act, const float* c, const float* c_prev,
                             int ld_c, void* dy, int ld_dy, int batch, int hidden, int bf16,
                             void* stream) {
  if (batch <= 0 || hidden <= 0) return int(cudaErrorInvalidValue);
  const int n = batch * hidden;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    typedef __nv_bfloat16 T;
    lstm_bwd_kernel<T><<<blocks_for(n), 256, 0, s>>>(
        dh_out, ld_dh, static_cast<const T*>(dh_rec), dc, static_cast<const T*>(act), ld_act, c,
        c_prev, ld_c, static_cast<T*>(dy), ld_dy, batch, hidden);
  } else {
    lstm_bwd_kernel<float><<<blocks_for(n), 256, 0, s>>>(
        dh_out, ld_dh, static_cast<const float*>(dh_rec), dc, static_cast<const float*>(act),
        ld_act, c, c_prev, ld_c, static_cast<float*>(dy), ld_dy, batch, hidden);
  }
  return int(cudaGetLastError());
}
