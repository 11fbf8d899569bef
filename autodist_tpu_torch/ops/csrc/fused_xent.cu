// Fused LM-head softmax cross-entropy kernels for Hopper (sm_90a).
//
// lse[n] = logsumexp_v(h[n] . w[:, v] + b[v]) and its gradient, with the
// [N, V] logits never written to device memory: each [BM, TN] logits tile
// lives in shared memory only and is reduced on the fly (forward) or
// recomputed from the saved lse (backward).
//
// Replaces the Pallas TPU kernels of autodist_tpu/ops/fused_xent.py:
//   xent_fwd_kernel  <- _fwd_kernel   (fused_xent.py:90, pallas_call :192)
//   xent_dh_kernel   <- _dh_kernel    (fused_xent.py:215, pallas_call :287)
//   xent_dwdb_kernel <- _dwdb_kernel  (fused_xent.py:237, pallas_call :305)
//
// What bounds them: operations. At the flagship micro-batch (N = 98,304,
// D = 512, V = 32,000) the forward is one [N,D]x[D,V] product (3.2 TFLOP)
// against 0.17 GB of inputs, and each backward kernel recomputes the logits
// and does one more product of the same size (6.4 TFLOP); all three sit far
// above the card's ~295 FLOP/byte ridge.
//
// Design, and how it differs from the TPU kernels:
// - The TPU grid runs in order, so the Pallas kernels carry (m, l) and the
//   dh / dw accumulators across grid steps in VMEM scratch. Hopper's blocks
//   run in no order, so the sequential loop moves inside one block: the
//   forward and dh kernels give each block one stripe of BM rows that walks
//   every vocab tile; the dw/db kernel gives each block one tile of TN_COL
//   vocab columns that walks every row stripe. No cross-block reduction.
// - Shared memory holds the block's bf16 h stripe (or w tile) for the whole
//   loop, the bf16 w tile (or h stripe) of the current step, and the f32
//   logits tile. The dh and dw accumulators live in registers as WMMA
//   fragments (128 floats a thread at D = 512).
// - In the forward and dh kernels every block streams all of w through
//   shared memory, so the w tile copy is what the products wait on. It is
//   asynchronous (cp.async into an f32 staging buffer): the copy of tile
//   t + 1 is in flight while tile t's products and softmax run.
// - w is read in its stored layout ([D,V] "dv" or [V,D] "vd") and dtype
//   (f32) and cast to bf16 per tile in shared memory; no cast or transposed
//   copy of the table is made in device memory.
// - Every load is bounds-checked: vocab lanes >= V read w = 0 and get logit
//   -inf; rows >= N read h = 0 and contribute exactly 0 to dw and db, whatever
//   the bias (the TPU reads undefined memory there and masks afterwards).
// - Products are bf16 x bf16 with f32 accumulation on the tensor cores
//   (WMMA 16x16x16); softmax statistics are f32. No TMA or wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;        // rows of h per stripe
constexpr int TN_ROW = 32;    // vocab columns per step of the forward and dh kernels
constexpr int TN_COL = 64;    // vocab columns per block of the dw/db kernel
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr float NEG_BIG = -1e30f;  // initial running max: finite, so exp(m - m_new) is never NaN

// Shared-memory tiles for TN vocab columns. Row strides are padded by 16
// bytes (8 bf16 / 4 f32) so that WMMA fragment loads do not all land on one
// bank; every region size is a multiple of 128 bytes.
template <int D, bool VD, int TN>
struct Tiles {
  static constexpr int H_LD = D + 8;           // bf16 h stripe [BM][H_LD]
  static constexpr int W_ROWS = VD ? TN : D;   // w tile in its stored layout:
  static constexpr int W_COLS = VD ? D : TN;   //   vd [TN][D], dv [D][TN]
  static constexpr int W_LD = W_COLS + 8;      // bf16 w tile [W_ROWS][W_LD]
  static constexpr int S_LD = TN + 4;          // f32 logits tile [BM][S_LD]
  static constexpr int P_LD = TN + 8;          // bf16 g*softmax tile [BM][P_LD]
  static constexpr size_t H_BYTES = size_t(BM) * H_LD * 2;
  static constexpr size_t F_BYTES = size_t(W_ROWS) * W_COLS * 4;  // f32 staging, unpadded
  static constexpr size_t W_BYTES = size_t(W_ROWS) * W_LD * 2;
  static constexpr size_t S_BYTES = size_t(BM) * S_LD * 4;
  static constexpr size_t P_BYTES = size_t(BM) * P_LD * 2;
  static constexpr size_t E_BYTES = size_t(WARPS) * 16 * 16 * 4;  // per-warp epilogue stage
  static_assert(H_BYTES % 128 == 0 && F_BYTES % 128 == 0 && W_BYTES % 128 == 0 &&
                S_BYTES % 128 == 0 && P_BYTES % 128 == 0, "regions must stay aligned");
};

// Dynamic shared memory of each kernel, region by region in that order.
template <int D, bool VD>
struct Smem {
  typedef Tiles<D, VD, TN_ROW> R;
  typedef Tiles<D, VD, TN_COL> C;
  static constexpr size_t FWD = R::H_BYTES + R::F_BYTES + R::W_BYTES + R::S_BYTES;
  static constexpr size_t DH = FWD + R::P_BYTES + R::E_BYTES;
  static constexpr size_t RED_BYTES = size_t(THREADS / TN_COL) * TN_COL * 4;  // db partials
  static constexpr size_t DWDB = C::H_BYTES + C::W_BYTES + C::S_BYTES + C::P_BYTES +
                                 C::E_BYTES + RED_BYTES + size_t(2) * BM * 4;
  static_assert(DH <= 232448 && DWDB <= 232448, "over the 227 KB a block may use");
};

// ------------------------------------------------------------ copies to smem

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copies. `bytes` below the copy size
// zero-fills the rest of the destination; 0 reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// h rows [n0, n0 + BM) -> hs, asynchronously; rows >= n are zeros. h must be
// 16-byte aligned (the wrapper checks).
template <int D>
__device__ __forceinline__ void copy_h_stripe(bf16* hs, const bf16* __restrict__ h, int n0,
                                              int n) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks a row
  static_assert((BM * CHUNKS) % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int k = 0; k < BM * CHUNKS / THREADS; ++k) {
    const int i = threadIdx.x + k * THREADS;
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const bool ok = n0 + r < n;
    cp_async16(hs + r * (D + 8) + c, ok ? h + size_t(n0 + r) * D + c : h, ok ? 16 : 0);
  }
}

// Vocab columns [v0, v0 + TN) of w, in its stored layout and dtype -> the
// f32 staging buffer fs ([D][TN] for dv, [TN][D] for vd), asynchronously.
// Lanes >= v are zero-filled. With `vec` (w 16-byte aligned, and vd or
// v % 4 == 0) the copies are 4-float chunks, none of which straddles v;
// otherwise single floats. Neighbouring threads copy neighbouring addresses.
template <int D, bool VD, int TN>
__device__ __forceinline__ void copy_w_tile(float* fs, const float* __restrict__ w, int v0,
                                            int v, bool vec) {
  constexpr int COLS = Tiles<D, VD, TN>::W_COLS;
  constexpr int ELEMS = D * TN;
  static_assert(ELEMS % (4 * THREADS) == 0, "whole chunks per thread");
  if (vec) {
#pragma unroll
    for (int k = 0; k < ELEMS / 4 / THREADS; ++k) {
      const int i = threadIdx.x + k * THREADS;
      const int r = i / (COLS / 4);
      const int c = (i % (COLS / 4)) * 4;
      const int vv = VD ? v0 + r : v0 + c;  // vocab index of the chunk's first lane
      const bool ok = vv < v;
      const float* src = VD ? w + size_t(vv) * D + c : w + size_t(r) * v + vv;
      cp_async16(fs + r * COLS + c, ok ? src : w, ok ? 16 : 0);
    }
  } else {
#pragma unroll 8
    for (int k = 0; k < ELEMS / THREADS; ++k) {
      const int i = threadIdx.x + k * THREADS;
      const int r = i / COLS;
      const int c = i % COLS;
      const int vv = VD ? v0 + r : v0 + c;
      const bool ok = vv < v;
      const float* src = VD ? w + size_t(vv) * D + c : w + size_t(r) * v + vv;
      cp_async4(fs + r * COLS + c, ok ? src : w, ok ? 4 : 0);
    }
  }
}

// f32 staging fs -> bf16 w tile ws (padded rows), four values a step.
template <int D, bool VD, int TN>
__device__ __forceinline__ void convert_w_tile(bf16* ws, const float* fs) {
  typedef Tiles<D, VD, TN> T;
#pragma unroll
  for (int k = 0; k < D * TN / 4 / THREADS; ++k) {
    const int i = threadIdx.x + k * THREADS;
    const int r = i / (T::W_COLS / 4);
    const int c = (i % (T::W_COLS / 4)) * 4;
    const float4 x = *reinterpret_cast<const float4*>(fs + r * T::W_COLS + c);
    __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
    uint2 packed;
    packed.x = *reinterpret_cast<unsigned*>(&lo);
    packed.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(ws + r * T::W_LD + c) = packed;
  }
}

// The dw/db kernel's w tile, loaded once per block: f32 global -> bf16
// shared through registers, eight loads in flight a thread.
template <int D, bool VD, int TN>
__device__ __forceinline__ void load_w_tile(bf16* ws, const float* __restrict__ w, int v0,
                                            int v) {
  typedef Tiles<D, VD, TN> T;
#pragma unroll 8
  for (int k = 0; k < D * TN / THREADS; ++k) {
    const int i = threadIdx.x + k * THREADS;
    const int r = i / T::W_COLS;
    const int c = i % T::W_COLS;
    const int vv = VD ? v0 + r : v0 + c;
    const float x = vv < v ? (VD ? w[size_t(vv) * D + c] : w[size_t(r) * v + vv]) : 0.f;
    ws[r * T::W_LD + c] = __float2bfloat16(x);
  }
}

// ss[BM][TN] = hs[BM][D] . w_tile[D][TN] (f32). Warp k computes rows
// 16*(k/2) .. +16 and columns (TN/2)*(k%2) .. +TN/2.
template <int D, bool VD, int TN>
__device__ __forceinline__ void logits_tile(const bf16* hs, const bf16* ws, float* ss) {
  typedef Tiles<D, VD, TN> T;
  typedef typename std::conditional<VD, wmma::col_major, wmma::row_major>::type WLayout;
  constexpr int CF = TN / 32;  // 16-column fragments per warp
  const int warp = threadIdx.x / 32;
  const int r = (warp / 2) * 16;
  const int c0 = (warp % 2) * (TN / 2);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[CF];
#pragma unroll
  for (int j = 0; j < CF; ++j) wmma::fill_fragment(acc[j], 0.f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, WLayout> b;
#pragma unroll 4
  for (int k = 0; k < D; k += 16) {
    wmma::load_matrix_sync(a, hs + r * T::H_LD + k, T::H_LD);
#pragma unroll
    for (int j = 0; j < CF; ++j) {
      const int c = c0 + 16 * j;
      // element (k, c) of the [D, TN] operand: vd stores it at ws[c][k], dv at ws[k][c]
      const bf16* bp = VD ? ws + c * T::W_LD + k : ws + k * T::W_LD + c;
      wmma::load_matrix_sync(b, bp, T::W_LD);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < CF; ++j)
    wmma::store_matrix_sync(ss + r * T::S_LD + c0 + 16 * j, acc[j], T::S_LD,
                            wmma::mem_row_major);
}

// ------------------------------------------------------------------ forward

template <int D, bool VD>
__global__ void __launch_bounds__(THREADS, 1)
xent_fwd_kernel(const bf16* __restrict__ h, const float* __restrict__ w,
                const float* __restrict__ b, float* __restrict__ lse, int n, int v,
                int vec) {
  typedef Tiles<D, VD, TN_ROW> T;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);
  float* fs = reinterpret_cast<float*>(smem + T::H_BYTES);
  bf16* ws = reinterpret_cast<bf16*>(smem + T::H_BYTES + T::F_BYTES);
  float* ss = reinterpret_cast<float*>(smem + T::H_BYTES + T::F_BYTES + T::W_BYTES);

  const int n0 = blockIdx.x * BM;
  copy_h_stripe<D>(hs, h, n0, n);
  copy_w_tile<D, VD, TN_ROW>(fs, w, 0, v, vec);
  cp_async_commit();
  // Four consecutive lanes share one row; lane `seg` takes columns seg, seg+4, ...
  const int row = threadIdx.x / 4;
  const int seg = threadIdx.x % 4;
  float m = NEG_BIG, l = 0.f;
  for (int v0 = 0; v0 < v; v0 += TN_ROW) {
    cp_async_wait_all();
    __syncthreads();  // fs holds tile v0; the previous step's readers of ws and ss are done
    convert_w_tile<D, VD, TN_ROW>(ws, fs);
    __syncthreads();  // ws is ready and fs free: start the next tile's copy
    if (v0 + TN_ROW < v) {
      copy_w_tile<D, VD, TN_ROW>(fs, w, v0 + TN_ROW, v, vec);
      cp_async_commit();
    }
    logits_tile<D, VD, TN_ROW>(hs, ws, ss);
    __syncthreads();
    float x[TN_ROW / 4];
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < TN_ROW / 4; ++i) {
      const int col = seg + 4 * i;
      const int vv = v0 + col;
      const float s = vv < v ? ss[row * T::S_LD + col] + (b ? b[vv] : 0.f) : -INFINITY;
      x[i] = s;
      tmax = fmaxf(tmax, s);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < TN_ROW / 4; ++i) psum += __expf(x[i] - m_new);
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * __expf(m - m_new) + psum;
    m = m_new;
  }
  if (seg == 0 && n0 + row < n) lse[n0 + row] = m + logf(fmaxf(l, 1e-30f));
}

// ----------------------------------------------------------------------- dh

// dh[n] = sum_v g[n] * softmax(h w + b)[n, v] * w[:, v], logits recomputed
// from the saved lse. Warp k accumulates rows 16*(k/2) .. +16 and model
// columns (D/2)*(k%2) .. +D/2 of the block's [BM, D] result in registers.
template <int D, bool VD>
__global__ void __launch_bounds__(THREADS, 1)
xent_dh_kernel(const bf16* __restrict__ h, const float* __restrict__ w,
               const float* __restrict__ b, const float* __restrict__ lse,
               const float* __restrict__ g, bf16* __restrict__ dh, int n, int v, int vec) {
  typedef Tiles<D, VD, TN_ROW> T;
  // B operand of P . w^T: element (vocab k, model d). vd stores it at ws[k][d]
  // (row major), dv at ws[d][k] (column major).
  typedef typename std::conditional<VD, wmma::row_major, wmma::col_major>::type WtLayout;
  constexpr int NF = D / 32;  // accumulator fragments per warp
  static_assert(D % 32 == 0, "D must be a multiple of 32");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);
  float* fs = reinterpret_cast<float*>(smem + T::H_BYTES);
  bf16* ws = reinterpret_cast<bf16*>(smem + T::H_BYTES + T::F_BYTES);
  float* ss = reinterpret_cast<float*>(smem + T::H_BYTES + T::F_BYTES + T::W_BYTES);
  bf16* ps = reinterpret_cast<bf16*>(smem + Smem<D, VD>::FWD);
  float* stage = reinterpret_cast<float*>(smem + Smem<D, VD>::FWD + T::P_BYTES);

  const int n0 = blockIdx.x * BM;
  copy_h_stripe<D>(hs, h, n0, n);
  copy_w_tile<D, VD, TN_ROW>(fs, w, 0, v, vec);
  cp_async_commit();
  const int row = threadIdx.x / 4;
  const int seg = threadIdx.x % 4;
  const bool row_ok = n0 + row < n;
  const float row_lse = row_ok ? lse[n0 + row] : 0.f;
  const float row_g = row_ok ? g[n0 + row] : 0.f;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = (warp / 2) * 16;
  const int c0 = (warp % 2) * (D / 2);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, WtLayout> bt;

  for (int v0 = 0; v0 < v; v0 += TN_ROW) {
    cp_async_wait_all();
    __syncthreads();  // fs holds tile v0; the previous step's readers of ws, ss, ps are done
    convert_w_tile<D, VD, TN_ROW>(ws, fs);
    __syncthreads();
    if (v0 + TN_ROW < v) {
      copy_w_tile<D, VD, TN_ROW>(fs, w, v0 + TN_ROW, v, vec);
      cp_async_commit();
    }
    logits_tile<D, VD, TN_ROW>(hs, ws, ss);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TN_ROW / 4; ++i) {
      const int col = seg + 4 * i;
      const int vv = v0 + col;
      float p = 0.f;
      if (row_ok && vv < v)
        p = __expf(ss[row * T::S_LD + col] + (b ? b[vv] : 0.f) - row_lse) * row_g;
      ps[row * T::P_LD + col] = __float2bfloat16(p);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TN_ROW; kk += 16) {
      wmma::load_matrix_sync(a, ps + r * T::P_LD + kk, T::P_LD);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int c = c0 + 16 * f;
        const bf16* bp = VD ? ws + kk * T::W_LD + c : ws + c * T::W_LD + kk;
        wmma::load_matrix_sync(bt, bp, T::W_LD);
        wmma::mma_sync(acc[f], a, bt, acc[f]);
      }
    }
  }

  // Epilogue: each fragment goes through the warp's 16x16 f32 stage and out
  // as bf16; rows >= n are not written.
  float* st = stage + warp * 256;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    wmma::store_matrix_sync(st, acc[f], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int rr = n0 + r + e / 16;
      if (rr < n) dh[size_t(rr) * D + c0 + 16 * f + e % 16] = __float2bfloat16(st[e]);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------- dwdb

// dw[:, v] = sum_n h[n] * g[n] * softmax(h w + b)[n, v], db[v] = sum_n of the
// same weights. One block per TN_COL-column vocab tile, walking all row
// stripes; its w tile stays in shared memory. The [D, TN_COL] dw accumulator
// is split over the warps by model rows: warp k owns rows (D/8)*k .. +D/8.
template <int D, bool VD>
__global__ void __launch_bounds__(THREADS, 1)
xent_dwdb_kernel(const bf16* __restrict__ h, const float* __restrict__ w,
                 const float* __restrict__ b, const float* __restrict__ lse,
                 const float* __restrict__ g, float* __restrict__ dw,
                 float* __restrict__ db, int n, int v) {
  typedef Tiles<D, VD, TN_COL> T;
  constexpr int DF = D / 16 / WARPS;  // model-row fragments per warp
  constexpr int CF = TN_COL / 16;     // vocab-column fragments
  constexpr int RGRPS = THREADS / TN_COL;  // row groups of the elementwise mapping
  static_assert(D % (16 * WARPS) == 0, "D must be a multiple of 128");
  static_assert(BM % RGRPS == 0, "whole rows per group");
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  bf16* hs = reinterpret_cast<bf16*>(p);
  bf16* ws = reinterpret_cast<bf16*>(p += T::H_BYTES);
  float* ss = reinterpret_cast<float*>(p += T::W_BYTES);
  bf16* ps = reinterpret_cast<bf16*>(p += T::S_BYTES);
  float* stage = reinterpret_cast<float*>(p += T::P_BYTES);
  float* red = reinterpret_cast<float*>(p += T::E_BYTES);
  float* lg = reinterpret_cast<float*>(p += Smem<D, VD>::RED_BYTES);  // [2][BM]: lse, g

  const int v0 = blockIdx.x * TN_COL;
  load_w_tile<D, VD, TN_COL>(ws, w, v0, v);
  // Elementwise mapping: thread t takes vocab column t % TN_COL and rows
  // (BM/RGRPS)*(t / TN_COL) .. of each stripe, so its db partial sum stays in a register.
  constexpr int RPG = BM / RGRPS;  // rows per group
  const int col = threadIdx.x % TN_COL;
  const int rgrp = (threadIdx.x / TN_COL) * RPG;
  const bool col_ok = v0 + col < v;
  const float bias = (col_ok && b) ? b[v0 + col] : 0.f;
  float db_part = 0.f;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d0 = warp * DF * 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DF][CF];
#pragma unroll
  for (int i = 0; i < DF; ++i)
#pragma unroll
    for (int j = 0; j < CF; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  // A operand h^T: element (model d, row k) sits at hs[k][d] -> column major.
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> pb;

  for (int n0 = 0; n0 < n; n0 += BM) {
    __syncthreads();  // the previous stripe's readers of hs / ps / lg are done
    copy_h_stripe<D>(hs, h, n0, n);
    cp_async_commit();
    if (threadIdx.x < BM) {  // the stripe's lse and g, read once per stripe
      const bool ok = n0 + threadIdx.x < n;
      lg[threadIdx.x] = ok ? lse[n0 + threadIdx.x] : 0.f;
      lg[BM + threadIdx.x] = ok ? g[n0 + threadIdx.x] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    logits_tile<D, VD, TN_COL>(hs, ws, ss);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < RPG; ++i) {
      const int rr = rgrp + i;
      float pv = 0.f;  // rows >= n and columns >= v contribute exactly 0
      if (n0 + rr < n && col_ok)
        pv = __expf(ss[rr * T::S_LD + col] + bias - lg[rr]) * lg[BM + rr];
      db_part += pv;
      ps[rr * T::P_LD + col] = __float2bfloat16(pv);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BM; kk += 16) {
#pragma unroll
      for (int i = 0; i < DF; ++i) {
        wmma::load_matrix_sync(a, hs + kk * T::H_LD + d0 + 16 * i, T::H_LD);
#pragma unroll
        for (int j = 0; j < CF; ++j) {
          wmma::load_matrix_sync(pb, ps + kk * T::P_LD + 16 * j, T::P_LD);
          wmma::mma_sync(acc[i][j], a, pb, acc[i][j]);
        }
      }
    }
  }

  // Epilogue: dw in w's stored layout and dtype (f32); columns >= v are not written.
  float* st = stage + warp * 256;
#pragma unroll
  for (int i = 0; i < DF; ++i) {
#pragma unroll
    for (int j = 0; j < CF; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int d = d0 + 16 * i + e / 16;
        const int vv = v0 + 16 * j + e % 16;
        if (vv < v) {
          if (VD)
            dw[size_t(vv) * D + d] = st[e];
          else
            dw[size_t(d) * v + vv] = st[e];
        }
      }
      __syncwarp();
    }
  }
  red[(threadIdx.x / TN_COL) * TN_COL + col] = db_part;
  __syncthreads();
  if (threadIdx.x < TN_COL && v0 + threadIdx.x < v) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < RGRPS; ++k) sum += red[k * TN_COL + threadIdx.x];
    db[v0 + threadIdx.x] = sum;
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

// 4-float copies of w need a 16-byte aligned table whose rows (dv: v floats)
// keep that alignment.
bool vec_ok(const float* w, int v, bool vd) {
  return reinterpret_cast<uintptr_t>(w) % 16 == 0 && (vd || v % 4 == 0);
}

template <int D, bool VD>
int launch_fwd(const bf16* h, const float* w, const float* b, float* lse, int n, int v,
               cudaStream_t stream) {
  auto kernel = xent_fwd_kernel<D, VD>;
  cudaError_t err = set_smem(kernel, Smem<D, VD>::FWD);
  if (err != cudaSuccess) return int(err);
  kernel<<<(n + BM - 1) / BM, THREADS, Smem<D, VD>::FWD, stream>>>(h, w, b, lse, n, v,
                                                                   vec_ok(w, v, VD));
  return int(cudaGetLastError());
}

template <int D, bool VD>
int launch_dh(const bf16* h, const float* w, const float* b, const float* lse,
              const float* g, bf16* dh, int n, int v, cudaStream_t stream) {
  auto kernel = xent_dh_kernel<D, VD>;
  cudaError_t err = set_smem(kernel, Smem<D, VD>::DH);
  if (err != cudaSuccess) return int(err);
  kernel<<<(n + BM - 1) / BM, THREADS, Smem<D, VD>::DH, stream>>>(h, w, b, lse, g, dh, n,
                                                                  v, vec_ok(w, v, VD));
  return int(cudaGetLastError());
}

template <int D, bool VD>
int launch_dwdb(const bf16* h, const float* w, const float* b, const float* lse,
                const float* g, float* dw, float* db, int n, int v, cudaStream_t stream) {
  auto kernel = xent_dwdb_kernel<D, VD>;
  cudaError_t err = set_smem(kernel, Smem<D, VD>::DWDB);
  if (err != cudaSuccess) return int(err);
  kernel<<<(v + TN_COL - 1) / TN_COL, THREADS, Smem<D, VD>::DWDB, stream>>>(
      h, w, b, lse, g, dw, db, n, v);
  return int(cudaGetLastError());
}

// What every entry point takes: d = 512 (the only width instantiated), a
// non-empty problem and a 16-byte aligned h (its rows are copied in 16-byte
// chunks).
bool args_ok(const void* h, int n, int d, int v) {
  return d == 512 && n > 0 && v > 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
}

}  // namespace

// Plain C interface, loaded with ctypes. Each returns a cudaError_t (0 on
// success; cudaErrorInvalidValue for arguments args_ok refuses). h is bf16
// [n, d]; w is f32 [d, v] (w_vd == 0) or [v, d] (w_vd == 1); b is f32 [v] or
// null; lse and g are f32 [n].

extern "C" int xent_fwd(const void* h, const float* w, const float* b, float* lse, int n,
                        int d, int v, int w_vd, void* stream) {
  if (!args_ok(h, n, d, v)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* hh = static_cast<const bf16*>(h);
  return w_vd ? launch_fwd<512, true>(hh, w, b, lse, n, v, s)
              : launch_fwd<512, false>(hh, w, b, lse, n, v, s);
}

extern "C" int xent_dh(const void* h, const float* w, const float* b, const float* lse,
                       const float* g, void* dh, int n, int d, int v, int w_vd,
                       void* stream) {
  if (!args_ok(h, n, d, v)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* hh = static_cast<const bf16*>(h);
  bf16* out = static_cast<bf16*>(dh);
  return w_vd ? launch_dh<512, true>(hh, w, b, lse, g, out, n, v, s)
              : launch_dh<512, false>(hh, w, b, lse, g, out, n, v, s);
}

extern "C" int xent_dwdb(const void* h, const float* w, const float* b, const float* lse,
                         const float* g, float* dw, float* db, int n, int d, int v,
                         int w_vd, void* stream) {
  if (!args_ok(h, n, d, v)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* hh = static_cast<const bf16*>(h);
  return w_vd ? launch_dwdb<512, true>(hh, w, b, lse, g, dw, db, n, v, s)
              : launch_dwdb<512, false>(hh, w, b, lse, g, dw, db, n, v, s);
}
