// Fused LM-head softmax cross-entropy kernels for Hopper (sm_90a).
//
// lse[n] = logsumexp_v(h[n] . w[:, v] + b[v]) and its gradient, with the
// [N, V] logits never written to device memory: each logits tile lives in
// registers (forward, dh) or shared memory (dw/db) only and is reduced on
// the fly (forward) or recomputed from the saved lse (backward).
//
// Replaces the Pallas TPU kernels of autodist_tpu/ops/fused_xent.py:
//   xent_fwd_kernel  <- _fwd_kernel   (fused_xent.py:90, pallas_call :192)
//   xent_dh_kernel   <- _dh_kernel    (fused_xent.py:215, pallas_call :287)
//   xent_dwdb_kernel <- _dwdb_kernel  (fused_xent.py:237, pallas_call :305)
// and, beside them, xent_pack_kernel, which is no TPU kernel: the JAX
// kernels cast each w block in VMEM (`w_ref[...].astype(h_ref.dtype)`).
//
// What bounds them: operations. At the flagship micro-batch (N = 98,304,
// D = 512, V = 32,000) the forward is one [N,D]x[D,V] product (3.2 TFLOP)
// against 0.17 GB of inputs, and each backward kernel recomputes the logits
// and does one more product of the same size (6.4 TFLOP); all three sit far
// above the card's ~295 FLOP/byte ridge. Every row block streams all of w,
// so the next limit is L2 -> SM traffic: (row blocks) x 32.8 MB of bf16 w.
//
// Common to all: the TPU grid runs in order, so the Pallas kernels carry
// (m, l) and the dh / dw accumulators across grid steps in VMEM scratch.
// Hopper's blocks run in no order, so the sequential loop moves inside one
// block: the forward and dh kernels give each block one stripe of rows that
// walks every vocab tile; the dw/db kernel gives each block one tile of
// TN_COL vocab columns that walks every row stripe. No cross-block reduction.
//
// Forward and dh design (xent_fwd_kernel, xent_dh_kernel):
// - The pack: xent_pack_kernel writes w once a call as bf16 in its stored
//   layout ([D, V] "dv" or [V, D] "vd"), the "dv" rows padded to a multiple
//   of 8 columns (zeros) so that TMA's 16-byte global stride holds at any V.
//   The walk then reads half the bytes of the f32 table and converts nothing.
// - Warp specialisation, as the flash forward walk (flash_attention.cu):
//   warpgroup 0 is the producer, one of its threads issuing every copy
//   (setmaxnreg hands its registers to the consumers); warpgroups 1 and 2
//   consume. TMA reads h (2-D tensor map, 64-column boxes of 128 bytes,
//   128-byte swizzle) once a block, rows past N zero-filled and never
//   written; w streams through a ring of 64-deep d chunks with full and
//   empty mbarriers. Columns past V (TMA's zero fill, or the pack's pad)
//   are masked to -inf in the forward and give p = 0 in dh.
// - wgmma with both operands in shared memory, f32 accumulators in
//   registers: no fragment reloads through the register file. "vd" chunks
//   ([vocab][64 d]) are K-major for h . w and MN-major for P . w^T; "dv"
//   chunks ([64 d][vocab]) the other way round, so one instruction set
//   serves both layouts with no transposed copy. An MN-major operand wider
//   than 64 is 64-wide atoms LBO apart (sw128_desc's second form).
// - Forward: 128 rows a block, 64 per consumer; vocab tiles of 128 columns
//   (the scores are 64 registers a thread, one m64n128k16 a k step). Both
//   consumers read each w chunk (4 ring stages of 16 KB); the
//   running max and sum are kept per lane, starting from NEG_BIG's finite
//   max so that no lane computes exp(-inf - (-inf)), and merged over the
//   quad once at the end. The softmax of tile t - 1 runs in pieces between
//   the chunk issues of tile t, so the exponentials overlap the products.
// - dh: the [64, 512] f32 dh tile is 256 registers a thread for one
//   warpgroup, over the 255 limit, so the two consumers split the model
//   width: consumer c owns dh columns [256c, 256c + 256) (128 registers)
//   and reads only the d chunks of its half. For a 64-column vocab tile
//   each computes the partial scores over its half of d; the halves are
//   exchanged through shared memory (named barrier 1) so that each finishes
//   the scores of 32 vocab columns, writes bf16 g*p into a swizzled [64, 64]
//   P tile, and after named barrier 2 both issue P . w^T from shared memory
//   into their own dh columns (m64n256k16: the four d chunks of a half lie
//   8 KB apart). The ring holds two tiles (16 chunks of 8 KB), so tile t + 1
//   loads while tile t computes. This split computes the scores once, where
//   a split over vocab columns would give each consumer m64n32 products, and
//   a split over rows needs 128 rows of f32 dh in registers. Its cost: the
//   scores (m64n64, waited for before the softmax) and the exchange do not
//   overlap the products, so dh stays further from its bound than the
//   forward.
// - Rows >= N of the stripe arrive as zeros, are excluded from the softmax
//   sums' use (p = 0) and are not written.

#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int KERNEL_D = 512;          // the one model width instantiated
constexpr int KC = KERNEL_D / 64;      // 64-wide d chunks (one swizzled 128-byte row each)
constexpr float NEG_BIG = -1e30f;      // initial running max: finite, so exp(m - m_new) is never NaN
constexpr float LOG2E = 1.4426950408889634f;

// --------------------------------------------------------------------- pack

__device__ __forceinline__ unsigned bf16x2_bits(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// w (f32, rows x cols, row stride cols) -> wp (bf16, rows x cols_p, cols_p
// >= cols), the pad columns zero. Eight values a step where the rows keep
// 16-byte alignment, else one.
__global__ void xent_pack_kernel(const float* __restrict__ w, bf16* __restrict__ wp, int rows,
                                 int cols, int cols_p, int vec) {
  const size_t stride = size_t(gridDim.x) * blockDim.x;
  const size_t first = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (vec) {  // cols == cols_p, a multiple of 8, w 16-byte aligned
    const size_t total = size_t(rows) * cols / 8;
    for (size_t i = first; i < total; i += stride) {
      const float4 a = reinterpret_cast<const float4*>(w)[2 * i];
      const float4 c = reinterpret_cast<const float4*>(w)[2 * i + 1];
      reinterpret_cast<uint4*>(wp)[i] =
          make_uint4(bf16x2_bits(a.x, a.y), bf16x2_bits(a.z, a.w), bf16x2_bits(c.x, c.y),
                     bf16x2_bits(c.z, c.w));
    }
  } else {
    const size_t total = size_t(rows) * cols_p;
    for (size_t i = first; i < total; i += stride) {
      const int r = int(i / cols_p), c = int(i % cols_p);
      wp[i] = __float2bfloat16(c < cols ? w[size_t(r) * cols + c] : 0.f);
    }
  }
}

// Columns of the packed "dv" table: V rounded up to a multiple of 8.
inline int packed_cols(int v) { return (v + 7) / 8 * 8; }

template <typename T>
__device__ __forceinline__ T& align1024(unsigned char* raw) {
  return *reinterpret_cast<T*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// ------------------------------------------------------------------ forward

constexpr int FWD_BM = 128;            // rows a block: two consumers of 64
constexpr int FWD_TN = 128;            // vocab columns a tile
constexpr int FWD_STAGES = 4;          // w ring, in d chunks of a tile
constexpr int FWD_THREADS = 384;       // the producer warpgroup and two consumers
constexpr unsigned FWD_H_BYTES = FWD_BM * KERNEL_D * 2;
constexpr unsigned FWD_CHUNK_BYTES = FWD_TN * 64 * 2;
// setmaxnreg: what the producer gives up, the consumers take (65,536 a block).
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 65536, "register file");

struct FwdSmem {
  alignas(1024) bf16 h[KC][FWD_BM * 64];         // [d chunk][row][64 d], swizzled
  alignas(1024) bf16 w[FWD_STAGES][FWD_TN * 64]; // vd: [vocab][64 d]; dv: [2][64 d][64 vocab]
  uint64_t h_full, full[FWD_STAGES], empty[FWD_STAGES];
};
constexpr size_t FWD_SMEM = sizeof(FwdSmem) + 1024;  // + room to align the base
static_assert(FWD_SMEM <= 232448, "over the 227 KB a block may use");

// One piece of the online logsumexp of the scores x of vocab tile v0 (this
// thread's rows r and r + 8; columns v0 + 8 nt + col (+1)). Piece 0 adds
// the bias, masks columns >= v and moves the per-lane max (rescaling l);
// pieces 1-4 take the exponentials of n-tiles 4(p-1) .. 4p - 1.
__device__ __forceinline__ void lse_piece(int piece, float (&x)[16][4], float (&m)[2],
                                          float (&l)[2], float (&mc)[2], int v0, int col, int v,
                                          const float* __restrict__ b) {
  if (piece == 0) {
    if (v0 + FWD_TN <= v) {
      if (b != nullptr) {
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          const float2 bb = *reinterpret_cast<const float2*>(b + v0 + 8 * nt + col);
          x[nt][0] += bb.x;
          x[nt][1] += bb.y;
          x[nt][2] += bb.x;
          x[nt][3] += bb.y;
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int vv = v0 + 8 * nt + col + (e & 1);
          x[nt][e] = vv < v ? x[nt][e] + (b != nullptr ? b[vv] : 0.f) : -INFINITY;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], x[nt][e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] *= ex2((m[i] - mx[i]) * LOG2E);
      m[i] = mx[i];
      mc[i] = mx[i] * LOG2E;
    }
  } else {
#pragma unroll
    for (int nt = 4 * (piece - 1); nt < 4 * piece; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += ex2(fmaf(x[nt][e], LOG2E, -mc[e >> 1]));
  }
}

template <bool VD>
__global__ void __launch_bounds__(FWD_THREADS, 1)
xent_fwd_kernel(const __grid_constant__ CUtensorMap hm, const __grid_constant__ CUtensorMap wm,
                const float* __restrict__ b, float* __restrict__ lse, int n, int v) {
  extern __shared__ unsigned char fwd_raw[];
  FwdSmem& sm = align1024<FwdSmem>(fwd_raw);
  const int n0 = blockIdx.x * FWD_BM;
  const int n_tiles = (v + FWD_TN - 1) / FWD_TN;
  if (threadIdx.x == 0) {
    mbar_init(&sm.h_full, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.h_full, FWD_H_BYTES);
      for (int j = 0; j < KC; ++j) tma_load(sm.h[j], &hm, &sm.h_full, 64 * j, n0);
      int stage = 0, parity = 0;
      for (int t = 0; t < n_tiles; ++t) {
        for (int j = 0; j < KC; ++j) {
          mbar_wait(&sm.empty[stage], parity ^ 1);
          mbar_expect_tx(&sm.full[stage], FWD_CHUNK_BYTES);
          if (VD) {
            tma_load(sm.w[stage], &wm, &sm.full[stage], 64 * j, t * FWD_TN);
          } else {
            tma_load(sm.w[stage], &wm, &sm.full[stage], t * FWD_TN, 64 * j);
            tma_load(sm.w[stage] + 64 * 64, &wm, &sm.full[stage], t * FWD_TN + 64, 64 * j);
          }
          if (++stage == FWD_STAGES) {
            stage = 0;
            parity ^= 1;
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int c = wg - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int col = (lane % 4) * 2;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f}, mc[2];
  float s[16][4], x[16][4];
  int stage = 0, parity = 0;
  mbar_wait(&sm.h_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      mbar_wait(&sm.full[stage], parity);
      const uint64_t da = sw128_desc(sm.h[j] + c * 64 * 64);
      const uint64_t db = sw128_desc(sm.w[stage]);
      const uint64_t db_mn = sw128_desc(sm.w[stage], 8192);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (VD)
          wgmma_m64n128k16_ss<0>(s, da + 2 * kk, db + 2 * kk, j | kk);
        else  // MN-major: two 64-column halves, 8 KB apart
          wgmma_m64n128k16_ss<1>(s, da + 2 * kk, db_mn + 128 * kk, j | kk);
      }
      wgmma_commit();
      // The last tile's softmax, a piece at a time, while these products run.
      if (t > 0 && j <= 4) lse_piece(j, x, m, l, mc, (t - 1) * FWD_TN, col, v, b);
      if (j > 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&sm.empty[stage == 0 ? FWD_STAGES - 1 : stage - 1]);
      }
      if (++stage == FWD_STAGES) {
        stage = 0;
        parity ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&sm.empty[stage == 0 ? FWD_STAGES - 1 : stage - 1]);
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[nt][e] = s[nt][e];
  }
#pragma unroll
  for (int p = 0; p <= 4; ++p) lse_piece(p, x, m, l, mc, (n_tiles - 1) * FWD_TN, col, v, b);

  // Merge the quad's per-lane (m, l) into the row's lse.
  const int row0 = n0 + 64 * c + warp * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mm = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, 2));
    float ll = l[i] * ex2((m[i] - mm) * LOG2E);
    ll += __shfl_xor_sync(0xffffffffu, ll, 1);
    ll += __shfl_xor_sync(0xffffffffu, ll, 2);
    const int row = row0 + 8 * i;
    if (lane % 4 == 0 && row < n) lse[row] = mm + logf(fmaxf(ll, 1e-30f));
  }
}

// ----------------------------------------------------------------------- dh

constexpr int DH_BM = 64;              // rows a block
constexpr int DH_TN = 64;              // vocab columns a tile
constexpr int DH_SLOTS = 2 * KC;       // the w ring: two tiles of d chunks
constexpr int DH_THREADS = 384;
constexpr unsigned DH_H_BYTES = DH_BM * KERNEL_D * 2;
constexpr unsigned DH_CHUNK_BYTES = DH_TN * 64 * 2;

struct DhSmem {
  alignas(1024) bf16 h[KC][DH_BM * 64];       // [d chunk][row][64 d], swizzled
  alignas(1024) bf16 w[DH_SLOTS][DH_TN * 64]; // vd: [64 vocab][64 d]; dv: [64 d][64 vocab]
  alignas(1024) bf16 p[DH_BM * 64];           // g * softmax, [row][64 vocab], swizzled
  float x[2][16][128];                        // partial scores handed to the other consumer
  uint64_t h_full, full[DH_SLOTS], empty[DH_SLOTS];
};
constexpr size_t DH_SMEM = sizeof(DhSmem) + 1024;
static_assert(DH_SMEM <= 232448, "over the 227 KB a block may use");

// Consumer c's half of a dh tile step after its partial scores s (over its
// d half, all 64 vocab columns of tile v0) have landed: hand the other
// consumer the columns it finishes, finish columns [32c, 32c + 32), and
// write g * p for them into the P tile. c picks values by select, so every
// register index stays a constant and no branch depends on the consumer;
// s, which the next tile's wgmma writes, is only read.
__device__ __forceinline__ void dh_scores_to_p(DhSmem& sm, const float (&s)[8][4], int c,
                                               int tid, int r, int col, int v0, int v,
                                               const float* __restrict__ b,
                                               const float (&row_lse)[2],
                                               const float (&row_g)[2]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) sm.x[c][k][tid] = c ? s[k / 4][k % 4] : s[4 + k / 4][k % 4];
  named_sync(1);
  float z[4][4];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    z[k / 4][k % 4] = (c ? s[4 + k / 4][k % 4] : s[k / 4][k % 4]) + sm.x[1 - c][k][tid];
  unsigned char* pbase = reinterpret_cast<unsigned char*>(sm.p);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int kcol = 32 * c + 8 * q + col;  // vocab column in the tile
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float pv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int vv = v0 + kcol + e;
        const float y = z[q][2 * i + e] + (b != nullptr && vv < v ? b[vv] : 0.f);
        pv[e] = vv < v ? row_g[i] * ex2(fmaf(y, LOG2E, -row_lse[i] * LOG2E)) : 0.f;
      }
      const int rr = r + 8 * i;
      // 128-byte swizzle: 16-byte unit u of row rr sits at unit u ^ (rr % 8).
      const int off = rr * 128 + (((kcol >> 3) ^ (rr & 7)) << 4) + (kcol & 7) * 2;
      *reinterpret_cast<__nv_bfloat162*>(pbase + off) = __floats2bfloat162_rn(pv[0], pv[1]);
    }
  }
  fence_proxy_async();  // the P stores, visible to wgmma
  named_sync(2);
}

// dh[n] = sum_v g[n] * softmax(h w + b)[n, v] * w[:, v], logits recomputed
// from the saved lse.
template <bool VD>
__global__ void __launch_bounds__(DH_THREADS, 1)
xent_dh_kernel(const __grid_constant__ CUtensorMap hm, const __grid_constant__ CUtensorMap wm,
               const float* __restrict__ b, const float* __restrict__ lse,
               const float* __restrict__ g, bf16* __restrict__ dh, int n, int v) {
  extern __shared__ unsigned char dh_raw[];
  DhSmem& sm = align1024<DhSmem>(dh_raw);
  const int n0 = blockIdx.x * DH_BM;
  const int n_tiles = (v + DH_TN - 1) / DH_TN;
  if (threadIdx.x == 0) {
    mbar_init(&sm.h_full, 1);
    for (int s = 0; s < DH_SLOTS; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4);  // lane 0 of each warp of the chunk's consumer
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.h_full, DH_H_BYTES);
      for (int j = 0; j < KC; ++j) tma_load(sm.h[j], &hm, &sm.h_full, 64 * j, n0);
      for (int t = 0; t < n_tiles; ++t) {
        const int parity = (t >> 1) & 1;
        for (int j = 0; j < KC; ++j) {
          const int slot = (t & 1) * KC + j;
          mbar_wait(&sm.empty[slot], parity ^ 1);
          mbar_expect_tx(&sm.full[slot], DH_CHUNK_BYTES);
          if (VD)
            tma_load(sm.w[slot], &wm, &sm.full[slot], 64 * j, t * DH_TN);
          else
            tma_load(sm.w[slot], &wm, &sm.full[slot], t * DH_TN, 64 * j);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int c = wg - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int col = (lane % 4) * 2;
  const int r = warp * 16 + lane / 4;  // this thread's rows of the stripe: r, r + 8
  float row_lse[2], row_g[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = n0 + r + 8 * i < n;
    row_lse[i] = ok ? lse[n0 + r + 8 * i] : 0.f;
    row_g[i] = ok ? g[n0 + r + 8 * i] : 0.f;  // g = 0: rows past n give p = 0
  }
  float acc[32][4];  // dh columns 256c + 8nt + col (+1)
#pragma unroll
  for (int nt = 0; nt < 32; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float s[8][4];
  mbar_wait(&sm.h_full, 0);
  const uint64_t dp = sw128_desc(sm.p);
  for (int t = 0; t < n_tiles; ++t) {
    const int slot0 = (t & 1) * KC + 4 * c;  // this consumer's d chunks of tile t
    const int parity = (t >> 1) & 1;
    // Partial scores over this consumer's half of d, queued behind the
    // last tile's P . w^T.
#pragma unroll
    for (int q = 0; q < 4; ++q) mbar_wait(&sm.full[slot0 + q], parity);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint64_t da = sw128_desc(sm.h[4 * c + q]);
      const uint64_t db = sw128_desc(sm.w[slot0 + q]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (VD)
          wgmma_m64n64k16_ss<0>(s, da + 2 * kk, db + 2 * kk, q | kk);
        else
          wgmma_m64n64k16_ss<1>(s, da + 2 * kk, db + 128 * kk, q | kk);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(acc);
    if (t > 0 && lane == 0) {  // the last tile's chunks: its P . w^T is done
      const int prev = ((t - 1) & 1) * KC + 4 * c;
      for (int q = 0; q < 4; ++q) mbar_arrive(&sm.empty[prev + q]);
    }
    dh_scores_to_p(sm, s, c, tid, r, col, t * DH_TN, v, b, row_lse, row_g);
    // dh[:, this half] += P . w^T: k runs over the tile's 64 vocab columns.
    // The four d chunks lie 8 KB apart: "vd" as MN atoms LBO apart, "dv" as
    // 256 K-major rows in 8-row groups 1024 bytes apart.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (VD)
        wgmma_m64n256k16_ss<1>(acc, dp + 2 * kk, sw128_desc(sm.w[slot0], 8192) + 128 * kk, 1);
      else
        wgmma_m64n256k16_ss<0>(acc, dp + 2 * kk, sw128_desc(sm.w[slot0]) + 2 * kk, 1);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue: bf16 dh; rows >= n are not written.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = n0 + r + 8 * i;
    if (row >= n) continue;
    bf16* out = dh + size_t(row) * KERNEL_D + 256 * c + col;
#pragma unroll
    for (int nt = 0; nt < 32; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * nt) =
          __floats2bfloat162_rn(acc[nt][2 * i], acc[nt][2 * i + 1]);
  }
}

// ---------------------------------------------------------------- dwdb tiles

// The dw/db kernel keeps the first design: WMMA 16x16x16 from shared memory.
constexpr int BM = 64;        // rows of h per stripe
constexpr int TN_COL = 64;    // vocab columns per block of the dw/db kernel
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;

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
  static constexpr size_t W_BYTES = size_t(W_ROWS) * W_LD * 2;
  static constexpr size_t S_BYTES = size_t(BM) * S_LD * 4;
  static constexpr size_t P_BYTES = size_t(BM) * P_LD * 2;
  static constexpr size_t E_BYTES = size_t(WARPS) * 16 * 16 * 4;  // per-warp epilogue stage
  static_assert(H_BYTES % 128 == 0 && W_BYTES % 128 == 0 && S_BYTES % 128 == 0 &&
                P_BYTES % 128 == 0, "regions must stay aligned");
};

// Dynamic shared memory of the dw/db kernel, region by region in that order.
template <int D, bool VD>
struct Smem {
  typedef Tiles<D, VD, TN_COL> C;
  static constexpr size_t RED_BYTES = size_t(THREADS / TN_COL) * TN_COL * 4;  // db partials
  static constexpr size_t DWDB = C::H_BYTES + C::W_BYTES + C::S_BYTES + C::P_BYTES +
                                 C::E_BYTES + RED_BYTES + size_t(2) * BM * 4;
  static_assert(DWDB <= 232448, "over the 227 KB a block may use");
};

// Asynchronous global -> shared copies. `bytes` below the copy size
// zero-fills the rest of the destination; 0 reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
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

// ---------------------------------------------------------------- launchers

int launch_pack(const float* w, bf16* wp, int d, int v, bool vd, cudaStream_t stream) {
  const int rows = vd ? v : d, cols = vd ? d : v, cols_p = vd ? d : packed_cols(v);
  const bool vec = cols == cols_p && cols % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const size_t work = size_t(rows) * cols_p / (vec ? 8 : 1);
  const int blocks = int(std::min<size_t>((work + 255) / 256, 132 * 16));
  xent_pack_kernel<<<blocks, 256, 0, stream>>>(w, wp, rows, cols, cols_p, vec);
  return int(cudaGetLastError());
}

// Tensor maps of h (box: `rows` rows of 64 columns) and of the packed table
// (box: tn vocab rows of 64 d for vd, 64 d rows of 64 vocab for dv).
bool maps(CUtensorMap* hm, CUtensorMap* wm, const void* h, const void* wp, int n, int v, bool vd,
          int rows, int tn) {
  return matrix_map(hm, h, n, KERNEL_D, rows) &&
         (vd ? matrix_map(wm, wp, v, KERNEL_D, tn)
             : matrix_map(wm, wp, KERNEL_D, packed_cols(v), 64));
}

template <bool VD>
int launch_fwd(const void* h, const void* wp, const float* b, float* lse, int n, int v,
               cudaStream_t stream) {
  CUtensorMap hm, wm;
  if (!maps(&hm, &wm, h, wp, n, v, VD, FWD_BM, FWD_TN)) return int(cudaErrorInvalidValue);
  auto kernel = xent_fwd_kernel<VD>;
  const cudaError_t err = set_smem(kernel, FWD_SMEM);
  if (err != cudaSuccess) return int(err);
  kernel<<<(n + FWD_BM - 1) / FWD_BM, FWD_THREADS, FWD_SMEM, stream>>>(hm, wm, b, lse, n, v);
  return int(cudaGetLastError());
}

template <bool VD>
int launch_dh(const void* h, const void* wp, const float* b, const float* lse, const float* g,
              bf16* dh, int n, int v, cudaStream_t stream) {
  CUtensorMap hm, wm;
  if (!maps(&hm, &wm, h, wp, n, v, VD, DH_BM, DH_TN)) return int(cudaErrorInvalidValue);
  auto kernel = xent_dh_kernel<VD>;
  const cudaError_t err = set_smem(kernel, DH_SMEM);
  if (err != cudaSuccess) return int(err);
  kernel<<<(n + DH_BM - 1) / DH_BM, DH_THREADS, DH_SMEM, stream>>>(hm, wm, b, lse, g, dh, n, v);
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
// non-empty problem, a 16-byte aligned h (TMA and the 16-byte row copies),
// and an 8-byte aligned bias (read two columns at a time).
bool args_ok(const void* h, const float* b, int n, int d, int v) {
  return d == KERNEL_D && n > 0 && v > 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 8 == 0;
}

}  // namespace

// Plain C interface, loaded with ctypes. Each returns a cudaError_t (0 on
// success; cudaErrorInvalidValue for arguments args_ok refuses, or when a
// tensor map cannot be encoded). h is bf16 [n, d]; w is f32 [d, v]
// (w_vd == 0) or [v, d] (w_vd == 1); wp is w packed by xent_pack_w: bf16
// [d, v rounded up to a multiple of 8] or [v, d], 16-byte aligned; b is f32
// [v] or null; lse and g are f32 [n].

extern "C" int xent_pack_w(const float* w, void* wp, int d, int v, int w_vd, void* stream) {
  if (d != KERNEL_D || v <= 0 || reinterpret_cast<uintptr_t>(wp) % 16 != 0)
    return int(cudaErrorInvalidValue);
  return launch_pack(w, static_cast<bf16*>(wp), d, v, w_vd != 0,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int xent_fwd(const void* h, const void* wp, const float* b, float* lse, int n, int d,
                        int v, int w_vd, void* stream) {
  if (!args_ok(h, b, n, d, v)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_vd ? launch_fwd<true>(h, wp, b, lse, n, v, s)
              : launch_fwd<false>(h, wp, b, lse, n, v, s);
}

extern "C" int xent_dh(const void* h, const void* wp, const float* b, const float* lse,
                       const float* g, void* dh, int n, int d, int v, int w_vd, void* stream) {
  if (!args_ok(h, b, n, d, v)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* out = static_cast<bf16*>(dh);
  return w_vd ? launch_dh<true>(h, wp, b, lse, g, out, n, v, s)
              : launch_dh<false>(h, wp, b, lse, g, out, n, v, s);
}

extern "C" int xent_dwdb(const void* h, const float* w, const float* b, const float* lse,
                         const float* g, float* dw, float* db, int n, int d, int v,
                         int w_vd, void* stream) {
  if (!args_ok(h, b, n, d, v)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* hh = static_cast<const bf16*>(h);
  return w_vd ? launch_dwdb<512, true>(hh, w, b, lse, g, dw, db, n, v, s)
              : launch_dwdb<512, false>(hh, w, b, lse, g, dw, db, n, v, s);
}
