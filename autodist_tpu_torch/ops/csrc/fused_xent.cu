// Fused LM-head softmax cross-entropy kernels for Hopper (sm_90a).
//
// lse[n] = logsumexp_v(h[n] . w[:, v] + b[v]) and its gradient, with the
// [N, V] logits never written to device memory: each logits tile lives in
// registers (and, as the backward's bf16 g * p, in shared memory) only and
// is reduced on the fly (forward) or recomputed from the saved lse
// (backward).
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
// so the next limit is L2 -> SM traffic: (row blocks) x 32.8 MB of bf16 w
// for the forward and dh, (vocab blocks) x 100.7 MB of h for dw/db.
//
// Common to all: the TPU grid runs in order, so the Pallas kernels carry
// (m, l) and the dh / dw accumulators across grid steps in VMEM scratch.
// Hopper's blocks run in no order, so the sequential loop moves inside one
// block: the forward and dh kernels give each block one stripe of rows that
// walks every vocab tile; the dw/db kernel gives each block one tile of 64
// vocab columns that walks every row stripe. No cross-block reduction.
// All three read the table as packed by xent_pack_kernel.
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
//
// dw/db design (xent_dwdb_kernel): dh's pattern mirrored.
// - A block owns 64 vocab columns. Its [64 vocab x 512 d] tile of the packed
//   table (64 KB) is loaded once with TMA and stays resident; h streams in
//   64-row stripes (64 KB) through a 2-stage ring with full and empty
//   mbarriers (a third stage does not fit beside the tile).
// - L2 -> SM traffic: 500 blocks each streaming all of h read 50.3 GB at
//   the flagship shape, more than L2 delivers in the products' time. So
//   two blocks on neighbouring vocab tiles form a cluster: each producer
//   loads half of every stripe (4 of its 8 d chunks) and multicasts it to
//   both blocks, halving the reads of h. Each block's full barrier expects
//   the whole stripe; each consumer warp releases a stage on the empty
//   barriers of both blocks (a remote arrive), so neither producer refills
//   a stage that its partner still reads. A block whose columns all lie
//   past V still walks and loads its half, and writes nothing.
// - Warp specialisation as in dh: the producer warpgroup's thread 0 issues
//   every copy; two consumer warpgroups split the model width, consumer c
//   owning d in [256c, 256c + 256): its dw^T [64 vocab, 256 d] is 128 f32
//   registers a thread. Each computes partial scores over its half of d
//   (m64n64, as dh), the halves are traded through shared memory, each
//   finishes 32 columns' g * p into a swizzled bf16 [row][vocab] P tile, and
//   after a named barrier both issue dw^T += P^T h (m64n256k16: P read
//   MN-major as A, h's four d chunks of the half as MN-major B atoms 8 KB
//   apart). db sums the f32 p before its bf16 rounding, per thread, and is
//   reduced once at the end (shuffles, then the 4 warps in order): no
//   atomics, so dw and db are the same bits from call to call.
// - Order a stripe: its scores are issued behind the last stripe's dw
//   product, whose stage is released as soon as that product lands; then
//   the softmax and the exchange; then its own dw product. So a stripe's
//   copy overlaps the two products and the softmax of the stripe before it.
//   The softmax does not overlap the products: that needs the next stripe
//   resident beside the two that the products read, a third stage.
// - Rows >= N (TMA zero fill) and columns >= V get p = 0 by a select; their
//   lse, g and bias are never read. dw is written in w's stored layout, f32,
//   straight from the accumulators (a warp's store fills whole 32-byte
//   sectors in either layout); columns >= V are not written.

#include <cuda_bf16.h>
#include <math.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

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

// --------------------------------------------------------------------- dw/db

constexpr int DW_BM = 64;              // rows a stripe
constexpr int DW_TN = 64;              // vocab columns a block
constexpr int DW_STAGES = 2;           // h stripes in flight
constexpr int DW_CLUSTER = 2;          // blocks sharing each stripe
constexpr int DW_THREADS = 384;
constexpr unsigned DW_W_BYTES = DW_TN * KERNEL_D * 2;
constexpr unsigned DW_STRIPE_BYTES = DW_BM * KERNEL_D * 2;
static_assert(KC % DW_CLUSTER == 0, "each block loads whole d chunks of a stripe");

struct DwSmem {
  alignas(1024) bf16 w[KC][DW_TN * 64];             // resident; vd: [64 vocab][64 d], dv: [64 d][64 vocab]
  alignas(1024) bf16 h[DW_STAGES][KC][DW_BM * 64];  // [stage][d chunk][row][64 d], swizzled
  alignas(1024) bf16 p[DW_BM * 64];                 // g * softmax, [row][64 vocab], swizzled
  float x[2][16][128];                              // partial scores handed over; then db partials
  uint64_t w_full, full[DW_STAGES], empty[DW_STAGES];
};
constexpr size_t DW_SMEM = sizeof(DwSmem) + 1024;
static_assert(DW_SMEM <= 232448, "over the 227 KB a block may use");

// Consumer c's half of a stripe once its partial scores s (over its d half,
// all 64 vocab columns) have landed: as dh_scores_to_p, and the f32 p of its
// columns [32c, 32c + 32) summed into db_part before the bf16 rounding. p is
// 0 by a select for rows past n (ok false: their lse and g are not read)
// and for columns past v (bias[q][e] is -inf there), never by arithmetic on
// a value that may be inf.
__device__ __forceinline__ void dw_scores_to_p(DwSmem& sm, const float (&s)[8][4], int c,
                                               int tid, int r, int col,
                                               const float (&bias)[4][2],
                                               const float (&row_lse2)[2],
                                               const float (&row_g)[2], const bool (&ok)[2],
                                               float (&db_part)[4][2]) {
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
        const float y = ex2(fmaf(z[q][2 * i + e] + bias[q][e], LOG2E, -row_lse2[i]));
        pv[e] = ok[i] && bias[q][e] != -INFINITY ? row_g[i] * y : 0.f;
        db_part[q][e] += pv[e];
      }
      const int rr = r + 8 * i;
      const int off = rr * 128 + (((kcol >> 3) ^ (rr & 7)) << 4) + (kcol & 7) * 2;
      *reinterpret_cast<__nv_bfloat162*>(pbase + off) = __floats2bfloat162_rn(pv[0], pv[1]);
    }
  }
  fence_proxy_async();  // the P stores, visible to wgmma
  named_sync(2);
}

// dw[:, v] = sum_n h[n] * bf16(g[n] * softmax(h w + b)[n, v]), db[v] = sum_n
// of the same weights in f32; the logits recomputed from the saved lse.
// One block per 64 vocab columns walks every row stripe; a cluster of
// DW_CLUSTER blocks on neighbouring tiles shares each stripe.
template <bool VD>
__global__ void __cluster_dims__(DW_CLUSTER, 1, 1) __launch_bounds__(DW_THREADS, 1)
xent_dwdb_kernel(const __grid_constant__ CUtensorMap hm, const __grid_constant__ CUtensorMap wm,
                 const float* __restrict__ b, const float* __restrict__ lse,
                 const float* __restrict__ g, float* __restrict__ dw,
                 float* __restrict__ db, int n, int v) {
  extern __shared__ unsigned char dw_raw[];
  DwSmem& sm = align1024<DwSmem>(dw_raw);  // the same offset in every block of the cluster
  const int v0 = blockIdx.x * DW_TN;
  const int n_stripes = (n + DW_BM - 1) / DW_BM;
  if (threadIdx.x == 0) {
    mbar_init(&sm.w_full, 1);
    for (int s = 0; s < DW_STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], DW_CLUSTER * 8);  // lane 0 of each consumer warp of the cluster
    }
    mbar_init_fence();
  }
  cluster_sync();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.w_full, DW_W_BYTES);
      for (int j = 0; j < KC; ++j) {
        if (VD)
          tma_load(sm.w[j], &wm, &sm.w_full, 64 * j, v0);
        else
          tma_load(sm.w[j], &wm, &sm.w_full, v0, 64 * j);
      }
      // This block's share of each stripe: d chunks [rank * KC / DW_CLUSTER, ...),
      // multicast to the whole cluster. Each block's full barrier expects
      // the whole stripe; a stage is refilled once every consumer of the
      // cluster has released it.
      const int j0 = int(cluster_ctarank()) * (KC / DW_CLUSTER);
      for (int t = 0; t < n_stripes; ++t) {
        const int stage = t % DW_STAGES;
        mbar_wait(&sm.empty[stage], ((t / DW_STAGES) & 1) ^ 1);
        mbar_expect_tx(&sm.full[stage], DW_STRIPE_BYTES);
        for (int j = j0; j < j0 + KC / DW_CLUSTER; ++j)
          tma_load_multicast(sm.h[stage][j], &hm, &sm.full[stage], 64 * j, t * DW_BM,
                             uint16_t((1u << DW_CLUSTER) - 1));
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int col = (lane % 4) * 2;
    const int r = warp * 16 + lane / 4;  // this thread's rows of a stripe: r, r + 8
    // This thread's columns of the P tile, v0 + 32c + 8q + col (+1): the
    // bias, or -inf for a column past v (its p is 0).
    float bias[4][2], db_part[4][2];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int vv = v0 + 32 * c + 8 * q + col + e;
        bias[q][e] = vv >= v ? -INFINITY : b != nullptr ? b[vv] : 0.f;
        db_part[q][e] = 0.f;
      }
    // The stripe's lse (times log2 e) and g of rows r and r + 8, read a
    // stripe ahead and taken over once the next scores have landed, so no
    // load's latency lies in the walk.
    float row_lse2[2], row_g[2], next_lse2[2], next_g[2];
    bool ok[2], next_ok[2];
    auto read_rows = [&](int t, float (&l2)[2], float (&gg)[2], bool (&in)[2]) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = t * DW_BM + r + 8 * i;
        in[i] = row < n;
        l2[i] = in[i] ? lse[row] * LOG2E : 0.f;
        gg[i] = in[i] ? g[row] : 0.f;
      }
    };
    read_rows(0, next_lse2, next_g, next_ok);
    float acc[32][4];  // dw^T: vocab rows r (+8) of the tile, d columns 256c + 8nt + col (+1)
#pragma unroll
    for (int nt = 0; nt < 32; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    float s[8][4];
    const uint64_t dp = sw128_desc(sm.p);
    mbar_wait(&sm.w_full, 0);
    for (int t = 0; t < n_stripes; ++t) {
      const int stage = t % DW_STAGES;
      mbar_wait(&sm.full[stage], (t / DW_STAGES) & 1);
      // Partial scores over this consumer's half of d, queued behind the
      // last stripe's dw product.
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint64_t da = sw128_desc(sm.h[stage][4 * c + q]);
        const uint64_t dbw = sw128_desc(sm.w[4 * c + q]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (VD)
            wgmma_m64n64k16_ss<0>(s, da + 2 * kk, dbw + 2 * kk, q | kk);
          else
            wgmma_m64n64k16_ss<1>(s, da + 2 * kk, dbw + 128 * kk, q | kk);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the last stripe's dw product: its stage is free
      fence_regs(acc);
      if (t > 0 && lane == 0)
        for (int rank = 0; rank < DW_CLUSTER; ++rank)
          mbar_arrive_cluster(&sm.empty[(t - 1) % DW_STAGES], rank);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        row_lse2[i] = next_lse2[i];
        row_g[i] = next_g[i];
        ok[i] = next_ok[i];
      }
      read_rows(t + 1, next_lse2, next_g, next_ok);
      wgmma_wait<0>();
      fence_regs(s);
      dw_scores_to_p(sm, s, c, tid, r, col, bias, row_lse2, row_g, ok, db_part);
      // dw^T[:, this half] += P^T h: M the tile's 64 vocab columns (P read
      // MN-major), k the stripe's 64 rows, N this half's 256 d (the four d
      // chunks as MN atoms 8 KB apart).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n256k16_ss<1, 1>(acc, dp + 128 * kk,
                                  sw128_desc(sm.h[stage][4 * c], 8192) + 128 * kk, 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // dw in w's stored layout, f32; vocab columns >= v are not written.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int vv = v0 + r + 8 * i;
      if (vv >= v) continue;
      if (VD) {
        float* out = dw + size_t(vv) * KERNEL_D + 256 * c + col;
#pragma unroll
        for (int nt = 0; nt < 32; ++nt)
          *reinterpret_cast<float2*>(out + 8 * nt) = make_float2(acc[nt][2 * i], acc[nt][2 * i + 1]);
      } else {
        // A warp's store covers 8 neighbouring columns of 4 d rows: whole
        // 32-byte sectors.
        float* out = dw + size_t(256 * c + col) * v + vv;
#pragma unroll
        for (int nt = 0; nt < 32; ++nt) {
          out[size_t(8 * nt) * v] = acc[nt][2 * i];
          out[size_t(8 * nt + 1) * v] = acc[nt][2 * i + 1];
        }
      }
    }
    // db: the column sums over the 8 lanes that share a column, then over
    // the 4 warps in order through shared memory (the exchange buffer is
    // free after the walk's last named barrier); no atomics.
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = db_part[q][e];
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        if (lane < 4) sm.x[c][warp][8 * q + col + e] = x;
      }
    named_sync(1);
    if (tid < 32 && v0 + 32 * c + tid < v)
      db[v0 + 32 * c + tid] = sm.x[c][0][tid] + sm.x[c][1][tid] + sm.x[c][2][tid] + sm.x[c][3][tid];
  }
  cluster_sync();
}

// ------------------------------------------------------------- wide widths
//
// D = 768 and 1,024. The D = 512 designs do not grow: at D = 1,024 the
// forward's resident h (128 rows) is 256 KB, and dh's and dw/db's
// accumulators ([64, D] f32) are 512 registers a thread for two consumers.
// So each wide kernel runs as a cluster of two blocks:
// - Forward (xent_fwd_wide_kernel): a block holds 64 rows (h resident,
//   KC x 8 KB) and both consumers compute all 64 of them, consumer c over
//   columns [128c, 128c + 128) of each 256-column vocab tile. The two
//   blocks of a cluster hold neighbouring row blocks and share each w
//   stage (32 KB): each producer loads half of it and multicasts, as dw/db
//   does with h at D = 512, so L2 -> SM traffic of w stays that of 128-row
//   blocks. The consumers' (max, sum) pairs of a row merge at the end.
// - dh and dw/db (xent_dh_wide_kernel, xent_dwdb_wide_kernel): the two
//   blocks of a cluster own the two halves of d, each with the D = 512
//   kernel's per-block budgets (h or w resident for its half; its own
//   half's chunks streamed). Consumer c of block r owns d quarter 2r + c
//   (HC = D / 256 chunks of 64): its partial scores over that quarter,
//   then the sum of the four: within the block through x (one way at a
//   time: 8 KB), then across the pair with st.async into the partner's
//   recv (one 8 KB tile a consumer, completing on its rfull barrier; it
//   hands the buffer back through rempty once read). Both blocks then hold
//   the same full scores, bit for bit (one addition, commutative), compute
//   the same P and each accumulates its own half of dh or dw; db is written
//   by rank 0. The ring holds a consumer's HC chunks as one group, two
//   tiles of groups: 224 KB of shared memory at D = 1,024.

constexpr int WIDE_BM = 64;            // forward: rows a block
constexpr int WIDE_TN = 256;           // forward: vocab columns a tile, 128 a consumer
constexpr unsigned WIDE_STAGE_BYTES = WIDE_TN * 64 * 2;

template <int CH>
struct FwdWideSmem {
  static constexpr int STAGES = CH >= 16 ? 3 : 4;
  alignas(1024) bf16 h[CH][WIDE_BM * 64];        // [d chunk][row][64 d], swizzled
  alignas(1024) bf16 w[STAGES][WIDE_TN * 64];    // vd: [256 vocab][64 d]; dv: [4][64 d][64 vocab]
  float ml[2][WIDE_BM][2];                       // each consumer's (max, sum) of a row
  uint64_t h_full, full[STAGES], empty[STAGES];
};
static_assert(sizeof(FwdWideSmem<16>) + 1024 <= 232448, "over the 227 KB a block may use");
static_assert(sizeof(FwdWideSmem<12>) + 1024 <= 232448, "over the 227 KB a block may use");

template <bool VD, int CH>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(FWD_THREADS, 1)
xent_fwd_wide_kernel(const __grid_constant__ CUtensorMap hm,
                     const __grid_constant__ CUtensorMap wm, const float* __restrict__ b,
                     float* __restrict__ lse, int n, int v) {
  using Smem = FwdWideSmem<CH>;
  constexpr int S = Smem::STAGES;
  extern __shared__ unsigned char fwd_wide_raw[];
  Smem& sm = align1024<Smem>(fwd_wide_raw);
  const int n0 = blockIdx.x * WIDE_BM;
  const int n_tiles = (v + WIDE_TN - 1) / WIDE_TN;
  if (threadIdx.x == 0) {
    mbar_init(&sm.h_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 16);  // lane 0 of each consumer warp of the cluster
    }
    mbar_init_fence();
  }
  cluster_sync();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const int rank = int(cluster_ctarank());
      mbar_expect_tx(&sm.h_full, CH * WIDE_BM * 64 * 2);
      for (int j = 0; j < CH; ++j) tma_load(sm.h[j], &hm, &sm.h_full, 64 * j, n0);
      // This block's half of each stage (128 vocab columns), multicast to
      // both blocks; a stage is refilled once every consumer of the
      // cluster has released it.
      int stage = 0, parity = 0;
#pragma unroll 1
      for (int t = 0; t < n_tiles; ++t) {
#pragma unroll 1
        for (int j = 0; j < CH; ++j) {
          mbar_wait(&sm.empty[stage], parity ^ 1);
          mbar_expect_tx(&sm.full[stage], WIDE_STAGE_BYTES);
          const int c0 = t * WIDE_TN + 128 * rank;
          if (VD) {
            tma_load_multicast(sm.w[stage] + rank * 128 * 64, &wm, &sm.full[stage], 64 * j, c0,
                               3);
          } else {
            for (int q = 0; q < 2; ++q)
              tma_load_multicast(sm.w[stage] + (2 * rank + q) * 64 * 64, &wm, &sm.full[stage],
                                 c0 + 64 * q, 64 * j, 3);
          }
          if (++stage == S) {
            stage = 0;
            parity ^= 1;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int col = (lane % 4) * 2;
    float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f}, mc[2];
    float s[16][4], x[16][4];
    int stage = 0, parity = 0;
    mbar_wait(&sm.h_full, 0);
    // One d chunk of the tile's scores; the stage before it is released
    // once its products have landed.
    auto chunk = [&](int j) {
      mbar_wait(&sm.full[stage], parity);
      const uint64_t da = sw128_desc(sm.h[j]);
      const uint64_t db = sw128_desc(sm.w[stage] + c * 128 * 64);
      const uint64_t db_mn = sw128_desc(sm.w[stage] + c * 128 * 64, 8192);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (VD)
          wgmma_m64n128k16_ss<0>(s, da + 2 * kk, db + 2 * kk, j | kk);
        else
          wgmma_m64n128k16_ss<1>(s, da + 2 * kk, db_mn + 128 * kk, j | kk);
      }
      wgmma_commit();
    };
    auto release = [&]() {
      wgmma_wait<1>();
      if (lane == 0)
        for (int rank = 0; rank < 2; ++rank)
          mbar_arrive_cluster(&sm.empty[stage == 0 ? S - 1 : stage - 1], rank);
    };
    auto next_stage = [&]() {
      if (++stage == S) {
        stage = 0;
        parity ^= 1;
      }
    };
    for (int t = 0; t < n_tiles; ++t) {
      wgmma_fence();
      // The first five chunks carry the last tile's softmax pieces; the rest
      // are a loop, so that no more than five chunks' descriptors are live.
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        chunk(j);
        if (t > 0) lse_piece(j, x, m, l, mc, (t - 1) * WIDE_TN + 128 * c, col, v, b);
        if (j > 0) release();
        next_stage();
      }
#pragma unroll 1
      for (int j = 5; j < CH; ++j) {
        chunk(j);
        release();
        next_stage();
      }
      wgmma_wait<0>();
      fence_regs(s);
      if (lane == 0)
        for (int rank = 0; rank < 2; ++rank)
          mbar_arrive_cluster(&sm.empty[stage == 0 ? S - 1 : stage - 1], rank);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[nt][e] = s[nt][e];
    }
#pragma unroll
    for (int p = 0; p <= 4; ++p)
      lse_piece(p, x, m, l, mc, (n_tiles - 1) * WIDE_TN + 128 * c, col, v, b);

    // The quad's (m, l) per row, then the two consumers' through shared memory.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mm = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, 2));
      float ll = l[i] * ex2((m[i] - mm) * LOG2E);
      ll += __shfl_xor_sync(0xffffffffu, ll, 1);
      ll += __shfl_xor_sync(0xffffffffu, ll, 2);
      m[i] = mm;
      l[i] = ll;
    }
    const int r = warp * 16 + lane / 4;
    if (lane % 4 == 0)
      for (int i = 0; i < 2; ++i) {
        sm.ml[c][r + 8 * i][0] = m[i];
        sm.ml[c][r + 8 * i][1] = l[i];
      }
    named_sync(1);
    if (c == 0 && lane % 4 == 0)
      for (int i = 0; i < 2; ++i) {
        const float m1 = sm.ml[1][r + 8 * i][0], l1 = sm.ml[1][r + 8 * i][1];
        const float mm = fmaxf(m[i], m1);
        const float ll = l[i] * ex2((m[i] - mm) * LOG2E) + l1 * ex2((m1 - mm) * LOG2E);
        const int row = n0 + r + 8 * i;
        if (row < n) lse[row] = mm + logf(fmaxf(ll, 1e-30f));
      }
  }
  cluster_sync();
}

// Shared memory of the wide dh (RESIDENT = h) and dw/db (RESIDENT = w)
// kernels: the resident operand's half of d, the ring of the streamed one
// (four groups: [2 (t & 1) + consumer][chunk]), the P tile and the
// exchange buffers.
template <int HC>
struct PairSmem {
  alignas(1024) bf16 resident[2 * HC][64 * 64];  // [d chunk][64 rows or vocab][64 d]
  alignas(1024) bf16 ring[4][HC][64 * 64];
  alignas(1024) bf16 p[64 * 64];                 // g * softmax, [row][64 vocab], swizzled
  float x[16][128];                              // within the block, one way at a time; then db
  float4 recv[2][4][128];                        // the partner's partial: [consumer][q][thread]
  uint64_t res_full, full[4], empty[4], rfull[2], rempty[2];
};
static_assert(sizeof(PairSmem<4>) + 1024 <= 232448, "over the 227 KB a block may use");

// Consumer c's full scores z of columns [32c, 32c + 32) of the tile (this
// thread's rows r and r + 8, columns 32c + 8q + col (+1)) from its partial
// scores s over its quarter of d: the other consumer's partial of those
// columns through x (consumer 0 writes first; consumer 1 reads its slots,
// then writes its own into them), then the partner block's sum through
// recv. t is the tile (or stripe) index, which sets the barriers' phases.
template <int HC>
__device__ __forceinline__ void pair_scores(PairSmem<HC>& sm, const float (&s)[8][4], int c,
                                            int tid, int t, unsigned partner,
                                            float (&z)[4][4]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) z[k / 4][k % 4] = c ? s[4 + k / 4][k % 4] : s[k / 4][k % 4];
  if (c == 0)
#pragma unroll
    for (int k = 0; k < 16; ++k) sm.x[k][tid] = s[4 + k / 4][k % 4];
  named_sync(1);
  if (c == 1)
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      z[k / 4][k % 4] += sm.x[k][tid];
      sm.x[k][tid] = s[k / 4][k % 4];
    }
  named_sync(3);
  if (c == 0)
#pragma unroll
    for (int k = 0; k < 16; ++k) z[k / 4][k % 4] += sm.x[k][tid];
  // The partner's recv[c] is free once it has read the last tile's.
  if (t > 0) mbar_wait(&sm.rempty[c], (t - 1) & 1);
  if (tid == 0) mbar_expect_tx(&sm.rfull[c], 128 * 4 * sizeof(float4));
#pragma unroll
  for (int q = 0; q < 4; ++q)
    st_async_cluster(&sm.recv[c][q][tid], &sm.rfull[c], partner, z[q][0], z[q][1], z[q][2],
                     z[q][3]);
  mbar_wait(&sm.rfull[c], t & 1);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 o = sm.recv[c][q][tid];
    z[q][0] += o.x;
    z[q][1] += o.y;
    z[q][2] += o.z;
    z[q][3] += o.w;
  }
}

// bf16 (p0, p1) at row rr, tile column kcol (even) of the swizzled P tile.
__device__ __forceinline__ void store_p(bf16* p, int rr, int kcol, float p0, float p1) {
  const int off = rr * 128 + (((kcol >> 3) ^ (rr & 7)) << 4) + (kcol & 7) * 2;
  *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<unsigned char*>(p) + off) =
      __floats2bfloat162_rn(p0, p1);
}

// dh at D = 256 HC: the cluster's two blocks share a 64-row stripe, block
// r computing dh[:, r D / 2 : (r + 1) D / 2].
template <bool VD, int HC>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(DH_THREADS, 1)
xent_dh_wide_kernel(const __grid_constant__ CUtensorMap hm,
                    const __grid_constant__ CUtensorMap wm, const float* __restrict__ b,
                    const float* __restrict__ lse, const float* __restrict__ g,
                    bf16* __restrict__ dh, int n, int v) {
  constexpr int DW = 256 * HC;  // the model width
  constexpr unsigned GROUP_BYTES = HC * 64 * 64 * 2;
  extern __shared__ unsigned char dh_wide_raw[];
  PairSmem<HC>& sm = align1024<PairSmem<HC>>(dh_wide_raw);
  const int n0 = (blockIdx.x >> 1) * DH_BM;
  const int n_tiles = (v + DH_TN - 1) / DH_TN;
  const unsigned rank = cluster_ctarank(), partner = rank ^ 1u;
  const int d0 = int(rank) * 2 * HC;  // this block's first d chunk
  if (threadIdx.x == 0) {
    mbar_init(&sm.res_full, 1);
    for (int i = 0; i < 4; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], 4);  // lane 0 of each warp of the group's consumer
    }
    for (int c = 0; c < 2; ++c) {
      mbar_init(&sm.rfull[c], 1);
      mbar_init(&sm.rempty[c], 1);
    }
    mbar_init_fence();
  }
  cluster_sync();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.res_full, 2 * GROUP_BYTES);
      for (int j = 0; j < 2 * HC; ++j) tma_load(sm.resident[j], &hm, &sm.res_full, 64 * (d0 + j), n0);
#pragma unroll 1
      for (int t = 0; t < n_tiles; ++t)
#pragma unroll 1
        for (int c = 0; c < 2; ++c) {
          const int grp = 2 * (t & 1) + c;
          mbar_wait(&sm.empty[grp], ((t >> 1) & 1) ^ 1);
          mbar_expect_tx(&sm.full[grp], GROUP_BYTES);
          for (int q = 0; q < HC; ++q) {
            const int dc = 64 * (d0 + c * HC + q);
            if (VD)
              tma_load(sm.ring[grp][q], &wm, &sm.full[grp], dc, t * DH_TN);
            else
              tma_load(sm.ring[grp][q], &wm, &sm.full[grp], t * DH_TN, dc);
          }
        }
    }
  } else {
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
    float acc[8 * HC][4];  // dh columns D / 2 rank + 64 HC c + 8 nt + col (+1)
#pragma unroll
    for (int nt = 0; nt < 8 * HC; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    float s[8][4], z[4][4];
    mbar_wait(&sm.res_full, 0);
    const uint64_t dp = sw128_desc(sm.p);
    for (int t = 0; t < n_tiles; ++t) {
      const int grp = 2 * (t & 1) + c;
      mbar_wait(&sm.full[grp], (t >> 1) & 1);
      // Partial scores over this consumer's quarter of d, queued behind the
      // last tile's P . w^T.
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < HC; ++q) {
        const uint64_t da = sw128_desc(sm.resident[c * HC + q]);
        const uint64_t dbw = sw128_desc(sm.ring[grp][q]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (VD)
            wgmma_m64n64k16_ss<0>(s, da + 2 * kk, dbw + 2 * kk, q | kk);
          else
            wgmma_m64n64k16_ss<1>(s, da + 2 * kk, dbw + 128 * kk, q | kk);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(acc);
      if (t > 0 && lane == 0) mbar_arrive(&sm.empty[2 * ((t - 1) & 1) + c]);
      // This thread's P columns' bias, or -inf past v (p = 0): loaded
      // outside any wgmma stage, their latency under the exchange.
      float bias[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int vv = t * DH_TN + 32 * c + 8 * q + col + e;
          bias[q][e] = vv >= v ? -INFINITY : b != nullptr ? b[vv] : 0.f;
        }
      pair_scores(sm, s, c, tid, t, partner, z);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kcol = 32 * c + 8 * q + col;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float pv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float y = ex2(fmaf(z[q][2 * i + e] + bias[q][e], LOG2E, -row_lse[i] * LOG2E));
            pv[e] = bias[q][e] != -INFINITY ? row_g[i] * y : 0.f;
          }
          store_p(sm.p, r + 8 * i, kcol, pv[0], pv[1]);
        }
      }
      fence_proxy_async();  // the P stores, visible to wgmma
      named_sync(2);
      if (tid == 0) mbar_arrive_cluster(&sm.rempty[c], partner);  // recv[c] read
      // dh[:, this quarter] += P . w^T, as the D = 512 kernel.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (VD)
          wgmma_wide_ss<1>(acc, dp + 2 * kk, sw128_desc(sm.ring[grp][0], 8192) + 128 * kk, 1);
        else
          wgmma_wide_ss<0>(acc, dp + 2 * kk, sw128_desc(sm.ring[grp][0]) + 2 * kk, 1);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = n0 + r + 8 * i;
      if (row >= n) continue;
      bf16* out = dh + size_t(row) * DW + 64 * (d0 + c * HC) + col;
#pragma unroll
      for (int nt = 0; nt < 8 * HC; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * nt) =
            __floats2bfloat162_rn(acc[nt][2 * i], acc[nt][2 * i + 1]);
    }
  }
  cluster_sync();
}

// dw/db at D = 256 HC: the cluster's two blocks share 64 vocab columns,
// block r computing dw over its half of d; rank 0 writes db.
template <bool VD, int HC>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(DW_THREADS, 1)
xent_dwdb_wide_kernel(const __grid_constant__ CUtensorMap hm,
                      const __grid_constant__ CUtensorMap wm, const float* __restrict__ b,
                      const float* __restrict__ lse, const float* __restrict__ g,
                      float* __restrict__ dw, float* __restrict__ db, int n, int v) {
  constexpr int DW = 256 * HC;
  constexpr unsigned GROUP_BYTES = HC * 64 * 64 * 2;
  extern __shared__ unsigned char dw_wide_raw[];
  PairSmem<HC>& sm = align1024<PairSmem<HC>>(dw_wide_raw);
  const int v0 = (blockIdx.x >> 1) * DW_TN;
  const int n_stripes = (n + DW_BM - 1) / DW_BM;
  const unsigned rank = cluster_ctarank(), partner = rank ^ 1u;
  const int d0 = int(rank) * 2 * HC;
  if (threadIdx.x == 0) {
    mbar_init(&sm.res_full, 1);
    for (int i = 0; i < 4; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], 4);
    }
    for (int c = 0; c < 2; ++c) {
      mbar_init(&sm.rfull[c], 1);
      mbar_init(&sm.rempty[c], 1);
    }
    mbar_init_fence();
  }
  cluster_sync();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.res_full, 2 * GROUP_BYTES);
      for (int j = 0; j < 2 * HC; ++j) {
        if (VD)
          tma_load(sm.resident[j], &wm, &sm.res_full, 64 * (d0 + j), v0);
        else
          tma_load(sm.resident[j], &wm, &sm.res_full, v0, 64 * (d0 + j));
      }
#pragma unroll 1
      for (int t = 0; t < n_stripes; ++t)
#pragma unroll 1
        for (int c = 0; c < 2; ++c) {
          const int grp = 2 * (t & 1) + c;
          mbar_wait(&sm.empty[grp], ((t >> 1) & 1) ^ 1);
          mbar_expect_tx(&sm.full[grp], GROUP_BYTES);
          for (int q = 0; q < HC; ++q)
            tma_load(sm.ring[grp][q], &hm, &sm.full[grp], 64 * (d0 + c * HC + q), t * DW_BM);
        }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int col = (lane % 4) * 2;
    const int r = warp * 16 + lane / 4;
    float bias[4][2], db_part[4][2];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int vv = v0 + 32 * c + 8 * q + col + e;
        bias[q][e] = vv >= v ? -INFINITY : b != nullptr ? b[vv] : 0.f;
        db_part[q][e] = 0.f;
      }
    float row_lse2[2], row_g[2], next_lse2[2], next_g[2];
    bool ok[2], next_ok[2];
    auto read_rows = [&](int t, float (&l2)[2], float (&gg)[2], bool (&in)[2]) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = t * DW_BM + r + 8 * i;
        in[i] = row < n;
        l2[i] = in[i] ? lse[row] * LOG2E : 0.f;
        gg[i] = in[i] ? g[row] : 0.f;
      }
    };
    read_rows(0, next_lse2, next_g, next_ok);
    float acc[8 * HC][4];  // dw^T: vocab rows r (+8), d columns of this quarter
#pragma unroll
    for (int nt = 0; nt < 8 * HC; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    float s[8][4], z[4][4];
    const uint64_t dp = sw128_desc(sm.p);
    mbar_wait(&sm.res_full, 0);
    for (int t = 0; t < n_stripes; ++t) {
      const int grp = 2 * (t & 1) + c;
      mbar_wait(&sm.full[grp], (t >> 1) & 1);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < HC; ++q) {
        const uint64_t da = sw128_desc(sm.ring[grp][q]);
        const uint64_t dbw = sw128_desc(sm.resident[c * HC + q]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (VD)
            wgmma_m64n64k16_ss<0>(s, da + 2 * kk, dbw + 2 * kk, q | kk);
          else
            wgmma_m64n64k16_ss<1>(s, da + 2 * kk, dbw + 128 * kk, q | kk);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the last stripe's dw product: its group is free
      fence_regs(acc);
      if (t > 0 && lane == 0) mbar_arrive(&sm.empty[2 * ((t - 1) & 1) + c]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        row_lse2[i] = next_lse2[i];
        row_g[i] = next_g[i];
        ok[i] = next_ok[i];
      }
      read_rows(t + 1, next_lse2, next_g, next_ok);
      wgmma_wait<0>();
      fence_regs(s);
      pair_scores(sm, s, c, tid, t, partner, z);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kcol = 32 * c + 8 * q + col;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float pv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float y = ex2(fmaf(z[q][2 * i + e] + bias[q][e], LOG2E, -row_lse2[i]));
            pv[e] = ok[i] && bias[q][e] != -INFINITY ? row_g[i] * y : 0.f;
            db_part[q][e] += pv[e];
          }
          store_p(sm.p, r + 8 * i, kcol, pv[0], pv[1]);
        }
      }
      fence_proxy_async();
      named_sync(2);
      if (tid == 0) mbar_arrive_cluster(&sm.rempty[c], partner);
      // dw^T[:, this quarter] += P^T h, as the D = 512 kernel.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_wide_ss<1, 1>(acc, dp + 128 * kk, sw128_desc(sm.ring[grp][0], 8192) + 128 * kk, 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int vv = v0 + r + 8 * i;
      if (vv >= v) continue;
      const int dcol = 64 * (d0 + c * HC) + col;
      if (VD) {
        float* out = dw + size_t(vv) * DW + dcol;
#pragma unroll
        for (int nt = 0; nt < 8 * HC; ++nt)
          *reinterpret_cast<float2*>(out + 8 * nt) = make_float2(acc[nt][2 * i], acc[nt][2 * i + 1]);
      } else {
        float* out = dw + size_t(dcol) * v + vv;
#pragma unroll
        for (int nt = 0; nt < 8 * HC; ++nt) {
          out[size_t(8 * nt) * v] = acc[nt][2 * i];
          out[size_t(8 * nt + 1) * v] = acc[nt][2 * i + 1];
        }
      }
    }
    // db, as the D = 512 kernel (x is free after the walk's last named
    // barrier): both blocks hold the same p, rank 0 writes.
    float(&part)[2][4][32] = *reinterpret_cast<float(*)[2][4][32]>(&sm.x[0][0]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = db_part[q][e];
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        if (lane < 4) part[c][warp][8 * q + col + e] = x;
      }
    named_sync(1);
    if (rank == 0 && tid < 32 && v0 + 32 * c + tid < v)
      db[v0 + 32 * c + tid] = part[c][0][tid] + part[c][1][tid] + part[c][2][tid] + part[c][3][tid];
  }
  cluster_sync();
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

// Tensor maps of h [n, d] (box: `rows` rows of 64 columns) and of the
// packed table (box: tn vocab rows of 64 d for vd, 64 d rows of 64 vocab
// for dv).
bool maps(CUtensorMap* hm, CUtensorMap* wm, const void* h, const void* wp, int n, int d, int v,
          bool vd, int rows, int tn) {
  return matrix_map(hm, h, n, d, rows) &&
         (vd ? matrix_map(wm, wp, v, d, tn) : matrix_map(wm, wp, d, packed_cols(v), 64));
}

// The dynamic shared memory of each kernel, and its grid: the wide
// kernels' grids are whole clusters of two.
template <bool VD, int CH>
struct Fwd {
  static constexpr auto kernel() { return xent_fwd_wide_kernel<VD, CH>; }
  static constexpr size_t smem = sizeof(FwdWideSmem<CH>) + 1024;
  static constexpr int rows = WIDE_BM, tn = 128;
  static int blocks(int n) { return (n + 2 * WIDE_BM - 1) / (2 * WIDE_BM) * 2; }
};
template <bool VD>
struct Fwd<VD, KERNEL_D / 64> {
  static constexpr auto kernel() { return xent_fwd_kernel<VD>; }
  static constexpr size_t smem = FWD_SMEM;
  static constexpr int rows = FWD_BM, tn = FWD_TN;
  static int blocks(int n) { return (n + FWD_BM - 1) / FWD_BM; }
};

template <bool VD, int CH>
int launch_fwd(const void* h, const void* wp, const float* b, float* lse, int n, int v,
               cudaStream_t stream) {
  using F = Fwd<VD, CH>;
  CUtensorMap hm, wm;
  if (!maps(&hm, &wm, h, wp, n, 64 * CH, v, VD, F::rows, F::tn)) return int(cudaErrorInvalidValue);
  auto kernel = F::kernel();
  const cudaError_t err = set_smem(kernel, F::smem);
  if (err != cudaSuccess) return int(err);
  kernel<<<F::blocks(n), FWD_THREADS, F::smem, stream>>>(hm, wm, b, lse, n, v);
  return int(cudaGetLastError());
}

template <bool VD, int CH>
int launch_dh(const void* h, const void* wp, const float* b, const float* lse, const float* g,
              bf16* dh, int n, int v, cudaStream_t stream) {
  CUtensorMap hm, wm;
  if (!maps(&hm, &wm, h, wp, n, 64 * CH, v, VD, DH_BM, DH_TN)) return int(cudaErrorInvalidValue);
  const int row_blocks = (n + DH_BM - 1) / DH_BM;
  if constexpr (CH == KERNEL_D / 64) {
    auto kernel = xent_dh_kernel<VD>;
    const cudaError_t err = set_smem(kernel, DH_SMEM);
    if (err != cudaSuccess) return int(err);
    kernel<<<row_blocks, DH_THREADS, DH_SMEM, stream>>>(hm, wm, b, lse, g, dh, n, v);
  } else {
    auto kernel = xent_dh_wide_kernel<VD, CH / 4>;
    constexpr size_t smem = sizeof(PairSmem<CH / 4>) + 1024;
    const cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return int(err);
    kernel<<<2 * row_blocks, DH_THREADS, smem, stream>>>(hm, wm, b, lse, g, dh, n, v);
  }
  return int(cudaGetLastError());
}

template <bool VD, int CH>
int launch_dwdb(const void* h, const void* wp, const float* b, const float* lse, const float* g,
                float* dw, float* db, int n, int v, cudaStream_t stream) {
  CUtensorMap hm, wm;
  if (!maps(&hm, &wm, h, wp, n, 64 * CH, v, VD, DW_BM, DW_TN)) return int(cudaErrorInvalidValue);
  const int tiles = (v + DW_TN - 1) / DW_TN;
  if constexpr (CH == KERNEL_D / 64) {
    auto kernel = xent_dwdb_kernel<VD>;
    const cudaError_t err = set_smem(kernel, DW_SMEM);
    if (err != cudaSuccess) return int(err);
    const int blocks = (tiles + DW_CLUSTER - 1) / DW_CLUSTER * DW_CLUSTER;  // whole clusters
    kernel<<<blocks, DW_THREADS, DW_SMEM, stream>>>(hm, wm, b, lse, g, dw, db, n, v);
  } else {
    auto kernel = xent_dwdb_wide_kernel<VD, CH / 4>;
    constexpr size_t smem = sizeof(PairSmem<CH / 4>) + 1024;
    const cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return int(err);
    kernel<<<2 * tiles, DW_THREADS, smem, stream>>>(hm, wm, b, lse, g, dw, db, n, v);
  }
  return int(cudaGetLastError());
}

// One of the instantiated widths: 512 (the D = 512 kernels), 768 and 1,024
// (the wide ones); `f` is called with the width's chunk count as a
// template argument.
template <typename F>
int by_width(int d, F&& f) {
  switch (d) {
    case 512: return f(std::integral_constant<int, 8>());
    case 768: return f(std::integral_constant<int, 12>());
    case 1024: return f(std::integral_constant<int, 16>());
    default: return int(cudaErrorInvalidValue);
  }
}

// What every entry point takes: an instantiated width, a non-empty problem,
// a 16-byte aligned h (TMA and the 16-byte row copies), and an 8-byte
// aligned bias (read two columns at a time).
bool args_ok(const void* h, const float* b, int n, int d, int v) {
  return (d == 512 || d == 768 || d == 1024) && n > 0 && v > 0 &&
         reinterpret_cast<uintptr_t>(h) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 8 == 0;
}

}  // namespace

// Plain C interface, loaded with ctypes. Each returns a cudaError_t (0 on
// success; cudaErrorInvalidValue for arguments args_ok refuses, or when a
// tensor map cannot be encoded). h is bf16 [n, d], d one of 512, 768 and
// 1,024; w is f32 [d, v] (w_vd == 0) or [v, d] (w_vd == 1); wp is w packed
// by xent_pack_w: bf16 [d, v rounded up to a multiple of 8] or [v, d],
// 16-byte aligned; b is f32 [v] or null; lse and g are f32 [n]; dw is f32
// in w's layout, db f32 [v].

extern "C" int xent_pack_w(const float* w, void* wp, int d, int v, int w_vd, void* stream) {
  if (!(d == 512 || d == 768 || d == 1024) || v <= 0 ||
      reinterpret_cast<uintptr_t>(wp) % 16 != 0)
    return int(cudaErrorInvalidValue);
  return launch_pack(w, static_cast<bf16*>(wp), d, v, w_vd != 0,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int xent_fwd(const void* h, const void* wp, const float* b, float* lse, int n, int d,
                        int v, int w_vd, void* stream) {
  if (!args_ok(h, b, n, d, v)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_width(d, [&](auto kc) {
    return w_vd ? launch_fwd<true, decltype(kc)::value>(h, wp, b, lse, n, v, s)
                : launch_fwd<false, decltype(kc)::value>(h, wp, b, lse, n, v, s);
  });
}

extern "C" int xent_dh(const void* h, const void* wp, const float* b, const float* lse,
                       const float* g, void* dh, int n, int d, int v, int w_vd, void* stream) {
  if (!args_ok(h, b, n, d, v)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* out = static_cast<bf16*>(dh);
  return by_width(d, [&](auto kc) {
    return w_vd ? launch_dh<true, decltype(kc)::value>(h, wp, b, lse, g, out, n, v, s)
                : launch_dh<false, decltype(kc)::value>(h, wp, b, lse, g, out, n, v, s);
  });
}

extern "C" int xent_dwdb(const void* h, const void* wp, const float* b, const float* lse,
                         const float* g, float* dw, float* db, int n, int d, int v, int w_vd,
                         void* stream) {
  if (!args_ok(h, b, n, d, v)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_width(d, [&](auto kc) {
    return w_vd ? launch_dwdb<true, decltype(kc)::value>(h, wp, b, lse, g, dw, db, n, v, s)
                : launch_dwdb<false, decltype(kc)::value>(h, wp, b, lse, g, dw, db, n, v, s);
  });
}

// How many clusters of the dw/db kernel the card holds at once (its waves
// are ceil(clusters launched / this)); -1 if the query fails.
extern "C" int xent_dwdb_active_clusters() {
  auto kernel = xent_dwdb_kernel<false>;
  if (set_smem(kernel, DW_SMEM) != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};  // the cluster size is the kernel's own
  cfg.gridDim = dim3(DW_CLUSTER);
  cfg.blockDim = dim3(DW_THREADS);
  cfg.dynamicSmemBytes = DW_SMEM;
  int clusters = 0;
  return cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) == cudaSuccess ? clusters : -1;
}
