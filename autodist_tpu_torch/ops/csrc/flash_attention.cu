// Flash attention kernels for Hopper (sm_90a): the causal forward and the
// two backward kernels, over q/k/v read in place as [B, L, H, 64] bf16.
//
// Replaces the Pallas TPU kernels of autodist_tpu/ops/flash_attention.py:
//   flash_fwd_kernel       <- _flash_kernel           (flash_attention.py:77, pallas_call :144)
//   flash_bwd_dkdv_kernel  <- _flash_bwd_dkdv_kernel  (flash_attention.py:199, pallas_call :332)
//   flash_bwd_dq_kernel    <- _flash_bwd_dq_kernel    (flash_attention.py:241, pallas_call :355)
//
// What bounds them: operations. At B = 8, H = 8, L = 8,192, hd = 64 the
// causal forward does 2*B*H*L^2*hd FLOPs (two products over half the score
// matrix; 0.56 ms at the card's dense bf16 peak), dK/dV 4*B*H*L^2*hd (S, dP,
// dV and dK recomputed or accumulated), dQ 3*B*H*L^2*hd, against 0.1 ms or
// less of input reads each.
//
// Design, and how it differs from the TPU kernels:
// - The TPU grid runs in order and carries the online-softmax state (or the
//   dK/dV/dQ accumulators) across grid steps in VMEM scratch. Hopper's
//   blocks run in no order, so the sequential loop moves inside one block:
//   forward and dQ give each block 64 query rows of one (batch, head) that
//   walk the key tiles up to the diagonal; dK/dV gives each block 64 keys
//   that walk the query tiles from the diagonal to the end. The causal skip
//   is a loop bound, not a per-step predicate. No reduction crosses blocks:
//   no atomics, and the same bits from run to run.
// - Each of the block's 4 warps owns 16 rows. Products are mma.sync
//   m16n8k16 bf16 x bf16 -> f32 with operands from shared memory through
//   ldmatrix; the score tile stays in registers, where the online softmax
//   (forward) or p and ds (backward) are computed and re-packed as the bf16
//   A operand of the next product without a trip through shared memory.
// - The next key (or query) tile is copied with cp.async into a second
//   buffer while the current one computes. Shared-memory rows are padded to
//   144 bytes so that ldmatrix rows fall on distinct banks.
// - q/k/v/dO are read in their [B, L, H, 64] layout (row stride H*64): no
//   transposed copies. lse and D are plain f32 [B*H, Lq]. Rows past the
//   sequence end are zero-filled on load and never stored.
// - Arithmetic follows the Pallas kernels: scale = 1/sqrt(64) applied in f32
//   to the f32 product; masked scores are NEG_INF and p = 0 at or below
//   NEG_INF/2; out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)); p and
//   ds are rounded to bf16 only as product operands. No TMA or wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 64;        // head width: the flagship's d_model 512 / 8 heads
constexpr int BQ = 64;        // query rows per block, 16 per warp
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 4 warps
constexpr int LD = HD + 8;    // shared-memory row stride in bf16 (144 bytes)
constexpr int TILE = 64 * LD; // elements of one [64][LD] tile
constexpr size_t TILE_BYTES = size_t(TILE) * 2;
constexpr float NEG_INF = -1e30f;
static_assert(BQ == 64 && BK == 64, "the tile helpers assume 64-row tiles");

// dK/dV: K, V, two Q and two dO buffers, two lse and two D rows.
constexpr size_t DKDV_SMEM = 6 * TILE_BYTES + 4 * BQ * sizeof(float);
// dQ: Q, dO, two K and two V buffers.
constexpr size_t DQ_SMEM = 6 * TILE_BYTES;

// ------------------------------------------------------------ copies to smem

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// Asynchronous global -> shared copies; `bytes` 0 reads nothing and
// zero-fills the destination.
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

// Rows [r0, r0 + 64) of one head's [L, 64] slice (row stride `stride`
// elements) -> tile, asynchronously; rows >= n are zeros.
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* __restrict__ base, int r0,
                                          int n, int stride) {
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks a row
#pragma unroll
  for (int j = 0; j < 64 * CHUNKS / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const bool ok = r0 + r < n;
    cp_async16(tile + r * LD + c, ok ? base + size_t(r0 + r) * stride + c : base, ok ? 16 : 0);
  }
}

// f32 entries [r0, r0 + 64) of `row` -> dst, asynchronously; entries >= n
// are zeros. Threads t0 .. t0 + 63 take one entry each.
__device__ __forceinline__ void load_row(float* dst, const float* __restrict__ row, int r0,
                                         int n, int t0) {
  const int i = threadIdx.x - t0;
  if (i >= 0 && i < 64) {
    const bool ok = r0 + i < n;
    cp_async4(dst + i, ok ? row + r0 + i : row, ok ? 4 : 0);
  }
}

// -------------------------------------------------------- tensor-core pieces

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
// d[16x8] += a[16x16] . b[16x8], bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// This lane's row address for an x4 ldmatrix of the 16x16 block at (row0,
// col0) of a tile, the four 8x8 matrices taken as (rows 0-7, cols 0-7),
// (8-15, 0-7), (0-7, 8-15), (8-15, 8-15): the A operand's order, and, with
// .trans, the B operands of two n-tiles from a [k][n] tile.
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int row0, int col0, int lane) {
  return tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + col0 + (lane >> 4) * 8;
}
// The same for the order (0-7, 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15):
// the B operands of two n-tiles from an [n][k] tile, without .trans.
__device__ __forceinline__ const bf16* b_addr(const bf16* tile, int row0, int col0, int lane) {
  return tile + (row0 + (lane & 7) + (lane >> 4) * 8) * LD + col0 + ((lane >> 3) & 1) * 8;
}

// A operand: rows row0 .. row0 + 15 of a tile, all 64 columns (4 k-chunks).
__device__ __forceinline__ void load_a(unsigned (&a)[4][4], const bf16* tile, int row0,
                                       int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) ldmatrix_x4(a[kc], a_addr(tile, row0, kc * 16, lane));
}

// acc[16 x 64] += A[16 x 64] . Bt^T, where Bt is a [64 n][64 k] tile (the
// keys, or the queries, in their stored layout): the score-shaped products.
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const unsigned (&a)[4][4],
                                        const bf16* bt, int lane) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      unsigned b[4];
      ldmatrix_x4(b, b_addr(bt, np * 16, kc * 16, lane));
      mma_bf16(acc[2 * np], a[kc], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[kc], b[2], b[3]);
    }
  }
}

// acc[16 x 64] += P[16 x 64] . Bm, where Bm is a [64 k][64 n] tile (V, dO, Q
// or K in their stored layout) and P is held as bf16 A fragments.
__device__ __forceinline__ void mma_ab(float (&acc)[8][4], const unsigned (&p)[4][4],
                                       const bf16* bm, int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned b[4];
      ldmatrix_x4_trans(b, a_addr(bm, kc * 16, np * 16, lane));
      mma_bf16(acc[2 * np], p[kc], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], p[kc], b[2], b[3]);
    }
  }
}

// An f32 accumulator tile [16 x 64] (8 n-tiles) -> the bf16 A fragments of
// the product that contracts over its 64 columns.
__device__ __forceinline__ void to_a(unsigned (&p)[4][4], const float (&s)[8][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    p[kc][0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
    p[kc][1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
    p[kc][2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
    p[kc][3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// Rows r0 + lane/4 (+8) of an accumulator tile, times `mul`, into one head's
// [L, 64] slice of a [B, L, H, 64] tensor; rows >= n are not stored.
__device__ __forceinline__ void store_rows(bf16* base, const float (&acc)[8][4], int r0, int n,
                                           int stride, float mul, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + lane / 4 + 8 * i;
    if (row >= n) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(base + size_t(row) * stride + nt * 8 + (lane % 4) * 2) =
          __floats2bfloat162_rn(acc[nt][2 * i] * mul, acc[nt][2 * i + 1] * mul);
  }
}
__device__ __forceinline__ void store_rows(float* base, const float (&acc)[8][4], int r0, int n,
                                           int stride, float mul, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + lane / 4 + 8 * i;
    if (row >= n) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<float2*>(base + size_t(row) * stride + nt * 8 + (lane % 4) * 2) =
          make_float2(acc[nt][2 * i] * mul, acc[nt][2 * i + 1] * mul);
  }
}

// Is the score of query qp (local) and key kp (local) masked?
__device__ __forceinline__ bool invalid(int qp, int kp, int lq, int lk, int causal, int q_off,
                                        int k_off) {
  return qp >= lq || kp >= lk || (causal && k_off + kp > q_off + qp);
}

// Keys a block of query rows [q0, q0 + 64) needs: [0, end).
__device__ __forceinline__ int key_end(int q0, int lq, int lk, int causal, int q_off,
                                       int k_off) {
  return causal ? min(lk, q_off - k_off + min(q0 + BQ, lq)) : lk;
}

// ------------------------------------------------------------------ forward

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                 int H, int lq, int lk, int causal, int q_off, int k_off, float scale) {
  __shared__ __align__(128) unsigned char smem[5 * TILE_BYTES];  // 45 KB: static is enough
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + TILE;      // [2][TILE]
  bf16* vs = ks + 2 * TILE;  // [2][TILE]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal rows start first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int stride = H * HD;
  const bf16* qb = q + (size_t(b) * lq * H + h) * HD;
  const bf16* kb = k + (size_t(b) * lk * H + h) * HD;
  const bf16* vb = v + (size_t(b) * lk * H + h) * HD;
  const int k_end = key_end(q0, lq, lk, causal, q_off, k_off);
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  load_tile(qs, qb, q0, lq, stride);
  if (n_tiles > 0) {
    load_tile(ks, kb, 0, lk, stride);
    load_tile(vs, vb, 0, lk, stride);
  }
  cp_async_commit();

  const int row0 = q0 + warp * 16 + lane / 4;  // this thread's rows: row0 and row0 + 8
  const int col = (lane % 4) * 2;              // and columns col, col + 1 of each n-tile
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[8][4];
  zero(o);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t + 1 < n_tiles) {
      load_tile(ks + ((t + 1) & 1) * TILE, kb, (t + 1) * BK, lk, stride);
      load_tile(vs + ((t + 1) & 1) * TILE, vb, (t + 1) * BK, lk, stride);
      cp_async_commit();
    }
    const int k0 = t * BK;
    float s[8][4];
    zero(s);
    {
      unsigned qa[4][4];
      load_a(qa, qs, warp * 16, lane);
      mma_abt(s, qa, ks + (t & 1) * TILE, lane);
    }
    const bool need_mask = k0 + BK > lk || (causal && k_off + k0 + BK - 1 > q_off + q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale;
        if (need_mask && invalid(row0 + 8 * (e >> 1), k0 + nt * 8 + col + (e & 1), lq, lk,
                                 causal, q_off, k_off))
          x = NEG_INF;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = __expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[nt][e];
        const float p = x <= NEG_INF * 0.5f ? 0.f : __expf(x - mx[e >> 1]);
        s[nt][e] = p;
        psum[e >> 1] += p;
        o[nt][e] *= corr[e >> 1];
      }
    // Per-thread partial denominators: the quad's four are summed at the end.
    l[0] = l[0] * corr[0] + psum[0];
    l[1] = l[1] * corr[1] + psum[1];
    unsigned pa[4][4];
    to_a(pa, s);
    mma_ab(o, pa, vs + (t & 1) * TILE, lane);
  }
  cp_async_wait_all();

  bf16* ob = out + (size_t(b) * lq * H + h) * HD;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float safe = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / safe;
    const int row = row0 + 8 * i;
    if (lane % 4 == 0 && row < lq) lse[size_t(bh) * lq + row] = m[i] + logf(safe);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= lq) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(ob + size_t(row) * stride + nt * 8 + col) =
          __floats2bfloat162_rn(o[nt][2 * i] * inv[i], o[nt][2 * i + 1] * inv[i]);
  }
}

// -------------------------------------------------------------------- dK/dV

// One block per 64 keys of one (batch, head), walking the query tiles from
// the diagonal to the end. Warp w owns keys k0 + 16w .. +16 and computes the
// transposed score tile S^T = K Q^T, so that P^T and dS^T come out as the A
// operands of dV += P^T dO and dK += dS^T Q.
template <typename OutT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dd,
                      OutT* __restrict__ dk, OutT* __restrict__ dv, int H, int lq, int lk,
                      int causal, int q_off, int k_off, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + TILE;
  bf16* qs = vs + TILE;      // [2][TILE]
  bf16* dos = qs + 2 * TILE; // [2][TILE]
  float* ls = reinterpret_cast<float*>(dos + 2 * TILE);  // [2][BQ] lse
  float* ds_ = ls + 2 * BQ;                               // [2][BQ] D
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int stride = H * HD;
  const bf16* qb = q + (size_t(b) * lq * H + h) * HD;
  const bf16* dob = dout + (size_t(b) * lq * H + h) * HD;
  const bf16* kb = k + (size_t(b) * lk * H + h) * HD;
  const bf16* vb = v + (size_t(b) * lk * H + h) * HD;
  const float* lrow = lse + size_t(bh) * lq;
  const float* drow = dd + size_t(bh) * lq;
  // The first query that sees key k0; tiles before its own see none of this block's keys.
  const int t0 = causal ? max(0, k_off - q_off + k0) / BQ : 0;
  const int n_q_tiles = (lq + BQ - 1) / BQ;

  load_tile(ks, kb, k0, lk, stride);
  load_tile(vs, vb, k0, lk, stride);
  if (t0 < n_q_tiles) {
    load_tile(qs, qb, t0 * BQ, lq, stride);
    load_tile(dos, dob, t0 * BQ, lq, stride);
    load_row(ls, lrow, t0 * BQ, lq, 0);
    load_row(ds_, drow, t0 * BQ, lq, 64);
  }
  cp_async_commit();

  const int key0 = k0 + warp * 16 + lane / 4;  // this thread's keys: key0 and key0 + 8
  const int col = (lane % 4) * 2;              // and query columns col, col + 1 of each n-tile
  float dka[8][4], dva[8][4];
  zero(dka);
  zero(dva);
  for (int t = t0; t < n_q_tiles; ++t) {
    const int buf = (t - t0) & 1;
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < n_q_tiles) {
      const int nb = buf ^ 1;
      load_tile(qs + nb * TILE, qb, (t + 1) * BQ, lq, stride);
      load_tile(dos + nb * TILE, dob, (t + 1) * BQ, lq, stride);
      load_row(ls + nb * BQ, lrow, (t + 1) * BQ, lq, 0);
      load_row(ds_ + nb * BQ, drow, (t + 1) * BQ, lq, 64);
      cp_async_commit();
    }
    const bf16* qt = qs + buf * TILE;
    const bf16* dot = dos + buf * TILE;
    const float* lt = ls + buf * BQ;
    const float* dt = ds_ + buf * BQ;
    const int qt0 = t * BQ;
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    {
      unsigned a[4][4];
      load_a(a, ks, warp * 16, lane);
      mma_abt(s, a, qt, lane);  // S^T [keys x queries]
      load_a(a, vs, warp * 16, lane);
      mma_abt(dp, a, dot, lane);  // dP^T
    }
    const bool need_mask =
        qt0 + BQ > lq || k0 + BK > lk || (causal && k_off + k0 + BK - 1 > q_off + qt0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + col + (e & 1);
        float p = __expf(s[nt][e] * scale - lt[qi]);
        if (need_mask &&
            invalid(qt0 + qi, key0 + 8 * (e >> 1), lq, lk, causal, q_off, k_off))
          p = 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - dt[qi]);
      }
    unsigned pa[4][4];
    to_a(pa, s);
    mma_ab(dva, pa, dot, lane);
    to_a(pa, dp);
    mma_ab(dka, pa, qt, lane);
  }
  cp_async_wait_all();

  const size_t head = (size_t(b) * lk * H + h) * HD;
  store_rows(dk + head, dka, k0 + warp * 16, lk, stride, scale, lane);
  store_rows(dv + head, dva, k0 + warp * 16, lk, stride, 1.f, lane);
}

// ----------------------------------------------------------------------- dQ

// One block per 64 query rows of one (batch, head), walking the key tiles up
// to the diagonal, as the forward does.
template <typename OutT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dd,
                    OutT* __restrict__ dq, int H, int lq, int lk, int causal, int q_off,
                    int k_off, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + TILE;
  bf16* ks = dos + TILE;      // [2][TILE]
  bf16* vs = ks + 2 * TILE;   // [2][TILE]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int stride = H * HD;
  const bf16* qb = q + (size_t(b) * lq * H + h) * HD;
  const bf16* dob = dout + (size_t(b) * lq * H + h) * HD;
  const bf16* kb = k + (size_t(b) * lk * H + h) * HD;
  const bf16* vb = v + (size_t(b) * lk * H + h) * HD;
  const int k_end = key_end(q0, lq, lk, causal, q_off, k_off);
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  load_tile(qs, qb, q0, lq, stride);
  load_tile(dos, dob, q0, lq, stride);
  if (n_tiles > 0) {
    load_tile(ks, kb, 0, lk, stride);
    load_tile(vs, vb, 0, lk, stride);
  }
  cp_async_commit();

  const int row0 = q0 + warp * 16 + lane / 4;
  const int col = (lane % 4) * 2;
  float row_lse[2], row_d[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    row_lse[i] = row < lq ? lse[size_t(bh) * lq + row] : 0.f;
    row_d[i] = row < lq ? dd[size_t(bh) * lq + row] : 0.f;
  }
  float dqa[8][4];
  zero(dqa);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < n_tiles) {
      const int nb = (t + 1) & 1;
      load_tile(ks + nb * TILE, kb, (t + 1) * BK, lk, stride);
      load_tile(vs + nb * TILE, vb, (t + 1) * BK, lk, stride);
      cp_async_commit();
    }
    const bf16* kt = ks + (t & 1) * TILE;
    const bf16* vt = vs + (t & 1) * TILE;
    const int k0 = t * BK;
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    {
      unsigned a[4][4];
      load_a(a, qs, warp * 16, lane);
      mma_abt(s, a, kt, lane);  // S
      load_a(a, dos, warp * 16, lane);
      mma_abt(dp, a, vt, lane);  // dP
    }
    const bool need_mask =
        q0 + BQ > lq || k0 + BK > lk || (causal && k_off + k0 + BK - 1 > q_off + q0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = __expf(s[nt][e] * scale - row_lse[i]);
        if (need_mask &&
            invalid(row0 + 8 * i, k0 + nt * 8 + col + (e & 1), lq, lk, causal, q_off, k_off))
          p = 0.f;
        dp[nt][e] = p * (dp[nt][e] - row_d[i]);
      }
    unsigned pa[4][4];
    to_a(pa, dp);
    mma_ab(dqa, pa, kt, lane);
  }
  cp_async_wait_all();

  store_rows(dq + (size_t(b) * lq * H + h) * HD, dqa, q0 + warp * 16, lq, stride, scale, lane);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

// What every entry point takes: head width 64 (the only one instantiated),
// non-empty sequences, and a grid that fits (b*h on the grid's y axis).
bool args_ok(int b, int h, int lq, int lk, int d) {
  return d == HD && b > 0 && h > 0 && lq > 0 && lk > 0 && b * h <= 65535;
}

template <typename OutT>
int launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
               const float* dd, void* dk, void* dv, void* dq, int b, int h, int lq, int lk,
               int causal, int q_off, int k_off, cudaStream_t stream) {
  const float scale = 1.f / sqrtf(float(HD));
  if (dk != nullptr) {
    auto kernel = flash_bwd_dkdv_kernel<OutT>;
    cudaError_t err = set_smem(kernel, DKDV_SMEM);
    if (err != cudaSuccess) return int(err);
    kernel<<<dim3((lk + BK - 1) / BK, b * h), THREADS, DKDV_SMEM, stream>>>(
        q, k, v, dout, lse, dd, static_cast<OutT*>(dk), static_cast<OutT*>(dv), h, lq, lk,
        causal, q_off, k_off, scale);
  } else {
    auto kernel = flash_bwd_dq_kernel<OutT>;
    cudaError_t err = set_smem(kernel, DQ_SMEM);
    if (err != cudaSuccess) return int(err);
    kernel<<<dim3((lq + BQ - 1) / BQ, b * h), THREADS, DQ_SMEM, stream>>>(
        q, k, v, dout, lse, dd, static_cast<OutT*>(dq), h, lq, lk, causal, q_off, k_off,
        scale);
  }
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Each returns a cudaError_t (0 on
// success; cudaErrorInvalidValue for arguments args_ok refuses). q, dout:
// bf16 [b, lq, h, d]; k, v: bf16 [b, lk, h, d]; lse, dd: f32 [b*h, lq]; all
// contiguous and 16-byte aligned. out is bf16 like q; dq/dk/dv are bf16, or
// f32 with out_f32.

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                         int b, int h, int lq, int lk, int d, int causal, int q_off, int k_off,
                         void* stream) {
  if (!args_ok(b, h, lq, lk, d)) return int(cudaErrorInvalidValue);
  flash_fwd_kernel<<<dim3((lq + BQ - 1) / BQ, b * h), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, h, lq, lk, causal, q_off, k_off, 1.f / sqrtf(float(HD)));
  return int(cudaGetLastError());
}

extern "C" int flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* dd, void* dk, void* dv, int b,
                              int h, int lq, int lk, int d, int causal, int q_off, int k_off,
                              int out_f32, void* stream) {
  if (!args_ok(b, h, lq, lk, d)) return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto q_ = static_cast<const bf16*>(q);
  auto k_ = static_cast<const bf16*>(k);
  auto v_ = static_cast<const bf16*>(v);
  auto do_ = static_cast<const bf16*>(dout);
  return out_f32 ? launch_bwd<float>(q_, k_, v_, do_, lse, dd, dk, dv, nullptr, b, h, lq, lk,
                                     causal, q_off, k_off, s)
                 : launch_bwd<bf16>(q_, k_, v_, do_, lse, dd, dk, dv, nullptr, b, h, lq, lk,
                                    causal, q_off, k_off, s);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* dd, void* dq, int b, int h, int lq,
                            int lk, int d, int causal, int q_off, int k_off, int out_f32,
                            void* stream) {
  if (!args_ok(b, h, lq, lk, d)) return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto q_ = static_cast<const bf16*>(q);
  auto k_ = static_cast<const bf16*>(k);
  auto v_ = static_cast<const bf16*>(v);
  auto do_ = static_cast<const bf16*>(dout);
  return out_f32 ? launch_bwd<float>(q_, k_, v_, do_, lse, dd, nullptr, nullptr, dq, b, h, lq,
                                     lk, causal, q_off, k_off, s)
                 : launch_bwd<bf16>(q_, k_, v_, do_, lse, dd, nullptr, nullptr, dq, b, h, lq,
                                    lk, causal, q_off, k_off, s);
}
