// Flash attention kernels for Hopper (sm_90a): the causal forward, its
// carry form (ring attention's local step) and the two backward kernels,
// over q/k/v read in place as [B, L, H, 64] bf16.
//
// Replaces the Pallas TPU kernels of autodist_tpu/ops/flash_attention.py:
//   flash_fwd_kernel       <- _flash_kernel           (flash_attention.py:77, pallas_call :144)
//   flash_bwd_dkdv_kernel  <- _flash_bwd_dkdv_kernel  (flash_attention.py:199, pallas_call :332)
//   flash_bwd_dq_kernel    <- _flash_bwd_dq_kernel    (flash_attention.py:241, pallas_call :355)
//   flash_fwd_carry_kernel <- _flash_carry_kernel     (flash_attention.py:387, pallas_call :480)
//
// What bounds the forward (and the carry kernel, which runs the same walk):
// two units, about equally. At B = 8, H = 8, L = 8,192, hd = 64, causal, it
// does 2*B*H*L^2*hd tensor-core FLOPs (two products over half the score
// matrix: 0.556 ms at the card's 989 TFLOP/s dense bf16) and one exp per
// score, 2.15e9 of them (0.55 ms at the special-function unit's 3.9 T/s,
// 1/256 of the tensor rate), against 0.1 ms of input reads (the carry adds
// 134 MB of f32 acc each way, 0.04 ms per direction at 3.35 TB/s). Run one
// after the other, the two units give a floor near 1.1 ms; overlapped, near
// 0.56 ms.
//
// Forward design (flash_fwd_kernel, flash_fwd_carry_kernel; forward_walk):
// - A block owns 192 query rows of one (batch, head) and walks the key tiles
//   they need, 128 keys a tile, from the diagonal down (the tiles that need
//   a mask come first, the causal skip is a loop bound). Hopper's blocks
//   run in no order, so the TPU grid's sequential key axis is this loop; no
//   reduction crosses blocks and the bits are the same from run to run.
// - Warp specialisation: warpgroup 0 is the producer; one of its threads
//   issues every copy, and setmaxnreg hands its registers to the three
//   consumer warpgroups (64 query rows each; 160 registers a thread). Two
//   consumers (128 rows, 240 registers) ran slower on an H100.
// - TMA: q, k and v are read in place through 4-D tensor maps over
//   [B, L, H, 64] (one 64-wide bf16 row is 128 bytes: 128-byte swizzle).
//   Q is loaded once; K and V pass through a ring of FWD_STAGES stages with
//   full and empty mbarriers, so the producer keeps copies in flight while
//   the consumers compute. Rows past the sequence end arrive zero-filled.
// - wgmma: S = Q K^T is m64n128k16 with both operands in shared memory
//   (K-major); O += P V is m64n64k16 with P from registers (the score
//   accumulator re-packed as bf16 in place: wgmma's accumulator layout per
//   warp is mma.sync's) and V from shared memory as an MN-major operand.
//   No shared-memory traffic through the register file, and Q is not
//   reloaded per tile.
// - Ping-pong: named barriers pass the turn to issue products round robin
//   among the consumers, so one warpgroup's products (Q K^T of its next
//   tile and P V of its last, issued together) run on the tensor cores while
//   the others compute their softmax on the exponential unit: the overlap
//   the floor above asks for. Within a warpgroup the softmax of the next
//   tile starts as soon as its scores land, beside its own P V.
// - Softmax: scale * log2(e) folds into one FFMA before ex2; m is kept in
//   the JAX units (the max of the scaled scores, natural log) and only the
//   tiles that cross the diagonal or the sequence end are masked.
//
// The backward kernels (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel) keep
// the first design: each block owns 64 query rows (dQ) or 64 keys (dK/dV)
// and walks the other side; each of its 4 warps owns 16 rows; products are
// mma.sync m16n8k16 with operands from shared memory through ldmatrix,
// the next tile double-buffered with cp.async into 144-byte padded rows.
//
// Arithmetic follows the Pallas kernels: scale = 1/sqrt(64) in f32 on the f32
// product; masked scores are NEG_INF and p = 0 at or below NEG_INF/2;
// out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)); p and ds are
// rounded to bf16 only as product operands. q/k/v/dO are read in their
// [B, L, H, 64] layout; lse and D are plain f32 [B*H, Lq].

#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 64;        // head width: the flagship's d_model 512 / 8 heads
constexpr int BQ = 64;        // backward: query rows per block, 16 per warp
constexpr int BK = 64;        // backward: keys per tile
constexpr int THREADS = 128;  // backward: 4 warps
constexpr int LD = HD + 8;    // backward: shared-memory row stride in bf16 (144 bytes)
constexpr int TILE = 64 * LD; // elements of one [64][LD] tile
constexpr size_t TILE_BYTES = size_t(TILE) * 2;
constexpr float NEG_INF = -1e30f;
static_assert(BQ == 64 && BK == 64, "the tile helpers assume 64-row tiles");

// dK/dV: K, V, two Q and two dO buffers, two lse and two D rows.
constexpr size_t DKDV_SMEM = 6 * TILE_BYTES + 4 * BQ * sizeof(float);
// dQ: Q, dO, two K and two V buffers.
constexpr size_t DQ_SMEM = 6 * TILE_BYTES;

// ------------------------------------------------------------ copies to smem

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

// An f32 accumulator tile [16 x 16 KC] (2 KC n-tiles) -> the bf16 A
// fragments of the product that contracts over its columns.
template <int KC>
__device__ __forceinline__ void to_a(unsigned (&p)[KC][4], const float (&s)[2 * KC][4]) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
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

constexpr int NC = 3;                // consumer warpgroups, 64 query rows each
constexpr int FWD_BM = 64 * NC;      // query rows per block
constexpr int FWD_BN = 128;          // keys per tile
constexpr int FWD_STAGES = 3;        // K/V ring depth
constexpr int FWD_THREADS = 128 * (1 + NC);  // the producer warpgroup and the consumers
// setmaxnreg: what the producer gives up, the consumers take (65,536 a block).
constexpr int PRODUCER_REGS = 32;
constexpr int CONSUMER_REGS = 160;
static_assert(128 * PRODUCER_REGS + 128 * NC * CONSUMER_REGS <= 65536, "register file");
constexpr unsigned Q_PART_BYTES = 64 * HD * 2;       // one consumer's Q rows
constexpr unsigned KV_BYTES = FWD_BN * HD * 2;       // one K or V tile
constexpr float SCALE = 0.125f;                      // 1/sqrt(HD), a power of two
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED = NEG_INF / SCALE;            // the raw score that scales to NEG_INF
// Consumers' empty-barrier arrivals: lane 0 of each of their warps.
constexpr unsigned CONSUMER_WARPS = 4 * NC;

// 128-byte-swizzled tiles (TMA writes them; wgmma reads them) must start on
// 1024-byte boundaries: one swizzle atom is 8 rows of 128 bytes.
struct FwdSmem {
  alignas(1024) bf16 q[NC][64 * HD];
  alignas(1024) bf16 k[FWD_STAGES][FWD_BN * HD];
  alignas(1024) bf16 v[FWD_STAGES][FWD_BN * HD];
  uint64_t q_full;
  uint64_t k_full[FWD_STAGES], v_full[FWD_STAGES];
  uint64_t k_empty[FWD_STAGES], v_empty[FWD_STAGES];
};
constexpr size_t FWD_SMEM = sizeof(FwdSmem) + 1024;  // + room to align the base

// What both forward kernels take besides the tensor maps of q, k and v.
// The forward writes out/lse; the carry kernel reads acc_in/m_in/l_in (all
// null: a fresh walk) and writes acc_out/m_out/l_out.
struct FwdParams {
  int h, lq, lk, causal, q_off, k_off;
  bf16* out;
  float* lse;
  const float* acc_in;
  const float* m_in;
  const float* l_in;
  float* acc_out;
  float* m_out;
  float* l_out;
};

// Named barriers 1 .. NC order the consumer warpgroups round robin: consumer
// c waits on barrier 1 + c (its own thread and the one before it, 256 in
// all) and then releases barrier 1 + (c + 1) % NC.

// Sum the quad's four partial denominators: every lane of the quad gets the row's l.
__device__ __forceinline__ void quad_sum(float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
}

// The online softmax of tile scores s (raw, unscaled; this thread's rows
// row0 and row0 + 8, keys k0 + 8 nt + col (+1)): mask if asked, update m
// (JAX units) and the partial l, leave p in s and the factor that rescales
// the accumulator in corr.
__device__ __forceinline__ void softmax_tile(float (&s)[16][4], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool need_mask, int row0, int k0,
                                             int col, const FwdParams& p) {
  if (need_mask) {
    // Each row sees the tile's keys below a limit: the sequence end, and
    // with causal masking its own position.
    int limit[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      limit[i] = p.lk - k0 - col;
      if (p.causal) limit[i] = min(limit[i], p.q_off - p.k_off + row0 + 8 * i + 1 - k0 - col);
    }
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (nt * 8 + (e & 1) >= limit[e >> 1]) s[nt][e] = MASKED;
  }
  float mx[2] = {MASKED, MASKED};
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
  float mc[2], psum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // SCALE is a power of two: max(s) * SCALE is the max of the scaled scores.
    const float m_new = fmaxf(m[i], mx[i] * SCALE);
    corr[i] = ex2((m[i] - m_new) * LOG2E);
    // A row with no visible key yet keeps m at NEG_INF: its masked scores
    // must give p = 0, not exp(0), whatever the carried state.
    mc[i] = m_new <= NEG_INF * 0.5f ? 0.f : m_new * LOG2E;
    m[i] = m_new;
  }
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = ex2(fmaf(s[nt][e], SCALE * LOG2E, -mc[e >> 1]));
      s[nt][e] = pe;
      psum[e >> 1] += pe;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + psum[i];
}

__device__ __forceinline__ void rescale(float (&o)[8][4], const float (&corr)[2]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] *= corr[e >> 1];
}

// S = Q K^T of one key tile (4 k steps over the head width).
__device__ __forceinline__ void issue_qk(float (&s)[16][4], uint64_t dq, const bf16* k_tile) {
  const uint64_t dk = sw128_desc(k_tile);
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) wgmma_m64n128k16_ss(s, dq + 2 * kc, dk + 2 * kc, kc);
}
// O += P V of one key tile (8 k steps over its keys; 2048 bytes each).
__device__ __forceinline__ void issue_pv(float (&o)[8][4], const unsigned (&pa)[8][4],
                                         const bf16* v_tile) {
  const uint64_t dv = sw128_desc(v_tile);
#pragma unroll
  for (int kc = 0; kc < FWD_BN / 16; ++kc) wgmma_m64n64k16_rs(o, pa[kc], dv + 128 * kc);
}

// One consumer warpgroup (c = 0 or 1: rows q0 + 64c .. + 63) over the
// block's n_tiles key tiles, from the last down. Each round issues, in its
// turn, Q K^T of the next tile and P V of the last one as two groups; the
// softmax of the next tile runs as soon as its scores land, beside this
// warpgroup's P V and the other warpgroup's products. The accumulator is
// rescaled just before the P V that follows, when no product writes it.
// The first round has no P V and the last no Q K^T; every wgmma sits on a
// path that all of the warpgroup takes, so none is serialized.
__device__ __forceinline__ void consume_key_tiles(FwdSmem& sm, int c, int q0, int n_tiles,
                                                  const FwdParams& p, float (&m)[2],
                                                  float (&l)[2], float (&o)[8][4]) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int qc = q0 + 64 * c;
  const int row0 = qc + warp * 16 + lane / 4;
  const int col = (lane % 4) * 2;
  const int my_turn = 1 + c, their_turn = 1 + (c + 1) % NC;
  const uint64_t dq = sw128_desc(sm.q[c]);
  float s[16][4], corr[2];
  unsigned pa[8][4];  // P of the last tile, bf16 A fragments
  auto softmax = [&](int i) {
    const int k0 = (n_tiles - 1 - i) * FWD_BN;
    const bool need_mask = k0 + FWD_BN > p.lk ||
                           (p.causal && p.k_off + k0 + FWD_BN - 1 > p.q_off + qc);
    softmax_tile(s, m, l, corr, need_mask, row0, k0, col, p);
  };
  mbar_wait(&sm.q_full, 0);
  if (c == NC - 1) named_arrive(1);  // consumer 0 goes first

  mbar_wait(&sm.k_full[0], 0);
  named_sync(my_turn);
  wgmma_fence();
  issue_qk(s, dq, sm.k[0]);
  wgmma_commit();
  named_arrive(their_turn);
  wgmma_wait<0>();
  fence_regs(s);
  if (lane == 0) mbar_arrive(&sm.k_empty[0]);
  softmax(0);
  to_a(pa, s);

  int stage = 0, parity = 0;  // the last tile's
  for (int i = 1; i < n_tiles; ++i) {
    const int next = stage + 1 == FWD_STAGES ? 0 : stage + 1;
    const int next_parity = next == 0 ? parity ^ 1 : parity;
    rescale(o, corr);
    mbar_wait(&sm.k_full[next], next_parity);
    mbar_wait(&sm.v_full[stage], parity);
    named_sync(my_turn);
    fence_regs(o);
    wgmma_fence();
    issue_qk(s, dq, sm.k[next]);
    wgmma_commit();
    issue_pv(o, pa, sm.v[stage]);
    wgmma_commit();
    named_arrive(their_turn);
    wgmma_wait<1>();  // the scores
    fence_regs(s);
    if (lane == 0) mbar_arrive(&sm.k_empty[next]);
    softmax(i);
    wgmma_wait<0>();  // P V
    fence_regs(o);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(&sm.v_empty[stage]);
    to_a(pa, s);
    stage = next;
    parity = next_parity;
  }

  rescale(o, corr);
  mbar_wait(&sm.v_full[stage], parity);
  named_sync(my_turn);
  fence_regs(o);
  wgmma_fence();
  issue_pv(o, pa, sm.v[stage]);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pa);
  // The last consumer's last round has no round of consumer 0's left to release.
  if (c != NC - 1) named_arrive(their_turn);
  if (lane == 0) mbar_arrive(&sm.v_empty[stage]);
}

// The walk both forward kernels run; CARRY selects the carry kernel's
// prologue (the carry read in) and epilogue (acc, m, l written back
// unnormalized) over the forward's (out and lse). In the carry, a block
// whose causal key range is empty runs no tile and writes its carry rows
// back bit for bit; the carried l enters once per row, in the quad's lane
// 0, since the walk keeps per-lane partial denominators.
template <bool CARRY>
__device__ __forceinline__ void forward_walk(const CUtensorMap* qm, const CUtensorMap* km,
                                             const CUtensorMap* vm, const FwdParams& p) {
  extern __shared__ unsigned char fwd_smem[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(
      (reinterpret_cast<uintptr_t>(fwd_smem) + 1023) & ~uintptr_t(1023));
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FWD_BM;  // the longest causal rows start first
  const int bh = blockIdx.y, b = bh / p.h, h = bh % p.h;
  const int k_end = p.causal ? min(p.lk, p.q_off - p.k_off + min(q0 + FWD_BM, p.lq)) : p.lk;
  const int n_tiles = k_end > 0 ? (k_end + FWD_BN - 1) / FWD_BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], CONSUMER_WARPS);
      mbar_init(&sm.v_empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread issues every copy, in the consumers' order.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (threadIdx.x == 0 && n_tiles > 0) {
      // Only consumers with a row inside the sequence get their Q rows.
      const int q_parts = min(NC, (p.lq - q0 + 63) / 64);
      mbar_expect_tx(&sm.q_full, q_parts * Q_PART_BYTES);
      for (int c = 0; c < q_parts; ++c) tma_load(sm.q[c], qm, &sm.q_full, 0, h, q0 + 64 * c, b);
      int stage = 0, parity = 0;
      for (int i = 0; i < n_tiles; ++i) {
        const int k0 = (n_tiles - 1 - i) * FWD_BN;
        mbar_wait(&sm.k_empty[stage], parity ^ 1);
        mbar_expect_tx(&sm.k_full[stage], KV_BYTES);
        tma_load(sm.k[stage], km, &sm.k_full[stage], 0, h, k0, b);
        mbar_wait(&sm.v_empty[stage], parity ^ 1);
        mbar_expect_tx(&sm.v_full[stage], KV_BYTES);
        tma_load(sm.v[stage], vm, &sm.v_full[stage], 0, h, k0, b);
        if (++stage == FWD_STAGES) {
          stage = 0;
          parity ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int row0 = q0 + 64 * c + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
    const int col = (lane % 4) * 2;
    const size_t acc_head = size_t(bh) * p.lq * HD;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float o[8][4];
    zero(o);
    if (CARRY && p.acc_in != nullptr) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        if (row >= p.lq) continue;
        m[i] = p.m_in[size_t(bh) * p.lq + row];
        if (lane % 4 == 0) l[i] = p.l_in[size_t(bh) * p.lq + row];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 x = *reinterpret_cast<const float2*>(p.acc_in + acc_head +
                                                            size_t(row) * HD + nt * 8 + col);
          o[nt][2 * i] = x.x;
          o[nt][2 * i + 1] = x.y;
        }
      }
    }
    if (n_tiles > 0) consume_key_tiles(sm, c, q0, n_tiles, p, m, l, o);
    quad_sum(l);

    if (CARRY) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        if (lane % 4 == 0 && row < p.lq) {
          p.m_out[size_t(bh) * p.lq + row] = m[i];
          p.l_out[size_t(bh) * p.lq + row] = l[i];
        }
      }
      store_rows(p.acc_out + acc_head, o, q0 + 64 * c + warp * 16, p.lq, HD, 1.f, lane);
    } else {
      const int stride = p.h * HD;
      bf16* ob = p.out + (size_t(b) * p.lq * p.h + h) * HD;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float safe = fmaxf(l[i], 1e-30f);
        const int row = row0 + 8 * i;
        if (lane % 4 == 0 && row < p.lq) p.lse[size_t(bh) * p.lq + row] = m[i] + logf(safe);
        if (row >= p.lq) continue;
        const float inv = 1.f / safe;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          *reinterpret_cast<__nv_bfloat162*>(ob + size_t(row) * stride + nt * 8 + col) =
              __floats2bfloat162_rn(o[nt][2 * i] * inv, o[nt][2 * i + 1] * inv);
      }
    }
  }
}

__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                 const __grid_constant__ CUtensorMap vm, const FwdParams p) {
  forward_walk<false>(&qm, &km, &vm, p);
}

// -------------------------------------------------------------------- carry

// Ring attention's local step: the forward's walk, with the online-softmax
// state (acc, m, l) read from the carry (fresh when acc_in is null) and
// written back unnormalized, so the next ring step (or finalize) continues
// it. acc is f32 [B, H, Lq, 64], m and l f32 [B * H, Lq], the JAX carry
// layout. The carry is not updated in place: the wrapper allocates the
// outputs, and the carry given stays as it was.
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_fwd_carry_kernel(const __grid_constant__ CUtensorMap qm,
                       const __grid_constant__ CUtensorMap km,
                       const __grid_constant__ CUtensorMap vm, const FwdParams p) {
  forward_walk<true>(&qm, &km, &vm, p);
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


// What every entry point takes: head width 64 (the only one instantiated),
// non-empty sequences, and a grid that fits (b*h on the grid's y axis).
bool args_ok(int b, int h, int lq, int lk, int d) {
  return d == HD && b > 0 && h > 0 && lq > 0 && lk > 0 && b * h <= 65535;
}

// A tensor map over a bf16 [b, l, h, 64] tensor read in place (dimensions
// innermost first: 64, h, l, b) whose box is `rows` rows of one (batch,
// head), 128-byte swizzled; rows past l read as zeros.
bool head_map(CUtensorMap* map, const void* base, int b, int l, int h, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row_bytes = HD * sizeof(bf16);
  const cuuint64_t dims[4] = {cuuint64_t(HD), cuuint64_t(h), cuuint64_t(l), cuuint64_t(b)};
  const cuuint64_t strides[3] = {row_bytes, row_bytes * h, row_bytes * h * l};
  const cuuint32_t box[4] = {cuuint32_t(HD), 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Both forward kernels: tensor maps of q (64-row boxes, one per consumer)
// and k, v (FWD_BN-row boxes), then one block per 128 query rows.
template <typename Kernel>
int launch_fwd(Kernel kernel, const void* q, const void* k, const void* v, const FwdParams& p,
               int b, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!head_map(&qm, q, b, p.lq, p.h, 64) || !head_map(&km, k, b, p.lk, p.h, FWD_BN) ||
      !head_map(&vm, v, b, p.lk, p.h, FWD_BN))
    return int(cudaErrorInvalidValue);
  const cudaError_t err = set_smem(kernel, FWD_SMEM);
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3((p.lq + FWD_BM - 1) / FWD_BM, b * p.h), FWD_THREADS, FWD_SMEM, stream>>>(qm, km,
                                                                                       vm, p);
  return int(cudaGetLastError());
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
// success; cudaErrorInvalidValue for arguments args_ok refuses, or when a
// tensor map cannot be encoded). q, dout: bf16 [b, lq, h, d]; k, v: bf16
// [b, lk, h, d]; lse, dd: f32 [b*h, lq]; all contiguous and 16-byte
// aligned. out is bf16 like q; dq/dk/dv are bf16, or f32 with out_f32.

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                         int b, int h, int lq, int lk, int d, int causal, int q_off, int k_off,
                         void* stream) {
  if (!args_ok(b, h, lq, lk, d)) return int(cudaErrorInvalidValue);
  FwdParams p{};
  p.h = h;
  p.lq = lq;
  p.lk = lk;
  p.causal = causal;
  p.q_off = q_off;
  p.k_off = k_off;
  p.out = static_cast<bf16*>(out);
  p.lse = lse;
  return launch_fwd(flash_fwd_kernel, q, k, v, p, b, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory a forward block asks for (both forward kernels).
extern "C" int flash_fwd_smem_bytes() { return int(FWD_SMEM); }

// acc_in, m_in and l_in are all null (no carry: the walk starts fresh) or
// all set; acc f32 [b, h, lq, d], m and l f32 [b*h, lq].
extern "C" int flash_fwd_carry(const void* q, const void* k, const void* v, const float* acc_in,
                               const float* m_in, const float* l_in, float* acc_out,
                               float* m_out, float* l_out, int b, int h, int lq, int lk, int d,
                               int causal, int q_off, int k_off, void* stream) {
  if (!args_ok(b, h, lq, lk, d) || (acc_in == nullptr) != (m_in == nullptr) ||
      (acc_in == nullptr) != (l_in == nullptr))
    return int(cudaErrorInvalidValue);
  FwdParams p{};
  p.h = h;
  p.lq = lq;
  p.lk = lk;
  p.causal = causal;
  p.q_off = q_off;
  p.k_off = k_off;
  p.acc_in = acc_in;
  p.m_in = m_in;
  p.l_in = l_in;
  p.acc_out = acc_out;
  p.m_out = m_out;
  p.l_out = l_out;
  return launch_fwd(flash_fwd_carry_kernel, q, k, v, p, b, static_cast<cudaStream_t>(stream));
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
