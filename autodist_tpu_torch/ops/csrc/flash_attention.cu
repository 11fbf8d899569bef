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
// What bounds the backward pair: the same two units. dK/dV does four
// products over the causal half of the scores (S^T, dP^T, dV, dK: 1.112 ms
// at the shape above) and dQ three (S, dP, dQ: 0.834 ms); each recomputes
// p, one exp a score (0.55 ms), and ds = p (dP - D), and rounds p and ds to
// bf16 as product operands. On an H100 neither unit alone holds them:
// builds with the score products cut to a quarter, or without the exp,
// ran only a little faster. What holds them is each consumer's chain from
// its scores through p, ds and the bf16 packs to its accumulating
// products, which the two (dK/dV) or three (dQ) consumers that fit in the
// register file hide only in part.
//
// Backward design (flash_bwd_dq_kernel, flash_bwd_dkdv_kernel), the
// forward's means with the roles mirrored:
// - Warp specialisation and TMA as in the forward: warpgroup 0 produces
//   (setmaxnreg hands its registers to the consumers), each consumer
//   warpgroup owns 64 rows of the block's side and walks 64-row tiles of
//   the other side through a ring of BWD_STAGES stages (full and empty
//   mbarriers). q, k, v and dO are read in place through 4-D tensor maps
//   with 64-row boxes; rows past the sequence end arrive zero-filled.
// - dQ: a block owns 192 query rows (three consumers; their Q and dO rows
//   are loaded once, their lse and D read once into registers) and streams
//   the K and V tiles they see, from the diagonal down. S = Q K^T and
//   dP = dO V^T are m64n64k16 with both operands in shared memory
//   (K-major); dQ += dS K takes dS from registers (re-packed as bf16 in
//   place, as the forward's P) and the K tile as an MN-major operand. V's
//   stage is released when dP lands, K's when dS K has run. Two consumers
//   with Q and dO as register operands ran slower; three have no room for
//   them.
// - dK/dV: a block owns 128 keys (two consumers; K and V loaded once and
//   read into registers as A fragments) and streams the Q, dO, lse and D
//   tiles of the queries that see them, from the diagonal to the end. The
//   consumers compute the transposed scores S^T = K Q^T and dP^T = V dO^T
//   (A from registers, which halves their shared-memory reads), so that
//   P^T and dS^T sit in the accumulator layout of a register A operand for
//   dV += P^T dO and dK += dS^T Q, dO and Q MN-major from the stage. lse
//   and D are f32 [B*H, Lq] rows whose length in bytes need not be a
//   multiple of 16, so no TMA map takes them: the producer's first warp
//   copies each tile's 64 values with cp.async and counts them on the
//   stage's full barrier (cp.async.mbarrier.arrive.noinc). A thread reads
//   the lse and D of its accumulator columns from the stage. dK and dV (32
//   f32 registers a thread each) stay in registers for the whole walk.
// - Ping-pong and pipelining as in the forward: the consumers take turns
//   (named barriers) to issue three commit groups, the next tile's scores,
//   its dP and the last tile's accumulating product(s); p is computed as
//   soon as the scores land and ds as soon as dP does, beside that
//   warpgroup's accumulating products and the other consumers' products.
//   Every mbarrier wait comes before a turn's wgmma_fence, and no wgmma
//   register is written under a branch, so ptxas serializes no wgmma.
// - Grid: the block along the sequence is x, (batch, head) y. Blocks start
//   in order of their linear index, so the blocks running at once share
//   one or two heads, whose tiles stay in L2; with (batch, head) as x, the
//   longest walks of every head first, both kernels ran slower.
// - p = exp2(s * scale * log2(e) - lse * log2(e)), one FFMA before ex2.
//   Only the tiles that cross the diagonal or a sequence end are masked,
//   by a select after the exponential (p = 0 exactly, whatever lse is: a
//   row that sees no key has lse near NEG_INF). Pad query rows in dK/dV
//   lie only in masked tiles; pad keys in dK/dV and pad rows in dQ are
//   computed and never stored. A dQ block whose rows see no key, and a
//   dK/dV block whose keys no query sees, run no tile and write zeros.
// - No atomics: every output row is written by the one block that owns it,
//   so the bits are the same from run to run.
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
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// An f32 accumulator tile [64 x 16 KC] (2 KC n-tiles of 8 columns) -> the
// bf16 A fragments of the product that contracts over its columns
// (wgmma's accumulator layout per warp is the mma.sync C layout, its
// register A operand the mma.sync A layout).
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

// ----------------------------------------------------------------- backward

// Every backward tile holds 64 rows of one head (one 8 KB TMA box): a
// consumer's own rows and each streamed tile of keys (dQ) or queries (dK/dV).
constexpr int BT = 64;
constexpr unsigned TILE_BYTES = BT * HD * 2;
constexpr int BWD_STAGES = 4;  // ring depth of the streamed tiles

// dQ: three consumers (as the forward) of 64 query rows; S, dP and dQ are
// 32 f32 registers a thread each, beside dS of the last tile, in 160.
constexpr int DQ_NC = 3;
constexpr int DQ_BM = BT * DQ_NC;
constexpr int DQ_THREADS = 128 * (1 + DQ_NC);
constexpr int DQ_PRODUCER_REGS = 32;
constexpr int DQ_CONSUMER_REGS = 160;
static_assert(128 * DQ_PRODUCER_REGS + 128 * DQ_NC * DQ_CONSUMER_REGS <= 65536, "register file");

// dK/dV: two consumers of 64 keys; S^T, dP^T, dK and dV are 32 f32
// registers a thread each, beside P^T and dS^T of the last tile and the
// consumer's K and V rows as A fragments, in 232.
constexpr int DKDV_NC = 2;
constexpr int DKDV_BK = BT * DKDV_NC;
constexpr int DKDV_THREADS = 128 * (1 + DKDV_NC);
constexpr int DKDV_PRODUCER_REGS = 40;
constexpr int DKDV_CONSUMER_REGS = 232;
static_assert(128 * DKDV_PRODUCER_REGS + 128 * DKDV_NC * DKDV_CONSUMER_REGS <= 65536,
              "register file");

struct DqSmem {
  alignas(1024) bf16 q[DQ_NC][BT * HD];
  alignas(1024) bf16 dout[DQ_NC][BT * HD];
  alignas(1024) bf16 k[BWD_STAGES][BT * HD];
  alignas(1024) bf16 v[BWD_STAGES][BT * HD];
  uint64_t q_full;
  uint64_t k_full[BWD_STAGES], v_full[BWD_STAGES];
  uint64_t k_empty[BWD_STAGES], v_empty[BWD_STAGES];
};
constexpr size_t DQ_SMEM = sizeof(DqSmem) + 1024;  // + room to align the base

struct DkdvSmem {
  alignas(1024) bf16 k[DKDV_NC][BT * HD];
  alignas(1024) bf16 v[DKDV_NC][BT * HD];
  alignas(1024) bf16 q[BWD_STAGES][BT * HD];
  alignas(1024) bf16 dout[BWD_STAGES][BT * HD];
  float lse[BWD_STAGES][BT];
  float dd[BWD_STAGES][BT];
  uint64_t kv_full;
  uint64_t full[BWD_STAGES], empty[BWD_STAGES];
};
constexpr size_t DKDV_SMEM = sizeof(DkdvSmem) + 1024;
// A dK/dV stage fills when the TMA thread's expect_tx and the 32 lanes'
// cp.async arrivals (lse and D) are all in.
constexpr unsigned DKDV_FULL_ARRIVALS = 1 + 32;

// What both backward kernels take besides the tensor maps of q, k, v and dO.
struct BwdParams {
  int h, lq, lk, causal, q_off, k_off;
  const float* lse;
  const float* dd;
  void* out0;  // dq, or dk
  void* out1;  // dv
};

template <typename T>
__device__ __forceinline__ T& align1024(unsigned char* raw) {
  return *reinterpret_cast<T*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// A 4-byte global -> shared copy; `bytes` 0 reads nothing and writes 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
// One arrival on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// A consumer's own 64 rows, a 128-byte-swizzled [64][64] tile (TMA's
// layout: the 16-byte chunk c of row r sits at chunk c ^ (r % 8)), as the
// bf16 A fragments of a product over the head width: warp w holds rows
// 16 w .. 16 w + 15 in the mma.sync A layout. Read once a block.
__device__ __forceinline__ void load_a(unsigned (&a)[HD / 16][4], const bf16* tile) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const unsigned char* base = reinterpret_cast<const unsigned char*>(tile);
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = warp * 16 + lane / 4 + 8 * (j & 1);
      const int col = kc * 16 + (lane % 4) * 2 + 8 * (j >> 1);
      a[kc][j] = *reinterpret_cast<const unsigned*>(
          base + row * 128 + ((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) * 2)));
    }
}

// s = A X^T over the head width (4 k steps): A a consumer's own 64 rows
// as register fragments, X a streamed tile, K-major in shared memory. A
// from registers halves the shared-memory reads of an m64n64k16, which
// with both operands in shared memory needs all of the SM's 128 bytes a
// clock at the tensor cores' rate.
__device__ __forceinline__ void issue_score(float (&s)[8][4], const unsigned (&a)[HD / 16][4],
                                            const bf16* x) {
  const uint64_t dx = sw128_desc(x);
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) wgmma_m64n64k16_rs<0>(s, a[kc], dx + 2 * kc, kc);
}
// The same with A in shared memory too (descriptor da): dQ's three
// consumers have no room for A fragments at 160 registers.
__device__ __forceinline__ void issue_score(float (&s)[8][4], uint64_t da, const bf16* x) {
  const uint64_t dx = sw128_desc(x);
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) wgmma_m64n64k16_ss<0>(s, da + 2 * kc, dx + 2 * kc, kc);
}
// acc += A T over a streamed tile T (its 64 rows the contraction: 4 k
// steps of 2048 bytes, T MN-major), A as bf16 register fragments.
__device__ __forceinline__ void issue_acc(float (&acc)[8][4], const unsigned (&a)[BT / 16][4],
                                          const bf16* t) {
  const uint64_t dt = sw128_desc(t);
#pragma unroll
  for (int kc = 0; kc < BT / 16; ++kc) wgmma_m64n64k16_rs(acc, a[kc], dt + 128 * kc);
}

// dQ's p on one key tile: s (raw scores, this thread's rows row0 and
// row0 + 8, keys k0 + 8 nt + col (+1)) becomes p = exp2(s scale log2e -
// lse2), set to 0 past the sequence end and the diagonal if asked; lse2 =
// lse log2e of the thread's two rows.
__device__ __forceinline__ void dq_p(float (&s)[8][4], const float (&lse2)[2], bool need_mask,
                                     int row0, int k0, int col, const BwdParams& p) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = ex2(fmaf(s[nt][e], SCALE * LOG2E, -lse2[e >> 1]));
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
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (nt * 8 + (e & 1) >= limit[e >> 1]) s[nt][e] = 0.f;
  }
}

// dK/dV's p^T on one query tile: s (raw transposed scores, this thread's
// keys key0 and key0 + 8, queries qt0 + 8 nt + col (+1)) becomes p^T, with
// the tile's lse from the stage, two columns a load.
__device__ __forceinline__ void dkdv_p(float (&s)[8][4], const float* lse, bool need_mask,
                                       int key0, int qt0, int col, const BwdParams& p) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float2 l = *reinterpret_cast<const float2*>(lse + nt * 8 + col);
    const float l2[2] = {l.x * LOG2E, l.y * LOG2E};
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = ex2(fmaf(s[nt][e], SCALE * LOG2E, -l2[e & 1]));
  }
  if (need_mask) {
    // Query column c of the tile is visible to a key iff lo <= c < hi: the
    // sequence end, and with causal masking q_off + q >= k_off + key.
    const int hi = p.lq - qt0 - col;
    int lo[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lo[i] = p.causal ? p.k_off - p.q_off + key0 + 8 * i - qt0 - col : -BT;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + (e & 1);
        if (c < lo[e >> 1] || c >= hi) s[nt][e] = 0.f;
      }
  }
}

// Named barriers 1 .. NC order a kernel's consumers round robin, as in the
// forward: consumer c waits on 1 + c and then releases 1 + (c + 1) % NC.
// Each round issues, in the consumer's turn, three commit groups: the next
// tile's scores, its dP, and the last tile's accumulating product(s). p is
// computed as soon as the scores land, ds as soon as dP does, beside the
// accumulating products and the other consumers' products.

// One dQ consumer (rows qc .. qc + 63) over the block's n_tiles key tiles,
// from the last down. V's stage is released when dP lands, K's when dS K
// has run.
__device__ __forceinline__ void dq_consume(DqSmem& sm, int c, int qc, int n_tiles,
                                           const BwdParams& p, const float (&lse2)[2],
                                           const float (&dd)[2], float (&dq)[8][4]) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int row0 = qc + warp * 16 + lane / 4;
  const int col = (lane % 4) * 2;
  const int my_turn = 1 + c, their_turn = 1 + (c + 1) % DQ_NC;
  float s[8][4], dp[8][4];
  unsigned ds[BT / 16][4];  // dS of the last tile, bf16 A fragments
  const uint64_t d_q = sw128_desc(sm.q[c]), d_do = sw128_desc(sm.dout[c]);
  auto probs = [&](int i) {
    const int k0 = (n_tiles - 1 - i) * BT;
    const bool need_mask = k0 + BT > p.lk || (p.causal && p.k_off + k0 + BT - 1 > p.q_off + qc);
    dq_p(s, lse2, need_mask, row0, k0, col, p);
  };
  auto grads = [&]() {  // s = ds = p (dP - D)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= dp[nt][e] - dd[e >> 1];
  };
  mbar_wait(&sm.q_full, 0);
  if (c == DQ_NC - 1) named_arrive(1);  // consumer 0 goes first

  mbar_wait(&sm.k_full[0], 0);
  mbar_wait(&sm.v_full[0], 0);
  named_sync(my_turn);
  wgmma_fence();
  issue_score(s, d_q, sm.k[0]);
  wgmma_commit();
  issue_score(dp, d_do, sm.v[0]);
  wgmma_commit();
  named_arrive(their_turn);
  wgmma_wait<1>();  // S
  fence_regs(s);
  probs(0);
  wgmma_wait<0>();  // dP
  fence_regs(dp);
  if (lane == 0) mbar_arrive(&sm.v_empty[0]);
  grads();
  to_a(ds, s);

  int stage = 0, parity = 0;  // the last tile's
  for (int i = 1; i < n_tiles; ++i) {
    const int next = stage + 1 == BWD_STAGES ? 0 : stage + 1;
    const int next_parity = next == 0 ? parity ^ 1 : parity;
    mbar_wait(&sm.k_full[next], next_parity);
    mbar_wait(&sm.v_full[next], next_parity);
    named_sync(my_turn);
    fence_regs(dq);
    wgmma_fence();
    issue_score(s, d_q, sm.k[next]);
    wgmma_commit();
    issue_score(dp, d_do, sm.v[next]);
    wgmma_commit();
    issue_acc(dq, ds, sm.k[stage]);
    wgmma_commit();
    named_arrive(their_turn);
    wgmma_wait<2>();  // S
    fence_regs(s);
    probs(i);
    wgmma_wait<1>();  // dP
    fence_regs(dp);
    if (lane == 0) mbar_arrive(&sm.v_empty[next]);
    grads();
    wgmma_wait<0>();  // dS K
    fence_regs(dq);
    fence_regs(ds);
    if (lane == 0) mbar_arrive(&sm.k_empty[stage]);
    to_a(ds, s);
    stage = next;
    parity = next_parity;
  }

  named_sync(my_turn);
  fence_regs(dq);
  wgmma_fence();
  issue_acc(dq, ds, sm.k[stage]);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dq);
  fence_regs(ds);
  // The last consumer's last round has no round of consumer 0's left to release.
  if (c != DQ_NC - 1) named_arrive(their_turn);
  if (lane == 0) mbar_arrive(&sm.k_empty[stage]);
}

// One block per DQ_BM query rows of one (batch, head), each head's longest
// causal rows first; the key tiles they see are walked from the diagonal
// down.
template <typename OutT>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                    const __grid_constant__ CUtensorMap vm,
                    const __grid_constant__ CUtensorMap dom, const BwdParams p) {
  extern __shared__ unsigned char dq_smem[];
  DqSmem& sm = align1024<DqSmem>(dq_smem);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * DQ_BM;
  const int bh = blockIdx.y, b = bh / p.h, h = bh % p.h;
  const int k_end = p.causal ? min(p.lk, p.q_off - p.k_off + min(q0 + DQ_BM, p.lq)) : p.lk;
  const int n_tiles = k_end > 0 ? (k_end + BT - 1) / BT : 0;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], 4 * DQ_NC);
      mbar_init(&sm.v_empty[s], 4 * DQ_NC);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread issues every copy, in the consumers' order.
    setmaxnreg_dec<DQ_PRODUCER_REGS>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      // Only consumers with a row inside the sequence get their Q and dO rows.
      const int parts = min(DQ_NC, (p.lq - q0 + BT - 1) / BT);
      mbar_expect_tx(&sm.q_full, 2 * parts * TILE_BYTES);
      for (int c = 0; c < parts; ++c) {
        tma_load(sm.q[c], &qm, &sm.q_full, 0, h, q0 + BT * c, b);
        tma_load(sm.dout[c], &dom, &sm.q_full, 0, h, q0 + BT * c, b);
      }
      int stage = 0, parity = 0;
      for (int i = 0; i < n_tiles; ++i) {
        const int k0 = (n_tiles - 1 - i) * BT;
        mbar_wait(&sm.k_empty[stage], parity ^ 1);
        mbar_expect_tx(&sm.k_full[stage], TILE_BYTES);
        tma_load(sm.k[stage], &km, &sm.k_full[stage], 0, h, k0, b);
        mbar_wait(&sm.v_empty[stage], parity ^ 1);
        mbar_expect_tx(&sm.v_full[stage], TILE_BYTES);
        tma_load(sm.v[stage], &vm, &sm.v_full[stage], 0, h, k0, b);
        if (++stage == BWD_STAGES) {
          stage = 0;
          parity ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<DQ_CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int qc = q0 + BT * c;
    const int row0 = qc + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
    float lse2[2], dd[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      lse2[i] = row < p.lq ? p.lse[size_t(bh) * p.lq + row] * LOG2E : 0.f;
      dd[i] = row < p.lq ? p.dd[size_t(bh) * p.lq + row] : 0.f;
    }
    float dq[8][4];
    zero(dq);
    if (n_tiles > 0) dq_consume(sm, c, qc, n_tiles, p, lse2, dd, dq);
    store_rows(static_cast<OutT*>(p.out0) + (size_t(b) * p.lq * p.h + h) * HD, dq,
               qc + warp * 16, p.lq, p.h * HD, SCALE, lane);
  }
}

// One dK/dV consumer (keys kc .. kc + 63) over the block's n_tiles query
// tiles, from tile t0 (the diagonal) to the end. A stage (Q, dO, lse, D) is
// released when dV += P^T dO and dK += dS^T Q have run on it.
__device__ __forceinline__ void dkdv_consume(DkdvSmem& sm, int c, int kc, int t0, int n_tiles,
                                             const BwdParams& p, float (&dk)[8][4],
                                             float (&dv)[8][4]) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int key0 = kc + warp * 16 + lane / 4;
  const int col = (lane % 4) * 2;
  const int my_turn = 1 + c, their_turn = 1 + (c + 1) % DKDV_NC;
  float s[8][4], dp[8][4];
  unsigned d_k[HD / 16][4], d_v[HD / 16][4];  // this consumer's K and V rows
  unsigned pa[BT / 16][4], dsa[BT / 16][4];  // P^T and dS^T of the last tile, bf16 A fragments
  auto probs = [&](int i, int stage) {
    const int qt0 = (t0 + i) * BT;
    const bool need_mask = qt0 + BT > p.lq || (p.causal && p.k_off + kc + BT - 1 > p.q_off + qt0);
    dkdv_p(s, sm.lse[stage], need_mask, key0, qt0, col, p);
  };
  auto grads = [&](int stage) {  // dp = ds^T = p^T (dP^T - D)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 d = *reinterpret_cast<const float2*>(sm.dd[stage] + nt * 8 + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = s[nt][e] * (dp[nt][e] - ((e & 1) ? d.y : d.x));
    }
  };
  mbar_wait(&sm.kv_full, 0);
  load_a(d_k, sm.k[c]);
  load_a(d_v, sm.v[c]);
  if (c == DKDV_NC - 1) named_arrive(1);  // consumer 0 goes first

  mbar_wait(&sm.full[0], 0);
  named_sync(my_turn);
  wgmma_fence();
  issue_score(s, d_k, sm.q[0]);
  wgmma_commit();
  issue_score(dp, d_v, sm.dout[0]);
  wgmma_commit();
  named_arrive(their_turn);
  wgmma_wait<1>();  // S^T
  fence_regs(s);
  probs(0, 0);
  wgmma_wait<0>();  // dP^T
  fence_regs(dp);
  grads(0);
  to_a(pa, s);
  to_a(dsa, dp);

  int stage = 0, parity = 0;  // the last tile's
  for (int i = 1; i < n_tiles; ++i) {
    const int next = stage + 1 == BWD_STAGES ? 0 : stage + 1;
    const int next_parity = next == 0 ? parity ^ 1 : parity;
    mbar_wait(&sm.full[next], next_parity);
    named_sync(my_turn);
    fence_regs(dk);
    fence_regs(dv);
    wgmma_fence();
    issue_score(s, d_k, sm.q[next]);
    wgmma_commit();
    issue_score(dp, d_v, sm.dout[next]);
    wgmma_commit();
    issue_acc(dv, pa, sm.dout[stage]);
    issue_acc(dk, dsa, sm.q[stage]);
    wgmma_commit();
    named_arrive(their_turn);
    wgmma_wait<2>();  // S^T
    fence_regs(s);
    probs(i, next);
    wgmma_wait<1>();  // dP^T
    fence_regs(dp);
    grads(next);
    wgmma_wait<0>();  // dV and dK
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pa);
    fence_regs(dsa);
    if (lane == 0) mbar_arrive(&sm.empty[stage]);
    to_a(pa, s);
    to_a(dsa, dp);
    stage = next;
    parity = next_parity;
  }

  named_sync(my_turn);
  fence_regs(dk);
  fence_regs(dv);
  wgmma_fence();
  issue_acc(dv, pa, sm.dout[stage]);
  issue_acc(dk, dsa, sm.q[stage]);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dk);
  fence_regs(dv);
  fence_regs(pa);
  fence_regs(dsa);
  if (c != DKDV_NC - 1) named_arrive(their_turn);
  if (lane == 0) mbar_arrive(&sm.empty[stage]);
}

// One block per DKDV_BK keys of one (batch, head), the query tiles that see
// them walked from the diagonal to the end; in causal attention the first
// keys see the most queries, so each head's longest walks start first.
template <typename OutT>
__global__ void __launch_bounds__(DKDV_THREADS, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qm,
                      const __grid_constant__ CUtensorMap km,
                      const __grid_constant__ CUtensorMap vm,
                      const __grid_constant__ CUtensorMap dom, const BwdParams p) {
  extern __shared__ unsigned char dkdv_smem[];
  DkdvSmem& sm = align1024<DkdvSmem>(dkdv_smem);
  const int k0 = blockIdx.x * DKDV_BK;
  const int bh = blockIdx.y, b = bh / p.h, h = bh % p.h;
  // The first query that sees key k0; tiles before its own see none of this block's keys.
  const int t0 = p.causal ? max(0, p.k_off - p.q_off + k0) / BT : 0;
  const int n_tiles = max(0, (p.lq + BT - 1) / BT - t0);

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(&sm.full[s], DKDV_FULL_ARRIVALS);
      mbar_init(&sm.empty[s], 4 * DKDV_NC);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: warp 0. Its lane 0 issues the TMA copies; all 32 lanes
    // copy the tile's lse and D (rows past lq read as 0).
    setmaxnreg_dec<DKDV_PRODUCER_REGS>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < 32 && n_tiles > 0) {
      if (lane == 0) {
        const int parts = min(DKDV_NC, (p.lk - k0 + BT - 1) / BT);
        mbar_expect_tx(&sm.kv_full, 2 * parts * TILE_BYTES);
        for (int c = 0; c < parts; ++c) {
          tma_load(sm.k[c], &km, &sm.kv_full, 0, h, k0 + BT * c, b);
          tma_load(sm.v[c], &vm, &sm.kv_full, 0, h, k0 + BT * c, b);
        }
      }
      const float* lrow = p.lse + size_t(bh) * p.lq;
      const float* drow = p.dd + size_t(bh) * p.lq;
      int stage = 0, parity = 0;
      for (int i = 0; i < n_tiles; ++i) {
        const int qt0 = (t0 + i) * BT;
        mbar_wait(&sm.empty[stage], parity ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&sm.full[stage], 2 * TILE_BYTES);
          tma_load(sm.q[stage], &qm, &sm.full[stage], 0, h, qt0, b);
          tma_load(sm.dout[stage], &dom, &sm.full[stage], 0, h, qt0, b);
        }
#pragma unroll
        for (int j = 0; j < BT / 32; ++j) {
          const int r = qt0 + lane + 32 * j;
          const bool ok = r < p.lq;
          cp_async4(&sm.lse[stage][lane + 32 * j], ok ? lrow + r : lrow, ok ? 4 : 0);
          cp_async4(&sm.dd[stage][lane + 32 * j], ok ? drow + r : drow, ok ? 4 : 0);
        }
        cp_async_arrive(&sm.full[stage]);
        if (++stage == BWD_STAGES) {
          stage = 0;
          parity ^= 1;
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");  // no copy outlives its thread
    }
  } else {
    setmaxnreg_inc<DKDV_CONSUMER_REGS>();
    const int c = wg - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int kc = k0 + BT * c;
    float dk[8][4], dv[8][4];
    zero(dk);
    zero(dv);
    if (n_tiles > 0) dkdv_consume(sm, c, kc, t0, n_tiles, p, dk, dv);
    const size_t head = (size_t(b) * p.lk * p.h + h) * HD;
    store_rows(static_cast<OutT*>(p.out0) + head, dk, kc + warp * 16, p.lk, p.h * HD, SCALE, lane);
    store_rows(static_cast<OutT*>(p.out1) + head, dv, kc + warp * 16, p.lk, p.h * HD, 1.f, lane);
  }
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

// Both backward kernels: tensor maps of q, k, v and dO (BT-row boxes),
// then one block per DQ_BM query rows or DKDV_BK keys.
template <typename OutT>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* dd, void* dk, void* dv, void* dq, int b, int h, int lq, int lk,
               int causal, int q_off, int k_off, cudaStream_t stream) {
  CUtensorMap qm, km, vm, dom;
  if (!head_map(&qm, q, b, lq, h, BT) || !head_map(&km, k, b, lk, h, BT) ||
      !head_map(&vm, v, b, lk, h, BT) || !head_map(&dom, dout, b, lq, h, BT))
    return int(cudaErrorInvalidValue);
  BwdParams p{h, lq, lk, causal, q_off, k_off, lse, dd, dk != nullptr ? dk : dq, dv};
  if (dk != nullptr) {
    auto kernel = flash_bwd_dkdv_kernel<OutT>;
    const cudaError_t err = set_smem(kernel, DKDV_SMEM);
    if (err != cudaSuccess) return int(err);
    kernel<<<dim3((lk + DKDV_BK - 1) / DKDV_BK, b * h), DKDV_THREADS, DKDV_SMEM, stream>>>(
        qm, km, vm, dom, p);
  } else {
    auto kernel = flash_bwd_dq_kernel<OutT>;
    const cudaError_t err = set_smem(kernel, DQ_SMEM);
    if (err != cudaSuccess) return int(err);
    kernel<<<dim3((lq + DQ_BM - 1) / DQ_BM, b * h), DQ_THREADS, DQ_SMEM, stream>>>(qm, km, vm,
                                                                                  dom, p);
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
  return out_f32 ? launch_bwd<float>(q, k, v, dout, lse, dd, dk, dv, nullptr, b, h, lq, lk,
                                     causal, q_off, k_off, s)
                 : launch_bwd<bf16>(q, k, v, dout, lse, dd, dk, dv, nullptr, b, h, lq, lk,
                                    causal, q_off, k_off, s);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* dd, void* dq, int b, int h, int lq,
                            int lk, int d, int causal, int q_off, int k_off, int out_f32,
                            void* stream) {
  if (!args_ok(b, h, lq, lk, d)) return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch_bwd<float>(q, k, v, dout, lse, dd, nullptr, nullptr, dq, b, h, lq,
                                     lk, causal, q_off, k_off, s)
                 : launch_bwd<bf16>(q, k, v, dout, lse, dd, nullptr, nullptr, dq, b, h, lq,
                                    lk, causal, q_off, k_off, s);
}
