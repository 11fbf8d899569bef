// Flash attention kernels for Hopper (sm_90a): the causal forward, its
// carry form (ring attention's local step) and the backward, over q/k/v
// read in place as [B, L, H, hd] bf16, hd 64 or 128 (the forward kernels
// templates on the head width, both widths instantiated; the backward a
// pair at 64 and one kernel at 128).
//
// Replaces the Pallas TPU kernels of autodist_tpu/ops/flash_attention.py:
//   flash_fwd_kernel       <- _flash_kernel           (flash_attention.py:77, pallas_call :144)
//   flash_bwd_dkdv_kernel  <- _flash_bwd_dkdv_kernel  (flash_attention.py:199, pallas_call :332)
//   flash_bwd_dq_kernel    <- _flash_bwd_dq_kernel    (flash_attention.py:241, pallas_call :355)
//   flash_bwd_kernel       <- both backward kernels at head width 128
//   flash_fwd_carry_kernel <- _flash_carry_kernel     (flash_attention.py:387, pallas_call :480)
// and, beside them, flash_bwd_dd_kernel (the backward's row term D, XLA in
// the JAX package) and flash_bwd_dq_convert_kernel (flash_bwd_kernel's dQ
// sums to dq).
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
// Head width 128 (d_model 1,024 over 8 heads, the width of most public
// LMs). The products double in depth (S, dP) or in width (P V, dS K, dV,
// dK) and every head-wide accumulator doubles in registers, so the
// forward's tiling is re-derived per width (FwdCfg) and its walk stays the
// same; the backward is one kernel of its own (flash_bwd_kernel, below):
// - A 256-byte row is two 128-byte swizzle atoms: a tile is stored as two
//   [rows][64] column blocks, each one TMA box of the same tensor map (64
//   columns wide, loaded at column 0 and 64). A K-major operand steps into
//   the second block after four k steps (kmajor); an MN-major operand of N
//   = 128 is one m64n128k16 wgmma whose two MN atoms lie rows * 128 bytes
//   apart (the descriptor's LBO, mn_desc).
// - Forward and carry: O is 64 f32 registers a thread beside S (64) and P
//   (32), and three consumers' Q (48 KB) beside a 3-stage ring of 32 KB K
//   and V tiles is over the 227 KB a block may take: two consumers (128
//   query rows a block) at 232 registers over a 2-stage ring (160 KB).
// - The backward: a pair at this width (dK/dV with K and V in shared
//   memory, each consumer finishing its tile before its next scores; dQ at
//   two consumers) ran 7 products where one walk runs 5, and lost to the
//   library's backward; flash_bwd_kernel replaced it.
// - 1/sqrt(128) is not a power of two: the scale still folds into the one
//   FFMA before ex2, and the running max takes a fully masked tile row as
//   NEG_INF itself.
//
// Arithmetic follows the Pallas kernels: scale = 1/sqrt(hd) in f32 on the
// f32 product; masked scores are NEG_INF and p = 0 at or below NEG_INF/2;
// out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)); p and ds are
// rounded to bf16 only as product operands. q/k/v/dO are read in their
// [B, L, H, hd] layout; lse and D are plain f32 [B*H, Lq].

#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Head widths the kernels are instantiated for: 64 (the flagship's d_model
// 512 over 8 heads) and 128 (d_model 1,024 over 8, most public LMs').
template <int HD>
constexpr bool kWidth = HD == 64 || HD == 128;
// 1/sqrt(HD) in f32: a power of two at 64, not at 128.
template <int HD>
constexpr float kScale = HD == 64 ? 0.125f : 0.08838834764831845f;

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

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int nt = 0; nt < N; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// Rows r0 + lane/4 (+8) of an accumulator tile [64 x 8 N], times `mul`,
// into one head's [L, 8 N] slice of a [B, L, H, 8 N] tensor; rows >= n are
// not stored.
template <int N>
__device__ __forceinline__ void store_rows(bf16* base, const float (&acc)[N][4], int r0, int n,
                                           int stride, float mul, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + lane / 4 + 8 * i;
    if (row >= n) continue;
#pragma unroll
    for (int nt = 0; nt < N; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(base + size_t(row) * stride + nt * 8 + (lane % 4) * 2) =
          __floats2bfloat162_rn(acc[nt][2 * i] * mul, acc[nt][2 * i + 1] * mul);
  }
}
template <int N>
__device__ __forceinline__ void store_rows(float* base, const float (&acc)[N][4], int r0, int n,
                                           int stride, float mul, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + lane / 4 + 8 * i;
    if (row >= n) continue;
#pragma unroll
    for (int nt = 0; nt < N; ++nt)
      *reinterpret_cast<float2*>(base + size_t(row) * stride + nt * 8 + (lane % 4) * 2) =
          make_float2(acc[nt][2 * i] * mul, acc[nt][2 * i + 1] * mul);
  }
}

// A tile of `rows` rows of one head sits in shared memory as HD / 64
// 128-byte-swizzled [rows][64] column blocks, one after the other (one TMA
// box each: a 64-wide bf16 row is one 128-byte swizzle atom).
//
// K-major operand (the head width is the contraction): k step kc (16 wide)
// lies in column block kc / 4, 32 bytes (+2) a step inside it. At HD = 64
// this is the descriptor plus 2 kc.
__device__ __forceinline__ uint64_t kmajor(uint64_t desc, int kc, int rows) {
  return desc + uint64_t((kc / 4) * rows * 8 + 2 * (kc % 4));
}
// MN-major operand whose N is the head width (V in P V, K in dS K, dO and
// Q in dV and dK): its 64-wide MN atoms are the column blocks, rows * 128
// bytes apart (LBO, which one atom leaves unread).
template <int HD>
__device__ __forceinline__ uint64_t mn_desc(const bf16* tile, int rows) {
  return HD == 64 ? sw128_desc(tile) : sw128_desc(tile, unsigned(rows) * 128);
}
// acc[64 x HD] += A[64 x 16] . B[16 x HD], A from registers, B MN-major.
__device__ __forceinline__ void wgmma_rs(float (&o)[8][4], const unsigned (&a)[4], uint64_t db) {
  wgmma_m64n64k16_rs(o, a, db);
}
__device__ __forceinline__ void wgmma_rs(float (&o)[16][4], const unsigned (&a)[4],
                                         uint64_t db) {
  wgmma_m64n128k16_rs(o, a, db);
}
// One tile of `rows` rows of (batch b, head h) from row `row`: HD / 64 boxes.
template <int HD>
__device__ __forceinline__ void tma_load_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                              int h, int row, int b, int rows) {
#pragma unroll
  for (int a = 0; a < HD / 64; ++a) tma_load(dst + a * rows * 64, map, bar, 64 * a, h, row, b);
}

// ------------------------------------------------------------------ forward

template <int HD>
struct FwdCfg {
  static_assert(kWidth<HD>, "head width 64 or 128");
  // Consumer warpgroups, 64 query rows each. At HD = 128 each one's O is
  // 64 f32 registers a thread, and three Q parts beside a K/V ring do not
  // fit in shared memory: two consumers at 232 registers.
  static constexpr int NC = HD == 64 ? 3 : 2;
  static constexpr int BM = 64 * NC;     // query rows per block
  static constexpr int BN = 128;         // keys per tile
  // K/V ring depth: at HD = 128 a stage is 64 KB (K and V), two fit beside Q.
  static constexpr int STAGES = HD == 64 ? 3 : 2;
  static constexpr int THREADS = 128 * (1 + NC);  // the producer warpgroup and the consumers
  // setmaxnreg: what the producer gives up, the consumers take (65,536 a block).
  static constexpr int PRODUCER_REGS = HD == 64 ? 32 : 40;
  static constexpr int CONSUMER_REGS = HD == 64 ? 160 : 232;
  static_assert(128 * PRODUCER_REGS + 128 * NC * CONSUMER_REGS <= 65536, "register file");
  static constexpr unsigned Q_PART_BYTES = 64 * HD * 2;  // one consumer's Q rows
  static constexpr unsigned KV_BYTES = BN * HD * 2;      // one K or V tile
  static constexpr float SCALE = kScale<HD>;
  static constexpr float MASKED = NEG_INF / SCALE;  // the raw score that scales to about NEG_INF
  // Consumers' empty-barrier arrivals: lane 0 of each of their warps.
  static constexpr unsigned CONSUMER_WARPS = 4 * NC;
};

// 128-byte-swizzled tiles (TMA writes them; wgmma reads them) must start on
// 1024-byte boundaries: one swizzle atom is 8 rows of 128 bytes.
template <int HD>
struct FwdSmem {
  using C = FwdCfg<HD>;
  alignas(1024) bf16 q[C::NC][64 * HD];
  alignas(1024) bf16 k[C::STAGES][C::BN * HD];
  alignas(1024) bf16 v[C::STAGES][C::BN * HD];
  uint64_t q_full;
  uint64_t k_full[C::STAGES], v_full[C::STAGES];
  uint64_t k_empty[C::STAGES], v_empty[C::STAGES];
};
template <int HD>
constexpr size_t kFwdSmem = sizeof(FwdSmem<HD>) + 1024;  // + room to align the base
static_assert(kFwdSmem<128> <= 232448, "forward shared memory at HD = 128");

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
template <int HD>
__device__ __forceinline__ void softmax_tile(float (&s)[16][4], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool need_mask, int row0, int k0,
                                             int col, const FwdParams& p) {
  constexpr float SCALE = FwdCfg<HD>::SCALE, MASKED = FwdCfg<HD>::MASKED;
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
    // Rounding is monotonic: max(s) * SCALE is the max of the scaled
    // scores. At HD = 64 SCALE is a power of two and MASKED scales to
    // NEG_INF exactly; at 128 a row with no visible key in the tile is
    // taken as NEG_INF itself, as the plain version's masked scores are.
    const float smx = HD == 64 || mx[i] > MASKED ? mx[i] * SCALE : NEG_INF;
    const float m_new = fmaxf(m[i], smx);
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

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N][4], const float (&corr)[2]) {
#pragma unroll
  for (int nt = 0; nt < N; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] *= corr[e >> 1];
}

// S = Q K^T of one key tile (HD / 16 k steps over the head width).
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[16][4], uint64_t dq, const bf16* k_tile) {
  const uint64_t dk = sw128_desc(k_tile);
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc)
    wgmma_m64n128k16_ss(s, kmajor(dq, kc, 64), kmajor(dk, kc, FwdCfg<HD>::BN), kc);
}
// O += P V of one key tile (8 k steps over its keys; 2048 bytes each).
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 8][4], const unsigned (&pa)[8][4],
                                         const bf16* v_tile) {
  constexpr int BN = FwdCfg<HD>::BN;
  const uint64_t dv = mn_desc<HD>(v_tile, BN);
#pragma unroll
  for (int kc = 0; kc < BN / 16; ++kc) wgmma_rs(o, pa[kc], dv + 128 * kc);
}

// One consumer warpgroup (rows q0 + 64c .. + 63) over the block's n_tiles
// key tiles, from the last down. Each round issues, in its turn, Q K^T of
// the next tile and P V of the last one as two groups; the softmax of the
// next tile runs as soon as its scores land, beside this warpgroup's P V
// and the other warpgroups' products. The accumulator is rescaled just
// before the P V that follows, when no product writes it. The first round
// has no P V and the last no Q K^T; every wgmma sits on a path that all of
// the warpgroup takes, so none is serialized.
template <int HD>
__device__ __forceinline__ void consume_key_tiles(FwdSmem<HD>& sm, int c, int q0, int n_tiles,
                                                  const FwdParams& p, float (&m)[2],
                                                  float (&l)[2], float (&o)[HD / 8][4]) {
  using C = FwdCfg<HD>;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int qc = q0 + 64 * c;
  const int row0 = qc + warp * 16 + lane / 4;
  const int col = (lane % 4) * 2;
  const int my_turn = 1 + c, their_turn = 1 + (c + 1) % C::NC;
  const uint64_t dq = sw128_desc(sm.q[c]);
  float s[16][4], corr[2];
  unsigned pa[8][4];  // P of the last tile, bf16 A fragments
  auto softmax = [&](int i) {
    const int k0 = (n_tiles - 1 - i) * C::BN;
    const bool need_mask = k0 + C::BN > p.lk ||
                           (p.causal && p.k_off + k0 + C::BN - 1 > p.q_off + qc);
    softmax_tile<HD>(s, m, l, corr, need_mask, row0, k0, col, p);
  };
  mbar_wait(&sm.q_full, 0);
  if (c == C::NC - 1) named_arrive(1);  // consumer 0 goes first

  mbar_wait(&sm.k_full[0], 0);
  named_sync(my_turn);
  wgmma_fence();
  issue_qk<HD>(s, dq, sm.k[0]);
  wgmma_commit();
  named_arrive(their_turn);
  wgmma_wait<0>();
  fence_regs(s);
  if (lane == 0) mbar_arrive(&sm.k_empty[0]);
  softmax(0);
  to_a(pa, s);

  int stage = 0, parity = 0;  // the last tile's
  for (int i = 1; i < n_tiles; ++i) {
    const int next = stage + 1 == C::STAGES ? 0 : stage + 1;
    const int next_parity = next == 0 ? parity ^ 1 : parity;
    rescale(o, corr);
    mbar_wait(&sm.k_full[next], next_parity);
    mbar_wait(&sm.v_full[stage], parity);
    named_sync(my_turn);
    fence_regs(o);
    wgmma_fence();
    issue_qk<HD>(s, dq, sm.k[next]);
    wgmma_commit();
    issue_pv<HD>(o, pa, sm.v[stage]);
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
  issue_pv<HD>(o, pa, sm.v[stage]);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pa);
  // The last consumer's last round has no round of consumer 0's left to release.
  if (c != C::NC - 1) named_arrive(their_turn);
  if (lane == 0) mbar_arrive(&sm.v_empty[stage]);
}

// The walk both forward kernels run; CARRY selects the carry kernel's
// prologue (the carry read in) and epilogue (acc, m, l written back
// unnormalized) over the forward's (out and lse). In the carry, a block
// whose causal key range is empty runs no tile and writes its carry rows
// back bit for bit; the carried l enters once per row, in the quad's lane
// 0, since the walk keeps per-lane partial denominators.
template <int HD, bool CARRY>
__device__ __forceinline__ void forward_walk(const CUtensorMap* qm, const CUtensorMap* km,
                                             const CUtensorMap* vm, const FwdParams& p) {
  using C = FwdCfg<HD>;
  extern __shared__ unsigned char fwd_smem[];
  FwdSmem<HD>& sm = *reinterpret_cast<FwdSmem<HD>*>(
      (reinterpret_cast<uintptr_t>(fwd_smem) + 1023) & ~uintptr_t(1023));
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BM;  // the longest causal rows start first
  const int bh = blockIdx.y, b = bh / p.h, h = bh % p.h;
  const int k_end = p.causal ? min(p.lk, p.q_off - p.k_off + min(q0 + C::BM, p.lq)) : p.lk;
  const int n_tiles = k_end > 0 ? (k_end + C::BN - 1) / C::BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], C::CONSUMER_WARPS);
      mbar_init(&sm.v_empty[s], C::CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread issues every copy, in the consumers' order.
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      // Only consumers with a row inside the sequence get their Q rows.
      const int q_parts = min(C::NC, (p.lq - q0 + 63) / 64);
      mbar_expect_tx(&sm.q_full, q_parts * C::Q_PART_BYTES);
      for (int c = 0; c < q_parts; ++c)
        tma_load_tile<HD>(sm.q[c], qm, &sm.q_full, h, q0 + 64 * c, b, 64);
      int stage = 0, parity = 0;
      for (int i = 0; i < n_tiles; ++i) {
        const int k0 = (n_tiles - 1 - i) * C::BN;
        mbar_wait(&sm.k_empty[stage], parity ^ 1);
        mbar_expect_tx(&sm.k_full[stage], C::KV_BYTES);
        tma_load_tile<HD>(sm.k[stage], km, &sm.k_full[stage], h, k0, b, C::BN);
        mbar_wait(&sm.v_empty[stage], parity ^ 1);
        mbar_expect_tx(&sm.v_full[stage], C::KV_BYTES);
        tma_load_tile<HD>(sm.v[stage], vm, &sm.v_full[stage], h, k0, b, C::BN);
        if (++stage == C::STAGES) {
          stage = 0;
          parity ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int row0 = q0 + 64 * c + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
    const int col = (lane % 4) * 2;
    const size_t acc_head = size_t(bh) * p.lq * HD;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float o[HD / 8][4];
    zero(o);
    if (CARRY && p.acc_in != nullptr) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        if (row >= p.lq) continue;
        m[i] = p.m_in[size_t(bh) * p.lq + row];
        if (lane % 4 == 0) l[i] = p.l_in[size_t(bh) * p.lq + row];
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt) {
          const float2 x = *reinterpret_cast<const float2*>(p.acc_in + acc_head +
                                                            size_t(row) * HD + nt * 8 + col);
          o[nt][2 * i] = x.x;
          o[nt][2 * i + 1] = x.y;
        }
      }
    }
    if (n_tiles > 0) consume_key_tiles<HD>(sm, c, q0, n_tiles, p, m, l, o);
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
        for (int nt = 0; nt < HD / 8; ++nt)
          *reinterpret_cast<__nv_bfloat162*>(ob + size_t(row) * stride + nt * 8 + col) =
              __floats2bfloat162_rn(o[nt][2 * i] * inv, o[nt][2 * i + 1] * inv);
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(FwdCfg<HD>::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                 const __grid_constant__ CUtensorMap vm, const FwdParams p) {
  forward_walk<HD, false>(&qm, &km, &vm, p);
}

// -------------------------------------------------------------------- carry

// Ring attention's local step: the forward's walk, with the online-softmax
// state (acc, m, l) read from the carry (fresh when acc_in is null) and
// written back unnormalized, so the next ring step (or finalize) continues
// it. acc is f32 [B, H, Lq, HD], m and l f32 [B * H, Lq], the JAX carry
// layout. The carry is not updated in place: the wrapper allocates the
// outputs, and the carry given stays as it was.
template <int HD>
__global__ void __launch_bounds__(FwdCfg<HD>::THREADS, 1)
flash_fwd_carry_kernel(const __grid_constant__ CUtensorMap qm,
                       const __grid_constant__ CUtensorMap km,
                       const __grid_constant__ CUtensorMap vm, const FwdParams p) {
  forward_walk<HD, true>(&qm, &km, &vm, p);
}

// ----------------------------------------------------------------- backward

// Every backward tile holds 64 rows of one head (HD / 64 TMA boxes of 8
// KB): a consumer's own rows and each streamed tile of keys (dQ) or
// queries (dK/dV).
constexpr int BT = 64;
constexpr int BWD_STAGES = 4;  // ring depth of the streamed tiles

template <int HD>
struct BwdCfg {
  // The pair is built at head width 64; at 128 one kernel, flash_bwd_kernel,
  // computes dq, dk and dv.
  static_assert(HD == 64, "the backward pair's head width is 64");
  static constexpr unsigned TILE_BYTES = BT * HD * 2;
  static constexpr float SCALE = kScale<HD>;
  // dQ: three consumers (as the forward) of 64 query rows; S, dP and dQ are
  // 32 f32 registers a thread each, beside dS of the last tile, in 160.
  static constexpr int DQ_NC = 3;
  static constexpr int DQ_BM = BT * DQ_NC;
  static constexpr int DQ_THREADS = 128 * (1 + DQ_NC);
  static constexpr int DQ_PRODUCER_REGS = 32;
  static constexpr int DQ_CONSUMER_REGS = 160;
  static_assert(128 * DQ_PRODUCER_REGS + 128 * DQ_NC * DQ_CONSUMER_REGS <= 65536,
                "register file");
  // dK/dV: two consumers of 64 keys. S^T, dP^T, dK and dV are 32 f32
  // registers a thread each, beside P^T and dS^T of the last tile and the
  // consumer's K and V rows as A fragments, in 232.
  static constexpr int DKDV_NC = 2;
  static constexpr int DKDV_BK = BT * DKDV_NC;
  static constexpr int DKDV_THREADS = 128 * (1 + DKDV_NC);
  static constexpr int DKDV_PRODUCER_REGS = 40;
  static constexpr int DKDV_CONSUMER_REGS = 232;
  static_assert(128 * DKDV_PRODUCER_REGS + 128 * DKDV_NC * DKDV_CONSUMER_REGS <= 65536,
                "register file");
};

template <int HD>
struct DqSmem {
  static constexpr int NC = BwdCfg<HD>::DQ_NC;
  alignas(1024) bf16 q[NC][BT * HD];
  alignas(1024) bf16 dout[NC][BT * HD];
  alignas(1024) bf16 k[BWD_STAGES][BT * HD];
  alignas(1024) bf16 v[BWD_STAGES][BT * HD];
  uint64_t q_full;
  uint64_t k_full[BWD_STAGES], v_full[BWD_STAGES];
  uint64_t k_empty[BWD_STAGES], v_empty[BWD_STAGES];
};
template <int HD>
constexpr size_t kDqSmem = sizeof(DqSmem<HD>) + 1024;  // + room to align the base

template <int HD>
struct DkdvSmem {
  static constexpr int NC = BwdCfg<HD>::DKDV_NC;
  alignas(1024) bf16 k[NC][BT * HD];
  alignas(1024) bf16 v[NC][BT * HD];
  alignas(1024) bf16 q[BWD_STAGES][BT * HD];
  alignas(1024) bf16 dout[BWD_STAGES][BT * HD];
  float lse[BWD_STAGES][BT];
  float dd[BWD_STAGES][BT];
  uint64_t kv_full;
  uint64_t full[BWD_STAGES], empty[BWD_STAGES];
};
template <int HD>
constexpr size_t kDkdvSmem = sizeof(DkdvSmem<HD>) + 1024;
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
// bf16 A fragments of a product over the head width 64: warp w holds rows
// 16 w .. 16 w + 15 in the mma.sync A layout. Read once a block.
__device__ __forceinline__ void load_a(unsigned (&a)[4][4], const bf16* tile) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const unsigned char* base = reinterpret_cast<const unsigned char*>(tile);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = warp * 16 + lane / 4 + 8 * (j & 1);
      const int col = kc * 16 + (lane % 4) * 2 + 8 * (j >> 1);
      a[kc][j] = *reinterpret_cast<const unsigned*>(
          base + row * 128 + ((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) * 2)));
    }
}

// s = A X^T over the head width 64 (4 k steps): A a consumer's own 64 rows
// as register fragments, X a streamed tile, K-major in shared memory. A
// from registers halves the shared-memory reads of an m64n64k16, which
// with both operands in shared memory needs all of the SM's 128 bytes a
// clock at the tensor cores' rate.
__device__ __forceinline__ void issue_score(float (&s)[8][4], const unsigned (&a)[4][4],
                                            const bf16* x) {
  const uint64_t dx = sw128_desc(x);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) wgmma_m64n64k16_rs<0>(s, a[kc], dx + 2 * kc, kc);
}
// The same over HD / 16 k steps with A in shared memory too (descriptor
// da of a [64 x HD] tile): dQ's three consumers have no room for A
// fragments at 160 registers, and at HD = 128 no consumer has.
template <int HD>
__device__ __forceinline__ void issue_score(float (&s)[8][4], uint64_t da, const bf16* x) {
  const uint64_t dx = sw128_desc(x);
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc)
    wgmma_m64n64k16_ss<0>(s, kmajor(da, kc, BT), kmajor(dx, kc, BT), kc);
}
// acc += A T over a streamed tile T (its 64 rows the contraction: 4 k
// steps of 2048 bytes, T MN-major), A as bf16 register fragments.
template <int HD>
__device__ __forceinline__ void issue_acc(float (&acc)[HD / 8][4],
                                          const unsigned (&a)[BT / 16][4], const bf16* t) {
  const uint64_t dt = mn_desc<HD>(t, BT);
#pragma unroll
  for (int kc = 0; kc < BT / 16; ++kc) wgmma_rs(acc, a[kc], dt + 128 * kc);
}

// dQ's p on one key tile: s (raw scores, this thread's rows row0 and
// row0 + 8, keys k0 + 8 nt + col (+1)) becomes p = exp2(s scale log2e -
// lse2), set to 0 past the sequence end and the diagonal if asked; lse2 =
// lse log2e of the thread's two rows.
template <int HD>
__device__ __forceinline__ void dq_p(float (&s)[8][4], const float (&lse2)[2], bool need_mask,
                                     int row0, int k0, int col, const BwdParams& p) {
  constexpr float SCALE = BwdCfg<HD>::SCALE;
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
template <int HD>
__device__ __forceinline__ void dkdv_p(float (&s)[8][4], const float* lse, bool need_mask,
                                       int key0, int qt0, int col, const BwdParams& p) {
  constexpr float SCALE = BwdCfg<HD>::SCALE;
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
template <int HD>
__device__ __forceinline__ void dq_consume(DqSmem<HD>& sm, int c, int qc, int n_tiles,
                                           const BwdParams& p, const float (&lse2)[2],
                                           const float (&dd)[2], float (&dq)[HD / 8][4]) {
  constexpr int NC = BwdCfg<HD>::DQ_NC;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int row0 = qc + warp * 16 + lane / 4;
  const int col = (lane % 4) * 2;
  const int my_turn = 1 + c, their_turn = 1 + (c + 1) % NC;
  float s[8][4], dp[8][4];
  unsigned ds[BT / 16][4];  // dS of the last tile, bf16 A fragments
  const uint64_t d_q = sw128_desc(sm.q[c]), d_do = sw128_desc(sm.dout[c]);
  auto probs = [&](int i) {
    const int k0 = (n_tiles - 1 - i) * BT;
    const bool need_mask = k0 + BT > p.lk || (p.causal && p.k_off + k0 + BT - 1 > p.q_off + qc);
    dq_p<HD>(s, lse2, need_mask, row0, k0, col, p);
  };
  auto grads = [&]() {  // s = ds = p (dP - D)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= dp[nt][e] - dd[e >> 1];
  };
  mbar_wait(&sm.q_full, 0);
  if (c == NC - 1) named_arrive(1);  // consumer 0 goes first

  mbar_wait(&sm.k_full[0], 0);
  mbar_wait(&sm.v_full[0], 0);
  named_sync(my_turn);
  wgmma_fence();
  issue_score<HD>(s, d_q, sm.k[0]);
  wgmma_commit();
  issue_score<HD>(dp, d_do, sm.v[0]);
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
    issue_score<HD>(s, d_q, sm.k[next]);
    wgmma_commit();
    issue_score<HD>(dp, d_do, sm.v[next]);
    wgmma_commit();
    issue_acc<HD>(dq, ds, sm.k[stage]);
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
  issue_acc<HD>(dq, ds, sm.k[stage]);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dq);
  fence_regs(ds);
  // The last consumer's last round has no round of consumer 0's left to release.
  if (c != NC - 1) named_arrive(their_turn);
  if (lane == 0) mbar_arrive(&sm.k_empty[stage]);
}

// One block per DQ_BM query rows of one (batch, head), each head's longest
// causal rows first; the key tiles they see are walked from the diagonal
// down.
template <int HD, typename OutT>
__global__ void __launch_bounds__(BwdCfg<HD>::DQ_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                    const __grid_constant__ CUtensorMap vm,
                    const __grid_constant__ CUtensorMap dom, const BwdParams p) {
  using C = BwdCfg<HD>;
  extern __shared__ unsigned char dq_smem[];
  DqSmem<HD>& sm = align1024<DqSmem<HD>>(dq_smem);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::DQ_BM;
  const int bh = blockIdx.y, b = bh / p.h, h = bh % p.h;
  const int k_end = p.causal ? min(p.lk, p.q_off - p.k_off + min(q0 + C::DQ_BM, p.lq)) : p.lk;
  const int n_tiles = k_end > 0 ? (k_end + BT - 1) / BT : 0;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], 4 * C::DQ_NC);
      mbar_init(&sm.v_empty[s], 4 * C::DQ_NC);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread issues every copy, in the consumers' order.
    setmaxnreg_dec<C::DQ_PRODUCER_REGS>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      // Only consumers with a row inside the sequence get their Q and dO rows.
      const int parts = min(C::DQ_NC, (p.lq - q0 + BT - 1) / BT);
      mbar_expect_tx(&sm.q_full, 2 * parts * C::TILE_BYTES);
      for (int c = 0; c < parts; ++c) {
        tma_load_tile<HD>(sm.q[c], &qm, &sm.q_full, h, q0 + BT * c, b, BT);
        tma_load_tile<HD>(sm.dout[c], &dom, &sm.q_full, h, q0 + BT * c, b, BT);
      }
      int stage = 0, parity = 0;
      for (int i = 0; i < n_tiles; ++i) {
        const int k0 = (n_tiles - 1 - i) * BT;
        mbar_wait(&sm.k_empty[stage], parity ^ 1);
        mbar_expect_tx(&sm.k_full[stage], C::TILE_BYTES);
        tma_load_tile<HD>(sm.k[stage], &km, &sm.k_full[stage], h, k0, b, BT);
        mbar_wait(&sm.v_empty[stage], parity ^ 1);
        mbar_expect_tx(&sm.v_full[stage], C::TILE_BYTES);
        tma_load_tile<HD>(sm.v[stage], &vm, &sm.v_full[stage], h, k0, b, BT);
        if (++stage == BWD_STAGES) {
          stage = 0;
          parity ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<C::DQ_CONSUMER_REGS>();
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
    float dq[HD / 8][4];
    zero(dq);
    if (n_tiles > 0) dq_consume<HD>(sm, c, qc, n_tiles, p, lse2, dd, dq);
    store_rows(static_cast<OutT*>(p.out0) + (size_t(b) * p.lq * p.h + h) * HD, dq,
               qc + warp * 16, p.lq, p.h * HD, C::SCALE, lane);
  }
}

// One dK/dV consumer at head width 64 (keys kc .. kc + 63) over the
// block's n_tiles query tiles, from tile t0 (the diagonal) to the end. A
// stage (Q, dO, lse, D) is released when dV += P^T dO and dK += dS^T Q
// have run on it.
__device__ __forceinline__ void dkdv_consume(DkdvSmem<64>& sm, int c, int kc, int t0,
                                             int n_tiles, const BwdParams& p, float (&dk)[8][4],
                                             float (&dv)[8][4]) {
  constexpr int NC = BwdCfg<64>::DKDV_NC;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int key0 = kc + warp * 16 + lane / 4;
  const int col = (lane % 4) * 2;
  const int my_turn = 1 + c, their_turn = 1 + (c + 1) % NC;
  float s[8][4], dp[8][4];
  unsigned d_k[4][4], d_v[4][4];  // this consumer's K and V rows
  unsigned pa[BT / 16][4], dsa[BT / 16][4];  // P^T and dS^T of the last tile, bf16 A fragments
  auto probs = [&](int i, int stage) {
    const int qt0 = (t0 + i) * BT;
    const bool need_mask = qt0 + BT > p.lq || (p.causal && p.k_off + kc + BT - 1 > p.q_off + qt0);
    dkdv_p<64>(s, sm.lse[stage], need_mask, key0, qt0, col, p);
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
  if (c == NC - 1) named_arrive(1);  // consumer 0 goes first

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
    issue_acc<64>(dv, pa, sm.dout[stage]);
    issue_acc<64>(dk, dsa, sm.q[stage]);
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
  issue_acc<64>(dv, pa, sm.dout[stage]);
  issue_acc<64>(dk, dsa, sm.q[stage]);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dk);
  fence_regs(dv);
  fence_regs(pa);
  fence_regs(dsa);
  if (c != NC - 1) named_arrive(their_turn);
  if (lane == 0) mbar_arrive(&sm.empty[stage]);
}

// One block per DKDV_BK keys of one (batch, head), the query tiles that see
// them walked from the diagonal to the end; in causal attention the first
// keys see the most queries, so each head's longest walks start first.
template <int HD, typename OutT>
__global__ void __launch_bounds__(BwdCfg<HD>::DKDV_THREADS, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qm,
                      const __grid_constant__ CUtensorMap km,
                      const __grid_constant__ CUtensorMap vm,
                      const __grid_constant__ CUtensorMap dom, const BwdParams p) {
  using C = BwdCfg<HD>;
  extern __shared__ unsigned char dkdv_smem[];
  DkdvSmem<HD>& sm = align1024<DkdvSmem<HD>>(dkdv_smem);
  const int k0 = blockIdx.x * C::DKDV_BK;
  const int bh = blockIdx.y, b = bh / p.h, h = bh % p.h;
  // The first query that sees key k0; tiles before its own see none of this block's keys.
  const int t0 = p.causal ? max(0, p.k_off - p.q_off + k0) / BT : 0;
  const int n_tiles = max(0, (p.lq + BT - 1) / BT - t0);

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(&sm.full[s], DKDV_FULL_ARRIVALS);
      mbar_init(&sm.empty[s], 4 * C::DKDV_NC);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: warp 0. Its lane 0 issues the TMA copies; all 32 lanes
    // copy the tile's lse and D (rows past lq read as 0).
    setmaxnreg_dec<C::DKDV_PRODUCER_REGS>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < 32 && n_tiles > 0) {
      if (lane == 0) {
        const int parts = min(C::DKDV_NC, (p.lk - k0 + BT - 1) / BT);
        mbar_expect_tx(&sm.kv_full, 2 * parts * C::TILE_BYTES);
        for (int c = 0; c < parts; ++c) {
          tma_load_tile<HD>(sm.k[c], &km, &sm.kv_full, h, k0 + BT * c, b, BT);
          tma_load_tile<HD>(sm.v[c], &vm, &sm.kv_full, h, k0 + BT * c, b, BT);
        }
      }
      const float* lrow = p.lse + size_t(bh) * p.lq;
      const float* drow = p.dd + size_t(bh) * p.lq;
      int stage = 0, parity = 0;
      for (int i = 0; i < n_tiles; ++i) {
        const int qt0 = (t0 + i) * BT;
        mbar_wait(&sm.empty[stage], parity ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&sm.full[stage], 2 * C::TILE_BYTES);
          tma_load_tile<HD>(sm.q[stage], &qm, &sm.full[stage], h, qt0, b, BT);
          tma_load_tile<HD>(sm.dout[stage], &dom, &sm.full[stage], h, qt0, b, BT);
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
    setmaxnreg_inc<C::DKDV_CONSUMER_REGS>();
    const int c = wg - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int kc = k0 + BT * c;
    float dk[HD / 8][4], dv[HD / 8][4];
    zero(dk);
    zero(dv);
    if (n_tiles > 0) dkdv_consume(sm, c, kc, t0, n_tiles, p, dk, dv);
    const size_t head = (size_t(b) * p.lk * p.h + h) * HD;
    store_rows(static_cast<OutT*>(p.out0) + head, dk, kc + warp * 16, p.lk, p.h * HD, C::SCALE,
               lane);
    store_rows(static_cast<OutT*>(p.out1) + head, dv, kc + warp * 16, p.lk, p.h * HD, 1.f, lane);
  }
}

// ------------------------------------------------------ one-pass backward

// flash_bwd_kernel: dQ, dK and dV at head width 128 in one walk, five
// products a (key block, query tile) pair where the pair runs seven (S and
// dP twice) and one exp a score where it runs two. What bounds it: the
// tensor cores (2.75e12 FLOPs at B = 8, L = 8,192, H = 8, causal: 2.78 ms
// at 989 TFLOP/s) and, beside them, shared memory: S^T and dP^T (both
// operands there) and dQ's dS K read 4 KB an m64n64k16, the SM's 128 bytes
// a clock at the tensor rate, and the dS^T exchange and the dQ staging add
// 80 KB a pair; what the design does about it is overlap.
// - A block owns 128 keys of one (batch, head): two consumer warpgroups of
//   64 keys at 240 registers (dK and dV, 128 f32 registers a thread, stay
//   in registers for the walk) and a producer warpgroup at 24. K and V are
//   loaded once; Q, dO, lse and D stream through a 2-stage ring.
// - Per 64-row query tile each consumer runs S^T = K Q^T and dP^T = V dO^T
//   (both operands in shared memory), p^T and ds^T in registers, and writes its dS^T rows (bf16, 128-byte swizzled)
//   to shared memory. Once the other consumer's rows are in (a named
//   barrier) it issues its half of the tile's dQ partial (64 rows x its 64
//   columns) as dS K, A the dS^T buffer read MN-major, B its columns of K;
//   then dV += P^T dO and dK += dS^T Q (P^T, dS^T as register A fragments),
//   and stages the dQ half while those two run. dS^T has two buffers: a
//   buffer is written again two tiles later, after both consumers passed
//   the next tile's barrier and so finished their dQ of this one.
// - dQ sums over key blocks in global memory: f32 [B*H, query tiles, 64 x
//   128], each tile's partial in the consumers' fragment order (a float4 a
//   thread and n-tile, so the staging stores are conflict-free);
//   flash_bwd_dq_convert_kernel then scales it and writes dq in [B, L, H,
//   128]. The producer's second warp takes each staged partial (two staging
//   buffers) and writes it with one bulk copy (the tile's first) or adds it
//   with one bulk reduce (cp.reduce.async.bulk .add.f32, 32 KB), then hands
//   the buffer back.
// - Fixed order: each (batch, head, query tile) has an int32 turn in a
//   zeroed buffer. The key blocks that see a tile add in descending order:
//   block j adds when the turn reads (the last block that sees the tile) -
//   j (ld.acquire), waits for its bulk operation to complete, and bumps it
//   (release). Every key block below the last one that sees a tile sees it
//   too (a query that sees a key sees every key before it), so the count
//   is exact. The sum's order is fixed, and dQ's bits are the same from run
//   to run.
// - Each block walks its query tiles from its diagonal up, and a head's key
//   blocks start in linear order from the last: block j + 1 reaches each
//   tile two tiles of walk before block j (its diagonal is two tiles
//   further on), so it has added by the time j comes, and j waits only on
//   blocks of a lower linear index, which started before it.
// - Keys past lk and queries past lq arrive zero-filled and are masked to p
//   = 0, so they add nothing to dQ; a row that no key sees gets a dQ of
//   exactly 0 (a tile that no block sees is never written, and the dQ pass
//   writes its zeros), and a block whose keys no query sees walks no tile
//   and writes zeros.
namespace b1 {
constexpr int NC = 2;                  // consumer warpgroups, 64 keys each
constexpr int BK = BT * NC;            // keys a block
constexpr int HD = 128;
constexpr int THREADS = 128 * (1 + NC);
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
static_assert(128 * PRODUCER_REGS + 128 * NC * CONSUMER_REGS <= 65536, "register file");
constexpr int STAGES = 2;              // ring depth of the Q, dO, lse, D tiles
constexpr int DQ_BUFS = 2;             // staging buffers of the dQ partials
constexpr unsigned TILE_BYTES = BT * HD * 2;
constexpr int DQ_TILE = BT * HD;       // f32 values of one query tile's dQ partial
constexpr float SCALE = kScale<128>;
}  // namespace b1

struct Bwd1Smem {
  alignas(1024) bf16 k[b1::NC][BT * b1::HD];
  alignas(1024) bf16 v[b1::NC][BT * b1::HD];
  alignas(1024) bf16 q[b1::STAGES][BT * b1::HD];
  alignas(1024) bf16 dout[b1::STAGES][BT * b1::HD];
  alignas(1024) bf16 ds[2][b1::BK * BT];  // dS^T [128 keys][64 queries], two buffers
  alignas(1024) float4 dq[b1::DQ_BUFS][b1::DQ_TILE / 4];  // dQ partials, fragment order
  float lse[b1::STAGES][BT];
  float dd[b1::STAGES][BT];
  uint64_t kv_full;
  uint64_t full[b1::STAGES], empty[b1::STAGES];
  uint64_t dq_full[b1::DQ_BUFS], dq_empty[b1::DQ_BUFS];
};
constexpr size_t kBwd1Smem = sizeof(Bwd1Smem) + 1024;
static_assert(kBwd1Smem <= 232448, "one-pass backward shared memory");

struct Bwd1Params {
  int h, lq, lk, causal, q_off, k_off;
  const float* lse;
  const float* dd;
  void* dk;
  void* dv;
  float* dq_acc;  // f32 [B*H, query tiles, DQ_TILE], zeroed
  int* dq_turn;   // int32 [B*H, query tiles], zeroed
};

// p^T on one query tile, as dkdv_p, with the keys past lk masked too (their
// scores would reach dQ).
__device__ __forceinline__ void bwd1_p(float (&s)[8][4], const float* lse, bool need_mask,
                                       int key0, int qt0, int col, const Bwd1Params& p) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float2 l = *reinterpret_cast<const float2*>(lse + nt * 8 + col);
    const float l2[2] = {l.x * LOG2E, l.y * LOG2E};
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = ex2(fmaf(s[nt][e], b1::SCALE * LOG2E, -l2[e & 1]));
  }
  if (need_mask) {
    // Query column c of the tile is visible to a key iff lo <= c < hi.
    const int hi = p.lq - qt0 - col;
    int lo[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lo[i] = p.causal ? p.k_off - p.q_off + key0 + 8 * i - qt0 - col : -BT;
      if (key0 + 8 * i >= p.lk) lo[i] = BT;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + (e & 1);
        if (c < lo[e >> 1] || c >= hi) s[nt][e] = 0.f;
      }
  }
}

// A consumer's dS^T fragments (its 64 keys x the tile's 64 queries, the
// register A layout) into rows 64 c .. 64 c + 63 of a [128][64] dS^T
// buffer, 128-byte swizzled (the 16-byte chunk k of row r at k ^ (r % 8)):
// the MN-major A operand of dS K.
__device__ __forceinline__ void store_ds(bf16* buf, int c, const unsigned (&dsa)[BT / 16][4]) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  unsigned char* base = reinterpret_cast<unsigned char*>(buf);
#pragma unroll
  for (int kc = 0; kc < BT / 16; ++kc)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = BT * c + warp * 16 + lane / 4 + 8 * (j & 1);
      const int col = kc * 16 + (lane % 4) * 2 + 8 * (j >> 1);
      *reinterpret_cast<unsigned*>(base + row * 128 +
                                   ((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) * 2))) =
          dsa[kc][j];
    }
}

// dQ[64 queries x columns 64 c .. 64 c + 63] = dS . K over the block's 128
// keys (8 k steps of 16): A the dS^T buffer (MN-major, 2048 bytes a step),
// B column block c of each 64-key part of K (MN-major).
__device__ __forceinline__ void issue_dq(float (&dq)[8][4], const bf16* ds, const Bwd1Smem& sm,
                                         int c) {
  const uint64_t da = sw128_desc(ds);
#pragma unroll
  for (int kc = 0; kc < b1::BK / 16; ++kc)
    wgmma_m64n64k16_ss<1, 1>(dq, da + 128 * kc,
                             sw128_desc(sm.k[kc / 4] + c * BT * 64) + 128 * (kc % 4), kc);
}

// Named barrier 1 + 2 c + buf says consumer c's dS^T rows of the tile are
// in buffer buf (c arrives, the other consumer syncs before its dQ). The
// buffer's parity in the id keeps a consumer from arriving twice before the
// other's sync: it arrives again on one id only two tiles later, after the
// sync of the tile between, which the other makes after its own.
__device__ __forceinline__ int ds_ready(int c, int buf) { return 1 + 2 * c + buf; }

// One consumer (keys kc .. kc + 63) over the block's n_tiles query tiles,
// from tile t0 (the diagonal) up. Each round issues the tile's S^T and
// dP^T; computes p, ds and the dS^T rows; once the other consumer's rows
// are in, issues its half of the tile's dQ, then dV and dK, and stages the
// dQ half for the writer while those two run. (Turns between the two
// consumers for their score products, as the forward takes them, measured
// no faster here: the dS^T barrier already staggers them.)
__device__ __forceinline__ void bwd1_consume(Bwd1Smem& sm, int c, int kc, int t0, int n_tiles,
                                             const Bwd1Params& p, float (&dk)[16][4],
                                             float (&dv)[16][4]) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int key0 = kc + warp * 16 + lane / 4;
  const int col = (lane % 4) * 2;
  float s[8][4], dp[8][4], dq[8][4];
  unsigned pa[BT / 16][4], dsa[BT / 16][4];  // P^T and dS^T, bf16 A fragments
  const uint64_t d_k = sw128_desc(sm.k[c]), d_v = sw128_desc(sm.v[c]);
  mbar_wait(&sm.kv_full, 0);

  int stage = 0, parity = 0;
  for (int i = 0; i < n_tiles; ++i) {
    const int qt0 = (t0 + i) * BT;
    const int buf = i & 1;
    const bool need_mask = qt0 + BT > p.lq || kc + BT > p.lk ||
                           (p.causal && p.k_off + kc + BT - 1 > p.q_off + qt0);
    mbar_wait(&sm.full[stage], parity);
    fence_regs(dk);
    fence_regs(dv);
    wgmma_fence();
    issue_score<128>(s, d_k, sm.q[stage]);
    wgmma_commit();
    issue_score<128>(dp, d_v, sm.dout[stage]);
    wgmma_commit();
    wgmma_wait<1>();  // S^T
    fence_regs(s);
    bwd1_p(s, sm.lse[stage], need_mask, key0, qt0, col, p);
    wgmma_wait<0>();  // dP^T
    fence_regs(dp);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {  // dp = ds^T = p^T (dP^T - D)
      const float2 d = *reinterpret_cast<const float2*>(sm.dd[stage] + nt * 8 + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = s[nt][e] * (dp[nt][e] - ((e & 1) ? d.y : d.x));
    }
    to_a(pa, s);
    to_a(dsa, dp);
    store_ds(sm.ds[buf], c, dsa);
    fence_proxy_async();
    named_arrive(ds_ready(c, buf));
    named_sync(ds_ready(1 - c, buf));
    wgmma_fence();
    issue_dq(dq, sm.ds[buf], sm, c);
    wgmma_commit();
    issue_acc<128>(dv, pa, sm.dout[stage]);
    issue_acc<128>(dk, dsa, sm.q[stage]);
    wgmma_commit();
    wgmma_wait<1>();  // dQ, staged while dV and dK run
    fence_regs(dq);
    // The writer has taken the partial staged DQ_BUFS tiles ago.
    const int sb = i % b1::DQ_BUFS;
    mbar_wait(&sm.dq_empty[sb], ((i / b1::DQ_BUFS) & 1) ^ 1);
    float4* staged = sm.dq[sb] + c * 8 * 128 + tid;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      staged[nt * 128] = make_float4(dq[nt][0], dq[nt][1], dq[nt][2], dq[nt][3]);
    fence_proxy_async();
    mbar_arrive(&sm.dq_full[sb]);
    wgmma_wait<0>();  // dV and dK: the stage is read
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pa);
    fence_regs(dsa);
    if (lane == 0) mbar_arrive(&sm.empty[stage]);
    if (++stage == b1::STAGES) {
      stage = 0;
      parity ^= 1;
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(b1::THREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                 const __grid_constant__ CUtensorMap vm, const __grid_constant__ CUtensorMap dom,
                 const Bwd1Params p) {
  extern __shared__ unsigned char bwd1_smem[];
  Bwd1Smem& sm = align1024<Bwd1Smem>(bwd1_smem);
  // A head's key blocks are consecutive in linear order, the last first.
  const int kb = gridDim.x - 1 - blockIdx.x;
  const int k0 = kb * b1::BK;
  const int bh = blockIdx.y, b = bh / p.h, h = bh % p.h;
  const int n_qt = (p.lq + BT - 1) / BT;
  // The first query tile that sees key k0; the tiles before it see none of
  // this block's keys.
  const int t0 = p.causal ? min(n_qt, max(0, p.k_off - p.q_off + k0) / BT) : 0;
  const int n_tiles = n_qt - t0;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < b1::STAGES; ++s) {
      mbar_init(&sm.full[s], DKDV_FULL_ARRIVALS);
      mbar_init(&sm.empty[s], 4 * b1::NC);
    }
    for (int s = 0; s < b1::DQ_BUFS; ++s) {
      mbar_init(&sm.dq_full[s], 128 * b1::NC);
      mbar_init(&sm.dq_empty[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<b1::PRODUCER_REGS>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < 32 && n_tiles > 0) {
      // Warp 0: its lane 0 issues the TMA copies (K and V of both consumers,
      // whole boxes past lk zero-filled as well, since dS K reads all 128
      // keys); all 32 lanes copy each tile's lse and D (rows past lq read 0).
      if (lane == 0) {
        mbar_expect_tx(&sm.kv_full, 2 * b1::NC * b1::TILE_BYTES);
        for (int c = 0; c < b1::NC; ++c) {
          tma_load_tile<128>(sm.k[c], &km, &sm.kv_full, h, k0 + BT * c, b, BT);
          tma_load_tile<128>(sm.v[c], &vm, &sm.kv_full, h, k0 + BT * c, b, BT);
        }
      }
      const float* lrow = p.lse + size_t(bh) * p.lq;
      const float* drow = p.dd + size_t(bh) * p.lq;
      int stage = 0, parity = 0;
#pragma unroll 1
      for (int i = 0; i < n_tiles; ++i) {
        const int qt0 = (t0 + i) * BT;
        mbar_wait(&sm.empty[stage], parity ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&sm.full[stage], 2 * b1::TILE_BYTES);
          tma_load_tile<128>(sm.q[stage], &qm, &sm.full[stage], h, qt0, b, BT);
          tma_load_tile<128>(sm.dout[stage], &dom, &sm.full[stage], h, qt0, b, BT);
        }
#pragma unroll
        for (int j = 0; j < BT / 32; ++j) {
          const int r = qt0 + lane + 32 * j;
          const bool ok = r < p.lq;
          cp_async4(&sm.lse[stage][lane + 32 * j], ok ? lrow + r : lrow, ok ? 4 : 0);
          cp_async4(&sm.dd[stage][lane + 32 * j], ok ? drow + r : drow, ok ? 4 : 0);
        }
        cp_async_arrive(&sm.full[stage]);
        if (++stage == b1::STAGES) {
          stage = 0;
          parity ^= 1;
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else if (threadIdx.x == 32 && n_tiles > 0) {
      // The dQ writer: each staged partial added in the key blocks' order,
      // the last block that sees the tile first.
      float* acc = p.dq_acc + size_t(bh) * n_qt * b1::DQ_TILE;
      int* turn = p.dq_turn + size_t(bh) * n_qt;
#pragma unroll 1
      for (int i = 0; i < n_tiles; ++i) {
        const int t = t0 + i;
        const int last = p.causal ? min(int(gridDim.x) - 1,
                                        (p.q_off - p.k_off + t * BT + BT - 1) / b1::BK)
                                  : int(gridDim.x) - 1;
        const int sb = i % b1::DQ_BUFS;
        mbar_wait(&sm.dq_full[sb], (i / b1::DQ_BUFS) & 1);
        while (ld_acquire_gpu(turn + t) != last - kb) {
        }
        fence_proxy_async_global();
        // The first block in the order writes the tile, the others add to it.
        const float* part = reinterpret_cast<const float*>(sm.dq[sb]);
        if (kb == last)
          bulk_copy_s2g(acc + size_t(t) * b1::DQ_TILE, part, b1::DQ_TILE * 4);
        else
          bulk_reduce_add_f32(acc + size_t(t) * b1::DQ_TILE, part, b1::DQ_TILE * 4);
        bulk_commit();
        bulk_wait_all();
        fence_proxy_async_global();
        red_add_release_gpu(turn + t, 1);
        mbar_arrive(&sm.dq_empty[sb]);
      }
    }
  } else {
    setmaxnreg_inc<b1::CONSUMER_REGS>();
    const int c = wg - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int kc = k0 + BT * c;
    float dk[16][4], dv[16][4];
    zero(dk);
    zero(dv);
    if (n_tiles > 0) bwd1_consume(sm, c, kc, t0, n_tiles, p, dk, dv);
    const size_t head = (size_t(b) * p.lk * p.h + h) * 128;
    store_rows(static_cast<OutT*>(p.dk) + head, dk, kc + warp * 16, p.lk, p.h * 128, b1::SCALE,
               lane);
    store_rows(static_cast<OutT*>(p.dv) + head, dv, kc + warp * 16, p.lk, p.h * 128, 1.f, lane);
  }
}

// dq [B, L, H, 128] = scale * the summed partials of flash_bwd_kernel (one
// block a query tile of one head): the tile's fragment order undone through
// shared memory, then each row written in 16-byte pieces.
__device__ __forceinline__ void store8(bf16* dst, const float* x, float mul) {
  uint4 v;
  unsigned* w = reinterpret_cast<unsigned*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = pack_bf16(x[2 * j] * mul, x[2 * j + 1] * mul);
  *reinterpret_cast<uint4*>(dst) = v;
}
__device__ __forceinline__ void store8(float* dst, const float* x, float mul) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0] * mul, x[1] * mul, x[2] * mul, x[3] * mul);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4] * mul, x[5] * mul, x[6] * mul, x[7] * mul);
}

template <typename OutT>
__global__ void __launch_bounds__(256)
flash_bwd_dq_convert_kernel(const float* acc, OutT* dq, int h, int lq, int causal, int q_off,
                            int k_off) {
  constexpr int PITCH = b1::HD + 4;
  __shared__ __align__(16) float tile[BT * PITCH];
  const int t = blockIdx.x, n_qt = gridDim.x, bh = blockIdx.y;
  const int b = bh / h, hh = bh % h;
  const float4* src = reinterpret_cast<const float4*>(acc + (size_t(bh) * n_qt + t) * b1::DQ_TILE);
  // A tile that no key block sees (its rows see no key) was never written.
  const bool seen = !causal || k_off <= q_off + t * BT + BT - 1;
  for (int f = threadIdx.x; f < b1::DQ_TILE / 4; f += 256) {
    const float4 x = seen ? src[f] : make_float4(0.f, 0.f, 0.f, 0.f);
    const int c = f >> 10, nt = (f >> 7) & 7, tid = f & 127;
    const int row = (tid >> 5) * 16 + (tid & 31) / 4, col = BT * c + nt * 8 + (tid & 3) * 2;
    tile[row * PITCH + col] = x.x;
    tile[row * PITCH + col + 1] = x.y;
    tile[(row + 8) * PITCH + col] = x.z;
    tile[(row + 8) * PITCH + col + 1] = x.w;
  }
  __syncthreads();
  for (int seg = threadIdx.x; seg < BT * b1::HD / 8; seg += 256) {
    const int row = seg / 16, col = (seg % 16) * 8;
    const int q = t * BT + row;
    if (q < lq)
      store8(dq + ((size_t(b) * lq + q) * h + hh) * b1::HD + col, tile + row * PITCH + col,
             b1::SCALE);
  }
}

// What every entry point takes: head width 64 or 128 (the widths
// instantiated), non-empty sequences, and a grid that fits (b*h on the
// grid's y axis).
bool args_ok(int b, int h, int lq, int lk, int d) {
  return (d == 64 || d == 128) && b > 0 && h > 0 && lq > 0 && lk > 0 && b * h <= 65535;
}

// A tensor map over a bf16 [b, l, h, hd] tensor read in place (dimensions
// innermost first: hd, h, l, b) whose box is `rows` rows of 64 columns of
// one (batch, head), 128-byte swizzled (a 64-wide bf16 row is one swizzle
// atom; a 128-wide head is loaded as two boxes); rows past l read as zeros.
bool head_map(CUtensorMap* map, const void* base, int b, int l, int h, int hd, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row_bytes = cuuint64_t(hd) * sizeof(bf16);
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(h), cuuint64_t(l), cuuint64_t(b)};
  const cuuint64_t strides[3] = {row_bytes, row_bytes * h, row_bytes * h * l};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Both forward kernels: tensor maps of q (64-row boxes, one per consumer)
// and k, v (BN-row boxes), then one block per BM query rows.
template <int HD, typename Kernel>
int launch_fwd(Kernel kernel, const void* q, const void* k, const void* v, const FwdParams& p,
               int b, cudaStream_t stream) {
  using C = FwdCfg<HD>;
  CUtensorMap qm, km, vm;
  if (!head_map(&qm, q, b, p.lq, p.h, HD, 64) || !head_map(&km, k, b, p.lk, p.h, HD, C::BN) ||
      !head_map(&vm, v, b, p.lk, p.h, HD, C::BN))
    return int(cudaErrorInvalidValue);
  const cudaError_t err = set_smem(kernel, kFwdSmem<HD>);
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3((p.lq + C::BM - 1) / C::BM, b * p.h), C::THREADS, kFwdSmem<HD>, stream>>>(
      qm, km, vm, p);
  return int(cudaGetLastError());
}

template <bool CARRY>
int launch_fwd_width(int d, const void* q, const void* k, const void* v, const FwdParams& p,
                     int b, cudaStream_t stream) {
  if (d == 64)
    return launch_fwd<64>(CARRY ? flash_fwd_carry_kernel<64> : flash_fwd_kernel<64>, q, k, v, p,
                          b, stream);
  return launch_fwd<128>(CARRY ? flash_fwd_carry_kernel<128> : flash_fwd_kernel<128>, q, k, v, p,
                         b, stream);
}

// Both backward kernels: tensor maps of q, k, v and dO (BT-row boxes),
// then one block per DQ_BM query rows or DKDV_BK keys.
template <int HD, typename OutT>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* dd, void* dk, void* dv, void* dq, int b, int h, int lq, int lk,
               int causal, int q_off, int k_off, cudaStream_t stream) {
  using C = BwdCfg<HD>;
  CUtensorMap qm, km, vm, dom;
  if (!head_map(&qm, q, b, lq, h, HD, BT) || !head_map(&km, k, b, lk, h, HD, BT) ||
      !head_map(&vm, v, b, lk, h, HD, BT) || !head_map(&dom, dout, b, lq, h, HD, BT))
    return int(cudaErrorInvalidValue);
  BwdParams p{h, lq, lk, causal, q_off, k_off, lse, dd, dk != nullptr ? dk : dq, dv};
  if (dk != nullptr) {
    auto kernel = flash_bwd_dkdv_kernel<HD, OutT>;
    const cudaError_t err = set_smem(kernel, kDkdvSmem<HD>);
    if (err != cudaSuccess) return int(err);
    kernel<<<dim3((lk + C::DKDV_BK - 1) / C::DKDV_BK, b * h), C::DKDV_THREADS, kDkdvSmem<HD>,
             stream>>>(qm, km, vm, dom, p);
  } else {
    auto kernel = flash_bwd_dq_kernel<HD, OutT>;
    const cudaError_t err = set_smem(kernel, kDqSmem<HD>);
    if (err != cudaSuccess) return int(err);
    kernel<<<dim3((lq + C::DQ_BM - 1) / C::DQ_BM, b * h), C::DQ_THREADS, kDqSmem<HD>, stream>>>(
        qm, km, vm, dom, p);
  }
  return int(cudaGetLastError());
}

template <typename OutT>
int launch_bwd_width(int d, const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* dd, void* dk, void* dv, void* dq, int b,
                     int h, int lq, int lk, int causal, int q_off, int k_off,
                     cudaStream_t stream) {
  if (d != 64) return int(cudaErrorInvalidValue);  // 128: flash_bwd
  return launch_bwd<64, OutT>(q, k, v, dout, lse, dd, dk, dv, dq, b, h, lq, lk, causal, q_off,
                              k_off, stream);
}

// D = rowsum(dO * O) in f32 [B*H, L] from bf16 [B, L, H, d] (the
// backward's row term, XLA in the JAX package): d / 8 lanes a (batch, row,
// head), one 16-byte load of each a lane, so a warp takes 256 / d rows;
// bound by its reads of O and dO.
__global__ void __launch_bounds__(256)
flash_bwd_dd_kernel(const bf16* o, const bf16* dout, float* dd, int l, int h, int d, int rows) {
  const int lanes = d / 8, per_warp = 32 / lanes;
  const int lane = threadIdx.x % 32;
  const int row = (blockIdx.x * 8 + threadIdx.x / 32) * per_warp + lane / lanes;
  float sum = 0.f;
  if (row < rows) {
    const size_t at = size_t(row) * d + (lane % lanes) * 8;
    const uint4 x = *reinterpret_cast<const uint4*>(o + at);
    const uint4 y = *reinterpret_cast<const uint4*>(dout + at);
    const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fx = __bfloat1622float2(xs[e]), fy = __bfloat1622float2(ys[e]);
      sum = fmaf(fx.x, fy.x, sum);
      sum = fmaf(fx.y, fy.y, sum);
    }
  }
  // The row's lanes are neighbours: sum within groups of `lanes`.
  for (int m = lanes / 2; m > 0; m /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (row < rows && lane % lanes == 0) {
    const int hh = row % h, bl = row / h;
    dd[(size_t(bl / l) * h + hh) * l + bl % l] = sum;
  }
}

// The one-pass backward at head width 128 and its dQ pass: tensor maps of
// q, k, v and dO (BT-row boxes), one block per 128 keys, then one per query
// tile.
template <typename OutT>
int launch_bwd1(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* dd, void* dq, void* dk, void* dv, float* dq_acc, int* dq_turn, int b,
                int h, int lq, int lk, int causal, int q_off, int k_off, cudaStream_t stream) {
  CUtensorMap qm, km, vm, dom;
  if (!head_map(&qm, q, b, lq, h, 128, BT) || !head_map(&km, k, b, lk, h, 128, BT) ||
      !head_map(&vm, v, b, lk, h, 128, BT) || !head_map(&dom, dout, b, lq, h, 128, BT))
    return int(cudaErrorInvalidValue);
  const Bwd1Params p{h, lq, lk, causal, q_off, k_off, lse, dd, dk, dv, dq_acc, dq_turn};
  auto kernel = flash_bwd_kernel<OutT>;
  const cudaError_t err = set_smem(kernel, kBwd1Smem);
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3((lk + b1::BK - 1) / b1::BK, b * h), b1::THREADS, kBwd1Smem, stream>>>(qm, km, vm,
                                                                                       dom, p);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return int(launched);
  flash_bwd_dq_convert_kernel<OutT><<<dim3((lq + BT - 1) / BT, b * h), 256, 0, stream>>>(
      dq_acc, static_cast<OutT*>(dq), h, lq, causal, q_off, k_off);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Each returns a cudaError_t (0 on
// success; cudaErrorInvalidValue for arguments args_ok refuses, or when a
// tensor map cannot be encoded). q, dout: bf16 [b, lq, h, d]; k, v: bf16
// [b, lk, h, d]; d 64 or 128; lse, dd: f32 [b*h, lq]; all contiguous and
// 16-byte aligned. out is bf16 like q; dq/dk/dv are bf16, or f32 with out_f32.

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
  return launch_fwd_width<false>(d, q, k, v, p, b, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory a forward block asks for at head width d (both
// forward kernels); 0 for a width not instantiated.
extern "C" int flash_fwd_smem_bytes(int d) {
  return d == 64 ? int(kFwdSmem<64>) : d == 128 ? int(kFwdSmem<128>) : 0;
}

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
  return launch_fwd_width<true>(d, q, k, v, p, b, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* dd, void* dk, void* dv, int b,
                              int h, int lq, int lk, int d, int causal, int q_off, int k_off,
                              int out_f32, void* stream) {
  if (!args_ok(b, h, lq, lk, d)) return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch_bwd_width<float>(d, q, k, v, dout, lse, dd, dk, dv, nullptr, b, h, lq,
                                           lk, causal, q_off, k_off, s)
                 : launch_bwd_width<bf16>(d, q, k, v, dout, lse, dd, dk, dv, nullptr, b, h, lq,
                                          lk, causal, q_off, k_off, s);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* dd, void* dq, int b, int h, int lq,
                            int lk, int d, int causal, int q_off, int k_off, int out_f32,
                            void* stream) {
  if (!args_ok(b, h, lq, lk, d)) return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch_bwd_width<float>(d, q, k, v, dout, lse, dd, nullptr, nullptr, dq, b, h,
                                           lq, lk, causal, q_off, k_off, s)
                 : launch_bwd_width<bf16>(d, q, k, v, dout, lse, dd, nullptr, nullptr, dq, b, h,
                                          lq, lk, causal, q_off, k_off, s);
}

// The one-pass backward (head width 128 only): dq, dk and dv, bf16 or f32
// with out_f32; dq_acc f32 [b*h, ceil(lq/64), 64*128] (scratch) and dq_turn
// int32 [b*h, ceil(lq/64)], zeroed (the call consumes both).
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* dd, void* dq, void* dk, void* dv,
                         float* dq_acc, int* dq_turn, int b, int h, int lq, int lk, int d,
                         int causal, int q_off, int k_off, int out_f32, void* stream) {
  if (!args_ok(b, h, lq, lk, d) || d != 128) return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch_bwd1<float>(q, k, v, dout, lse, dd, dq, dk, dv, dq_acc, dq_turn, b, h,
                                      lq, lk, causal, q_off, k_off, s)
                 : launch_bwd1<bf16>(q, k, v, dout, lse, dd, dq, dk, dv, dq_acc, dq_turn, b, h,
                                     lq, lk, causal, q_off, k_off, s);
}

// D = rowsum(dO * O): o and dout bf16 [b, l, h, d] (d 64 or 128), dd f32
// [b*h, l].
extern "C" int flash_bwd_dd(const void* o, const void* dout, float* dd, int b, int l, int h,
                            int d, void* stream) {
  if (!args_ok(b, h, l, l, d)) return int(cudaErrorInvalidValue);
  const int rows = b * l * h, per_block = 8 * 256 / d;  // 8 warps of 256 / d rows
  flash_bwd_dd_kernel<<<(rows + per_block - 1) / per_block, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), dd, l, h, d, rows);
  return int(cudaGetLastError());
}
