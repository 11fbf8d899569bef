// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA copies and their tensor maps, clusters (multicast copies, remote
// arrives), named barriers and wgmma, as inline PTX.
// Included by flash_attention.cu and fused_xent.cu; ops/_build.py hashes it
// with each source, so an edited header rebuilds both libraries.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// --------------------------------------------- mbarriers, TMA, named barriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// Make the initialised barriers visible to the async proxy (TMA) and the block.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// One box of a 2-D or 4-D tensor map (coordinates innermost first) -> dst;
// the bytes land on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
// --------------------------------------------------------------- clusters
// A cluster's blocks run on neighbouring SMs and reach each other's shared
// memory: one TMA copy can land in all of them (multicast), and a thread can
// arrive on a partner's mbarrier. Every block of a cluster runs
// cluster_sync() after its barriers are initialised (so no copy or remote
// arrive finds an uninitialised barrier) and again before it exits (so none
// lands in a block that has left).

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of every block of the cluster, converged or not.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}
// Arrive on the mbarrier at `bar`'s offset in block `rank` of the cluster
// (this block's own included). The default semantics, release at CTA
// scope: a consumer arrives after wgmma.wait_group, when its reads of the
// stage are complete, not just ordered. (Release at cluster scope made the
// dw/db kernel slower than with no cluster at all.)
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, unsigned rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(rank)
      : "memory");
}
// One box of a 2-D tensor map into `dst` of every block in `mask` (bit i:
// cluster rank i), each block's bytes landing on its own mbarrier at
// `bar`'s offset: each receiver expects the whole box's bytes.
__device__ __forceinline__ void tma_load_multicast(void* dst, const CUtensorMap* map,
                                                   uint64_t* bar, int c0, int c1,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// Four floats into `dst`'s offset in block `rank` of the cluster, their 16
// bytes completing a transaction on the mbarrier at `bar`'s offset there:
// the receiver arms that barrier with the bytes it expects
// (mbar_expect_tx) and waits on it, as for a TMA copy, which makes the
// stores visible to it.
__device__ __forceinline__ void st_async_cluster(void* dst, uint64_t* bar, unsigned rank,
                                                 float a, float b, float c, float d) {
  asm volatile(
      "{\n"
      ".reg .b32 rdst, rbar;\n"
      "mapa.shared::cluster.u32 rdst, %0, %2;\n"
      "mapa.shared::cluster.u32 rbar, %1, %2;\n"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [rdst], "
      "{%3, %4, %5, %6}, [rbar];\n"
      "}\n" ::"r"(smem_u32(dst)),
      "r"(smem_u32(bar)), "r"(rank), "f"(a), "f"(b), "f"(c), "f"(d)
      : "memory");
}

// Named barriers over two consumer warpgroups (256 threads); id 0 is
// __syncthreads'.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
// Shared-memory stores made by threads, visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Hand registers back (producer) or take them (consumers): warp-specialised
// blocks of one producer warpgroup and a few consumers.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N) : "memory");
}

// -------------------------------------------------------------------- wgmma

// Descriptor of a 128-byte-swizzled operand in shared memory (TMA writes
// that layout from 64-wide bf16 boxes): rows of 128 bytes, 8-row groups
// 1024 bytes apart (SBO). K-major (a row holds 64 k values): a 16-wide k
// step adds 32 bytes to the start (+2 here). MN-major (a row holds 64 m or
// n values, one row per k): a 16-deep k step adds 2048 bytes (+128). LBO,
// the stride between 64-wide MN atoms, matters only for an MN-major operand
// wider than 64: the second form sets it.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
// The same with LBO, the stride between 64-wide MN atoms of an MN-major
// operand wider than 64.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, unsigned lbo_bytes) {
  return (sw128_desc(p) & ~(uint64_t(0x3FFF) << 16)) | (uint64_t(lbo_bytes >> 4) << 16);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across a wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[i][e])::"memory");
}
// The same for register A operands, which wgmma reads until its group completes.
template <int N>
__device__ __forceinline__ void fence_regs(unsigned (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

#define ACC4(d, i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])

// s[64 x 128] (+)= A[64 x 16] . B[16 x 128], A K-major and B K-major
// (TRANS_B 0: B[128 x 16]^T) or MN-major (TRANS_B 1), both in shared memory;
// `accumulate` 0 overwrites s. s[nt][e] is the mma.sync C layout of n-tile
// nt for this warp's 16 rows.
template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&s)[16][4], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : ACC4(s, 0), ACC4(s, 1), ACC4(s, 2), ACC4(s, 3), ACC4(s, 4), ACC4(s, 5), ACC4(s, 6),
        ACC4(s, 7), ACC4(s, 8), ACC4(s, 9), ACC4(s, 10), ACC4(s, 11), ACC4(s, 12),
        ACC4(s, 13), ACC4(s, 14), ACC4(s, 15)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// s[64 x 64] (+)= A[64 x 16] . B[16 x 64], A K-major and B K-major
// (TRANS_B 0) or MN-major (TRANS_B 1), both in shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&s)[8][4], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : ACC4(s, 0), ACC4(s, 1), ACC4(s, 2), ACC4(s, 3), ACC4(s, 4), ACC4(s, 5), ACC4(s, 6),
        ACC4(s, 7)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// s[64 x 256] (+)= A[64 x 16] . B[16 x 256], A K-major (TRANS_A 0) or
// MN-major (TRANS_A 1: one 64-wide atom, a row of 64 m values per k) and B
// K-major (TRANS_B 0) or MN-major (TRANS_B 1, 64-wide MN atoms LBO apart),
// both in shared memory.
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&s)[32][4], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
      "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : ACC4(s, 0), ACC4(s, 1), ACC4(s, 2), ACC4(s, 3), ACC4(s, 4), ACC4(s, 5), ACC4(s, 6),
        ACC4(s, 7), ACC4(s, 8), ACC4(s, 9), ACC4(s, 10), ACC4(s, 11), ACC4(s, 12),
        ACC4(s, 13), ACC4(s, 14), ACC4(s, 15), ACC4(s, 16), ACC4(s, 17), ACC4(s, 18),
        ACC4(s, 19), ACC4(s, 20), ACC4(s, 21), ACC4(s, 22), ACC4(s, 23), ACC4(s, 24),
        ACC4(s, 25), ACC4(s, 26), ACC4(s, 27), ACC4(s, 28), ACC4(s, 29), ACC4(s, 30),
        ACC4(s, 31)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
}

// s[64 x 192] (+)= A[64 x 16] . B[16 x 192]: wgmma_m64n256k16_ss at N = 192.
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n192k16_ss(float (&s)[24][4], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n"
      "}\n"
      : ACC4(s, 0), ACC4(s, 1), ACC4(s, 2), ACC4(s, 3), ACC4(s, 4), ACC4(s, 5), ACC4(s, 6),
        ACC4(s, 7), ACC4(s, 8), ACC4(s, 9), ACC4(s, 10), ACC4(s, 11), ACC4(s, 12),
        ACC4(s, 13), ACC4(s, 14), ACC4(s, 15), ACC4(s, 16), ACC4(s, 17), ACC4(s, 18),
        ACC4(s, 19), ACC4(s, 20), ACC4(s, 21), ACC4(s, 22), ACC4(s, 23)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
}

// The product of a consumer's [64 x 64 HC] accumulator, HC = 3 or 4: one
// overload per width.
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_wide_ss(float (&s)[32][4], uint64_t da, uint64_t db,
                                              int accumulate) {
  wgmma_m64n256k16_ss<TRANS_B, TRANS_A>(s, da, db, accumulate);
}
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_wide_ss(float (&s)[24][4], uint64_t da, uint64_t db,
                                              int accumulate) {
  wgmma_m64n192k16_ss<TRANS_B, TRANS_A>(s, da, db, accumulate);
}

// o[64 x 64] (+)= A[64 x 16] . B[16 x 64], A as bf16 fragments in
// registers (the mma.sync A layout per warp), B in shared memory MN-major
// (TRANS_B 1: V in P . V) or K-major (TRANS_B 0: B[64 x 16]^T);
// `accumulate` 0 overwrites o.
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&o)[8][4], const unsigned (&a)[4],
                                                   uint64_t db, int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : ACC4(o, 0), ACC4(o, 1), ACC4(o, 2), ACC4(o, 3), ACC4(o, 4), ACC4(o, 5), ACC4(o, 6),
        ACC4(o, 7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// o[64 x 128] += A[64 x 16] . B[16 x 128], A as bf16 register fragments, B
// in shared memory MN-major: two 64-wide MN atoms, LBO apart (the
// descriptor's second form), as the flash kernels store a 128-wide head.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&o)[16][4], const unsigned (&a)[4],
                                                    uint64_t db, int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : ACC4(o, 0), ACC4(o, 1), ACC4(o, 2), ACC4(o, 3), ACC4(o, 4), ACC4(o, 5), ACC4(o, 6),
        ACC4(o, 7), ACC4(o, 8), ACC4(o, 9), ACC4(o, 10), ACC4(o, 11), ACC4(o, 12),
        ACC4(o, 13), ACC4(o, 14), ACC4(o, 15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

#undef ACC4

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------- tensor maps

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

// cuTensorMapEncodeTiled is a driver call; it is fetched through the runtime
// so that the library needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A tensor map over a row-major bf16 matrix [rows, cols] (row stride
// `cols` elements, a multiple of 8) whose box is `box_rows` rows of 64
// columns, 128-byte swizzled; entries past either edge read as zeros.
inline bool matrix_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || cols % 8 != 0) return false;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * 2};
  const cuuint32_t box[2] = {64, cuuint32_t(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
