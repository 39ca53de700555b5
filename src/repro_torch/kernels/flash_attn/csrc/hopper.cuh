// Hopper (sm_90a) building blocks in inline PTX: mbarriers, TMA tensor
// loads, the same boxes loaded by a warp without TMA, shared-memory matrix
// descriptors and warpgroup MMAs (wgmma). Included by flash_attn.cu;
// nothing here launches or allocates.
//
// Layout contract shared by the TMA boxes and the wgmma descriptors: every
// operand tile in shared memory is a stack of 64-element (128-byte) column
// chunks, each chunk `rows` x 128 B, written by one TMA box with the
// 128-byte swizzle and starting on a 1024-byte boundary. `load_boxes`
// writes the same boxes with threads, for rows TMA cannot take. bf16 and
// f16 share all of it (64 2-byte elements a chunk, 32 bytes a k16 step):
// the wgmma pieces below take either as their template parameter T, which
// names the MMA's input type and how a pair of f32 is rounded.
//
// Its tf32 twin: the same stack of 128-byte chunks, but a chunk is 32 f32
// columns, and a k8 step of a tf32 wgmma is 8 columns, again 32 bytes, so
// the descriptors and the start-address step are the bf16 ones. Element
// (row r, column c) of a chunk lies at byte r * 128 + (((c / 4) ^ (r % 8))
// * 16) + (c % 4) * 4: the 16-byte unit is XORed with the row's place in
// its 1024-byte group. A tile that threads write themselves (the kernel's
// transposed V) follows the same rule, so TMA and threads share one layout.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA -------------------------------------------------------------------
// Copies the box at coordinates (c0, c1, c2, c3) (innermost first) of a
// 4-D tensor map into shared memory at `dst`; completion is counted in
// bytes on `bar`. Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ---- the same boxes without TMA --------------------------------------------
// A granule of G bytes (2, 4 or 8) at p if `pred`, else zeros: one
// predicated ld.global.nc, no branch, nothing read when pred is false.
template <int G>
struct Granule;
template <>
struct Granule<2> {
  uint16_t v;
  __device__ __forceinline__ void load(const uint8_t* p, bool pred) {
    asm("{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\nmov.b16 %0, 0;\n"
        "@q ld.global.nc.u16 %0, [%1];\n}\n"
        : "=h"(v) : "l"(p), "r"((int)pred));
  }
};
template <>
struct Granule<4> {
  uint32_t v;
  __device__ __forceinline__ void load(const uint8_t* p, bool pred) {
    asm("{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\nmov.b32 %0, 0;\n"
        "@q ld.global.nc.u32 %0, [%1];\n}\n"
        : "=r"(v) : "l"(p), "r"((int)pred));
  }
};
template <>
struct Granule<8> {
  uint2 v;
  __device__ __forceinline__ void load(const uint8_t* p, bool pred) {
    asm("{\n.reg .pred q;\nsetp.ne.b32 q, %3, 0;\nmov.b32 %0, 0;\n"
        "mov.b32 %1, 0;\n@q ld.global.nc.v2.u32 {%0, %1}, [%2];\n}\n"
        : "=r"(v.x), "=r"(v.y) : "l"(p), "r"((int)pred));
  }
};

// One 16-byte unit of a box from its granules.
__device__ __forceinline__ uint4 pack_unit(const Granule<2> (&g)[8]) {
  return make_uint4(g[0].v | (uint32_t)g[1].v << 16,
                    g[2].v | (uint32_t)g[3].v << 16,
                    g[4].v | (uint32_t)g[5].v << 16,
                    g[6].v | (uint32_t)g[7].v << 16);
}
__device__ __forceinline__ uint4 pack_unit(const Granule<4> (&g)[4]) {
  return make_uint4(g[0].v, g[1].v, g[2].v, g[3].v);
}
__device__ __forceinline__ uint4 pack_unit(const Granule<8> (&g)[2]) {
  return make_uint4(g[0].v.x, g[0].v.y, g[1].v.x, g[1].v.y);
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 x) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w)
               : "memory");
}

// One box of the TMA layout to be written by threads: ROWS_BOX rows of
// 128 bytes, 128-byte swizzled (16-byte unit u of row r at `dst` + r * 128
// + ((u ^ (r % 8)) * 16)), from one head of a (b, s, heads, width) tensor
// as it lies. Row r of the box is position r0 + r, unit u holds bytes 16 u
// .. 16 u + 15 of the row from column c0 on; `src` points at (r0, c0),
// `ld` bytes separate two positions, and the first `rows` (>= 1)
// positions and `bytes` (>= 1) bytes from (r0, c0) hold data. The rest of
// the box is zeros, as TMA fills what lies outside a tensor.
struct Box {
  uint32_t dst;
  const uint8_t* src;
  long ld;
  int rows, bytes;
};

// A tensor map needs every global stride to be a multiple of 16 bytes, and
// a head's row is width x element size bytes. Where it is not, the 32
// lanes of a warp write NB boxes (a K box and a V box together) as TMA
// would have, in granules of G bytes: the largest power of two (2, 4 or 8)
// that divides every row's length and every tensor's address, so a granule
// is aligned and lies wholly inside or wholly outside a row's data (a bf16
// row of odd width starts on a 2-byte boundary: G = 2). A box row's units
// that may hold data (16 u < bytes) are rounded up to a power of two, du,
// and spread over the 32 lanes, B a lane at a time for each box; each lane
// issues all its predicated granule loads (rows past `rows` and granules
// past `bytes` read nothing and give zeros) before it uses the first, and
// calls ready() once, after the first loads and before the first store,
// so the round trip to L2 overlaps the wait for the buffer to be free.
// Each unit is stored whole (one 16-byte st.shared). With `zero_rest` the
// units from du to the box edge are zeroed too: once a buffer, since they
// stay zero until something else writes the buffer. The caller orders the
// stores before an async-proxy read (fence_proxy_async) and publishes them
// (an mbarrier arrival).
template <int G, int ROWS_BOX, int NB, typename Ready>
__device__ __forceinline__ void load_boxes(const Box (&bx)[NB],
                                           bool zero_rest, int lane,
                                           Ready ready) {
  constexpr int NG = 16 / G;              // granules of a unit
  constexpr int B = NG > 4 ? 2 : 4;       // units of a box a lane holds
  int lg[NB], n[NB], steps = 0;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int du = (bx[b].bytes + 15) >> 4;
    lg[b] = du > 4 ? 3 : du > 2 ? 2 : du > 1 ? 1 : 0;
    n[b] = ROWS_BOX << lg[b];
    steps = max(steps, (n[b] + 32 * B - 1) / (32 * B));
  }
  for (int k = 0; k < steps; ++k) {
    Granule<G> x[NB][B][NG];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int j = 0; j < B; ++j) {
        const int i = 32 * (B * k + j) + lane;
        const int r = i >> lg[b], c0 = (i & ((1 << lg[b]) - 1)) << 4;
        const bool row = i < n[b] && r < bx[b].rows;
        const uint8_t* p = bx[b].src + r * bx[b].ld + c0;
#pragma unroll
        for (int g = 0; g < NG; ++g)
          x[b][j][g].load(p + g * G, row && c0 + g * G < bx[b].bytes);
      }
    }
    if (k == 0) ready();
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int j = 0; j < B; ++j) {
        const int i = 32 * (B * k + j) + lane;
        const int r = i >> lg[b], u = i & ((1 << lg[b]) - 1);
        if (i < n[b])
          st_shared_v4(bx[b].dst + r * 128 + ((u ^ (r & 7)) << 4),
                       pack_unit(x[b][j]));
      }
    }
  }
  if (zero_rest) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      for (int i = lane; i < ROWS_BOX * 8; i += 32) {
        const int r = i >> 3, u = i & 7;
        if (u >= 1 << lg[b])
          st_shared_v4(bx[b].dst + r * 128 + ((u ^ (r & 7)) << 4),
                       make_uint4(0, 0, 0, 0));
      }
    }
  }
}

// Nothing to wait for (load_boxes' `ready`).
struct NoWait {
  __device__ __forceinline__ void operator()() const {}
};

// A granule size as a type, for a generic lambda's template argument.
template <int N>
struct Int {
  static constexpr int value = N;
};

// ---- wgmma -----------------------------------------------------------------
// Shared-memory matrix descriptor of a 128-byte-swizzled operand.
// K-major (rows of K contiguous): `lbo` is unused and `sbo` = 1024 B, the
// step between 8-row groups; the start address moves by 32 B per k16
// step inside a 128-byte chunk. MN-major (the transpose bit): `lbo` is the
// step between 64-element chunks along MN and `sbo` = 1024 B the step
// between 8-row groups along K.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);  // layout type 1: 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Returns once at most N of this warp's committed wgmma groups are pending
// (groups complete in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving register traffic across a wgmma boundary.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Whether T (__nv_bfloat16 or __half) is f16: the wgmma's input type.
template <typename T>
__host__ __device__ constexpr bool is_f16() {
  return false;
}
template <>
__host__ __device__ constexpr bool is_f16<__half>() {
  return true;
}

// Two f32 values as the T pair of one A-fragment register (lo first),
// rounded to nearest even.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (is_f16<T>()) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// The "+f" operands of an accumulator fragment d[I] .. d[I + 7], and of
// the 32, 64 and 128 registers of an m64n64, m64n128 and m64n256 result.
#define HOPPER_ACC8(d, I)                                                  \
  "+f"(d[I]), "+f"(d[I + 1]), "+f"(d[I + 2]), "+f"(d[I + 3]),              \
      "+f"(d[I + 4]), "+f"(d[I + 5]), "+f"(d[I + 6]), "+f"(d[I + 7])
#define HOPPER_ACC32(d, I)                                                 \
  HOPPER_ACC8(d, I), HOPPER_ACC8(d, I + 8), HOPPER_ACC8(d, I + 16),        \
      HOPPER_ACC8(d, I + 24)
#define HOPPER_ACC64(d) HOPPER_ACC32(d, 0), HOPPER_ACC32(d, 32)
#define HOPPER_ACC128(d)                                                   \
  HOPPER_ACC32(d, 0), HOPPER_ACC32(d, 32), HOPPER_ACC32(d, 64),            \
      HOPPER_ACC32(d, 96)

// Accumulator fragment of an m64nN f32 result, thread t of the warpgroup
// (warp w = t / 32, lane l): register i holds row 16 w + l / 4 + 8 ((i / 2)
// % 2), column 8 (i / 4) + 2 (l % 4) + i % 2. So registers 8k..8k+7
// (columns 16k..16k+15), packed pairwise, are the A fragment of the k-th
// k16 slice of the same 64-row tile: FlashAttention-3's in-place P.

// The k16 MMAs of T (bf16 or f16) with an f32 accumulator, each asm
// statement spelled once for either type (TY: "bf16" or "f16").
#define HOPPER_WGMMA_SS_N64(TY)                                            \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                             \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                           \
      "%24, %25, %26, %27, %28, %29, %30, %31"                             \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                   \
      : HOPPER_ACC32(d, 0)                                                 \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))
#define HOPPER_WGMMA_RS_N64(TY)                                            \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                             \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                           \
      "%24, %25, %26, %27, %28, %29, %30, %31"                             \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                     \
      : HOPPER_ACC32(d, 0)                                                 \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),           \
        "r"(scale_d))
#define HOPPER_WGMMA_RS_N128(TY)                                           \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"        \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                             \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                           \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                           \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                           \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                           \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                           \
      "%56, %57, %58, %59, %60, %61, %62, %63"                             \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                     \
      : HOPPER_ACC64(d)                                                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),           \
        "r"(scale_d))
#define HOPPER_WGMMA_RS_N256(TY)                                           \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"        \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                             \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                           \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                           \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                           \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                           \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                           \
      "%56, %57, %58, %59, %60, %61, %62, %63, "                           \
      "%64, %65, %66, %67, %68, %69, %70, %71, "                           \
      "%72, %73, %74, %75, %76, %77, %78, %79, "                           \
      "%80, %81, %82, %83, %84, %85, %86, %87, "                           \
      "%88, %89, %90, %91, %92, %93, %94, %95, "                           \
      "%96, %97, %98, %99, %100, %101, %102, %103, "                       \
      "%104, %105, %106, %107, %108, %109, %110, %111, "                   \
      "%112, %113, %114, %115, %116, %117, %118, %119, "                   \
      "%120, %121, %122, %123, %124, %125, %126, %127"                     \
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                \
      : HOPPER_ACC128(d)                                                   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),           \
        "r"(scale_d))

// D (64 x 64, f32) (+)= A (64 x 16, T, shared, K-major) * B^T
// (B: 64 x 16, T, shared, K-major). scale_d = 0 overwrites D.
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  if constexpr (is_f16<T>())
    HOPPER_WGMMA_SS_N64("f16");
  else
    HOPPER_WGMMA_SS_N64("bf16");
}

// D (64 x 64, f32) (+)= A (64 x 16, T, registers) * B (16 x 64, T,
// shared, MN-major: the transpose bit).
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  if constexpr (is_f16<T>())
    HOPPER_WGMMA_RS_N64("f16");
  else
    HOPPER_WGMMA_RS_N64("bf16");
}

// D (64 x 128, f32) (+)= A (64 x 16, T, registers) * B (16 x 128, T,
// shared, MN-major: the transpose bit).
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  if constexpr (is_f16<T>())
    HOPPER_WGMMA_RS_N128("f16");
  else
    HOPPER_WGMMA_RS_N128("bf16");
}

// D (64 x 256, f32) (+)= A (64 x 16, T, registers) * B (16 x 256, T,
// shared, MN-major: the transpose bit).
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  if constexpr (is_f16<T>())
    HOPPER_WGMMA_RS_N256("f16");
  else
    HOPPER_WGMMA_RS_N256("bf16");
}

// ---- tf32 ------------------------------------------------------------------
// x rounded to tf32 (10 mantissa bits, to nearest, ties away from zero) as
// an f32 whose low 13 bits are zero.
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// x as a tf32 wgmma reads an f32 operand on an H100: its low 13 bits
// dropped (measured: an f32 passed as it is multiplies as this, not as
// tf32_round(x)).
__device__ __forceinline__ float tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & ~0x1FFFu);
}

// The small part of an f32 operand passed as it is: x - tf32_trunc(x)
// (exact), rounded to tf32.
__device__ __forceinline__ float tf32_lo(float x) {
  return tf32_round(x - tf32_trunc(x));
}

// Raises (inc) or lowers (dec) the registers of each thread of this
// warpgroup to N, for the code that follows: every thread of the
// warpgroup runs it.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Named barrier `id` over `threads` threads (a warpgroup without the
// producer warp; barrier 0 is __syncthreads).
__device__ __forceinline__ void bar_sync(uint32_t id, uint32_t threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrives at named barrier `id` without waiting (the threads that wait
// there with bar_sync count these arrivals among `threads`).
__device__ __forceinline__ void bar_arrive(uint32_t id, uint32_t threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Orders this thread's shared-memory writes (generic proxy) before later
// reads and writes of the async proxy: wgmma operands, TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// tf32 wgmma has no transpose bit: both operands are K-major. The A
// fragment of an m64k8 tf32 slice, thread t of the warpgroup (warp w =
// t / 32, lane l): registers 0..3 hold (row, column) (16 w + l / 4, l % 4),
// (+8, l % 4), (16 w + l / 4, l % 4 + 4), (+8, l % 4 + 4).

// D (64 x 64, f32) (+)= A (64 x 8, tf32, shared, K-major) * B^T
// (B: 64 x 8, tf32, shared, K-major). scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 32, f32) (+)= A (64 x 8, tf32, shared, K-major) * B^T
// (B: 32 x 8, tf32, shared, K-major).
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, f32) (+)= A (64 x 8, tf32, registers) * B^T (B: 64 x 8, tf32,
// shared, K-major).
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

}  // namespace hopper
