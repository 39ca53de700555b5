// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Built by build.py with nvcc into a shared library and loaded with ctypes;
// kernel.py holds the wrappers and decides which kernel takes a call. Each
// entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns the first CUDA error (cudaGetLastError()
// after the launch) so that a refused launch surfaces in the wrapper.
//
// Both kernels replace src/repro/kernels/flash_attn/kernel.py:
// flash_attention_fwd (body _fwd_kernel): causal or non-causal GQA
// attention with an online softmax. q (b, s, h, d), k (b, s, kvh, d),
// v (b, s, kvh, dv) and the output o (b, s, h, dv) keep that layout in
// device memory; query head hq of batch row bi reads KV head hq / (h / kvh).
// Precision follows the reference kernel step by step: f32 scores of the
// inputs scaled by 1/sqrt(d) (the reference scales q in f32 first; the
// two orders differ by f32 rounding only), masked scores and the initial
// running max at -1e30, probabilities rounded to v's type for the PV
// product but not in the running denominator l, the PV product accumulated
// in f32, and the output acc / max(l, 1e-30) in v's type. Any s is taken:
// keys past s are masked, query rows past s are not written (the
// reference asserts s % block == 0 instead).
//
// Bound on the card: at serving shapes (d = 128, bf16) the FLOPs of the
// two products bound it from s of about 1,000 up (4 h d flops per
// (query, key) pair the mask keeps, at the tensor cores' bf16 peak); below
// that the bytes of q, k, v and o do.
//
// ---------------------------------------------------------------------------
// flash_attn_wgmma_kernel: bf16 with d and dv multiples of 8, at most 256
//   (the serve prefill). Both products run on the tensor cores (wgmma),
//   and every tile arrives by TMA, so the CUDA cores are left with the
//   softmax.
//   - Work split: one CTA per (batch row x query head, 64-row query tile),
//     the tiles of the last (heaviest causal) query rows launched first.
//     Four consumer warps (one warpgroup, wgmma's M of 64) and one
//     producer warp that issues the copies. At llama3.2-3b's heads and
//     s = 512 that is 8 x 24 = 192 CTAs for 132 SMs; at d = 128 a CTA
//     takes 82 KB of shared memory, so two share an SM and one's softmax
//     overlaps the other's products.
//   - Loads: 4-D tensor maps over q, k, v as they lie (no copies), built
//     on the host for each call and passed as __grid_constant__ params.
//     Boxes are 64 rows x 64 columns (128 bytes, the 128-byte swizzle's
//     limit), so a 128-wide head is two boxes. Q is loaded once; K and V
//     tiles of 64 keys go through a two-stage ring with full/empty
//     mbarriers. TMA zero-fills rows past s and columns past d inside a
//     box, so no garbage reaches a product; boxes wholly past d or dv
//     are not loaded.
//   - S = Q K^T: wgmma m64n64k16, both operands K-major from shared
//     memory, f32 accumulators; the scores are scaled in f32.
//   - Online softmax in registers: a row's 64 scores lie in the 4 lanes
//     of a quad (two shuffles per reduction); the causal mask is applied
//     on the diagonal tile only, the key mask on the tile that holds s,
//     and tiles the mask empties are never loaded.
//   - O += P V: P's f32 accumulator fragment is rounded in place into the
//     bf16 A fragment (registers), V is the MN-major B operand from shared
//     memory (the transpose bit); O is rescaled by alpha before.
//   - Heads are padded to 64, 128 or 256 columns (one instance each), the
//     k16 steps past d are skipped, and only the columns below dv are
//     stored.
//   - Tried on the card and no faster (PERF.md, section 6): two consumer
//     warpgroups per CTA sharing each K/V tile, and FlashAttention-3's
//     overlap of one tile's softmax with the previous tile's PV product.
//
// flash_attn_fwd_kernel: f32 (the reference's f32 tolerance of 2e-5 rules
//   out TF32), and bf16 heads whose d or dv is not a multiple of 8.
//   One CTA of four warps per (b*h, 32-row query tile). The scaled query
//   tile is staged in shared memory in f32; the CTA walks 32-key K/V tiles
//   up to the causal limit, skipping the tiles the mask empties as the
//   reference does. Each warp owns 8 query rows. For the scores a lane
//   owns one key of the tile (float4 reads of its K row against broadcast
//   reads of the query rows); the running max and denominator come from
//   warp shuffles; for the PV product a lane owns the output dims
//   lane + 32 i and reads each key's probability by shuffle. Everything
//   runs on the CUDA cores in f32, far above the f32 FLOP bound.
// ---------------------------------------------------------------------------
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

#define FULL_MASK 0xffffffffu

namespace {

constexpr int WARPS = 4;
constexpr int ROWS = 8;             // query rows per warp
constexpr int BQ = WARPS * ROWS;    // query rows per CTA
constexpr int BK = 32;              // keys per K/V tile: one per lane
constexpr int PAD = 4;              // floats of padding per shared row
constexpr float NEG = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as astype does
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL_MASK, x, o);
  return x;
}

// NDIM = ceil(dv / 32) rounded up to a power of two: output dims per lane.
template <typename T, int NDIM>
__global__ void __launch_bounds__(WARPS * 32)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int s,
                      int h, int kvh, int d, int dv, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = d + PAD;
  const int ldv = dv + PAD;
  float* Qs = smem;                 // [BQ][ldq] scaled queries
  float* Ks = Qs + BQ * ldq;        // [BK][ldq]
  float* Vs = Ks + BK * ldq;        // [BK][ldv]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bi = blockIdx.y / h;
  const int hq = blockIdx.y % h;
  const int kh = hq / (h / kvh);
  const int q0 = blockIdx.x * BQ;

  // element strides between consecutive positions of each tensor
  const long q_row = (long)h * d;
  const long k_row = (long)kvh * d;
  const long v_row = (long)kvh * dv;
  const long o_row = (long)h * dv;
  const T* qb = q + (long)bi * s * q_row + (long)hq * d;
  const T* kb = k + (long)bi * s * k_row + (long)kh * d;
  const T* vb = v + (long)bi * s * v_row + (long)kh * dv;
  T* ob = o + (long)bi * s * o_row + (long)hq * dv;

  for (int i = tid; i < BQ * d; i += WARPS * 32) {
    const int r = i / d;
    const int c = i - r * d;
    const int pos = q0 + r;
    Qs[r * ldq + c] = pos < s ? to_f<T>(qb[pos * q_row + c]) * scale : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][NDIM];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NDIM; ++i) acc[r][i] = 0.f;
  }

  int n_tiles = (s + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ + BK - 1) / BK);
  const float* q_rows = Qs + warp * ROWS * ldq;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int i = tid; i < BK * d; i += WARPS * 32) {
      const int r = i / d;
      const int c = i - r * d;
      const int pos = k0 + r;
      Ks[r * ldq + c] = pos < s ? to_f<T>(kb[pos * k_row + c]) : 0.f;
    }
    for (int i = tid; i < BK * dv; i += WARPS * 32) {
      const int r = i / dv;
      const int c = i - r * dv;
      const int pos = k0 + r;
      Vs[r * ldv + c] = pos < s ? to_f<T>(vb[pos * v_row + c]) : 0.f;
    }
    __syncthreads();

    // scores of this lane's key against the warp's rows
    float sc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) sc[r] = 0.f;
    const float* k_lane = Ks + lane * ldq;
    for (int c = 0; c < d; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(k_lane + c);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qq =
            *reinterpret_cast<const float4*>(q_rows + r * ldq + c);
        sc[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }

    // online softmax; sc[r] becomes the probability the PV product reads
    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q0 + warp * ROWS + r;
      const bool keep = kpos < s && (!causal || kpos <= qpos);
      const float x = keep ? sc[r] : NEG;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float p = expf(x - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NDIM; ++i) acc[r][i] *= alpha;
      sc[r] = to_f<T>(from_f<T>(p));
    }

    // PV: this lane's output dims over the tile's keys
    for (int j = 0; j < BK; ++j) {
      const float* v_key = Vs + j * ldv;
      float vv[NDIM];
#pragma unroll
      for (int i = 0; i < NDIM; ++i) {
        const int c = lane + 32 * i;
        vv[i] = c < dv ? v_key[c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pj = __shfl_sync(FULL_MASK, sc[r], j);
#pragma unroll
        for (int i = 0; i < NDIM; ++i) acc[r][i] += pj * vv[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qpos = q0 + warp * ROWS + r;
    if (qpos >= s) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < NDIM; ++i) {
      const int c = lane + 32 * i;
      if (c < dv) ob[qpos * o_row + c] = from_f<T>(acc[r][i] / den);
    }
  }
}

template <typename T, int NDIM>
int launch(const void* q, const void* k, const void* v, void* o, int b, int s,
           int h, int kvh, int d, int dv, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem =
      (size_t)((BQ + BK) * (d + PAD) + BK * (dv + PAD)) * sizeof(float);
  auto kern = flash_attn_fwd_kernel<T, NDIM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + BQ - 1) / BQ, b * h);
  kern<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, h, kvh, d, dv, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int s, int h, int kvh, int d, int dv, float scale, int causal,
             cudaStream_t st) {
  if (dv <= 32) return launch<T, 1>(q, k, v, o, b, s, h, kvh, d, dv, scale, causal, st);
  if (dv <= 64) return launch<T, 2>(q, k, v, o, b, s, h, kvh, d, dv, scale, causal, st);
  if (dv <= 128) return launch<T, 4>(q, k, v, o, b, s, h, kvh, d, dv, scale, causal, st);
  return launch<T, 8>(q, k, v, o, b, s, h, kvh, d, dv, scale, causal, st);
}

}  // namespace

// ---------------------------------------------------------------------------
// flash_attn_wgmma_kernel (design in the note at the top)
// ---------------------------------------------------------------------------
namespace wg {

constexpr int BQ = 64;                   // query rows per CTA: wgmma's M
constexpr int BK = 64;                   // keys per K/V tile
constexpr int STAGES = 2;                // depth of the K/V ring
constexpr int CONSUMERS = 128;           // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int CHUNK = 64;                // bf16 columns of one 128-byte box
constexpr int BOX = 64 * 128;            // bytes of one box: 64 rows (BQ, BK)
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

static_assert(BQ == 64 && BK == 64, "boxes and descriptors assume 64 rows");

// Shared memory of one CTA for heads padded to P columns: Q, then STAGES x
// (K, V), each P / 64 boxes, then the barriers (q, full[], empty[]).
template <int P>
struct Smem {
  static constexpr int kChunks = P / CHUNK;
  static constexpr int kTile = kChunks * BOX;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kBars = kTile + STAGES * kStage;
  static constexpr int kBytes = 1024 + kBars + 8 * (1 + 2 * STAGES);
};

template <int P, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_attn_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        __nv_bfloat16* __restrict__ o, int s, int h, int kvh,
                        int d, int dv, float scale_log2, int causal) {
  using L = Smem<P>;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align every box to it
  const uint32_t base = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;
  const uint32_t skv = base + L::kTile;  // stage i: K at skv + i kStage, V after
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_full = bar_q + 8;                // + 8 i
  const uint32_t bar_empty = bar_full + 8 * STAGES;   // + 8 i

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / h;
  const int hq = blockIdx.x % h;
  const int kh = hq / (h / kvh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  int n_tiles = (s + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ + BK - 1) / BK);
  const int qk_chunks = (d + CHUNK - 1) / CHUNK;   // boxes that hold data
  const int v_chunks = (dv + CHUNK - 1) / CHUNK;

  if (tid == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(bar_full + 8 * i, 1);
      hopper::mbar_init(bar_empty + 8 * i, CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one lane issues every copy
    if (tid == CONSUMERS) {
      hopper::mbar_arrive_expect_tx(bar_q, qk_chunks * BOX);
      for (int c = 0; c < qk_chunks; ++c)
        hopper::tma_load_4d(sq + c * BOX, &tm_q, bar_q, c * CHUNK, hq, q0, bi);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        const uint32_t full = bar_full + 8 * st;
        const uint32_t sk = skv + st * L::kStage;
        hopper::mbar_wait(bar_empty + 8 * st, ((t / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(full, (qk_chunks + v_chunks) * BOX);
        for (int c = 0; c < qk_chunks; ++c)
          hopper::tma_load_4d(sk + c * BOX, &tm_k, full, c * CHUNK, kh,
                              t * BK, bi);
        for (int c = 0; c < v_chunks; ++c)
          hopper::tma_load_4d(sk + L::kTile + c * BOX, &tm_v, full,
                              c * CHUNK, kh, t * BK, bi);
      }
    }
    return;
  }

  // ---- the consumer warpgroup ----
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r_lo = warp * 16 + (lane >> 2);  // this thread's rows: r_lo, +8
  const int c_in = 2 * (lane & 3);           // its columns in each 8-block
  const int k_steps = (d + 15) / 16;         // k16 steps of S that see data

  float acc[P / 2];
#pragma unroll
  for (int i = 0; i < P / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  hopper::mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    const uint32_t sk = skv + st * L::kStage;
    const uint32_t sv = sk + L::kTile;
    hopper::mbar_wait(bar_full + 8 * st, (t / STAGES) & 1);

    // S = Q K^T (f32)
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < P / 16; ++kc) {
      if (kc < k_steps) {
        const uint32_t off = (kc / 4) * BOX + (kc % 4) * 32;
        hopper::wgmma_ss(sc, hopper::smem_desc(sq + off, 16, 1024),
                         hopper::smem_desc(sk + off, 16, 1024), 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(sc);

    // masks: the causal one on the diagonal tile, the key one past s
    const int k0 = t * BK;
    if (k0 + BK > s || (causal && k0 + BK - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int row = q0 + r_lo + 8 * ((i >> 1) & 1);
        const int col = k0 + 8 * (i >> 2) + c_in + (i & 1);
        if (col >= s || (causal && col > row)) sc[i] = NEG;
      }
    }

    // online softmax; sc becomes p (f32), summed unrounded into l
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], shift[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * scale_log2);
      shift[r] = mx[r] * scale_log2;
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = exp2f(fmaf(sc[i], scale_log2, -shift[r]));
      rs[r] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int i = 0; i < P / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V: P rounded to bf16 in place as the A fragment
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kk][j] = hopper::pack_bf16x2(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
      hopper::fence_regs(pa[kk]);
    }
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::wgmma_rs(acc, pa[kk],
                       hopper::smem_desc(sv + kk * 16 * 128, BOX, 1024), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(bar_empty + 8 * st);  // this stage may be refilled
  }

  // epilogue: acc / max(l, 1e-30) in bf16, rows below s, columns below dv
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
  }
  const long o_row = (long)h * dv;
  __nv_bfloat16* ob = o + (long)bi * s * o_row + (long)hq * dv;
#pragma unroll
  for (int i = 0; i < P / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int row = q0 + r_lo + 8 * r;
    const int col = 8 * (i >> 2) + c_in;
    if (row < s && col < dv)
      *reinterpret_cast<__nv_bfloat162*>(ob + row * o_row + col) =
          __floats2bfloat162_rn(acc[i] / den[r], acc[i + 1] / den[r]);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry point), found through the
// runtime so that the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map over a contiguous bf16 (b, s, heads, width) tensor, in boxes
// of 64 positions x 64 columns of one head, 128-byte swizzled.
bool make_map(CUtensorMap* map, const void* ptr, int b, int s, int heads,
              int width) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t row = (cuuint64_t)width * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {row, row * heads, row * heads * s};
  const cuuint32_t box[4] = {CHUNK, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int P, int MIN_BLOCKS>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           void* o, int b, int s, int h, int kvh, int d, int dv,
           float scale_log2, int causal, cudaStream_t stream) {
  const int smem = Smem<P>::kBytes;
  auto kern = flash_attn_wgmma_kernel<P, MIN_BLOCKS>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * h, (s + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(tq, tk, tv,
                                        static_cast<__nv_bfloat16*>(o), s, h,
                                        kvh, d, dv, scale_log2, causal);
  return (int)cudaGetLastError();
}

}  // namespace wg

extern "C" {

// q, k, v, o: device pointers of contiguous (b, s, h|kvh, d|dv) tensors,
// all float32 (is_bf16 = 0) or all bfloat16 (is_bf16 = 1). The wrapper
// checks d, dv in [4, 256] and multiples of 4, h % kvh == 0, b*h <= 65535.
int fa_forward(const void* q, const void* k, const void* v, void* o, int b,
               int s, int h, int kvh, int d, int dv, float scale, int causal,
               int is_bf16, void* stream) {
  if (d <= 0 || d > 256 || d % 4 || dv <= 0 || dv > 256 || dv % 4 ||
      kvh <= 0 || h % kvh)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0 || h == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, b, s, h, kvh, d, dv, scale,
                                   causal, st);
  return dispatch<float>(q, k, v, o, b, s, h, kvh, d, dv, scale, causal, st);
}

// The tensor-core kernel. q, k, v, o: device pointers of contiguous
// bfloat16 (b, s, h|kvh, d|dv) tensors, each 16-byte aligned. The wrapper
// checks d, dv in [8, 256] and multiples of 8, h % kvh == 0, and
// ceil(s / 64) <= 65535. Returns cudaErrorInvalidValue where
// cuTensorMapEncodeTiled refuses a tensor map.
int fa_forward_wgmma(const void* q, const void* k, const void* v, void* o,
                     int b, int s, int h, int kvh, int d, int dv, float scale,
                     int causal, void* stream) {
  if (d < 8 || d > 256 || d % 8 || dv < 8 || dv > 256 || dv % 8 ||
      kvh <= 0 || h % kvh || (s + wg::BQ - 1) / wg::BQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0 || h == 0) return 0;
  CUtensorMap tq, tk, tv;
  if (!wg::make_map(&tq, q, b, s, h, d) || !wg::make_map(&tk, k, b, s, kvh, d) ||
      !wg::make_map(&tv, v, b, s, kvh, dv))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = 2^(x log2 e)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int p = d > dv ? d : dv;
  if (p <= 64)
    return wg::launch<64, 3>(tq, tk, tv, o, b, s, h, kvh, d, dv, scale_log2,
                             causal, st);
  if (p <= 128)
    return wg::launch<128, 2>(tq, tk, tv, o, b, s, h, kvh, d, dv, scale_log2,
                              causal, st);
  return wg::launch<256, 1>(tq, tk, tv, o, b, s, h, kvh, d, dv, scale_log2,
                            causal, st);
}

}  // extern "C"
