// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Built by build.py with nvcc into a shared library and loaded with ctypes;
// kernel.py holds the wrapper. The entry point launches on the caller's
// stream, does not synchronise, allocates nothing, and returns the first
// CUDA error (cudaGetLastError() after the launch) so that a refused launch
// surfaces in the wrapper.
//
// ---------------------------------------------------------------------------
// flash_attn_fwd_kernel
//   Replaces src/repro/kernels/flash_attn/kernel.py:flash_attention_fwd
//   (body _fwd_kernel): causal or non-causal GQA attention with an online
//   softmax. q (b, s, h, d), k (b, s, kvh, d), v (b, s, kvh, dv) and the
//   output o (b, s, h, dv) keep that layout in device memory; query head
//   hq of batch row bi reads KV head hq / (h / kvh).
//   Precision follows the reference kernel step by step: q is scaled in
//   f32, scores are f32, masked scores and the initial running max are
//   -1e30, the probabilities are rounded to v's type before the PV
//   product (but not in the running denominator l), the PV product is
//   accumulated in f32, and the output is acc / max(l, 1e-30) in v's type.
//   Any s is taken: keys past s are masked, query rows past s are not
//   written (the reference asserts s % block == 0 instead).
//   Bound on the card: at serving shapes (d = 128) the FLOPs of the two
//   products bound it from s of about 1,000 up (4 h d flops per
//   (query, key) pair the mask keeps, at the tensor cores' bf16 peak);
//   below that the bytes of q, k, v and o do.
//   Design (simple first): one CTA of four warps per (b*h, 32-row query
//   tile). The scaled query tile is staged in shared memory in f32; the
//   CTA walks 32-key K/V tiles up to the causal limit, skipping the tiles
//   the mask empties as the reference does. Each warp owns 8 query rows.
//   For the scores a lane owns one key of the tile (float4 reads of its K
//   row against broadcast reads of the query rows); the running max and
//   denominator come from warp shuffles; for the PV product a lane owns
//   the output dims lane + 32 i and reads each key's probability by
//   shuffle. Everything runs on the CUDA cores in f32, so the kernel sits
//   far above the tensor-core bound: wgmma, TMA and warp specialisation
//   are later work.
// ---------------------------------------------------------------------------
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // extern "C"
