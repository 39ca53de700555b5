// Flash-hash counting-table kernels for Hopper (sm_90a), plain C interface.
//
// Built by build.py with nvcc into a shared library and loaded with ctypes;
// kernel.py holds the wrappers. Every entry point launches on the caller's
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so that a refused launch surfaces in the wrapper.
//
// Table layout (shared with the reference package): the data segment is
// (n_b, r) int32 keys and counts, EMPTY = -1 marks a free slot (count 0);
// filter rows are (n_b, fw) 32-bit words of a per-block Bloom filter with
// k = 2 probes. A key's home slot is (key * mult) & (r - 1); probing walks
// cyclically inside the block.
//
// ---------------------------------------------------------------------------
// merge_dirty_kernel
//   Replaces src/repro/kernels/flash_hash/kernel.py:merge_dirty (body
//   _merge_kernel); merge (kernel.py:merge) is the same kernel over the
//   identity block list.
//   Bound on the card: bytes. Each listed tile (keys, counts, filter row)
//   is read once and written once, plus the update rows in and the spill
//   rows out. The fold itself is serial per block: insertion order fixes
//   the slot layout, so updates cannot be applied in parallel. That serial
//   chain (shared-memory probe, ballot, one-lane write per update) is the
//   latency the design accepts.
//   Design: one CTA of one warp per listed block. The tile and filter row
//   are staged in shared memory; each update is resolved by the warp
//   walking 32-slot windows from home with __ballot_sync, so the first set
//   bit is the smallest cyclic distance holding the key or EMPTY (the
//   reference's min over d_match and d_empty). Lane 0 applies it. A CTA
//   whose row carries no valid key writes no tile, which keeps a repeated
//   padding id harmless; the wrapper refuses a repeated id that carries
//   updates, since two CTAs would race on one tile.
//
// query_grid_kernel
//   Replaces kernel.py:query_grid (body _query_kernel); kernel.py:query is
//   a reshaping wrapper over it.
//   Bound on the card: bytes, one tile read per grid row plus the query
//   lanes in and two int32 results out per lane.
//   Design: one CTA of four warps per row stages its block's tile in
//   shared memory once; each warp answers lanes with the same 32-slot
//   ballot walk.
//
// filter_probe_kernel
//   Replaces kernel.py:filter_probe_grid (body _filter_probe_kernel).
//   Bound on the card: bytes, the query lanes in and one mask word out per
//   lane; the two filter words per lane mostly hit in L1/L2.
//   Design: one thread per (row, lane), elementwise.
// ---------------------------------------------------------------------------
#include <cuda_runtime.h>
#include <stdint.h>

#define EMPTY_KEY (-1)
#define FULL_MASK 0xffffffffu

namespace {

__device__ __forceinline__ uint32_t bloom_mix(int key) {
  uint32_t h = (uint32_t)key;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Smallest cyclic distance d from home at which the tile holds `key` or
// EMPTY, found by the calling warp; -1 if the block has neither.
__device__ __forceinline__ int probe_warp(const int* s_keys, int r, int key,
                                          uint32_t home, int lane) {
  const int rmask = r - 1;
  for (int w = 0; w < r; w += 32) {
    bool pred = false;
    if (w + lane < r) {
      int kk = s_keys[(home + w + lane) & rmask];
      pred = (kk == key) || (kk == EMPTY_KEY);
    }
    unsigned bal = __ballot_sync(FULL_MASK, pred);
    if (bal) return w + __ffs(bal) - 1;
  }
  return -1;
}

__global__ void merge_dirty_kernel(const int* __restrict__ blocks,
                                   int* keys, int* counts, uint32_t* filt,
                                   const int* __restrict__ uk,
                                   const int* __restrict__ uc,
                                   int* __restrict__ sk, int* __restrict__ sc,
                                   int r_log2, int fw, int fbits_log2,
                                   int max_u, uint32_t mult) {
  extern __shared__ int smem[];
  const int r = 1 << r_log2;
  const int rmask = r - 1;
  int* s_keys = smem;
  int* s_counts = smem + r;
  uint32_t* s_filt = reinterpret_cast<uint32_t*>(smem + 2 * r);
  const int lane = threadIdx.x;
  const size_t row = blockIdx.x;
  const int* urow_k = uk + row * max_u;
  const int* urow_c = uc + row * max_u;
  int* srow_k = sk + row * max_u;
  int* srow_c = sc + row * max_u;

  int any = 0;
  for (int j = lane; j < max_u; j += 32) any |= (urow_k[j] != EMPTY_KEY);
  if (!__any_sync(FULL_MASK, any)) {
    for (int j = lane; j < max_u; j += 32) {
      srow_k[j] = EMPTY_KEY;
      srow_c[j] = 0;
    }
    return;
  }

  const size_t b = (size_t)blocks[row];
  int* tk = keys + b * r;
  int* tc = counts + b * r;
  uint32_t* tf = filt + b * fw;
  for (int i = lane; i < r; i += 32) {
    s_keys[i] = tk[i];
    s_counts[i] = tc[i];
  }
  for (int i = lane; i < fw; i += 32) s_filt[i] = tf[i];
  __syncwarp();

  const uint32_t fmask = (1u << fbits_log2) - 1u;
  int n_spill = 0;
  for (int base = 0; base < max_u; base += 32) {
    const int mine = base + lane;
    const int my_k = mine < max_u ? urow_k[mine] : EMPTY_KEY;
    const int my_c = mine < max_u ? urow_c[mine] : 0;
    const int n = min(32, max_u - base);
    for (int t = 0; t < n; ++t) {
      const int k = __shfl_sync(FULL_MASK, my_k, t);
      const int c = __shfl_sync(FULL_MASK, my_c, t);
      if (k == EMPTY_KEY) continue;                 // warp-uniform
      const uint32_t home = ((uint32_t)k * mult) & (uint32_t)rmask;
      const int d = probe_warp(s_keys, r, k, home, lane);
      if (lane == 0) {
        if (d >= 0) {
          const int slot = (int)((home + (uint32_t)d) & (uint32_t)rmask);
          if (s_keys[slot] == EMPTY_KEY) s_keys[slot] = k;
          s_counts[slot] = (int)((uint32_t)s_counts[slot] + (uint32_t)c);
        } else {
          srow_k[n_spill] = k;
          srow_c[n_spill] = c;
        }
        const uint32_t h = bloom_mix(k);
        const uint32_t p0 = h & fmask;
        const uint32_t p1 = (h >> fbits_log2) & fmask;
        s_filt[p0 >> 5] |= 1u << (p0 & 31u);
        s_filt[p1 >> 5] |= 1u << (p1 & 31u);
      }
      n_spill += (d < 0);                           // warp-uniform
      __syncwarp();
    }
  }
  for (int j = n_spill + lane; j < max_u; j += 32) {
    srow_k[j] = EMPTY_KEY;
    srow_c[j] = 0;
  }
  for (int i = lane; i < r; i += 32) {
    tk[i] = s_keys[i];
    tc[i] = s_counts[i];
  }
  for (int i = lane; i < fw; i += 32) tf[i] = s_filt[i];
}

__global__ void query_grid_kernel(const int* __restrict__ keys,
                                  const int* __restrict__ counts,
                                  const int* __restrict__ blocks,
                                  const int* __restrict__ q2,
                                  int* __restrict__ out_cnt,
                                  int* __restrict__ out_dist,
                                  int r_log2, int qcap, uint32_t mult) {
  extern __shared__ int smem[];
  const int r = 1 << r_log2;
  const int rmask = r - 1;
  int* s_keys = smem;
  int* s_counts = smem + r;
  const size_t row = blockIdx.x;
  const size_t b = (size_t)blocks[row];
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    s_keys[i] = keys[b * r + i];
    s_counts[i] = counts[b * r + i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int j = warp; j < qcap; j += n_warps) {
    const int k = q2[row * qcap + j];
    const uint32_t home = ((uint32_t)k * mult) & (uint32_t)rmask;
    const int d = probe_warp(s_keys, r, k, home, lane);
    if (lane == 0) {
      int cnt = 0;
      int dist = r;                       // neither key nor EMPTY: r slots
      if (d >= 0) {
        const int slot = (int)((home + (uint32_t)d) & (uint32_t)rmask);
        if (k != EMPTY_KEY && s_keys[slot] == k) cnt = s_counts[slot];
        dist = d + 1;
      }
      out_cnt[row * qcap + j] = cnt;
      out_dist[row * qcap + j] = dist;
    }
  }
}

__global__ void filter_probe_kernel(const uint32_t* __restrict__ filt,
                                    const int* __restrict__ blocks,
                                    const int* __restrict__ q2,
                                    int* __restrict__ may, long long n,
                                    int qcap, int fw, int fbits_log2) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int k = q2[idx];
  const size_t b = (size_t)blocks[idx / qcap];
  const uint32_t* f = filt + b * fw;
  const uint32_t fmask = (1u << fbits_log2) - 1u;
  const uint32_t h = bloom_mix(k);
  const uint32_t p0 = h & fmask;
  const uint32_t p1 = (h >> fbits_log2) & fmask;
  const uint32_t hit = (f[p0 >> 5] >> (p0 & 31u)) & (f[p1 >> 5] >> (p1 & 31u)) & 1u;
  may[idx] = (k != EMPTY_KEY) && hit;
}

int fbits_for(int fw) {
  int bits = 0;
  while ((1 << (bits + 1)) <= fw * 32) ++bits;
  return bits;
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

int fh_merge_dirty(const void* blocks, int n_d, void* keys, void* counts,
                   void* filt, int r_log2, int fw, const void* uk,
                   const void* uc, int max_u, void* sk, void* sc,
                   unsigned int mult, void* stream) {
  const size_t smem = ((size_t)2 * (1 << r_log2) + fw) * sizeof(int);
  cudaError_t err = allow_smem((const void*)merge_dirty_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  merge_dirty_kernel<<<n_d, 32, smem, (cudaStream_t)stream>>>(
      (const int*)blocks, (int*)keys, (int*)counts, (uint32_t*)filt,
      (const int*)uk, (const int*)uc, (int*)sk, (int*)sc, r_log2, fw,
      fbits_for(fw), max_u, mult);
  return (int)cudaGetLastError();
}

int fh_query_grid(const void* keys, const void* counts, const void* blocks,
                  const void* q2, void* out_cnt, void* out_dist, int n_rows,
                  int r_log2, int qcap, unsigned int mult, void* stream) {
  const size_t smem = (size_t)2 * (1 << r_log2) * sizeof(int);
  cudaError_t err = allow_smem((const void*)query_grid_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  query_grid_kernel<<<n_rows, 128, smem, (cudaStream_t)stream>>>(
      (const int*)keys, (const int*)counts, (const int*)blocks,
      (const int*)q2, (int*)out_cnt, (int*)out_dist, r_log2, qcap, mult);
  return (int)cudaGetLastError();
}

int fh_filter_probe_grid(const void* filt, const void* blocks, const void* q2,
                         void* may, int n_rows, int qcap, int fw,
                         void* stream) {
  const long long n = (long long)n_rows * qcap;
  const int threads = 256;
  const long long grid = (n + threads - 1) / threads;
  filter_probe_kernel<<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)filt, (const int*)blocks, (const int*)q2, (int*)may, n,
      qcap, fw, fbits_for(fw));
  return (int)cudaGetLastError();
}

}  // extern "C"
