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
//   rows out.
//   Why a parallel fold keeps insertion order: only where each *new* key
//   lands depends on the order of a row's updates.
//   - Slots are never freed, so the slots from a key's home up to the
//     tile's first EMPTY at or after it (its window in the tile as it was
//     before the merge) stay as they are for the whole fold. A key found
//     in that window is found there by the serial fold too, whatever is
//     inserted meanwhile.
//   - A repeat of a key inserted earlier in the row finds that key's slot:
//     when it was inserted, every slot between its home and that slot was
//     already taken. A repeat of a spilled key spills too: a full tile
//     stays full.
//   - Count adds (uint32, wrapping) and filter ORs commute.
//   So only the keys absent from their window need a pass in update
//   order. For such a key the serial probe walks on from the window's end
//   (the tile's first EMPTY) over slots that later inserts filled, to the
//   first slot still free: it takes that slot, unless it meets itself on
//   the way (a repeat of a key inserted earlier in the row, or, in a tile
//   the fold did not build, a key of the tile past an EMPTY). Taking a
//   slot changes that walk only for a later key that wanted the same
//   slot, so one warp places the new keys among 32 updates at once: each
//   lane finds the first free slot in a bitmap of the free slots as it
//   stands and scans the slots between for its key, __match_any_sync
//   finds lanes that want a slot an earlier lane wants, the lanes before
//   the first such clash are final (they insert and take their slots),
//   and the rest look again. Rows whose new keys crowd one run of the
//   tile take more rounds; a round always settles at least one key.
//   Design: one CTA of 4 warps per listed row. Its tile, filter row and
//   update row arrive in shared memory by 1-D bulk copies on an mbarrier;
//   an array whose row size or base address is not a multiple of 16 bytes
//   is loaded with plain coalesced loads instead (the kernel decides from
//   its arguments). A persistent grid (as many CTAs as fit, striding over
//   the rows with a two-stage ring, so that row i+1 loads while row i
//   folds) was slower on the H100 in every case measured (PERF.md): the
//   card hides each CTA's loads behind the other CTAs on its SM and hands
//   rows to SMs as they free up, where a fixed stride leaves the CTAs that
//   drew long rows running alone at the end.
//   Block widths r from 8 (two int4 groups) to 8192 (a new key's first
//   free slot is packed into 14 bits of its class); the entry point
//   refuses others with cudaErrorInvalidValue.
//   Per row, in chunks of at most 1024 updates:
//   1. a bitmap of the tile's EMPTY slots, ceil(r / 32) words;
//   2. every valid update classified in parallel: its window scanned four
//      slots a step (int4 loads), giving "present at slot s" or "new";
//   3. warp 0 places the new keys as above (a repeat of a new key takes
//      the placement of its first occurrence, which a shared-memory hash
//      keeping each key's smallest update index names), adds their counts
//      at their slots (an insert adds to the slot's count, as the serial
//      fold does) and compacts the spills in update order (ballot + popc),
//      while the other warps add the counts of present keys, OR both Bloom
//      bits of every valid update, spills included, into the filter row,
//      and check whether every key of the tile lies in its window (warp 0
//      waits for that on a named barrier only when it needs it);
//   4. the tile and filter row go back only if the row held a valid key,
//      which keeps a repeated padding id harmless (the wrapper refuses a
//      repeated id that carries updates: two CTAs would race on a tile).
//
// merge_dirty_serial_kernel
//   The kernel merge_dirty_kernel replaced, kept as the in-turn "before"
//   of kernels/flash_hash/check.py; no path launches it. One CTA of one
//   warp per listed block folds the row's updates one at a time: the warp
//   walks 32-slot windows from home with __ballot_sync (the first set bit
//   is the reference's min over d_match and d_empty) and lane 0 applies
//   the update in shared memory.
//
// query_grid_kernel
//   Replaces kernel.py:query_grid (body _query_kernel); kernel.py:query is
//   a reshaping wrapper over it.
//   Bound on the card: bytes, but of sectors, not tiles. A lane needs the
//   32-byte sectors of its window (home to the slot holding the key or the
//   first EMPTY; one or two at the loads the tables run at) and, on a
//   hit, the sector of one count; the query lanes come in and two int32
//   results per lane go out. The lookup path hands it 1,024 rows of 128
//   lanes that hold one or two live keys each (one row per queried
//   block, the rest EMPTY padding), so a design that reads whole tiles
//   reads some 256 sectors a row to answer one key. Each thread waits on
//   three dependent loads (its key, the window, the count), so at these
//   sizes latency, not bandwidth, sets the time.
//   Design: probe in place, one thread per lane, a row's lanes in
//   consecutive threads (CTAs of 128 threads, grid.y strides over rows),
//   so a warp shares one tile and the EMPTY lanes of a row, which all
//   walk from EMPTY's home, hit in L1 after the first. A thread walks its
//   window from home in aligned sectors, two 16-byte read-only loads of
//   8 keys each (slots before home masked off in the first sector,
//   wrapping at r) and stops at the first slot holding its key or EMPTY;
//   a hit loads one count (loading the home sector's counts beside its
//   keys was faster at the path's layout cold but slower warm and on
//   dense rows, and was dropped).
//   No shared memory, no barrier, so it takes any block width. The answer
//   is the plain version's on every lane: d + 1 on stopping at distance
//   d, r when the tile holds neither the key nor EMPTY, count 0 unless
//   the slot holds the key (an EMPTY key stops at the first EMPTY). Tiles
//   whose base is not 16-byte aligned, and blocks under 8 slots, walk
//   slot by slot (the entry point picks from its arguments).
//
// query_grid_staged_kernel
//   The kernel query_grid_kernel replaced, kept as the in-turn "before"
//   of kernels/flash_hash/check.py; no path launches it. One CTA of four
//   warps per row stages the block's whole tile (keys and counts) in
//   shared memory, as the TPU kernel's BlockSpec fetches a whole row into
//   VMEM; each warp answers a lane at a time with a 32-slot ballot walk.
//
// filter_probe_kernel
//   Replaces kernel.py:filter_probe_grid (body _filter_probe_kernel).
//   Bound on the card: bytes, the query lanes in and one mask word out per
//   lane; the two filter words a lane tests mostly hit in L1/L2. At the
//   lookup path's 1,024 x 128 lanes it is latency that sets the time:
//   each lane waits on its key and block id, then on its filter words.
//   A plain copy of the lanes (may.copy_(q2): one load, one store) is the
//   floor, and this kernel runs within 1.17x of it on the H100 (PERF.md),
//   so it stays as first written.
//   Design: one thread per (row, lane), elementwise, both filter words
//   loaded at once. A 2-D grid with read-only loads timed the same; four
//   lanes a thread by 16-byte loads and stores, loading the second word
//   only when the first bit is set, skipping the loads of EMPTY lanes and
//   CTAs of 128 threads were each slower on the H100 at that layout
//   (PERF.md). An EMPTY lane answers 0.
// ---------------------------------------------------------------------------
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "bulk_copy.cuh"

#define EMPTY_KEY (-1)
#define FULL_MASK 0xffffffffu
// CTA size of the query kernel, the faster of 128 and 256 at the lookup
// path's layout on the H100 (PERF.md)
#define QUERY_THREADS 128

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

__global__ void merge_dirty_serial_kernel(const int* __restrict__ blocks,
                                          int* keys, int* counts,
                                          uint32_t* filt,
                                          const int* __restrict__ uk,
                                          const int* __restrict__ uc,
                                          int* __restrict__ sk,
                                          int* __restrict__ sc, int r_log2,
                                          int fw, int fbits_log2, int max_u,
                                          uint32_t mult) {
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

// ---- merge_dirty_kernel ----------------------------------------------------
constexpr int MERGE_THREADS = 128;
constexpr int MERGE_WARPS = MERGE_THREADS / 32;
// most updates of a row folded per pass; longer rows fold in chunks, each
// against the tile the chunks before it left
constexpr int MERGE_CHUNK = 1024;
// s_cls of an EMPTY update; a new key's s_cls packs its first free slot
// from home (f0, or -1) and its slot in the hash of new keys
constexpr int CLS_INVALID = INT_MIN;
constexpr int CLS_F0_BITS = 14;             // f0 + 1 <= 8192
// a placement is a slot, the slot | PLACE_FOUND of a tile key met past an
// EMPTY, or -1 (a spill); the hash entry of a placed key holds
// PLACED | (placement + 1) instead of its smallest update index
constexpr int PLACE_FOUND = 1 << 14;
constexpr int PLACED = 1 << 30;

struct MergeArgs {
  const int* blocks;
  int* keys;
  int* counts;
  uint32_t* filt;
  const int* uk;
  const int* uc;
  int* sk;
  int* sc;
  int r_log2, fw, fbits_log2, max_u, chunk, hash_log2;
  uint32_t mult;
  int bulk_tile, bulk_filt, bulk_upd;   // arrays staged by bulk copies
};

// Shared memory of one CTA, in ints: the row's (keys, counts, filter row,
// update keys, update counts), then each update's class, the hash of new
// keys, the free bitmap, its summary (one bit per word that holds a free
// slot) and its copy as the chunk found it, 8 scalars and an 8-byte
// mbarrier.
struct MergeSmem {
  int r, fwp, up, hs, nwp, bw;
  __host__ __device__ MergeSmem(const MergeArgs& a)
      : r(1 << a.r_log2), fwp((a.fw + 3) & ~3), up((a.chunk + 3) & ~3),
        hs(1 << a.hash_log2), nwp((((r + 31) >> 5) + 3) & ~3),
        bw(nwp + ((((r + 1023) >> 10) + 3) & ~3)) {}
  __host__ __device__ int work() const { return 2 * r + fwp + 2 * up; }
  __host__ __device__ int misc() const { return work() + up + hs + 2 * bw; }
  __host__ __device__ size_t bytes() const {
    return (size_t)(misc() + 8) * sizeof(int) + sizeof(uint64_t);
  }
};

__device__ __forceinline__ uint32_t home_of(int key, uint32_t mult,
                                            uint32_t rmask) {
  return ((uint32_t)key * mult) & rmask;
}

// First slot at or after h (cyclically) whose bit is set in the bitmap
// `fr` of `nwords` words; -1 if none.
__device__ __forceinline__ int first_free(const uint32_t* fr, int nwords,
                                          uint32_t h) {
  int w = (int)(h >> 5);
  uint32_t bits = fr[w] & (FULL_MASK << (h & 31u));
  for (int i = 0; i < nwords; ++i) {
    if (bits) return (w << 5) + __ffs(bits) - 1;
    w = (w + 1 == nwords) ? 0 : w + 1;
    bits = fr[w];
  }
  bits &= (1u << (h & 31u)) - 1u;           // the start word's low part
  return bits ? (w << 5) + __ffs(bits) - 1 : -1;
}

// The same, reading past an empty home word only the words a summary
// `sum` names: bit w is set when word w holds a free slot, or held one (a
// word emptied since is skipped and its bit cleared), so the search stays
// short however few slots are free.
__device__ __forceinline__ int first_free_sum(const uint32_t* fr,
                                              uint32_t* sum, int nwords,
                                              uint32_t h) {
  const int w0 = (int)(h >> 5);
  const uint32_t b0 = h & 31u;
  uint32_t bits = fr[w0] & (FULL_MASK << b0);
  if (bits) return (w0 << 5) + __ffs(bits) - 1;
  for (int pass = 0; pass < 2; ++pass) {    // words after w0, then to w0
    const int lo = pass ? 0 : w0 + 1;
    const int hi = pass ? w0 + 1 : nwords;
    for (int sw = lo >> 5; (sw << 5) < hi; ++sw) {
      uint32_t m = sum[sw];
      if ((sw << 5) < lo) m &= FULL_MASK << (lo & 31);
      if (((sw + 1) << 5) > hi) m &= (1u << (hi & 31)) - 1u;
      for (; m; m &= m - 1u) {
        const int w = (sw << 5) + __ffs(m) - 1;
        bits = w == w0 ? fr[w] & ((1u << b0) - 1u) : fr[w];
        if (bits) return (w << 5) + __ffs(bits) - 1;
        if (fr[w] == 0u) atomicAnd(&sum[sw], ~(1u << (w & 31)));
      }
    }
  }
  return -1;
}

// Smallest cyclic distance d < len from h at which the tile holds `key`,
// reading four slots a step; -1 if none. r >= 8.
__device__ __forceinline__ int scan_window(const int* s_keys, uint32_t rmask,
                                           uint32_t h, int len, int key) {
  const int4* v = reinterpret_cast<const int4*>(s_keys);
  const uint32_t gmask = rmask >> 2;
  const int off = (int)(h & 3u);
  const int n_groups = (off + len + 3) >> 2;
  for (int i = 0; i < n_groups; ++i) {
    const int4 q = v[((h >> 2) + (uint32_t)i) & gmask];
    const int d0 = 4 * i - off;             // distance of q.x
    // a slot counts in the visit whose distance range holds it
    int best = -1;
    if (q.w == key && d0 + 3 >= 0 && d0 + 3 < len) best = d0 + 3;
    if (q.z == key && d0 + 2 >= 0 && d0 + 2 < len) best = d0 + 2;
    if (q.y == key && d0 + 1 >= 0 && d0 + 1 < len) best = d0 + 1;
    if (q.x == key && d0 >= 0 && d0 < len) best = d0;
    if (best >= 0) return best;
  }
  return -1;
}

// Barrier `id` (1..15; __syncthreads uses 0) over `n` threads: sync waits,
// arrive does not.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void copy_ints(int* dst, const int* src, int n,
                                          bool vec) {
  if (vec) {
    int4* d = reinterpret_cast<int4*>(dst);
    const int4* s = reinterpret_cast<const int4*>(src);
    for (int i = threadIdx.x; i < n / 4; i += MERGE_THREADS) d[i] = s[i];
  } else {
    for (int i = threadIdx.x; i < n; i += MERGE_THREADS) dst[i] = src[i];
  }
}

// Thread 0: arm the barrier and start the bulk copies of row `row` into
// `stage`.
__device__ void stage_row(const MergeArgs& a, const MergeSmem& L, int* stage,
                          uint32_t bar, int row) {
  const size_t b = (size_t)a.blocks[row];
  const int r = L.r;
  const int n0 = min(a.max_u, a.chunk);
  uint32_t bytes = 0;
  if (a.bulk_tile) bytes += 2u * r * 4u;
  if (a.bulk_filt) bytes += (uint32_t)a.fw * 4u;
  if (a.bulk_upd) bytes += 2u * n0 * 4u;
  bulk::mbar_arrive_expect_tx(bar, bytes);
  if (a.bulk_tile) {
    bulk::copy_to_smem(stage, a.keys + b * r, r * 4u, bar);
    bulk::copy_to_smem(stage + r, a.counts + b * r, r * 4u, bar);
  }
  if (a.bulk_filt)
    bulk::copy_to_smem(stage + 2 * r, a.filt + b * a.fw, a.fw * 4u, bar);
  if (a.bulk_upd) {
    const size_t u = (size_t)row * a.max_u;
    bulk::copy_to_smem(stage + 2 * r + L.fwp, a.uk + u, n0 * 4u, bar);
    bulk::copy_to_smem(stage + 2 * r + L.fwp + L.up, a.uc + u, n0 * 4u, bar);
  }
}

__global__ void __launch_bounds__(MERGE_THREADS, 8)
    merge_dirty_kernel(const MergeArgs a) {
  extern __shared__ __align__(16) int smem[];
  const MergeSmem L(a);
  const int r = L.r;
  const uint32_t rmask = (uint32_t)r - 1u;
  const int nwords = (r + 31) >> 5;
  const uint32_t fmask = (1u << a.fbits_log2) - 1u;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t hmask = (uint32_t)L.hs - 1u;
  // per update: present at slot (>= 0), new (-1 - (hash slot << 14 |
  // f0 + 1)) or CLS_INVALID
  int* s_cls = smem + L.work();
  int* s_hash = s_cls + L.up;       // new keys: smallest update index
  uint32_t* s_free = reinterpret_cast<uint32_t*>(s_hash + L.hs);
  uint32_t* s_sum = s_free + L.nwp;
  uint32_t* s_free0 = s_free + L.bw;
  int* s_misc = smem + L.misc();    // n_free, n_used, n_spill, irregular
  const uint32_t bar = bulk::smem_addr(s_misc + 8);
  const int row = blockIdx.x;

  if (tid == 0) {
    bulk::mbar_init(bar, 1);
    bulk::fence_barrier_init();
    stage_row(a, L, smem, bar, row);
  }
  __syncthreads();

  int* t_keys = smem;
  int* t_counts = t_keys + r;
  uint32_t* t_filt = reinterpret_cast<uint32_t*>(t_counts + r);
  int* t_uk = t_keys + 2 * r + L.fwp;
  int* t_uc = t_uk + L.up;
  const size_t b = (size_t)a.blocks[row];
  int* g_keys = a.keys + b * r;
  int* g_counts = a.counts + b * r;
  uint32_t* g_filt = a.filt + b * a.fw;
  const int* g_uk = a.uk + (size_t)row * a.max_u;
  const int* g_uc = a.uc + (size_t)row * a.max_u;
  int* g_sk = a.sk + (size_t)row * a.max_u;
  int* g_sc = a.sc + (size_t)row * a.max_u;

  bulk::mbar_wait(bar, 0);
  if (!a.bulk_tile) {
    copy_ints(t_keys, g_keys, r, false);
    copy_ints(t_counts, g_counts, r, false);
  }
  if (!a.bulk_filt)
    copy_ints(reinterpret_cast<int*>(t_filt),
              reinterpret_cast<const int*>(g_filt), a.fw, false);
  int row_any = 0;
  int n_spill = 0;                        // warp 0's running spill count

  for (int c0 = 0; c0 < a.max_u; c0 += a.chunk) {
    const int n = min(a.chunk, a.max_u - c0);
    if (c0 > 0) __syncthreads();          // the last chunk's reads done
    if (c0 > 0 || !a.bulk_upd) {
      copy_ints(t_uk, g_uk + c0, n, false);
      copy_ints(t_uc, g_uc + c0, n, false);
    }
    if (tid == 0) s_misc[0] = s_misc[1] = s_misc[3] = 0;
    __syncthreads();

    // 1. free bitmap of the tile as it stands; the chunk's used length;
    //    the hash cleared
    for (int w = warp; w < nwords; w += MERGE_WARPS) {
      const int i = 32 * w + lane;
      const unsigned bal =
          __ballot_sync(FULL_MASK, i < r && t_keys[i] == EMPTY_KEY);
      if (lane == 0) {
        s_free[w] = s_free0[w] = bal;
        if (bal) atomicAdd(&s_misc[0], __popc(bal));
      }
    }
    for (int i = tid; i < L.hs; i += MERGE_THREADS) s_hash[i] = -1;
    int used = 0;                         // past this chunk's last key
    for (int j = tid; j < n; j += MERGE_THREADS)
      if (t_uk[j] != EMPTY_KEY) used = j + 1;
    if (used) atomicMax(&s_misc[1], used);
    if (!__syncthreads_or(used)) continue;
    row_any = 1;
    const int n_free = s_misc[0];
    const int n_used = s_misc[1];

    // 2. classify every update against the tile as it stands; new keys
    //    into the hash, which keeps each key's smallest update index
    for (int j = tid; j < n_used; j += MERGE_THREADS) {
      const int key = t_uk[j];
      int cls = CLS_INVALID;
      if (key != EMPTY_KEY) {
        const uint32_t h = home_of(key, a.mult, rmask);
        const int f0 = n_free ? first_free(s_free, nwords, h) : -1;
        const int len = f0 < 0 ? r : (int)(((uint32_t)f0 - h) & rmask);
        const int d = scan_window(t_keys, rmask, h, len, key);
        if (d >= 0) {
          cls = (int)((h + (uint32_t)d) & rmask);
        } else {
          uint32_t p = bloom_mix(key) & hmask;
          for (;;) {
            const int old = atomicCAS(&s_hash[p], -1, j);
            if (old == -1) break;
            if (t_uk[old] == key) {
              atomicMin(&s_hash[p], j);
              break;
            }
            p = (p + 1u) & hmask;
          }
          cls = -1 - (int)((p << CLS_F0_BITS) | (uint32_t)(f0 + 1));
        }
      }
      s_cls[j] = cls;
    }
    __syncthreads();

    // 3. warp 0 places the first occurrence of each new key, those among
    //    32 updates at a time: each lane takes the first free slot from
    //    its key's home in the bitmap as it stands (in a tile with a key
    //    past an EMPTY, unless it meets its key on the way there).
    //    Taking a slot changes only the answer of a later key that
    //    wanted that same slot, so the keys before the first such clash
    //    are final; the rest look again. A repeat takes its first
    //    occurrence's placement. Then warp 0 adds the new keys' counts
    //    and compacts the spills in update order, while the other warps
    //    add present keys' counts, OR every valid key's Bloom bits and
    //    check whether every key of the tile as the chunk found it lies
    //    in its window (barrier 1 hands that to warp 0, which waits for
    //    it only once a key's first free slot moved past its window).
    if (warp == 0) {
      int left = n_free;
      bool checked = false, irregular = false;
      for (int sw = 0; 32 * sw < nwords; ++sw) {
        const int w = 32 * sw + lane;
        const unsigned bal =
            __ballot_sync(FULL_MASK, w < nwords && s_free[w] != 0u);
        if (lane == 0) s_sum[sw] = bal;
      }
      __syncwarp();
      for (int base = 0; base < n_used; base += 32) {
        const int j = base + lane;
        const int cls = j < n_used ? s_cls[j] : CLS_INVALID;
        const bool is_new = cls < 0 && cls != CLS_INVALID;
        const uint32_t packed = is_new ? (uint32_t)(-1 - cls) : 0u;
        const int f0 = (int)(packed & ((1u << CLS_F0_BITS) - 1u)) - 1;
        const int hp = (int)(packed >> CLS_F0_BITS);
        const int key = is_new ? t_uk[j] : EMPTY_KEY;
        const uint32_t h = home_of(key, a.mult, rmask);
        unsigned todo = __ballot_sync(FULL_MASK, is_new && s_hash[hp] == j);
        while (todo) {
          const bool active = (todo >> lane) & 1u;
          const int cand =
              active && left ? first_free_sum(s_free, s_sum, nwords, h) : -1;
          int place = cand;
          const bool moved = active && f0 >= 0 && cand != f0;
          if (!checked && __any_sync(FULL_MASK, moved)) {
            named_sync(1, MERGE_THREADS);
            checked = true;
            irregular = s_misc[3] != 0;
          }
          if (moved && irregular) {
            const int lo = (int)(((uint32_t)f0 - h) & rmask);
            const int hi =
                cand < 0 ? r : (int)(((uint32_t)cand - h) & rmask);
            const int d =
                scan_window(t_keys, rmask, h + (uint32_t)lo, hi - lo, key);
            if (d >= 0)
              place = (int)((h + (uint32_t)(lo + d)) & rmask) | PLACE_FOUND;
          }
          const unsigned same = __match_any_sync(
              FULL_MASK, active && cand >= 0 ? cand : -2 - lane);
          const unsigned clash = __ballot_sync(
              FULL_MASK, active && (same & ((1u << lane) - 1u)) != 0u);
          const unsigned done =
              todo & (clash ? (1u << (__ffs(clash) - 1)) - 1u : FULL_MASK);
          const bool mine = (done >> lane) & 1u;
          const bool takes = mine && place >= 0 && !(place & PLACE_FOUND);
          if (takes) {
            atomicAnd(&s_free[place >> 5], ~(1u << (place & 31)));
            t_keys[place] = key;
          }
          if (mine) s_hash[hp] = PLACED | (place + 1);
          left -= __popc(__ballot_sync(FULL_MASK, takes));
          todo &= ~done;
          __syncwarp();
        }
        const int place = is_new ? (s_hash[hp] & ~PLACED) - 1 : -1;
        if (place >= 0) atomicAdd(&t_counts[place & ~PLACE_FOUND], t_uc[j]);
        const bool sp = is_new && place < 0;
        const unsigned bal = __ballot_sync(FULL_MASK, sp);
        if (sp) {
          const int pos = n_spill + __popc(bal & ((1u << lane) - 1u));
          g_sk[pos] = key;
          g_sc[pos] = t_uc[j];
        }
        n_spill += __popc(bal);
      }
      if (!checked) named_sync(1, MERGE_THREADS);
    } else {
      for (int j = tid - 32; j < n_used; j += MERGE_THREADS - 32) {
        const int key = t_uk[j];
        if (key == EMPTY_KEY) continue;
        const int cls = s_cls[j];
        if (cls >= 0) atomicAdd(&t_counts[cls], t_uc[j]);
        const uint32_t hb = bloom_mix(key);
        const uint32_t p0 = hb & fmask;
        const uint32_t p1 = (hb >> a.fbits_log2) & fmask;
        atomicOr(&t_filt[p0 >> 5], 1u << (p0 & 31u));
        atomicOr(&t_filt[p1 >> 5], 1u << (p1 & 31u));
      }
      // warp 0 fills free slots meanwhile: read the tile's own keys only
      for (int i = tid - 32; n_free && i < r; i += MERGE_THREADS - 32) {
        if ((s_free0[i >> 5] >> (i & 31)) & 1u) continue;
        const uint32_t h = home_of(t_keys[i], a.mult, rmask);
        const int f0 = first_free(s_free0, nwords, h);
        if ((((uint32_t)i - h) & rmask) > (((uint32_t)f0 - h) & rmask))
          s_misc[3] = 1;
      }
      named_arrive(1, MERGE_THREADS);
    }
  }
  if (tid == 0) s_misc[2] = n_spill;
  __syncthreads();
  for (int j = s_misc[2] + tid; j < a.max_u; j += MERGE_THREADS) {
    g_sk[j] = EMPTY_KEY;
    g_sc[j] = 0;
  }
  if (row_any) {
    copy_ints(g_keys, t_keys, r, a.bulk_tile);
    copy_ints(g_counts, t_counts, r, a.bulk_tile);
    copy_ints(reinterpret_cast<int*>(g_filt),
              reinterpret_cast<const int*>(t_filt), a.fw, a.bulk_filt);
  }
}

__global__ void query_grid_staged_kernel(const int* __restrict__ keys,
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

// Distance d from home of the first slot of `tile` holding `key` or
// EMPTY, walked in aligned 8-slot sectors by two 16-byte read-only loads
// each (r >= 8, tile 16-byte aligned); -1 if the tile holds neither.
// `hit` says whether that slot holds the key (never for an EMPTY key).
__device__ __forceinline__ int probe_sectors(const int* tile, int r_log2,
                                             int key, uint32_t home,
                                             bool& hit) {
  const int r = 1 << r_log2;
  const uint32_t smask = (1u << (r_log2 - 3)) - 1u;
  const int head = (int)(home & 7u);
  uint32_t s = home >> 3;
  // d0: the distance from home of the sector's first slot; the home
  // sector comes twice when home is not its first slot (its tail first,
  // its head last)
  for (int d0 = -head; d0 < r; d0 += 8) {
    const int4* p = reinterpret_cast<const int4*>(tile + (s << 3));
    const int4 lo = __ldg(p);
    const int4 hi = __ldg(p + 1);
    const int v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    unsigned same = 0, stop = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      same |= (unsigned)(v[i] == key) << i;
      stop |= (unsigned)(v[i] == key || v[i] == EMPTY_KEY) << i;
    }
    if (d0 < 0) stop &= 0xffu << head;              // slots before home
    if (d0 + 8 > r) stop &= (1u << (r - d0)) - 1u;  // past a full wrap
    if (stop) {
      const int i = __ffs(stop) - 1;
      hit = key != EMPTY_KEY && ((same >> i) & 1u);
      return d0 + i;
    }
    s = (s + 1) & smask;
  }
  return -1;
}

// probe_sectors one slot at a time: any r, any alignment.
__device__ __forceinline__ int probe_slots(const int* tile, int r, int key,
                                           uint32_t home, bool& hit) {
  const uint32_t rmask = (uint32_t)r - 1u;
  for (int d = 0; d < r; ++d) {
    const int v = __ldg(tile + ((home + (uint32_t)d) & rmask));
    if (v == key || v == EMPTY_KEY) {
      hit = key != EMPTY_KEY && v == key;
      return d;
    }
  }
  return -1;
}

// Rows of a lookup grid: threadIdx.y picks a row of the CTA's blockDim.y,
// and the grid's y dimension strides over the rest.
__device__ __forceinline__ int first_row() {
  return blockIdx.y * blockDim.y + threadIdx.y;
}
__device__ __forceinline__ int row_stride() {
  return gridDim.y * blockDim.y;
}

template <bool kSectors>
__global__ void __launch_bounds__(QUERY_THREADS)
    query_grid_kernel(const int* __restrict__ keys,
                      const int* __restrict__ counts,
                      const int* __restrict__ blocks,
                      const int* __restrict__ q2, int* __restrict__ out_cnt,
                      int* __restrict__ out_dist, int n_rows, int r_log2,
                      int qcap, uint32_t mult) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= qcap) return;
  const int r = 1 << r_log2;
  const uint32_t rmask = (uint32_t)r - 1u;
  for (int row = first_row(); row < n_rows; row += row_stride()) {
    const size_t lane = (size_t)row * qcap + j;
    const int k = __ldg(q2 + lane);
    const size_t base = (size_t)__ldg(blocks + row) << r_log2;
    const uint32_t home = ((uint32_t)k * mult) & rmask;
    bool hit = false;
    const int d = kSectors ? probe_sectors(keys + base, r_log2, k, home, hit)
                           : probe_slots(keys + base, r, k, home, hit);
    out_cnt[lane] =
        hit ? __ldg(counts + base + ((home + (uint32_t)d) & rmask)) : 0;
    out_dist[lane] = d < 0 ? r : d + 1;  // neither key nor EMPTY: r slots
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

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// The launch shape of a lookup grid of n_rows rows of qcap lanes, one
// thread a lane, in CTAs of `threads`: a row's threads along x, as many
// rows per CTA as fill it along y, and the rows past 65,535 CTAs strided
// over.
struct LaneGrid {
  dim3 grid, block;
  LaneGrid(int n_rows, int qcap, int threads) {
    const int tx = std::min(threads, (qcap + 31) / 32 * 32);
    const int ty = std::max(1, threads / tx);
    block = dim3(tx, ty);
    grid = dim3((qcap + tx - 1) / tx,
                (unsigned)std::min(65535, (n_rows + ty - 1) / ty));
  }
};

}  // namespace

extern "C" {

int fh_merge_dirty(const void* blocks, int n_d, void* keys, void* counts,
                   void* filt, int r_log2, int fw, const void* uk,
                   const void* uc, int max_u, void* sk, void* sc,
                   unsigned int mult, void* stream) {
  // blocks of 8 to 8192 slots (merge_dirty_kernel's header says why)
  if (r_log2 < 3 || r_log2 > 13) return (int)cudaErrorInvalidValue;
  MergeArgs a;
  a.blocks = (const int*)blocks;
  a.keys = (int*)keys;
  a.counts = (int*)counts;
  a.filt = (uint32_t*)filt;
  a.uk = (const int*)uk;
  a.uc = (const int*)uc;
  a.sk = (int*)sk;
  a.sc = (int*)sc;
  a.r_log2 = r_log2;
  a.fw = fw;
  a.fbits_log2 = fbits_for(fw);
  a.max_u = max_u;
  a.chunk = std::min(max_u, MERGE_CHUNK);
  a.hash_log2 = 1;                          // at most half full
  while ((1 << a.hash_log2) < 2 * a.chunk) ++a.hash_log2;
  a.mult = mult;
  // row sizes and offsets that are multiples of 16 bytes go by bulk copy
  // (r * 4 always is, r >= 8)
  a.bulk_tile = aligned16(keys) && aligned16(counts);
  a.bulk_filt = fw % 4 == 0 && aligned16(filt);
  a.bulk_upd = max_u % 4 == 0 && aligned16(uk) && aligned16(uc);
  const size_t smem = MergeSmem(a).bytes();
  cudaError_t err = allow_smem((const void*)merge_dirty_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  merge_dirty_kernel<<<n_d, MERGE_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The serial baseline (merge_dirty_serial_kernel), for check.py only.
int fh_merge_dirty_serial(const void* blocks, int n_d, void* keys,
                          void* counts, void* filt, int r_log2, int fw,
                          const void* uk, const void* uc, int max_u,
                          void* sk, void* sc, unsigned int mult,
                          void* stream) {
  const size_t smem = ((size_t)2 * (1 << r_log2) + fw) * sizeof(int);
  cudaError_t err = allow_smem((const void*)merge_dirty_serial_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  merge_dirty_serial_kernel<<<n_d, 32, smem, (cudaStream_t)stream>>>(
      (const int*)blocks, (int*)keys, (int*)counts, (uint32_t*)filt,
      (const int*)uk, (const int*)uc, (int*)sk, (int*)sc, r_log2, fw,
      fbits_for(fw), max_u, mult);
  return (int)cudaGetLastError();
}

int fh_query_grid(const void* keys, const void* counts, const void* blocks,
                  const void* q2, void* out_cnt, void* out_dist, int n_rows,
                  int r_log2, int qcap, unsigned int mult, void* stream) {
  const LaneGrid g(n_rows, qcap, QUERY_THREADS);
  const cudaStream_t s = (cudaStream_t)stream;
  // sectors by 16-byte loads where a block holds whole sectors and the
  // tiles are aligned; else slot by slot
  if (r_log2 >= 3 && aligned16(keys))
    query_grid_kernel<true><<<g.grid, g.block, 0, s>>>(
        (const int*)keys, (const int*)counts, (const int*)blocks,
        (const int*)q2, (int*)out_cnt, (int*)out_dist, n_rows, r_log2, qcap,
        mult);
  else
    query_grid_kernel<false><<<g.grid, g.block, 0, s>>>(
        (const int*)keys, (const int*)counts, (const int*)blocks,
        (const int*)q2, (int*)out_cnt, (int*)out_dist, n_rows, r_log2, qcap,
        mult);
  return (int)cudaGetLastError();
}

// The staged baseline (query_grid_staged_kernel), for check.py only.
int fh_query_grid_staged(const void* keys, const void* counts,
                         const void* blocks, const void* q2, void* out_cnt,
                         void* out_dist, int n_rows, int r_log2, int qcap,
                         unsigned int mult, void* stream) {
  const size_t smem = (size_t)2 * (1 << r_log2) * sizeof(int);
  cudaError_t err = allow_smem((const void*)query_grid_staged_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  query_grid_staged_kernel<<<n_rows, 128, smem, (cudaStream_t)stream>>>(
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
