// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Built by build.py with nvcc into a shared library and loaded with ctypes;
// kernel.py holds the wrappers and decides which kernel takes a call. Each
// entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns the first CUDA error (cudaGetLastError()
// after the launch) so that a refused launch surfaces in the wrapper.
//
// Both kernels (three entry points) replace
// src/repro/kernels/flash_attn/kernel.py:
// flash_attention_fwd (body _fwd_kernel): causal or non-causal GQA
// attention with an online softmax. q (b, s, h, d), k (b, s, kvh, d),
// v (b, s, kvh, dv) and the output o (b, s, h, dv) keep that layout in
// device memory; query head hq of batch row bi reads KV head hq / (h / kvh).
// d and dv are any widths from 1 up, as the reference's are (it pads
// nothing and takes any width): flash_attn_wgmma_kernel takes every bf16
// and every f16 call (one instance for each type, each through its own
// entry point), flash_attn_tf32x3_kernel every f32 one, each in one
// launch. Heads
// up to 256 columns (d and dv) take the instances padded to 64, 128 or 256
// columns; a wider head takes each kernel's wide instance (below).
// Precision follows the reference kernel step by step: f32 scores of the
// inputs scaled by 1/sqrt(d) (the reference scales q in f32 first; the
// two orders differ by f32 rounding only), masked scores and the initial
// running max at -1e30, probabilities rounded to v's type for the PV
// product but not in the running denominator l, the PV product accumulated
// in f32, and the output acc / max(l, 1e-30) in v's type. Any s is taken:
// keys past s are masked, query rows past s are not written (the
// reference asserts s % block == 0 instead).
//
// Sliding window (window > 0, causal only; the reference computes it in
// src/repro/models/attention.py: _causal_mask and _sdpa_chunked, not in
// its Pallas kernel): query i keeps key j iff i - window < j <= i. All
// kernels start at the first key tile that holds some row's lower edge,
// t0 = floor((q0 - window + 1) / BK) clamped at 0, so the key tiles wholly
// before every row's window are neither loaded nor computed: O(s w) work
// instead of O(s^2). The lower edge is masked on each tile it crosses
// (two tiles where window is no multiple of the tile). A row can find
// every key of its first tile masked (its edge lies in the next tile).
// The reference's arithmetic then takes max -1e30 and p = exp(0) = 1, which
// the next tile's alpha = exp(-1e30 - m) = 0 clears exactly; the kernels,
// whose exp2 of a fused multiply-add would see the rounding error of -1e30
// x scale, take no shift for a row whose max is still -1e30, so its p are
// exp2(-huge) = 0 and its l and acc stay 0 until a kept key arrives (the
// same result: 0 against x * 0).
//
// Loads: both kernels read q, k and v as they lie (no padded copy in
// device memory) into one shared-memory layout, boxes of 128 bytes of one
// head's columns (64 bf16 or 32 f32) by 64 (or 32) positions, 128-byte
// swizzled, on a 1024-byte boundary. The entry point picks one of two
// routes a call, by the rows' length (width x element size, for d and dv):
//   - 16-byte rows (bf16 widths multiples of 8, f32 of 4): TMA, from 4-D
//     tensor maps built on the host for each call. TMA zero-fills rows past
//     s and columns past d inside a box. Each full barrier takes one
//     arrival and the boxes' bytes.
//   - Other rows (a tensor map needs 16-byte strides): the producer warp's
//     32 lanes write the same boxes (hopper.cuh: load_boxes) with their own
//     loads, in granules of 2, 4 or 8 bytes: the largest power of two that
//     divides every row's length and every tensor's address (the entry
//     point's `granule`; 2 for a bf16 row of odd width, which starts on a
//     2-byte boundary). Plain loads and not cp.async: cp.async copies 4, 8
//     or 16 aligned bytes, so it would not take every row, and the
//     registers let a unit be stored whole with its zeros. The whole warp
//     and not one lane, since it is one warp's instruction stream that
//     limits this route: a tile's K and V boxes are gathered together, the
//     units that may hold data (rounded up to a power of two a row, so the
//     index math is shifts) spread over the lanes, every granule load a
//     predicated ld.global.nc (nothing read, zeros kept, past s or past the
//     row's data: no branch, no clamped address), all issued before the
//     producer waits for the buffer to be free, so the round trip to L2
//     overlaps that wait. Measured on an H100 (PERF.md, section 6): with
//     one element a load and clamped addresses the loader alone cost 1.8
//     us a tile, twice the consumers' work at d = 12. The units past a
//     row's data are zeroed once a buffer (they stay zero: only the
//     producer writes K and V), or each tile where the f32 kernel's V^T
//     lies over K. Each lane orders its stores before the tensor cores'
//     reads (fence.proxy.async) and arrives on the stage's full barrier,
//     which counts 32 arrivals on this route; the empty barriers, the
//     ring, the consumers and their k steps are the TMA route's, and no
//     tensor map is built.
//   Zeros add exactly nothing to either product (in bf16, and in each of
//   the three TF32 passes: a zero's lo part is zero), so a padded width
//   gives the unpadded result; rows past s are masked keys (p = 0, and 0 x 0
//   for V) or query rows that are not stored. The output's pairs are stored
//   element by element where dv is odd (a pair would cross the row and its
//   4- or 8-byte alignment).
//
// Bound on the card: at serving shapes (d = 128, bf16) the FLOPs of the
// two products bound it from s of about 1,000 up (4 h d flops per
// (query, key) pair the mask keeps, at the tensor cores' bf16 peak); below
// that the bytes of q, k, v and o do. In f32 the FLOPs bound it from s of
// about 300 up, at a third of the tensor cores' TF32 peak (three passes).
//
// ---------------------------------------------------------------------------
// flash_attn_wgmma_kernel: bf16 or f16 (the template's T), d and dv from
//   1 to 256 (the serve prefill; wider heads: its wide instance, below).
//   The two types share everything but the MMA's input type (.bf16 or
//   .f16 in each wgmma), the rounding of P and of the output (to T, to
//   nearest even) and the tensor maps' element type: a 2-byte element
//   gives the same boxes, swizzle, descriptors and k16 steps, and the
//   producer warp's granules are bytes. Both products run on
//   the tensor cores (wgmma), and every tile arrives by TMA or the
//   producer warp's loads, so the consumers' CUDA cores are left with the
//   softmax.
//   - Work split: one CTA per (batch row x query head, 64-row query tile),
//     the tiles of the last (heaviest causal) query rows launched first.
//     Four consumer warps (one warpgroup, wgmma's M of 64) and one
//     producer warp that issues the copies. At llama3.2-3b's heads and
//     s = 512 that is 8 x 24 = 192 CTAs for 132 SMs; at d = 128 a CTA
//     takes 82 KB of shared memory, so two share an SM and one's softmax
//     overlaps the other's products.
//   - Loads (see above; the tensor maps are __grid_constant__ params):
//     boxes of 64 rows x 64 columns (128 bytes, the 128-byte swizzle's
//     limit), so a 128-wide head is two boxes. Q is loaded once; K and V
//     tiles of 64 keys go through a two-stage ring with full/empty
//     mbarriers. Rows past s and columns past d inside a box arrive as
//     zeros, so no garbage reaches a product; boxes wholly past d or dv
//     are not loaded.
//   - S = Q K^T: wgmma m64n64k16, both operands K-major from shared
//     memory, f32 accumulators; the scores are scaled in f32.
//   - Online softmax in registers: a row's 64 scores lie in the 4 lanes
//     of a quad (two shuffles per reduction); the causal mask is applied
//     on the diagonal tile only, the key mask on the tile that holds s,
//     (and the window's lower edge on each tile it crosses), and tiles the
//     mask empties are never loaded.
//   - O += P V: P's f32 accumulator fragment is rounded in place into the
//     T A fragment (registers), V is the MN-major B operand from shared
//     memory (the transpose bit); O is rescaled by alpha before.
//   - Heads are padded to 64, 128 or 256 columns (one instance each), the
//     k16 steps past d are skipped, and only the columns below dv are
//     stored.
//   - Tried on the card and no faster (PERF.md, section 6): two consumer
//     warpgroups per CTA sharing each K/V tile, and FlashAttention-3's
//     overlap of one tile's softmax with the previous tile's PV product.
//
// flash_attn_tf32x3_kernel: f32, d and dv from 1 to 256 (wider heads: its
//   wide instance, below). Both products run on the tensor cores in tf32
//   in three passes: x = hi + lo, where hi is x
//   as the tensor core reads an f32 operand (its low 13 bits dropped:
//   measured on an H100, where a lo taken against cvt.rna's rounding
//   instead left errors of 2.8e-3) and lo = tf32(x - hi) (cvt.rna.tf32),
//   and a b ~ hi_a lo_b + lo_a hi_b + hi_a hi_b, the small terms summed
//   first into the same f32 accumulator. Each product keeps about 20 bits
//   of its operands (lo_a lo_b, under 2^-20 of it, is dropped): the
//   reference's f32 tolerance of 2e-5 rules out one tf32 pass (10 bits:
//   70-132x over it on the reference's f32 sweep), not three. So hi is the
//   operand as it lies: Q and K go to the tensor cores as they were loaded,
//   V^T and P as they are, and only lo is formed on the CUDA cores.
//   - Work split, producer warp, consumer warpgroup, heaviest tiles first,
//     window tiles skipped, the two load routes: as the bf16 kernel. Q, K
//     and V arrive in boxes of 32 f32 columns (128 bytes, the swizzle's
//     width; narrower heads are zero-filled in the box); K and V have one
//     buffer each with full / empty mbarriers of their own.
//   - tf32 wgmma (m64nNk8) has no transpose bit: both operands are
//     K-major. Q and K are as they lie; the consumers write each one's lo
//     part beside it. V (keys x dv, dv contiguous) is MN-major, so the
//     consumers write V^T and its lo part (dv rows of keys) into tiles of
//     their own with the same 128-byte swizzle, 16-byte reads and writes
//     at the least wavefronts.
//   - P from registers: in the S accumulator a thread holds keys (2c,
//     2c+1) of each 8 for rows r and r+8; the tf32 A fragment wants columns
//     (c, c+4). Since PV sums over keys, V^T's keys of each 8 are written
//     in the order 0 2 4 6 1 3 5 7, and the S registers are P's fragment as
//     they lie: no shuffle.
//   - Overlap inside one warpgroup: S is issued, V's transposition runs
//     while the tensor cores compute it, then the softmax; PV is issued and
//     the next tile's K is split while it runs. They hide in part: copies
//     without the transposition or without the split ran 24-26% and 16%
//     faster on an H100 (chip_attn_ab.py; the split then still wrote hi
//     back, 4% of the time). Every wgmma group is
//     retired inside its tile: a group left running across the loop's back
//     edge made ptxas serialise every wgmma (C7514 / C7515): 1.6x slower
//     on an H100.
//   - 64-key tiles at P = 64 and 128 (224 KB at P = 128: one CTA an SM);
//     at P = 256 32-key tiles, and V^T goes over K's tiles (the split-out
//     tiles would not fit beside a 256-column Q), so that instance runs
//     the phases in turn. O is a stack of m64n64 products, so dv = 256 is
//     128 accumulator registers a thread, with no spill.
//
// The wide instances (flash_attn_wgmma_wide_kernel and
//   flash_attn_tf32x3_wide_kernel: d or dv over 256). One warpgroup holds at
//   most 256 f32 accumulator columns of O (128 registers a thread), and a
//   CTA's 227 KB of shared memory holds a 576-column bf16 Q beside a ring of
//   K stages, an f32 Q (hi and lo) not at all. So:
//   - Two consumer warpgroups on the same 64 query rows and a producer
//     warpgroup (setmaxnreg: the producers keep 40 registers a thread, 56
//     on the producer-warp route, the consumers take 232, 224; at the 168
//     ptxas gives 12 warps the accumulators spilled). Each consumer
//     warpgroup computes S over half of d's columns (m64n64 products, the
//     whole 64-key tile), the two partial sums are exchanged and added, and
//     each holds half of the CTA's columns of O (wg_cols). S is computed
//     once per (query tile, key tile) for the CTA's columns. The plan,
//     fixed by the shape alone (slice_cols; kernel.py's wide_plan): a CTA
//     computes 512 columns, so S once for every dv up to 512 (at d = 576,
//     dv = 512 the products are the function's 1,088 columns: 1.0x; slices
//     of 256 would take 1.53x), and grid z slices o past 512; or 256
//     columns where dv <= 256 (128 a warpgroup) or where CTAs of 256
//     columns still fit in one wave of the card's 132 SMs (8 / 2 heads of
//     320 at s = 512 are 64 query tiles: 2 x 64 CTAs of 256 columns, each
//     computing S again, busy twice the SMs).
//   - The exchange: each warpgroup writes its partial S (16 KB of f32
//     fragments) into its own half of the tile's last S stage, whose bytes
//     only its own (retired) products read, signals the other (named
//     barrier 1 + w, bar.arrive against bar.sync) and adds the other's:
//     IEEE addition commutes, so both hold the same S. Both then run the
//     same online softmax over the whole tile (m, l and alpha agree), and
//     P stays in registers as the A fragment of their P V (bf16: rounded
//     to T; f32: hi, the low 13 bits cleared, and lo), as in the narrow
//     instances. One barrier a tile, nothing of P in shared memory.
//   - d is streamed through one ring of stages, each consumed by both
//     warpgroups (empty barriers count 256): for each key tile, d's chunks,
//     then V's stages. A stage is released when its wgmma group retires:
//     wgmma_wait<1> after the next chunk's product is issued. The scale is
//     1/sqrt(d) of the true d. 64-key tiles in both types.
//   - bf16 / f16: Q resident where d <= 576 (72 KB; else it is streamed
//     beside K); a stage (32 KB) holds K's next 256 columns, warpgroup w's
//     128 in its half (with Q streamed: Q's and K's next 128, a box of each
//     a warpgroup), or half of V's tile: 32 keys x the slice's columns in
//     boxes of 32 rows (the V map's boxes), each warpgroup's P V one m64n64
//     product a 64-column box that holds data, two k16 steps a stage. Four
//     stages. Both load routes; on the producer-warp route the four
//     producer warps share a stage's boxes (box i by warp i % 4), each
//     waiting for the stage and arriving on its full barrier (count 128).
//   - f32: tf32_split_kernel, a pre-pass of the same call, writes into the
//     scratch the wrapper allocates Q's and K's hi (the low 13 bits cleared
//     explicitly, so the products no longer rely on the tensor cores
//     dropping them) and lo = tf32(x - hi) parts, rows padded to 32
//     columns, and V^T's hi and lo parts, keys along a row in the narrow
//     instance's order: the values the narrow instance forms in shared
//     memory, bit for bit. Every operand then arrives by TMA (no
//     producer-warp route, at any width), and the inner loop is the three
//     tf32 passes of each product and the softmax: nothing is split or
//     transposed on the CUDA cores. A stage (64 KB) holds Q's and K's hi
//     and lo over 64 columns of d (32 a warpgroup), or a quarter of V^T's
//     (64 of each warpgroup's columns, hi and lo, 64 keys). Three stages.
//   Offsets into q, k, v, o and the split copies are 64-bit throughout (a
//   q of more than 2^31 elements is taken).
//
// The grid (cta_grid, tile_of), every instance of both kernels: b h CTAs
//   along x (its limit is 2^31 - 1), and the (query tile, o slice) pairs
//   along y and z: y holds the tiles and z the slices where each count
//   fits in 65,535 (the grid every instance ran on before), else the pairs
//   in order fill y's 65,535 and go on along z, and a CTA past the last
//   pair returns at once. Either way a CTA's pair is its index y + gridDim.y
//   z, counted tiles first, heaviest (last) tile first, so the launch order
//   (x fastest, then y, then z) stays: every b h of the heaviest tile,
//   then the next, slice by slice. So any b h up to 2^31 - 1 and any s is
//   taken (65,536 tiles or more: over 4,194,240 tokens), and any dv with
//   them, as long as tiles x slices stays within 65,535^2 (an o that
//   overran it would hold more than 2^46 elements).
//
// ---------------------------------------------------------------------------
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

// ---------------------------------------------------------------------------
// Tensor maps (host): both kernels' TMA route over q, k, v
// ---------------------------------------------------------------------------
namespace tma {

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

// Tensor map over a contiguous (b, s, heads, width) tensor of `elem`-byte
// elements, in boxes of `box_rows` positions x `box_cols` columns of one
// head (box_cols x elem = 128 bytes), 128-byte swizzled. Elements outside
// the tensor arrive as zeros.
bool make_map(CUtensorMap* map, CUtensorMapDataType dtype, int elem,
              const void* ptr, int b, int s, int heads, int width,
              int box_cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t row = (cuuint64_t)width * elem;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {row, row * heads, row * heads * s};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)box_rows,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, dtype, 4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tma

// One call's operands and sizes, as an entry point hands them to a launch.
struct Call {
  bool tma;                  // the route: TMA, or the producer warp's loads
  CUtensorMap tq, tk, tv;    // the TMA route's maps (zeros on the other)
  const void *q, *k, *v;
  void* o;
  int b, s, h, kvh, d, dv;
  float scale_log2;          // 1/sqrt(d) log2(e): exp(x) = 2^(x log2 e)
  int causal, window;
  int g;                     // the other route's granule bytes
  cudaStream_t stream;
};

// The grid of a call whose query tiles hold `bq` rows and whose o is cut
// into `n_sl` column slices (the note at the top); x holds b h, which the
// caller has checked against fits_grid.
dim3 cta_grid(int bh, int s, int bq, int n_sl) {
  const long long n_q = (s + (long long)bq - 1) / bq;
  if (n_q <= 65535 && n_sl <= 65535)
    return dim3(bh, (unsigned)n_q, n_sl);
  const long long pairs = n_q * n_sl;
  return dim3(bh, 65535, (unsigned)((pairs + 65534) / 65535));
}

// Whether cta_grid can lay out b h rows of such a call.
bool fits_grid(int b, int h, int s, int bq, int n_sl) {
  const long long n_q = (s + (long long)bq - 1) / bq;
  return (long long)b * h <= 0x7fffffffLL &&
         (n_q * n_sl + 65534) / 65535 <= 65535;
}

// This CTA's query tile, heaviest first (q0, its first row), and o's
// column slice (sl) on cta_grid; false for a CTA past the last pair.
// On the grid the kernels ran on before (y the tiles, z the slices) no
// division is needed; 32 bits hold every index of a folded one (fits_grid
// keeps the pairs within 65,535^2).
__device__ __forceinline__ bool tile_of(int s, int bq, int n_sl, int& q0,
                                        int& sl) {
  const unsigned n_q = ((unsigned)s + bq - 1) / bq;
  unsigned t = blockIdx.y, slice = blockIdx.z;
  if (gridDim.y != n_q) {                  // folded: pairs along y, then z
    const unsigned at = blockIdx.y + gridDim.y * blockIdx.z;
    q0 = 0;
    sl = 0;
    if (at >= n_q * (unsigned)n_sl) return false;
    t = at % n_q;
    slice = at / n_q;
  }
  q0 = (int)(n_q - 1 - t) * bq;
  sl = (int)slice;
  return true;
}

// The largest power of two up to 8 that divides the rows' lengths (`elem`
// x d and x dv bytes) and the tensors' addresses: the granule the producer
// warp loads in where a row is not 16 bytes.
int granule(int elem, int d, int dv, const void* q, const void* k,
            const void* v) {
  const uintptr_t x = (uintptr_t)(elem * d) | (uintptr_t)(elem * dv) |
                      (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | 8u;
  return (int)(x & (~x + 1));
}

// An output pair (two adjacent columns, the first 4- or 8-byte aligned)
// and one output element, each rounded once to o's type.
__device__ __forceinline__ void store_pair(__nv_bfloat16* out, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(__half* out, float a, float b) {
  *reinterpret_cast<__half2*>(out) = __floats2half2_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* out, float a, float b) {
  *reinterpret_cast<float2*>(out) = make_float2(a, b);
}
__device__ __forceinline__ void store_one(__nv_bfloat16* out, float a) {
  *out = __float2bfloat16(a);
}
__device__ __forceinline__ void store_one(__half* out, float a) {
  *out = __float2half_rn(a);
}
__device__ __forceinline__ void store_one(float* out, float a) { *out = a; }

// ---------------------------------------------------------------------------
// What the wide instances of both kernels share (the note at the top)
// ---------------------------------------------------------------------------
namespace wide {

constexpr int O_SLICE = 512;   // columns of O a CTA computes at most
constexpr int WG_COLS = 256;   // of them, each consumer warpgroup's at most
constexpr int SMS = 132;       // an H100's SMs: one wave of CTAs
constexpr int BQ = 64;         // query rows a CTA: wgmma's M
constexpr int BK = 64;         // keys a tile
constexpr int HALF = BK / 2;   // half a key tile: a V stage (bf16), a V^T box
constexpr int CONSUMERS = 256;            // two warpgroups
constexpr int PRODUCERS = 128;            // and a producer warpgroup
constexpr int THREADS = CONSUMERS + PRODUCERS;
// Registers a thread (setmaxnreg): 12 warps put 3 on each of the SM's four
// register-file quarters of 16,384, so ptxas starts each thread at 168;
// the producer warpgroup gives up to 40 (56 where its warps load the
// boxes themselves) and each consumer takes 232 (224): 40 + 2 x 232 = 504
// of a quarter's 512 registers a lane.
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr uint32_t BAR_READY = 1;  // + w: warpgroup w's partial S is written
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// The columns of O one CTA computes (the plan, fixed by the shape alone as
// kernel.py's slice_cols fixes it): 512 (grid z slices o past it), or 256
// where dv <= 256 (each warpgroup then holds half of them) or where the
// CTAs of 256 columns still fit in one wave of the card (a query tile then
// takes more CTAs, each computing S again, on SMs that would idle).
inline int slice_cols(int b, int s, int h, int dv) {
  const long long tiles = (long long)b * h * ((s + BQ - 1) / BQ);
  return dv <= WG_COLS ||
                 tiles * ((dv + O_SLICE / 2 - 1) / (O_SLICE / 2)) <= SMS
             ? O_SLICE / 2
             : O_SLICE;
}

// The masks and the online softmax of one key tile (keys k0 .. k0 + 63),
// as the narrow instances run them: S's m64n64 accumulator fragment `sc`
// (row r_lo + 8 ((i / 2) % 2), key k0 + 8 (i / 4) + c_in + i % 2 of register
// i) becomes p (f32); m and l (this thread's share of each row's sum) are
// carried, alpha is the rescale of O.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int q0, int k0, int r_lo,
                                             int c_in, int s, int causal,
                                             int window, float scale_log2) {
  const bool windowed = window > 0;
  // the causal mask on the diagonal tiles, the key one past s, the
  // window's lower edge on every tile that holds some row's edge
  if (k0 + BK > s || (causal && k0 + BK - 1 > q0) ||
      (windowed && k0 <= q0 + BQ - 1 - window)) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = q0 + r_lo + 8 * ((i >> 1) & 1);
      const int col = k0 + 8 * (i >> 2) + c_in + (i & 1);
      if (col >= s || (causal && col > row) ||
          (windowed && col <= row - window))
        sc[i] = NEG;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float shift[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    alpha[r] = exp2f((m[r] - mx[r]) * scale_log2);
    // a row with no kept key yet (its window starts in a later tile)
    // takes no shift: its p are then exp2(-1e30 x scale) = 0
    shift[r] = mx[r] == NEG ? 0.f : mx[r] * scale_log2;
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = exp2f(fmaf(sc[i], scale_log2, -shift[r]));
    rs[r] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

// The two warpgroups' partial S (each over its boxes of d) summed in both:
// each writes its fragments into its own half of the tile's last S stage
// (`stage`, halves of `half` bytes: the bytes only its own products read,
// all retired), signals the other (named barrier BAR_READY + wg), waits
// for the other's and adds them. IEEE addition is commutative, so both
// warpgroups hold the same S, and each then runs the same softmax.
__device__ __forceinline__ void exchange(float (&sc)[32], uint8_t* stage,
                                         int half, int wg, int wt) {
  float4* mine = reinterpret_cast<float4*>(stage + wg * half);
  const float4* other =
      reinterpret_cast<const float4*>(stage + (wg ^ 1) * half);
#pragma unroll
  for (int g = 0; g < 8; ++g)
    mine[g * 128 + wt] =
        make_float4(sc[4 * g], sc[4 * g + 1], sc[4 * g + 2], sc[4 * g + 3]);
  hopper::bar_arrive(BAR_READY + wg, CONSUMERS);
  hopper::bar_sync(BAR_READY + (wg ^ 1), CONSUMERS);
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const float4 x = other[g * 128 + wt];
    sc[4 * g] += x.x;
    sc[4 * g + 1] += x.y;
    sc[4 * g + 2] += x.z;
    sc[4 * g + 3] += x.w;
  }
}

// One CTA of a wide instance whose shared-memory layout is L: its batch row
// and query head (grid x), its query tile, heaviest first, and its slice of
// O's sw columns from v0 (tile_of: live is false for a CTA past the last
// pair), the key tiles it walks (from t0, the tile that holds its lowest
// row's window edge), the columns of O each warpgroup holds (warpgroup w
// from v0 + w wg_cols, wg_cols = sw / 2), and the ring's stages a key tile
// takes: d's chunks of L::chunk(d) columns, then V's (L::v_stages).
template <typename L>
struct Cta {
  int bi, hq, kh, q0, v0, t0, n_tiles, s_stages, v_stages, wg_cols, cols[2];
  bool live;

  __device__ __forceinline__ Cta(int s, int h, int kvh, int d, int dv,
                                 int causal, int window, int sw) {
    bi = blockIdx.x / h;
    hq = blockIdx.x % h;
    kh = hq / (h / kvh);
    int sl;
    live = tile_of(s, BQ, (dv + sw - 1) / sw, q0, sl);
    v0 = sl * sw;
    n_tiles = (s + BK - 1) / BK;
    if (causal) n_tiles = min(n_tiles, (q0 + BQ + BK - 1) / BK);
    const int lo = q0 - window + 1;  // the lowest row's first kept key
    t0 = window > 0 && lo > 0 ? lo / BK : 0;
    s_stages = (d - 1) / L::chunk(d) + 1;
    const int here = min(dv - v0, sw);
    wg_cols = sw / 2;
    cols[0] = min(here, wg_cols);
    cols[1] = here - cols[0];
    v_stages = L::v_stages(cols[0]);
  }
};

// The epilogue of a wide instance: acc / max(l, 1e-30) in o's type, the
// rows below s, warpgroup wg's `cols` columns (from v0 + wg wg_cols); a
// thread's column pairs are stored whole where `pairs` (dv even: a pair
// stays in its row, aligned).
template <typename L, typename T>
__device__ __forceinline__ void store_cols(T* o, const Cta<L>& c,
                                           const float (&acc)[WG_COLS / 2],
                                           float (&l)[2], bool pairs, int wg,
                                           int cols, int r_lo, int c_in,
                                           int s, int h, int dv) {
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
  }
  const long o_row = (long)h * dv;
  T* ob = o + (long)c.bi * s * o_row + (long)c.hq * dv;
#pragma unroll
  for (int i = 0; i < WG_COLS / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int row = c.q0 + r_lo + 8 * r;
    const int at = 8 * (i >> 2) + c_in;  // in this warpgroup's columns
    const int col = c.v0 + c.wg_cols * wg + at;
    if (row < s && at < cols) {
      T* out = ob + row * o_row + col;
      if (pairs) {
        store_pair(out, acc[i] / den[r], acc[i + 1] / den[r]);
      } else {
        store_one(out, acc[i] / den[r]);
        if (col + 1 < dv) store_one(out + 1, acc[i + 1] / den[r]);
      }
    }
  }
}

}  // namespace wide

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

// TMA: the boxes arrive by TMA (tm_*), else the producer warp loads them
// from q, k, v (the note at the top).
template <typename T, int P, int MIN_BLOCKS, bool TMA>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_attn_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const uint16_t* __restrict__ q,
                        const uint16_t* __restrict__ k,
                        const uint16_t* __restrict__ v,
                        T* __restrict__ o, int s, int h, int kvh, int d,
                        int dv, float scale_log2, int causal, int window,
                        int g) {
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
  int q0, sl;                                        // heaviest tiles first
  if (!tile_of(s, BQ, 1, q0, sl)) return;            // past the last tile
  int n_tiles = (s + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ + BK - 1) / BK);
  const int lo = q0 - window + 1;  // the lowest row's first kept key
  const int t0 = window > 0 && lo > 0 ? lo / BK : 0;
  const bool windowed = window > 0;
  const int qk_chunks = (d + CHUNK - 1) / CHUNK;   // boxes that hold data
  const int v_chunks = (dv + CHUNK - 1) / CHUNK;

  if (tid == 0) {
    hopper::mbar_init(bar_q, TMA ? 1 : 32);
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(bar_full + 8 * i, TMA ? 1 : 32);
      hopper::mbar_init(bar_empty + 8 * i, CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (!TMA && tid >= CONSUMERS) {  // the producer warp: all lanes load
    using hopper::Box;
    const int lane = tid - CONSUMERS;
    // byte strides between positions, and each head's first row
    const long ldq = 2L * h * d, ldk = 2L * kvh * d, ldv = 2L * kvh * dv;
    const uint8_t* qh = reinterpret_cast<const uint8_t*>(q) +
                        ((long)bi * s + q0) * ldq + 2L * hq * d;
    const uint8_t* kb = reinterpret_cast<const uint8_t*>(k) +
                        (long)bi * s * ldk + 2L * kh * d;
    const uint8_t* vb = reinterpret_cast<const uint8_t*>(v) +
                        (long)bi * s * ldv + 2L * kh * dv;
    auto produce = [&](auto gran) {
      constexpr int G = decltype(gran)::value;
      for (int c = 0; c < qk_chunks; ++c) {
        const Box bq[1] = {{sq + c * BOX, qh + 128 * c, ldq, s - q0,
                            2 * d - 128 * c}};
        hopper::load_boxes<G, BQ>(bq, true, lane, hopper::NoWait());
      }
      hopper::fence_proxy_async();
      hopper::mbar_arrive(bar_q);
      for (int t = t0; t < n_tiles; ++t) {
        const int j = t - t0;  // ring slot and phase count from t0
        const int st = j % STAGES;
        const uint32_t sk = skv + st * L::kStage;
        const int rows = s - t * BK;
        auto ready = [&] {
          hopper::mbar_wait(bar_empty + 8 * st, ((j / STAGES) & 1) ^ 1);
        };
        // box c of K and box c of V together, while both have one
        for (int c = 0; c < max(qk_chunks, v_chunks); ++c) {
          const Box bk = {sk + c * BOX, kb + t * BK * ldk + 128 * c, ldk,
                          rows, 2 * d - 128 * c};
          const Box bv = {sk + L::kTile + c * BOX,
                          vb + t * BK * ldv + 128 * c, ldv, rows,
                          2 * dv - 128 * c};
          if (c < qk_chunks && c < v_chunks) {
            const Box kv[2] = {bk, bv};
            hopper::load_boxes<G, BK>(kv, j < STAGES, lane, ready);
          } else {
            const Box one[1] = {c < qk_chunks ? bk : bv};
            hopper::load_boxes<G, BK>(one, j < STAGES, lane, ready);
          }
        }
        hopper::fence_proxy_async();
        hopper::mbar_arrive(bar_full + 8 * st);
      }
    };
    if (g == 8)
      produce(hopper::Int<8>());
    else if (g == 4)
      produce(hopper::Int<4>());
    else
      produce(hopper::Int<2>());
    return;
  }
  if (tid >= CONSUMERS) {  // the producer warp: one lane issues every copy
    if (tid == CONSUMERS) {
      hopper::mbar_arrive_expect_tx(bar_q, qk_chunks * BOX);
      for (int c = 0; c < qk_chunks; ++c)
        hopper::tma_load_4d(sq + c * BOX, &tm_q, bar_q, c * CHUNK, hq, q0, bi);
      for (int t = t0; t < n_tiles; ++t) {
        const int j = t - t0;  // ring slot and phase count from t0
        const int st = j % STAGES;
        const uint32_t full = bar_full + 8 * st;
        const uint32_t sk = skv + st * L::kStage;
        hopper::mbar_wait(bar_empty + 8 * st, ((j / STAGES) & 1) ^ 1);
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
  for (int t = t0; t < n_tiles; ++t) {
    const int j = t - t0;
    const int st = j % STAGES;
    const uint32_t sk = skv + st * L::kStage;
    const uint32_t sv = sk + L::kTile;
    hopper::mbar_wait(bar_full + 8 * st, (j / STAGES) & 1);

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
        hopper::wgmma_ss<T>(sc, hopper::smem_desc(sq + off, 16, 1024),
                            hopper::smem_desc(sk + off, 16, 1024), 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(sc);

    // masks: the causal one on the diagonal tile, the key one past s,
    // the window's lower edge on every tile that holds some row's edge
    const int k0 = t * BK;
    if (k0 + BK > s || (causal && k0 + BK - 1 > q0) ||
        (windowed && k0 <= q0 + BQ - 1 - window)) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int row = q0 + r_lo + 8 * ((i >> 1) & 1);
        const int col = k0 + 8 * (i >> 2) + c_in + (i & 1);
        if (col >= s || (causal && col > row) ||
            (windowed && col <= row - window))
          sc[i] = NEG;
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
      // a row with no kept key yet (its window starts in a later tile)
      // takes no shift: its p are then exp2(-1e30 x scale) = 0
      shift[r] = mx[r] == NEG ? 0.f : mx[r] * scale_log2;
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

    // O += P V: P rounded to T in place as the A fragment
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kk][j] = hopper::pack2<T>(sc[8 * kk + 2 * j],
                                     sc[8 * kk + 2 * j + 1]);
      hopper::fence_regs(pa[kk]);
    }
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::wgmma_rs<T>(acc, pa[kk],
                          hopper::smem_desc(sv + kk * 16 * 128, BOX, 1024), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(bar_empty + 8 * st);  // this stage may be refilled
  }

  // epilogue: acc / max(l, 1e-30) in T, rows below s, columns below dv
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
  }
  const long o_row = (long)h * dv;
  T* ob = o + (long)bi * s * o_row + (long)hq * dv;
  const bool pairs = TMA || dv % 2 == 0;  // a pair stays in the row, aligned
#pragma unroll
  for (int i = 0; i < P / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int row = q0 + r_lo + 8 * r;
    const int col = 8 * (i >> 2) + c_in;
    if (row < s && col < dv) {
      T* out = ob + row * o_row + col;
      if (pairs) {
        store_pair(out, acc[i] / den[r], acc[i + 1] / den[r]);
      } else {
        store_one(out, acc[i] / den[r]);
        if (col + 1 < dv) store_one(out + 1, acc[i + 1] / den[r]);
      }
    }
  }
}

// Tensor map over a contiguous T (b, s, heads, width) tensor, in boxes of
// `rows` positions x 64 columns of one head, 128-byte swizzled.
template <typename T>
bool make_map(CUtensorMap* map, const void* ptr, int b, int s, int heads,
              int width, int rows = 64) {
  return tma::make_map(map,
                       hopper::is_f16<T>() ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       2, ptr, b, s, heads, width, CHUNK, rows);
}

template <typename T, int P, int MIN_BLOCKS, bool TMA>
int launch(const Call& c) {
  const int smem = Smem<P>::kBytes;
  auto kern = flash_attn_wgmma_kernel<T, P, MIN_BLOCKS, TMA>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = cta_grid(c.b * c.h, c.s, BQ, 1);
  kern<<<grid, THREADS, smem, c.stream>>>(
      c.tq, c.tk, c.tv, static_cast<const uint16_t*>(c.q),
      static_cast<const uint16_t*>(c.k), static_cast<const uint16_t*>(c.v),
      static_cast<T*>(c.o), c.s, c.h, c.kvh, c.d, c.dv, c.scale_log2,
      c.causal, c.window, c.g);
  return (int)cudaGetLastError();
}

// The instance for heads padded to P columns, on the call's route.
template <typename T, int P, int MIN_BLOCKS>
int route(const Call& c) {
  return c.tma ? launch<T, P, MIN_BLOCKS, true>(c)
               : launch<T, P, MIN_BLOCKS, false>(c);
}


// ---- the wide instance: d or dv over 256 (the note at the top) ----
// Shared memory: Q (kQBoxes boxes: resident where d <= kQMax, else unused),
// then kStages stages of 32 KB, then the barriers (q, full[], empty[]). A
// stage holds one key tile's chunk of d, warpgroup w's part in its half w
// (with Q resident, K's boxes 2w and 2w + 1 of the chunk's 256 columns;
// with Q streamed, Q's and then K's box w of its 128), or half of V's tile
// (32 keys x the slice's columns: boxes of 32 rows, warpgroup w's from box
// w wg_cols / 64).
struct WideSmem {
  static constexpr int kQMax = 576;               // widest resident Q
  static constexpr int kQBoxes = kQMax / CHUNK;
  static constexpr int kStages = 4;
  static constexpr int kStage = 4 * BOX;
  static constexpr int kVBox = wide::HALF * 128;  // 32 keys x 64 columns
  static constexpr int kRing = kQBoxes * BOX;
  static constexpr int kBars = kRing + kStages * kStage;
  static constexpr int kBytes = 1024 + kBars + 8 * (1 + 2 * kStages);
  static_assert(wide::O_SLICE / CHUNK * kVBox == kStage,
                "half of V's tile fills one stage");
  static_assert(wide::BQ * wide::BK * 4 <= kStage / 2,
                "a warpgroup's partial S fits in its half of a stage");
  static_assert(kBytes <= 232448, "227 KB of shared memory a CTA");
  // d's columns a stage holds
  __device__ static int chunk(int d) { return d <= kQMax ? 4 * CHUNK : 2 * CHUNK; }
  // V's stages a key tile: its two halves
  __device__ static int v_stages(int) { return 2; }
};

template <typename T, bool TMA>
__global__ void __launch_bounds__(wide::THREADS, 1)
flash_attn_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const uint16_t* __restrict__ q,
                             const uint16_t* __restrict__ k,
                             const uint16_t* __restrict__ v,
                             T* __restrict__ o, int s, int h, int kvh, int d,
                             int dv, float scale_log2, int causal, int window,
                             int g, int sw) {
  using L = WideSmem;
  constexpr int S = L::kStages, HALF = wide::HALF;
  // registers a thread (the note at the top): the producer-warp route's
  // granule loads want more than TMA's one issuing lane
  constexpr int PREGS = TMA ? wide::PRODUCER_REGS : 56;
  constexpr int CREGS = TMA ? wide::CONSUMER_REGS : 224;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const sm = smem_raw + (base - raw);  // the same bytes, generic
  const uint32_t sq = base, ring = base + L::kRing;
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_full = bar_q + 8;             // + 8 i
  const uint32_t bar_empty = bar_full + 8 * S;     // + 8 i
  const int tid = threadIdx.x;
  const wide::Cta<L> c(s, h, kvh, d, dv, causal, window, sw);
  if (!c.live) return;                             // past the last pair
  const bool resident = d <= L::kQMax;
  const int cw = L::chunk(d);
  const int v_boxes = (c.cols[0] + c.cols[1] + CHUNK - 1) / CHUNK;

  if (tid == 0) {
    hopper::mbar_init(bar_q, TMA ? 1 : wide::PRODUCERS);
    for (int i = 0; i < S; ++i) {
      hopper::mbar_init(bar_full + 8 * i, TMA ? 1 : wide::PRODUCERS);
      hopper::mbar_init(bar_empty + 8 * i, wide::CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= wide::CONSUMERS) {
    // ---- the producer warpgroup: stage j of the run in slot j % S, phase
    // (j / S) & 1; a key tile's stages are d's chunks, then V's halves (a
    // half wholly past s is not loaded: nothing multiplies it). Box i of a
    // chunk lies at i x BOX with Q resident, else Q's at 2 i x BOX and K's
    // right after it ----
    hopper::setmaxnreg_dec<PREGS>();
    const int q_boxes = (d + CHUNK - 1) / CHUNK;
    if constexpr (TMA) {
      if (tid != wide::CONSUMERS) return;  // one lane issues every copy
      if (resident) {
        hopper::mbar_arrive_expect_tx(bar_q, q_boxes * BOX);
        for (int i = 0; i < q_boxes; ++i)
          hopper::tma_load_4d(sq + i * BOX, &tm_q, bar_q, i * CHUNK, c.hq,
                              c.q0, c.bi);
      }
      int j = 0;
      for (int t = c.t0; t < c.n_tiles; ++t) {
        for (int x = 0; x < c.s_stages + c.v_stages; ++x, ++j) {
          const int st = j % S;
          const uint32_t full = bar_full + 8 * st;
          const uint32_t sd = ring + st * L::kStage;
          hopper::mbar_wait(bar_empty + 8 * st, ((j / S) & 1) ^ 1);
          if (x < c.s_stages) {
            const int col = x * cw;
            const int n = min(cw, d - col + CHUNK - 1) / CHUNK;
            hopper::mbar_arrive_expect_tx(full, (resident ? 1 : 2) * n * BOX);
            for (int i = 0; i < n; ++i) {
              if (!resident)
                hopper::tma_load_4d(sd + 2 * i * BOX, &tm_q, full,
                                    col + i * CHUNK, c.hq, c.q0, c.bi);
              hopper::tma_load_4d(sd + (resident ? i : 2 * i + 1) * BOX,
                                  &tm_k, full, col + i * CHUNK, c.kh,
                                  t * wide::BK, c.bi);
            }
          } else {
            const int k0 = t * wide::BK + (x - c.s_stages) * HALF;
            const int n = k0 < s ? v_boxes : 0;
            hopper::mbar_arrive_expect_tx(full, n * L::kVBox);
            for (int i = 0; i < n; ++i)
              hopper::tma_load_4d(sd + i * L::kVBox, &tm_v, full,
                                  c.v0 + i * CHUNK, c.kh, k0, c.bi);
          }
        }
      }
    } else {
      // the four warps load the boxes in granules of g bytes, box i of a
      // stage by warp i % 4, one load_boxes each; every warp waits for the
      // stage to be free and arrives on its full barrier (count 128). Byte
      // strides between positions, and each head's first row (V's from the
      // slice's first column)
      const int pw = (tid - wide::CONSUMERS) >> 5, lane = tid & 31;
      const long ldq = 2L * h * d, ldk = 2L * kvh * d, ldv = 2L * kvh * dv;
      const uint8_t* qh = reinterpret_cast<const uint8_t*>(q) +
                          ((long)c.bi * s + c.q0) * ldq + 2L * c.hq * d;
      const uint8_t* kb = reinterpret_cast<const uint8_t*>(k) +
                          (long)c.bi * s * ldk + 2L * c.kh * d;
      const uint8_t* vb = reinterpret_cast<const uint8_t*>(v) +
                          (long)c.bi * s * ldv + 2L * ((long)c.kh * dv + c.v0);
      auto run = [&](auto gran) {
        constexpr int G = decltype(gran)::value;
        // one box: ROWS positions from src, bytes of data a row
        auto box = [&](auto rows_box, uint32_t dst, const uint8_t* src,
                       long ld, int rows, int bytes, auto ready) {
          constexpr int ROWS = decltype(rows_box)::value;
          const hopper::Box one[1] = {{dst, src, ld, rows, bytes}};
          hopper::load_boxes<G, ROWS>(one, true, lane, ready);
        };
        if (resident) {
          for (int i = pw; i < q_boxes; i += 4)
            box(hopper::Int<wide::BQ>(), sq + i * BOX, qh + 128 * i, ldq,
                s - c.q0, 2 * d - 128 * i, hopper::NoWait());
          hopper::fence_proxy_async();
          hopper::mbar_arrive(bar_q);
        }
        int j = 0;
        for (int t = c.t0; t < c.n_tiles; ++t) {
          const int rows = s - t * wide::BK;
          for (int x = 0; x < c.s_stages + c.v_stages; ++x, ++j) {
            const int st = j % S;
            const uint32_t sd = ring + st * L::kStage;
            auto ready = [&] {
              hopper::mbar_wait(bar_empty + 8 * st, ((j / S) & 1) ^ 1);
            };
            if (x < c.s_stages) {
              const int col = x * cw;
              const int n = min(cw, d - col + CHUNK - 1) / CHUNK;
              const int bytes = 2 * min(d - col, cw);  // this chunk's
              // Q's boxes (streamed) are u = 0 .. n - 1, K's after them
              const int q_n = resident ? 0 : n;
              for (int u = pw; u < q_n + n; u += 4) {
                const int i = u < q_n ? u : u - q_n;
                if (u < q_n)
                  box(hopper::Int<wide::BQ>(), sd + 2 * i * BOX,
                      qh + 2L * col + 128 * i, ldq, s - c.q0, bytes - 128 * i,
                      ready);
                else
                  box(hopper::Int<wide::BK>(),
                      sd + (resident ? i : 2 * i + 1) * BOX,
                      kb + t * wide::BK * ldk + 2L * col + 128 * i, ldk, rows,
                      bytes - 128 * i, ready);
              }
            } else {
              const int k0 = t * wide::BK + (x - c.s_stages) * HALF;
              const int n = k0 < s ? v_boxes : 0;
              for (int i = pw; i < n; i += 4)
                box(hopper::Int<HALF>(), sd + i * L::kVBox,
                    vb + k0 * ldv + 128 * i, ldv, s - k0,
                    2 * (c.cols[0] + c.cols[1]) - 128 * i, ready);
            }
            ready();  // a warp with no box of this stage waits here
            hopper::fence_proxy_async();  // the tensor cores read these
            hopper::mbar_arrive(bar_full + 8 * st);
          }
        }
      };
      if (g == 8)
        run(hopper::Int<8>());
      else if (g == 4)
        run(hopper::Int<4>());
      else
        run(hopper::Int<2>());
    }
    return;
  }

  // ---- the two consumer warpgroups: each half of d's columns of every
  // key tile's S, then the whole S and softmax, and its columns of O ----
  hopper::setmaxnreg_inc<CREGS>();
  const int wg = tid >> 7;
  const int wt = tid & 127;
  const int warp = wt >> 5;
  const int lane = tid & 31;
  const int r_lo = warp * 16 + (lane >> 2);  // this thread's rows: r_lo, +8
  const int c_in = 2 * (lane & 3);           // its columns in each 8-block
  const int cols = wg ? c.cols[1] : c.cols[0];  // its columns of O
  const int n_box = (cols + CHUNK - 1) / CHUNK;   // its boxes of V
  const int steps = cw / 32;                 // its k16 steps of a chunk

  float acc[wide::WG_COLS / 2];
#pragma unroll
  for (int i = 0; i < wide::WG_COLS / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  if (resident) hopper::mbar_wait(bar_q, 0);
  int j = 0, prev = 0;  // the ring's stage, and the last one taken
  for (int t = c.t0; t < c.n_tiles; ++t) {
    // this warpgroup's part of S: over its boxes of each of d's chunks
    // (f32), a stage freed once the next chunk's product is issued and its
    // own has retired; the tile's last stage is kept for the exchange
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    for (int x = 0; x < c.s_stages; ++x, ++j) {
      const int st = j % S;
      const uint32_t half = ring + st * L::kStage + wg * 2 * BOX;
      hopper::mbar_wait(bar_full + 8 * st, (j / S) & 1);
      const uint32_t a = resident ? sq + (x * 4 + wg * 2) * BOX : half;
      const uint32_t b = resident ? half : half + BOX;
      const int col0 = x * cw + wg * (cw / 2);  // its first column
      hopper::fence_regs(sc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) {
        if (kc < steps && col0 + 16 * kc < d) {
          const uint32_t off = (kc / 4) * BOX + (kc % 4) * 32;
          hopper::wgmma_ss<T>(sc, hopper::smem_desc(a + off, 16, 1024),
                              hopper::smem_desc(b + off, 16, 1024), 1);
        }
      }
      hopper::wgmma_commit();
      if (x > 0) {
        hopper::wgmma_wait<1>();
        hopper::mbar_arrive(bar_empty + 8 * prev);
      }
      prev = st;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    wide::exchange(sc, sm + L::kRing + prev * L::kStage, 2 * BOX, wg, wt);
    hopper::fence_proxy_async();  // before the stage's next TMA writes
    hopper::mbar_arrive(bar_empty + 8 * prev);

    float alpha[2];
    wide::softmax_tile(sc, m, l, alpha, c.q0, t * wide::BK, r_lo, c_in, s,
                       causal, window, scale_log2);

    // O = alpha O + P V over this warpgroup's columns: P rounded to T in
    // place as the A fragment, one m64n64 product a box of V that holds
    // data, each half of the keys a stage
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = hopper::pack2<T>(sc[8 * kk + 2 * e],
                                     sc[8 * kk + 2 * e + 1]);
      hopper::fence_regs(pa[kk]);
    }
#pragma unroll
    for (int i = 0; i < wide::WG_COLS / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    const uint32_t my_v = wg * (c.wg_cols / CHUNK) * L::kVBox;
#pragma unroll
    for (int vh = 0; vh < 2; ++vh, ++j) {
      const int st = j % S;
      const uint32_t sd = ring + st * L::kStage + my_v;
      hopper::mbar_wait(bar_full + 8 * st, (j / S) & 1);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      if (t * wide::BK + vh * HALF < s) {
#pragma unroll
        for (int kk = 0; kk < HALF / 16; ++kk) {
#pragma unroll
          for (int nb = 0; nb < wide::WG_COLS / CHUNK; ++nb) {
            if (nb < n_box)
              hopper::wgmma_rs<T>(
                  reinterpret_cast<float(&)[32]>(acc[32 * nb]),
                  pa[vh * HALF / 16 + kk],
                  hopper::smem_desc(sd + nb * L::kVBox + kk * 16 * 128,
                                    L::kVBox, 1024),
                  1);
          }
        }
      }
      hopper::wgmma_commit();
      if (vh > 0) {
        hopper::wgmma_wait<1>();
        hopper::mbar_arrive(bar_empty + 8 * prev);
      }
      prev = st;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(bar_empty + 8 * prev);
  }
  wide::store_cols(o, c, acc, l, TMA || dv % 2 == 0, wg, cols, r_lo, c_in, s,
                   h, dv);
}

template <typename T, bool TMA>
int launch_wide(const Call& c) {
  const int smem = WideSmem::kBytes;
  auto kern = flash_attn_wgmma_wide_kernel<T, TMA>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int sw = wide::slice_cols(c.b, c.s, c.h, c.dv);
  const dim3 grid = cta_grid(c.b * c.h, c.s, wide::BQ, (c.dv + sw - 1) / sw);
  kern<<<grid, wide::THREADS, smem, c.stream>>>(
      c.tq, c.tk, c.tv, static_cast<const uint16_t*>(c.q),
      static_cast<const uint16_t*>(c.k), static_cast<const uint16_t*>(c.v),
      static_cast<T*>(c.o), c.s, c.h, c.kvh, c.d, c.dv, c.scale_log2,
      c.causal, c.window, c.g, sw);
  return (int)cudaGetLastError();
}

// One call of either 2-byte type: the checks and routing of both entry
// points (below).
template <typename T>
int forward(const void* q, const void* k, const void* v, void* o, int b,
            int s, int h, int kvh, int d, int dv, float scale, int causal,
            int window, void* stream) {
  if (d < 1 || dv < 1 || kvh <= 0 || h % kvh || window < 0 ||
      (window > 0 && !causal) ||
      !fits_grid(b, h, s, BQ, (dv - 1) / wide::slice_cols(b, s, h, dv) + 1))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0 || h == 0) return 0;
  Call c = {d % 8 == 0 && dv % 8 == 0,  // 16-byte rows: TMA
            {}, {}, {}, q, k, v, o, b, s, h, kvh, d, dv,
            scale * 1.4426950408889634f, causal, window,
            granule(2, d, dv, q, k, v), static_cast<cudaStream_t>(stream)};
  if (c.tma && (!make_map<T>(&c.tq, q, b, s, h, d) ||
                !make_map<T>(&c.tk, k, b, s, kvh, d) ||
                !make_map<T>(&c.tv, v, b, s, kvh, dv)))
    return (int)cudaErrorInvalidValue;
  const int p = d > dv ? d : dv;
  if (p <= 64) return route<T, 64, 3>(c);
  if (p <= 128) return route<T, 128, 2>(c);
  if (p <= 256) return route<T, 256, 1>(c);
  // the wide instance takes V in halves of a key tile: boxes of 32 keys
  if (c.tma && !make_map<T>(&c.tv, v, b, s, kvh, dv, wide::HALF))
    return (int)cudaErrorInvalidValue;
  return c.tma ? launch_wide<T, true>(c) : launch_wide<T, false>(c);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// flash_attn_tf32x3_kernel (design in the note at the top)
// ---------------------------------------------------------------------------
namespace tf {

constexpr int BQ = 64;                   // query rows per CTA: wgmma's M
constexpr int CONSUMERS = 128;           // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int CHUNK = 32;                // f32 columns of one 128-byte box
constexpr int QBOX = BQ * 128;           // bytes of one Q box
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Shared memory of one CTA for heads padded to P columns and BK-key tiles:
// Q, Q's lo part, K's lo part, K and V as TMA writes them, V^T and its lo
// part, then the barriers (q, k full, k empty, v full, v empty). Where
// V^T's two tiles do not fit beside the rest (P = 256), they lie over K's
// tile and K's lo part instead (`kAlias`), and the transposition waits for
// the S product. Every piece is a multiple of 1024 bytes.
template <int P, int BK>
struct Smem {
  static constexpr int kChunks = P / CHUNK;
  static constexpr int kKBox = BK * 128;         // one K or V box
  static constexpr int kQ = kChunks * QBOX;
  static constexpr int kTile = kChunks * kKBox;  // = P x BK x 4: V^T too
  static constexpr int kBarBytes = 8 * 5;
  static constexpr bool kAlias =
      1024 + 2 * kQ + 5 * kTile + kBarBytes > 232448;
  static constexpr int kKlo = 2 * kQ;
  static constexpr int kK = kKlo + kTile;
  static constexpr int kV = kK + kTile;
  static constexpr int kVThi = kAlias ? kK : kV + kTile;
  static constexpr int kVTlo = kAlias ? kKlo : kVThi + kTile;
  static constexpr int kBars = kAlias ? kV + kTile : kVTlo + kTile;
  static constexpr int kBytes = 1024 + kBars + kBarBytes;
};

// Writes the lo part of n float4 units at `x` to `lo` at the same offsets:
// the layout, swizzle included, is kept. Each consumer thread takes every
// 128th unit.
__device__ __forceinline__ void split(const uint8_t* x, uint8_t* lo, int n,
                                      int tid) {
  const float4* xs = reinterpret_cast<const float4*>(x);
  float4* ls = reinterpret_cast<float4*>(lo);
  for (int i = tid; i < n; i += CONSUMERS) {
    const float4 v = xs[i];
    ls[i] = make_float4(hopper::tf32_lo(v.x), hopper::tf32_lo(v.y),
                        hopper::tf32_lo(v.z), hopper::tf32_lo(v.w));
  }
}

// V (BK keys x 32-column boxes, as TMA wrote it) into V^T and its lo
// tile, K-major for the PV product (P rows of BK keys, 32-key chunks),
// the keys of each 8 in the order 0 2 4 6 1 3 5 7 (see the note at the
// top). A lane writes one 16-byte unit u of V^T (4 consecutive columns of
// V^T: keys 8 (u / 2) + u % 2 + {0, 2, 4, 6}) in 4 rows: 4 16-byte reads
// of V's rows, a 4 x 4 transpose in registers, 8 16-byte writes. The 8
// lanes of a unit group take the units of one key chunk; the 4 groups of a
// warp take column groups 2 apart, so reads and writes both run at 4
// wavefronts a warp instruction (the least for 512 bytes).
template <int P, int BK>
__device__ __forceinline__ void transpose_v(const uint8_t* v, uint8_t* vt_hi,
                                            uint8_t* vt_lo, int v_chunks,
                                            int warp, int lane) {
  const int u = lane & 7;
  const int lg = lane >> 3;
  const int key0 = 8 * (u >> 1) + (u & 1);
  const int steps = (BK / 32) * v_chunks * 2;  // (key chunk, box, parity)
  for (int w = warp; w < steps; w += CONSUMERS / 32) {
    const int par = w & 1;
    const int box = (w >> 1) % v_chunks;
    const int kc = (w >> 1) / v_chunks;
    const int g = par + 2 * lg;  // the column group in the box: 4 g..4 g+3
    float x[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = kc * 32 + key0 + 2 * i;
      const float4 r = *reinterpret_cast<const float4*>(
          v + box * (BK * 128) + key * 128 + ((g ^ (key & 7)) << 4));
      x[i][0] = r.x;
      x[i][1] = r.y;
      x[i][2] = r.z;
      x[i][3] = r.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = box * CHUNK + 4 * g + e;
      const int off = kc * (P * 128) + row * 128 + ((u ^ (row & 7)) << 4);
      *reinterpret_cast<float4*>(vt_hi + off) =
          make_float4(x[0][e], x[1][e], x[2][e], x[3][e]);
      *reinterpret_cast<float4*>(vt_lo + off) =
          make_float4(hopper::tf32_lo(x[0][e]), hopper::tf32_lo(x[1][e]),
                      hopper::tf32_lo(x[2][e]), hopper::tf32_lo(x[3][e]));
    }
  }
}

// TMA: as the bf16 kernel's.
template <int P, int BK, int MIN_BLOCKS, bool TMA>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_attn_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const uint32_t* __restrict__ q,
                         const uint32_t* __restrict__ k,
                         const uint32_t* __restrict__ v,
                         float* __restrict__ o, int s, int h, int kvh, int d,
                         int dv, float scale_log2, int causal, int window,
                         int g) {
  using L = Smem<P, BK>;
  static_assert(BK == 32 || BK == 64, "S is one m64n32 or m64n64 product");
  static_assert(P % 64 == 0, "O is a stack of m64n64 products");
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align every box to it
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const sm = smem_raw + (base - raw);  // the same bytes, generic
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_kfull = bar_q + 8, bar_kempty = bar_q + 16;
  const uint32_t bar_vfull = bar_q + 24, bar_vempty = bar_q + 32;

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / h;
  const int hq = blockIdx.x % h;
  const int kh = hq / (h / kvh);
  int q0, sl;                                        // heaviest tiles first
  if (!tile_of(s, BQ, 1, q0, sl)) return;            // past the last tile
  int n_tiles = (s + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ + BK - 1) / BK);
  const int lo = q0 - window + 1;  // the lowest row's first kept key
  const int t0 = window > 0 && lo > 0 ? lo / BK : 0;
  const bool windowed = window > 0;
  const int qk_chunks = (d + CHUNK - 1) / CHUNK;   // boxes that hold data
  const int v_chunks = (dv + CHUNK - 1) / CHUNK;

  if (tid == 0) {
    hopper::mbar_init(bar_q, TMA ? 1 : 32);
    hopper::mbar_init(bar_kfull, TMA ? 1 : 32);
    hopper::mbar_init(bar_kempty, CONSUMERS);
    hopper::mbar_init(bar_vfull, TMA ? 1 : 32);
    hopper::mbar_init(bar_vempty, CONSUMERS);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (!TMA && tid >= CONSUMERS) {  // the producer warp: all lanes load
    using hopper::Box;
    const int lane = tid - CONSUMERS;
    // byte strides between positions, and each head's first row
    const long ldq = 4L * h * d, ldk = 4L * kvh * d, ldv = 4L * kvh * dv;
    const uint8_t* qh = reinterpret_cast<const uint8_t*>(q) +
                        ((long)bi * s + q0) * ldq + 4L * hq * d;
    const uint8_t* kb = reinterpret_cast<const uint8_t*>(k) +
                        (long)bi * s * ldk + 4L * kh * d;
    const uint8_t* vb = reinterpret_cast<const uint8_t*>(v) +
                        (long)bi * s * ldv + 4L * kh * dv;
    auto produce = [&](auto gran) {
      constexpr int G = decltype(gran)::value;
      for (int c = 0; c < qk_chunks; ++c) {
        const Box bq[1] = {{base + c * QBOX, qh + 128 * c, ldq, s - q0,
                            4 * d - 128 * c}};
        hopper::load_boxes<G, BQ>(bq, true, lane, hopper::NoWait());
      }
      hopper::fence_proxy_async();
      hopper::mbar_arrive(bar_q);
      for (int t = t0; t < n_tiles; ++t) {
        const int par = ((t - t0) & 1) ^ 1;  // phases count from t0
        const int rows = s - t * BK;
        // K and V are loaded together: both buffers must be free (the
        // consumers free V before K in each tile, so this waits no longer)
        auto ready = [&] {
          hopper::mbar_wait(bar_kempty, par);
          hopper::mbar_wait(bar_vempty, par);
        };
        // the pad of K's boxes again each tile where V^T lies over them
        const bool zero = t == t0 || L::kAlias;
        for (int c = 0; c < max(qk_chunks, v_chunks); ++c) {
          const Box bk = {base + L::kK + c * L::kKBox,
                          kb + t * BK * ldk + 128 * c, ldk, rows,
                          4 * d - 128 * c};
          const Box bv = {base + L::kV + c * L::kKBox,
                          vb + t * BK * ldv + 128 * c, ldv, rows,
                          4 * dv - 128 * c};
          if (c < qk_chunks && c < v_chunks) {
            const Box kv[2] = {bk, bv};
            hopper::load_boxes<G, BK>(kv, zero, lane, ready);
          } else {
            const Box one[1] = {c < qk_chunks ? bk : bv};
            hopper::load_boxes<G, BK>(one, zero, lane, ready);
          }
        }
        hopper::fence_proxy_async();  // K goes to the tensor cores as it lies
        hopper::mbar_arrive(bar_kfull);
        hopper::mbar_arrive(bar_vfull);
      }
    };
    if (g == 8)
      produce(hopper::Int<8>());
    else
      produce(hopper::Int<4>());
    return;
  }
  if (tid >= CONSUMERS) {  // the producer warp: one lane issues every copy
    if (tid == CONSUMERS) {
      hopper::mbar_arrive_expect_tx(bar_q, qk_chunks * QBOX);
      for (int c = 0; c < qk_chunks; ++c)
        hopper::tma_load_4d(base + c * QBOX, &tm_q, bar_q, c * CHUNK, hq, q0,
                            bi);
      for (int t = t0; t < n_tiles; ++t) {
        const int par = ((t - t0) & 1) ^ 1;  // phases count from t0
        hopper::mbar_wait(bar_kempty, par);
        hopper::mbar_arrive_expect_tx(bar_kfull, qk_chunks * L::kKBox);
        for (int c = 0; c < qk_chunks; ++c)
          hopper::tma_load_4d(base + L::kK + c * L::kKBox, &tm_k, bar_kfull,
                              c * CHUNK, kh, t * BK, bi);
        hopper::mbar_wait(bar_vempty, par);
        hopper::mbar_arrive_expect_tx(bar_vfull, v_chunks * L::kKBox);
        for (int c = 0; c < v_chunks; ++c)
          hopper::tma_load_4d(base + L::kV + c * L::kKBox, &tm_v, bar_vfull,
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
  const int k_steps = (d + 7) / 8;           // k8 steps of S that see data
  const int v_slices = (dv + 63) / 64;       // n64 slices of O that do
  // descriptors of each operand's first k8 step (a step adds 32 bytes, a
  // box QBOX or BK x 128, a 64-row slice of V^T 8 KB: >> 4 in the address)
  const uint64_t desc_q = hopper::smem_desc(base, 16, 1024);
  const uint64_t desc_ql = hopper::smem_desc(base + L::kQ, 16, 1024);
  const uint64_t desc_k = hopper::smem_desc(base + L::kK, 16, 1024);
  const uint64_t desc_kl = hopper::smem_desc(base + L::kKlo, 16, 1024);
  const uint64_t desc_vh = hopper::smem_desc(base + L::kVThi, 16, 1024);
  const uint64_t desc_vl = hopper::smem_desc(base + L::kVTlo, 16, 1024);

  float acc[P / 2];
#pragma unroll
  for (int i = 0; i < P / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum
  uint32_t ph[BK / 8][4], pl[BK / 8][4];  // P's A fragments, hi and lo

  // Every wgmma group is committed and retired within one tile: a product
  // left running across the loop's back edge makes ptxas serialise them
  // all (the loop-carried accumulators are copied at the back edge).
  const int k_units = qk_chunks * L::kKBox / 16;
  hopper::mbar_wait(bar_q, 0);
  split(sm, sm + L::kQ, qk_chunks * QBOX / 16, tid);
  hopper::mbar_wait(bar_kfull, 0);
  split(sm + L::kK, sm + L::kKlo, k_units, tid);
  for (int t = t0; t < n_tiles; ++t) {
    const int par = (t - t0) & 1;
    hopper::fence_proxy_async();
    hopper::bar_sync(1, CONSUMERS);  // the lo parts of Q and K are written

    // S = Q K^T (f32) in three tf32 passes, the small terms first; the
    // first product overwrites S. The descriptors are rebuilt each tile
    // (kept in registers across the loop, 64 of them would crowd out the
    // accumulators)
    uint64_t dq = desc_q, dql = desc_ql, dk = desc_k, dkl = desc_kl;
    asm volatile("" : "+l"(dq), "+l"(dql), "+l"(dk), "+l"(dkl));
    float sc[BK / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
      const uint64_t a = pass == 1 ? dql : dq;   // Q hi, Q lo, Q hi
      const uint64_t b = pass == 0 ? dkl : dk;   // K lo, K hi, K hi
#pragma unroll
      for (int kc = 0; kc < P / 8; ++kc) {
        if (kc < k_steps)
          hopper::wgmma_tf32_ss(sc, a + (kc / 4) * (QBOX >> 4) + (kc % 4) * 2,
                                b + (kc / 4) * (L::kKBox >> 4) + (kc % 4) * 2,
                                pass + kc > 0);
      }
    }
    hopper::wgmma_commit();
    if (L::kAlias) {  // V^T goes over K's tiles: S must have read them
      hopper::wgmma_wait<0>();
      hopper::bar_sync(1, CONSUMERS);
    }

    // V^T (while the tensor cores compute S, unless aliased)
    hopper::mbar_wait(bar_vfull, par);
    transpose_v<P, BK>(sm + L::kV, sm + L::kVThi, sm + L::kVTlo, v_chunks,
                       warp, lane);
    hopper::fence_proxy_async();
    hopper::mbar_arrive(bar_vempty);  // V may be refilled
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::bar_sync(1, CONSUMERS);  // S is read out, V^T is written
    if (!L::kAlias) hopper::mbar_arrive(bar_kempty);  // K may be refilled

    // masks: the causal one on the diagonal tiles, the key one past s,
    // the window's lower edge on every tile that holds some row's edge
    const int k0 = t * BK;
    if (k0 + BK > s || (causal && k0 + BK - 1 > q0) ||
        (windowed && k0 <= q0 + BQ - 1 - window)) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int row = q0 + r_lo + 8 * ((i >> 1) & 1);
        const int col = k0 + 8 * (i >> 2) + c_in + (i & 1);
        if (col >= s || (causal && col > row) ||
            (windowed && col <= row - window))
          sc[i] = NEG;
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
      // a row with no kept key yet (its window starts in a later tile)
      // takes no shift: its p are then exp2(-1e30 x scale) = 0
      shift[r] = mx[r] == NEG ? 0.f : mx[r] * scale_log2;
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

    // P's A fragments, p and its lo part: registers 4kk..4kk+3 of the S
    // accumulator are rows (r, r, r+8, r+8) at keys (2c, 2c+1, 2c, 2c+1) of
    // the kk-th 8 keys; the fragment wants rows (r, r+8, r, r+8) at its
    // columns (c, c, c+4, c+4), so column c is key 2c and c+4 is key 2c+1
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const float pv[4] = {sc[4 * kk], sc[4 * kk + 2], sc[4 * kk + 1],
                           sc[4 * kk + 3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // p cut as the tensor core would read it, in a register of its own:
        // with the S accumulator's own register as the A fragment the
        // kernel ran 1.8-1.9x slower on an H100 (chip_attn_ab.py; ptxas
        // printed no serialisation note, the cause is not traced)
        ph[kk][e] = __float_as_uint(hopper::tf32_trunc(pv[e]));
        pl[kk][e] = __float_as_uint(hopper::tf32_lo(pv[e]));
      }
    }

    // O = alpha O + P V in three tf32 passes (P hi V lo, P lo V hi, P hi
    // V hi), one m64n64 product per 64 columns that hold data
#pragma unroll
    for (int i = 0; i < P / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    hopper::fence_regs(acc);
    uint64_t dvh = desc_vh, dvl = desc_vl;
    asm volatile("" : "+l"(dvh), "+l"(dvl));
    hopper::wgmma_fence();
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
      const uint64_t b = pass == 0 ? dvl : dvh;   // V^T lo, hi, hi
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
        for (int ns = 0; ns < P / 64; ++ns) {
          if (ns < v_slices)
            hopper::wgmma_tf32_rs(
                reinterpret_cast<float(&)[32]>(acc[32 * ns]),
                pass == 1 ? pl[kk] : ph[kk],
                b + (kk / 4) * (P * 128 >> 4) + (kk % 4) * 2 +
                    ns * (64 * 128 >> 4),
                1);
        }
      }
    }
    hopper::wgmma_commit();
    if (!L::kAlias && t + 1 < n_tiles) {
      // the next tile's K is split while the tensor cores compute PV
      hopper::mbar_wait(bar_kfull, par ^ 1);
      split(sm + L::kK, sm + L::kKlo, k_units, tid);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (L::kAlias) {
      hopper::bar_sync(1, CONSUMERS);  // PV has read V^T: K's tiles are free
      hopper::mbar_arrive(bar_kempty);
      if (t + 1 < n_tiles) {
        hopper::mbar_wait(bar_kfull, par ^ 1);
        split(sm + L::kK, sm + L::kKlo, k_units, tid);
      }
    }
  }

  // epilogue: acc / max(l, 1e-30), rows below s, columns below dv
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
  }
  const long o_row = (long)h * dv;
  float* ob = o + (long)bi * s * o_row + (long)hq * dv;
  const bool pairs = TMA || dv % 2 == 0;  // a pair stays in the row, aligned
#pragma unroll
  for (int i = 0; i < P / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int row = q0 + r_lo + 8 * r;
    const int col = 8 * (i >> 2) + c_in;
    if (row < s && col < dv) {
      float* out = ob + row * o_row + col;
      if (pairs) {
        *reinterpret_cast<float2*>(out) =
            make_float2(acc[i] / den[r], acc[i + 1] / den[r]);
      } else {
        out[0] = acc[i] / den[r];
        if (col + 1 < dv) out[1] = acc[i + 1] / den[r];
      }
    }
  }
}

template <int P, int BK, int MIN_BLOCKS, bool TMA>
int launch(const Call& c) {
  const int smem = Smem<P, BK>::kBytes;
  auto kern = flash_attn_tf32x3_kernel<P, BK, MIN_BLOCKS, TMA>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = cta_grid(c.b * c.h, c.s, BQ, 1);
  kern<<<grid, THREADS, smem, c.stream>>>(
      c.tq, c.tk, c.tv, static_cast<const uint32_t*>(c.q),
      static_cast<const uint32_t*>(c.k), static_cast<const uint32_t*>(c.v),
      static_cast<float*>(c.o), c.s, c.h, c.kvh, c.d, c.dv, c.scale_log2,
      c.causal, c.window, c.g);
  return (int)cudaGetLastError();
}

// The key-tile length for heads padded to P columns: 64, or 32 where the
// 256-column tiles would not fit in shared memory beside Q.
template <int P>
constexpr int tile_keys() { return P <= 128 ? 64 : 32; }

// The instance for heads padded to P columns, on the call's route.
template <int P>
int route(const Call& c) {
  return c.tma ? launch<P, tile_keys<P>(), 1, true>(c)
               : launch<P, tile_keys<P>(), 1, false>(c);
}


// ---- the wide instance: d or dv over 256 (the note at the top) ----
// Its operands, split once a call by tf32_split_kernel into the scratch the
// wrapper allocates (split_floats floats): q's and k's rows as (b, s,
// heads, 2 dp), hi in columns [0, dp), lo in [dp, 2 dp), dp = d rounded up
// to 32, zeros past d; then V^T as (b, kvh, 2, dv, s8), hi then lo, keys
// along a row of s8 = s rounded up to 8, zeros past s. Within each 8 the
// keys lie in the order 0 2 4 6 1 3 5 7 (position p holds key
// split_key(p)), as the narrow instance writes V^T: P's A fragment is then
// the S accumulator's registers as they lie (the note at the top).
__host__ __device__ inline int split_cols(int d) { return (d + 31) / 32 * 32; }
__host__ __device__ inline int split_keys(int s) { return (s + 7) / 8 * 8; }
__device__ __forceinline__ int split_key(int p) {
  return (p & ~7) | ((p & 3) << 1) | ((p >> 2) & 1);
}
inline long long split_floats(int b, int s, int h, int kvh, int d, int dv) {
  return (long long)b * s * (h + kvh) * 2 * split_cols(d) +
         (long long)b * kvh * 2 * dv * split_keys(s);
}

constexpr int SPLIT_THREADS = 256;

// The pre-pass. Blocks [0, nq) take q's elements (four columns of a row a
// thread, hi and lo written as float4), [nq, nq + nk) k's, the rest V^T's
// 32 x 32 tiles (b, kvh, key
// block, column block), transposed through shared memory so that reads
// and writes both run along rows (a permutation within 8 keys stays in a
// tile).
__global__ void __launch_bounds__(SPLIT_THREADS)
tf32_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ qs,
                  float* __restrict__ ks, float* __restrict__ vt,
                  long long q_rows, long long k_rows, long long nq,
                  long long nk, int b, int s, int kvh, int d, int dv) {
  const int dp = split_cols(d), s8 = split_keys(s);
  const long long blk = blockIdx.x;
  if (blk < nq + nk) {
    const bool is_q = blk < nq;
    // dp is a multiple of 32: a thread's four columns lie in one row
    const long long e =
        ((is_q ? blk : blk - nq) * SPLIT_THREADS + threadIdx.x) * 4;
    if (e >= (is_q ? q_rows : k_rows) * dp) return;
    const long long row = e / dp;
    const int col = (int)(e - row * dp);
    const float* src = (is_q ? q : k) + row * d;
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = col + i < d ? src[col + i] : 0.f;
    float* out = (is_q ? qs : ks) + row * 2 * dp + col;
    *reinterpret_cast<float4*>(out) =
        make_float4(hopper::tf32_trunc(x[0]), hopper::tf32_trunc(x[1]),
                    hopper::tf32_trunc(x[2]), hopper::tf32_trunc(x[3]));
    *reinterpret_cast<float4*>(out + dp) =
        make_float4(hopper::tf32_lo(x[0]), hopper::tf32_lo(x[1]),
                    hopper::tf32_lo(x[2]), hopper::tf32_lo(x[3]));
    return;
  }
  __shared__ float tile[32][33];
  const int k_blocks = (s8 + 31) / 32, c_blocks = (dv + 31) / 32;
  long long tb = blk - nq - nk;
  const int cb = (int)(tb % c_blocks);
  tb /= c_blocks;
  const int kb = (int)(tb % k_blocks);
  tb /= k_blocks;
  const int kh = (int)(tb % kvh);
  const long long bi = tb / kvh;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += SPLIT_THREADS / 32) {  // columns along tx
    const int key = kb * 32 + r, col = cb * 32 + tx;
    tile[r][tx] = key < s && col < dv
                      ? v[((bi * s + key) * kvh + kh) * dv + col]
                      : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += SPLIT_THREADS / 32) {  // keys along tx
    const int col = cb * 32 + r, at = kb * 32 + tx;       // at: a position
    if (col < dv && at < s8) {
      const float x = tile[split_key(tx)][r];
      float* out = vt + ((bi * kvh + kh) * 2 * dv + col) * s8 + at;
      out[0] = hopper::tf32_trunc(x);
      out[(long long)dv * s8] = hopper::tf32_lo(x);
    }
  }
}

// The split copies of one call, in the scratch (above).
struct Split {
  float *qs, *ks, *vt;
  Split(const Call& c, void* scratch)
      : qs(static_cast<float*>(scratch)),
        ks(qs + (long long)c.b * c.s * c.h * 2 * split_cols(c.d)),
        vt(ks + (long long)c.b * c.s * c.kvh * 2 * split_cols(c.d)) {}
};

// Launches the pre-pass on the call's stream; returns its launch error.
int split(const Call& c, const Split& sp) {
  const long long q_rows = (long long)c.b * c.s * c.h;
  const long long k_rows = (long long)c.b * c.s * c.kvh;
  const int dp = split_cols(c.d);
  const long long nq = (q_rows * dp / 4 + SPLIT_THREADS - 1) / SPLIT_THREADS;
  const long long nk = (k_rows * dp / 4 + SPLIT_THREADS - 1) / SPLIT_THREADS;
  const long long nv = (long long)c.b * c.kvh * ((split_keys(c.s) + 31) / 32) *
                       ((c.dv + 31) / 32);
  if (nq + nk + nv > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tf32_split_kernel<<<(unsigned)(nq + nk + nv), SPLIT_THREADS, 0, c.stream>>>(
      static_cast<const float*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), sp.qs, sp.ks, sp.vt, q_rows, k_rows, nq,
      nk, c.b, c.s, c.kvh, c.d, c.dv);
  return (int)cudaGetLastError();
}

// Shared memory: kStages stages of 64 KB, then the barriers (full[],
// empty[]). A stage holds one key tile's chunk of d (64 columns), warpgroup
// w's 32 in its half w: Q's hi and lo parts, then K's (64-row boxes); or a
// quarter of V^T (for each warpgroup w, at w x 32 KB, 64 of its columns:
// hi then lo, each two 32-key boxes).
struct WideSmem {
  static constexpr int kBox = 64 * 128;         // 64 rows x 32 f32
  static constexpr int kChunk = 64;             // d's columns a stage
  static constexpr int kStages = 3;
  static constexpr int kStage = 8 * kBox;
  static constexpr int kBars = kStages * kStage;
  static constexpr int kBytes = 1024 + kBars + 8 * 2 * kStages;
  static_assert(kBytes <= 232448, "227 KB of shared memory a CTA");
  __device__ static int chunk(int) { return kChunk; }
  // V^T's stages a key tile: a quarter of each warpgroup's 256 columns
  __device__ static int v_stages(int cols0) { return (cols0 + 63) / 64; }
};

__global__ void __launch_bounds__(wide::THREADS, 1)
flash_attn_tf32x3_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              float* __restrict__ o, int s, int h, int kvh,
                              int d, int dv, float scale_log2, int causal,
                              int window, int sw) {
  using L = WideSmem;
  constexpr int S = L::kStages, HALF = wide::HALF, BOX = L::kBox;
  constexpr int BK = wide::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const sm = smem_raw + (base - raw);  // the same bytes, generic
  const uint32_t ring = base;
  const uint32_t bar_full = base + L::kBars;       // + 8 i
  const uint32_t bar_empty = bar_full + 8 * S;     // + 8 i
  const int tid = threadIdx.x;
  const wide::Cta<L> c(s, h, kvh, d, dv, causal, window, sw);
  if (!c.live) return;                             // past the last pair
  const int dp = split_cols(d);

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      hopper::mbar_init(bar_full + 8 * i, 1);
      hopper::mbar_init(bar_empty + 8 * i, wide::CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= wide::CONSUMERS) {
    // ---- the producer warpgroup, one lane (every operand by TMA): stage
    // j of the run in slot j % S, phase (j / S) & 1; a key tile's stages
    // are d's chunks, then V^T's quarters (a 32-key half wholly past s is
    // not loaded: nothing multiplies it) ----
    hopper::setmaxnreg_dec<wide::PRODUCER_REGS>();
    if (tid != wide::CONSUMERS) return;
    int j = 0;
    for (int t = c.t0; t < c.n_tiles; ++t) {
      const int k0 = t * BK;
      for (int x = 0; x < c.s_stages + c.v_stages; ++x, ++j) {
        const int st = j % S;
        const uint32_t full = bar_full + 8 * st;
        const uint32_t sd = ring + st * L::kStage;
        hopper::mbar_wait(bar_empty + 8 * st, ((j / S) & 1) ^ 1);
        if (x < c.s_stages) {
          const int col = x * L::kChunk;
          const int n = min(2, (dp - col) / 32);
          hopper::mbar_arrive_expect_tx(full, 4 * n * BOX);
          for (int i = 0; i < n; ++i) {
            const int hi = col + 32 * i, lo = dp + col + 32 * i;
            const uint32_t at = sd + 4 * i * BOX;
            hopper::tma_load_4d(at, &tm_q, full, hi, c.hq, c.q0, c.bi);
            hopper::tma_load_4d(at + BOX, &tm_q, full, lo, c.hq, c.q0, c.bi);
            hopper::tma_load_4d(at + 2 * BOX, &tm_k, full, hi, c.kh, k0, c.bi);
            hopper::tma_load_4d(at + 3 * BOX, &tm_k, full, lo, c.kh, k0, c.bi);
          }
        } else {
          const int qt = x - c.s_stages;  // the quarter
          const int halves = k0 + HALF < s ? 2 : 1;
          int n = 0;
          for (int w = 0; w < 2; ++w) n += 64 * qt < c.cols[w];
          hopper::mbar_arrive_expect_tx(full, n * 2 * halves * BOX);
          for (int w = 0; w < 2; ++w) {
            if (64 * qt >= c.cols[w]) continue;
            for (int part = 0; part < 2; ++part)
              for (int kb = 0; kb < halves; ++kb)
                hopper::tma_load_4d(
                    sd + (4 * w + 2 * part + kb) * BOX, &tm_v, full,
                    k0 + HALF * kb, c.v0 + c.wg_cols * w + 64 * qt,
                    2 * c.kh + part, c.bi);
          }
        }
      }
    }
    return;
  }

  // ---- the two consumer warpgroups: each half of d's columns of every
  // key tile's S, then the whole S and softmax, and its columns of O;
  // both products in three tf32 passes ----
  hopper::setmaxnreg_inc<wide::CONSUMER_REGS>();
  const int wg = tid >> 7;
  const int wt = tid & 127;
  const int warp = wt >> 5;
  const int lane = tid & 31;
  const int r_lo = warp * 16 + (lane >> 2);  // this thread's rows: r_lo, +8
  const int c_in = 2 * (lane & 3);           // its columns in each 8-block
  const int cols = wg ? c.cols[1] : c.cols[0];  // its columns of O

  float acc[wide::WG_COLS / 2];
#pragma unroll
  for (int i = 0; i < wide::WG_COLS / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum
  uint32_t ph[BK / 8][4], pl[BK / 8][4];  // P's A fragments, hi and lo

  // Every wgmma group is retired within its key tile.
  int j = 0, prev = 0;  // the ring's stage, and the last one taken
  for (int t = c.t0; t < c.n_tiles; ++t) {
    // this warpgroup's part of S: over its 32 columns of each of d's chunks,
    // in three passes, the small terms first (Q hi K lo, Q lo K hi, Q hi K
    // hi); a stage freed once the next chunk's product is issued and its
    // own has retired; the tile's last stage is kept for the exchange
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    for (int x = 0; x < c.s_stages; ++x, ++j) {
      const int st = j % S;
      const uint32_t half = ring + st * L::kStage + wg * 4 * BOX;
      hopper::mbar_wait(bar_full + 8 * st, (j / S) & 1);
      // descriptors of each operand's first k8 step (a step adds 32 bytes:
      // >> 4 in the address); opaque, so that they are not hoisted with
      // their offsets
      uint64_t qh = hopper::smem_desc(half, 16, 1024);
      uint64_t ql = hopper::smem_desc(half + BOX, 16, 1024);
      uint64_t kh = hopper::smem_desc(half + 2 * BOX, 16, 1024);
      uint64_t kl = hopper::smem_desc(half + 3 * BOX, 16, 1024);
      asm volatile("" : "+l"(qh), "+l"(ql), "+l"(kh), "+l"(kl));
      const int col0 = x * L::kChunk + wg * 32;  // its first column
      hopper::fence_regs(sc);
      hopper::wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
        const uint64_t a = pass == 1 ? ql : qh;
        const uint64_t b = pass == 0 ? kl : kh;
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          if (col0 + 8 * kc < d)
            hopper::wgmma_tf32_ss(sc, a + kc * 2, b + kc * 2, 1);
        }
      }
      hopper::wgmma_commit();
      if (x > 0) {
        hopper::wgmma_wait<1>();
        hopper::mbar_arrive(bar_empty + 8 * prev);
      }
      prev = st;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    wide::exchange(sc, sm + prev * L::kStage, 4 * BOX, wg, wt);
    hopper::fence_proxy_async();  // before the stage's next TMA writes
    hopper::mbar_arrive(bar_empty + 8 * prev);

    const int k0 = t * BK;
    float alpha[2];
    wide::softmax_tile(sc, m, l, alpha, c.q0, k0, r_lo, c_in, s, causal,
                       window, scale_log2);

    // P's A fragments, hi (the low 13 bits cleared) and lo: registers
    // 4kk..4kk+3 of the S accumulator are rows (r, r, r+8, r+8) at keys (2c,
    // 2c+1, 2c, 2c+1) of the kk-th 8 keys; the fragment wants rows (r, r+8,
    // r, r+8) at its columns (c, c, c+4, c+4), which V^T's order of keys
    // (0 2 4 6 1 3 5 7) makes keys 2c and 2c+1
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const float pv[4] = {sc[4 * kk], sc[4 * kk + 2], sc[4 * kk + 1],
                           sc[4 * kk + 3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ph[kk][e] = __float_as_uint(hopper::tf32_trunc(pv[e]));
        pl[kk][e] = __float_as_uint(hopper::tf32_lo(pv[e]));
      }
    }

    // O = alpha O + P V in three passes (P hi V lo, P lo V hi, P hi V hi),
    // each quarter of this warpgroup's columns a stage (an m64n64 product)
#pragma unroll
    for (int i = 0; i < wide::WG_COLS / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    const int halves = k0 + HALF < s ? 2 : 1;
#pragma unroll
    for (int qt = 0; qt < wide::WG_COLS / 64; ++qt) {
      if (qt < c.v_stages) {
        const int st = j % S;
        const uint32_t sd = ring + st * L::kStage + wg * 4 * BOX;
        hopper::mbar_wait(bar_full + 8 * st, (j / S) & 1);
        uint64_t vh = hopper::smem_desc(sd, 16, 1024);
        uint64_t vl = hopper::smem_desc(sd + 2 * BOX, 16, 1024);
        asm volatile("" : "+l"(vh), "+l"(vl));
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
        if (64 * qt < cols) {
#pragma unroll
          for (int pass = 0; pass < 3; ++pass) {
            const uint64_t b = pass == 0 ? vl : vh;
#pragma unroll
            for (int kk = 0; kk < BK / 8; ++kk) {
              if (kk / 4 < halves)
                hopper::wgmma_tf32_rs(
                    reinterpret_cast<float(&)[32]>(acc[32 * qt]),
                    pass == 1 ? pl[kk] : ph[kk],
                    b + (kk / 4) * (BOX >> 4) + (kk % 4) * 2, 1);
            }
          }
        }
        hopper::wgmma_commit();
        if (qt > 0) {
          hopper::wgmma_wait<1>();
          hopper::mbar_arrive(bar_empty + 8 * prev);
        }
        prev = st;
        ++j;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(bar_empty + 8 * prev);
  }
  wide::store_cols(o, c, acc, l, dv % 2 == 0, wg, cols, r_lo, c_in, s, h,
                   dv);
}

// A tensor map over V^T's two parts (split_floats' layout): boxes of 32
// key positions x 64 columns of V of one (kv head, part), 128-byte
// swizzled; positions past s8 and columns past dv arrive as zeros.
bool make_vt_map(CUtensorMap* map, const float* vt, int b, int s, int kvh,
                 int dv) {
  const tma::EncodeTiled fn = tma::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t row = (cuuint64_t)split_keys(s) * 4;
  const cuuint64_t dims[4] = {(cuuint64_t)split_keys(s), (cuuint64_t)dv,
                              (cuuint64_t)kvh * 2, (cuuint64_t)b};
  const cuuint64_t strides[3] = {row, row * dv, row * dv * kvh * 2};
  const cuuint32_t box[4] = {(cuuint32_t)wide::HALF, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(vt),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The wide call: the pre-pass, then the kernel on its output, each launch
// checked. `bytes`: the scratch's size, at least split_floats x 4.
int launch_wide(const Call& c, void* scratch, long long bytes) {
  if (scratch == nullptr ||
      bytes < 4 * split_floats(c.b, c.s, c.h, c.kvh, c.d, c.dv))
    return (int)cudaErrorInvalidValue;
  const Split sp(c, scratch);
  int err = split(c, sp);
  if (err != 0) return err;
  const int dp = split_cols(c.d);
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap tq, tk, tv;
  if (!tma::make_map(&tq, f32, 4, sp.qs, c.b, c.s, c.h, 2 * dp, CHUNK, BQ) ||
      !tma::make_map(&tk, f32, 4, sp.ks, c.b, c.s, c.kvh, 2 * dp, CHUNK,
                     wide::BK) ||
      !make_vt_map(&tv, sp.vt, c.b, c.s, c.kvh, c.dv))
    return (int)cudaErrorInvalidValue;
  const int smem = WideSmem::kBytes;
  auto kern = flash_attn_tf32x3_wide_kernel;
  err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  const int sw = wide::slice_cols(c.b, c.s, c.h, c.dv);
  const dim3 grid = cta_grid(c.b * c.h, c.s, wide::BQ, (c.dv + sw - 1) / sw);
  kern<<<grid, wide::THREADS, smem, c.stream>>>(
      tq, tk, tv, static_cast<float*>(c.o), c.s, c.h, c.kvh, c.d, c.dv,
      c.scale_log2, c.causal, c.window, sw);
  return (int)cudaGetLastError();
}

}  // namespace tf

extern "C" {

// The wgmma kernel's two entry points, one for each 2-byte type: bf16
// (fa_forward_wgmma) and f16 (fa_forward_wgmma_f16), the same kernel
// instanced for the type. q, k, v, o: device pointers of contiguous (b, s,
// h|kvh, d|dv) tensors of that type. The wrapper checks d, dv >= 1,
// h % kvh == 0, that the grid can hold the call (b h <= 2^31 - 1, and
// query tiles x o slices within 65,535^2: fits_grid), and that q, k and v
// are 16-byte aligned where d and dv are multiples of 8 (the TMA route);
// window: 0 (none) or the sliding window's width (causal only). Returns
// cudaErrorInvalidValue where cuTensorMapEncodeTiled refuses a tensor map.
int fa_forward_wgmma(const void* q, const void* k, const void* v, void* o,
                     int b, int s, int h, int kvh, int d, int dv, float scale,
                     int causal, int window, void* stream) {
  return wg::forward<__nv_bfloat16>(q, k, v, o, b, s, h, kvh, d, dv, scale,
                                    causal, window, stream);
}
int fa_forward_wgmma_f16(const void* q, const void* k, const void* v,
                         void* o, int b, int s, int h, int kvh, int d, int dv,
                         float scale, int causal, int window, void* stream) {
  return wg::forward<__half>(q, k, v, o, b, s, h, kvh, d, dv, scale, causal,
                             window, stream);
}

// The f32 kernel. q, k, v, o: device pointers of contiguous float32 (b, s,
// h|kvh, d|dv) tensors. The wrapper's checks are the bf16 kernel's, with
// the TMA route where d and dv are multiples of 4. A wide call (d or dv over
// 256) splits its operands first into `scratch` (device memory of
// `scratch_bytes`, at least 4 x split_floats; unused by the other calls),
// two launches, each checked. Returns cudaErrorInvalidValue where
// cuTensorMapEncodeTiled refuses a tensor map or the scratch is short.
int fa_forward_tf32x3(const void* q, const void* k, const void* v, void* o,
                      int b, int s, int h, int kvh, int d, int dv,
                      float scale, int causal, int window, void* scratch,
                      long long scratch_bytes, void* stream) {
  if (d < 1 || dv < 1 || kvh <= 0 || h % kvh || window < 0 ||
      (window > 0 && !causal) ||
      !fits_grid(b, h, s, tf::BQ,
                 (dv - 1) / wide::slice_cols(b, s, h, dv) + 1))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0 || h == 0) return 0;
  const int p = d > dv ? d : dv;
  Call c = {d % 4 == 0 && dv % 4 == 0,  // 16-byte rows: TMA
            {}, {}, {}, q, k, v, o, b, s, h, kvh, d, dv,
            scale * 1.4426950408889634f, causal, window,
            granule(4, d, dv, q, k, v), static_cast<cudaStream_t>(stream)};
  if (p > 256) return tf::launch_wide(c, scratch, scratch_bytes);
  const int bk = p <= 128 ? tf::tile_keys<128>() : tf::tile_keys<256>();
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (c.tma &&
      (!tma::make_map(&c.tq, f32, 4, q, b, s, h, d, tf::CHUNK, tf::BQ) ||
       !tma::make_map(&c.tk, f32, 4, k, b, s, kvh, d, tf::CHUNK, bk) ||
       !tma::make_map(&c.tv, f32, 4, v, b, s, kvh, dv, tf::CHUNK, bk)))
    return (int)cudaErrorInvalidValue;
  if (p <= 64) return tf::route<64>(c);
  if (p <= 128) return tf::route<128>(c);
  return tf::route<256>(c);
}

// The f32 wide instance's pre-pass alone (its output is fa_forward_tf32x3's
// scratch for the same call): held to its plain version and timed on its
// own. Any d, dv >= 1.
int fa_tf32x3_split(const void* q, const void* k, const void* v, int b,
                    int s, int h, int kvh, int d, int dv, void* scratch,
                    long long scratch_bytes, void* stream) {
  if (d < 1 || dv < 1 || kvh <= 0 || h % kvh || scratch == nullptr ||
      scratch_bytes < 4 * tf::split_floats(b, s, h, kvh, d, dv))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0 || h == 0) return 0;
  Call c = {true, {}, {}, {}, q, k, v, nullptr, b, s, h, kvh, d, dv, 0.f,
            0, 0, 4, static_cast<cudaStream_t>(stream)};
  return tf::split(c, tf::Split(c, scratch));
}

}  // extern "C"
