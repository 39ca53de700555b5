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
//   flash_attn_tf32x3_wide_kernel: d or dv over 256). Neither a whole O
//   row nor a resident Q fits: one warpgroup holds at most 256 f32
//   accumulator columns (128 registers a thread), and a CTA's 227 KB of
//   shared memory holds a 576-column bf16 Q and one K stage of the same
//   width only just, an f32 one not at all. So:
//   - O's columns are split across CTAs: grid z takes slices of 256
//     columns (O_SLICE), and each CTA computes S and the softmax of its
//     query tile over again and stores only its slice. S is recomputed
//     once a slice: at d = 576, dv = 512 the kernel does 2 x 576 + 512 =
//     1,664 columns of products for the function's 1,088 (1.53x).
//   - d is streamed: for each key tile, Q's and K's chunks of 128 columns
//     (kDChunk) pass through a ring of stages together (Q is read from L2
//     again for each key tile), S = sum over chunks of Q_c K_c^T in the
//     same f32 registers, then V's slice takes a stage of its own. The
//     scale is 1/sqrt(d) of the true d. Stages are one size, so one ring
//     and one pair of mbarriers a stage carry both kinds; one producer
//     (wide::produce) fills it for both kernels, on both load routes.
//   - bf16: chunks of 128 columns (Q_c 16 KB + K_c 16 KB = one 32 KB stage,
//     as a 64-key x 256-column V slice is), six stages; P V in m64n64
//     products, one a 64-column box of the slice that holds data.
//   - f32: 32-key tiles, chunks of 128 columns (Q_c 32 KB + K_c 16 KB), 3
//     stages of 48 KB; the lo parts of Q_c and K_c are formed in 48 KB of
//     scratch, and V^T and its lo part (2 x 32 KB) lie over the same
//     scratch once S is read out. Every phase runs in turn.
//   - Both load routes as above: a slice is a column offset (TMA: a box
//     coordinate in the same V map; the producer warp: a column offset in
//     its source pointer, the row length still dv). The producer warp's
//     boxes are zeroed past the data each time, since a stage holds Q and
//     K in one use and V in the next.
//   Offsets into q, k, v and o are 64-bit throughout (a q of more than
//   2^31 elements is taken).
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

constexpr int O_SLICE = 256;     // columns of O a CTA computes (grid z)
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// The masks and the online softmax of one key tile of BK = 2 N keys, as the
// narrow instances run them: S's m64nBK accumulator fragment `sc` (row
// r_lo + 8 ((i / 2) % 2), key k0 + 8 (i / 4) + c_in + i % 2 of register i)
// becomes p (f32); m and l (this thread's share of each row's sum) are
// carried, alpha is the rescale of O.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int q0, int k0, int r_lo,
                                             int c_in, int s, int causal,
                                             int window, float scale_log2) {
  constexpr int BQ = 64, BK = 2 * N;
  const bool windowed = window > 0;
  // the causal mask on the diagonal tiles, the key one past s, the
  // window's lower edge on every tile that holds some row's edge
  if (k0 + BK > s || (causal && k0 + BK - 1 > q0) ||
      (windowed && k0 <= q0 + BQ - 1 - window)) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int row = q0 + r_lo + 8 * ((i >> 1) & 1);
      const int col = k0 + 8 * (i >> 2) + c_in + (i & 1);
      if (col >= s || (causal && col > row) ||
          (windowed && col <= row - window))
        sc[i] = NEG;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < N; ++i)
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
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = exp2f(fmaf(sc[i], scale_log2, -shift[r]));
    rs[r] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

// The producer warp's loads of n boxes of one operand into one stage, two
// boxes a call of load_boxes: box i (ROWS positions x 128 bytes) at dst + i
// box_bytes, from src + 128 i, with bytes - 128 i bytes of data a row and
// the rest zeroed (a stage holds another operand in its previous use).
template <int G, int ROWS, typename Ready>
__device__ __forceinline__ void load_run(uint32_t dst, int box_bytes,
                                         const uint8_t* src, long ld,
                                         int rows, int bytes, int n,
                                         int lane, Ready ready) {
  using hopper::Box;
  for (int i = 0; i < n; i += 2) {
    const Box b0 = {dst + i * box_bytes, src + 128 * i, ld, rows,
                    bytes - 128 * i};
    if (i + 1 < n) {
      const Box two[2] = {b0, {dst + (i + 1) * box_bytes,
                               src + 128 * (i + 1), ld, rows,
                               bytes - 128 * (i + 1)}};
      hopper::load_boxes<G, ROWS>(two, true, lane, ready);
    } else {
      const Box one[1] = {b0};
      hopper::load_boxes<G, ROWS>(one, true, lane, ready);
    }
  }
}

// One CTA of a wide instance whose shared-memory layout is L (kBQ query
// rows, kBK keys a tile, boxes of kChunk columns, d's chunks of kDChunk):
// its batch row and query head (grid x), its query tile, heaviest first,
// and its slice of O's columns from v0 (tile_of: live is false for a CTA
// past the last pair), the key tiles it walks (from t0, the tile that
// holds its lowest row's window edge) and the boxes of its slice that hold
// data.
template <typename L>
struct Cta {
  int bi, hq, kh, q0, v0, t0, n_tiles, d_chunks, v_boxes;
  bool live;

  __device__ __forceinline__ Cta(int s, int h, int kvh, int d, int dv,
                                 int causal, int window) {
    bi = blockIdx.x / h;
    hq = blockIdx.x % h;
    kh = hq / (h / kvh);
    int sl;
    live = tile_of(s, L::kBQ, (dv + O_SLICE - 1) / O_SLICE, q0, sl);
    v0 = sl * O_SLICE;
    n_tiles = (s + L::kBK - 1) / L::kBK;
    if (causal) n_tiles = min(n_tiles, (q0 + L::kBQ + L::kBK - 1) / L::kBK);
    const int lo = q0 - window + 1;  // the lowest row's first kept key
    t0 = window > 0 && lo > 0 ? lo / L::kBK : 0;
    d_chunks = (d - 1) / L::kDChunk + 1;
    v_boxes = min((dv - v0 + L::kChunk - 1) / L::kChunk, O_SLICE / L::kChunk);
  }

  // the boxes of d's chunk c that hold data
  __device__ __forceinline__ int chunk_boxes(int d, int c) const {
    return min(L::kDChunk / L::kChunk,
               (d - c * L::kDChunk + L::kChunk - 1) / L::kChunk);
  }
};

// The producer warp of a wide instance (`lane` 0-31). Stage j of the run
// (for each key tile, d_chunks stages of Q's and K's chunk c, Q's boxes at
// the stage's start and K's at L::kKOff, then one of V's slice) lies in slot
// j % L::kStages, in phase (j / L::kStages) & 1, each slot with a full and
// an empty mbarrier (bar_full + 8 slot, bar_empty + 8 slot); the consumers
// take the stages in the same order. By TMA one lane issues the copies;
// otherwise every lane loads the same boxes in granules of g bytes.
template <typename L, bool TMA>
__device__ __forceinline__ void produce(
    const Cta<L>& c, const CUtensorMap* tm_q, const CUtensorMap* tm_k,
    const CUtensorMap* tm_v, const void* q, const void* k, const void* v,
    int s, int h, int kvh, int d, int dv, int g, uint32_t base,
    uint32_t bar_full, uint32_t bar_empty, int lane) {
  constexpr int E = L::kElem, C = L::kChunk, BK = L::kBK;
  if constexpr (TMA) {
    if (lane != 0) return;
    int j = 0;
    for (int t = c.t0; t < c.n_tiles; ++t) {
      for (int ch = 0; ch <= c.d_chunks; ++ch, ++j) {  // d_chunks: V's slice
        const int st = j % L::kStages;
        const uint32_t full = bar_full + 8 * st;
        const uint32_t sd = base + st * L::kStage;
        hopper::mbar_wait(bar_empty + 8 * st, ((j / L::kStages) & 1) ^ 1);
        if (ch < c.d_chunks) {
          const int col = ch * L::kDChunk;
          const int n = c.chunk_boxes(d, ch);
          hopper::mbar_arrive_expect_tx(full, n * (L::kQBox + L::kKBox));
          for (int i = 0; i < n; ++i) {
            hopper::tma_load_4d(sd + i * L::kQBox, tm_q, full, col + i * C,
                                c.hq, c.q0, c.bi);
            hopper::tma_load_4d(sd + L::kKOff + i * L::kKBox, tm_k, full,
                                col + i * C, c.kh, t * BK, c.bi);
          }
        } else {
          hopper::mbar_arrive_expect_tx(full, c.v_boxes * L::kKBox);
          for (int i = 0; i < c.v_boxes; ++i)
            hopper::tma_load_4d(sd + i * L::kKBox, tm_v, full,
                                c.v0 + i * C, c.kh, t * BK, c.bi);
        }
      }
    }
  } else {
    // byte strides between positions, and each head's first row (V's from
    // the slice's first column)
    const long ldq = (long)E * h * d, ldk = (long)E * kvh * d,
               ldv = (long)E * kvh * dv;
    const uint8_t* qh = reinterpret_cast<const uint8_t*>(q) +
                        ((long)c.bi * s + c.q0) * ldq + (long)E * c.hq * d;
    const uint8_t* kb = reinterpret_cast<const uint8_t*>(k) +
                        (long)c.bi * s * ldk + (long)E * c.kh * d;
    const uint8_t* vb = reinterpret_cast<const uint8_t*>(v) +
                        (long)c.bi * s * ldv + (long)E * (c.kh * (long)dv +
                                                          c.v0);
    auto run = [&](auto gran) {
      constexpr int G = decltype(gran)::value;
      int j = 0;
      for (int t = c.t0; t < c.n_tiles; ++t) {
        const int rows = s - t * BK;
        for (int ch = 0; ch <= c.d_chunks; ++ch, ++j) {  // d_chunks: V
          const int st = j % L::kStages;
          const uint32_t sd = base + st * L::kStage;
          auto ready = [&] {
            hopper::mbar_wait(bar_empty + 8 * st,
                              ((j / L::kStages) & 1) ^ 1);
          };
          if (ch < c.d_chunks) {
            const int col = ch * L::kDChunk;
            const int n = c.chunk_boxes(d, ch);
            const int bytes = E * min(d - col, L::kDChunk);  // this chunk's
            load_run<G, L::kBQ>(sd, L::kQBox, qh + (long)E * col, ldq,
                                s - c.q0, bytes, n, lane, ready);
            load_run<G, BK>(sd + L::kKOff, L::kKBox,
                            kb + t * BK * ldk + (long)E * col, ldk, rows,
                            bytes, n, lane, ready);
          } else {
            load_run<G, BK>(sd, L::kKBox, vb + t * BK * ldv, ldv, rows,
                            E * min(dv - c.v0, O_SLICE), c.v_boxes, lane,
                            ready);
          }
          hopper::fence_proxy_async();  // the tensor cores read these
          hopper::mbar_arrive(bar_full + 8 * st);
        }
      }
    };
    if (g == 8) {
      run(hopper::Int<8>());
    } else if constexpr (E == 4) {  // f32 rows: granules of 4 or 8 bytes
      run(hopper::Int<4>());
    } else if (g == 4) {
      run(hopper::Int<4>());
    } else {
      run(hopper::Int<2>());
    }
  }
}

// The epilogue of a wide instance: acc / max(l, 1e-30) in o's type, the
// rows below s, the slice's columns below dv; a thread's column pairs are
// stored whole where `pairs` (dv even: a pair stays in its row, aligned).
template <typename L, typename T>
__device__ __forceinline__ void store_slice(T* o, const Cta<L>& c,
                                            const float (&acc)[O_SLICE / 2],
                                            float (&l)[2], bool pairs,
                                            int r_lo, int c_in, int s,
                                            int h, int dv) {
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
  for (int i = 0; i < O_SLICE / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int row = c.q0 + r_lo + 8 * r;
    const int col = c.v0 + 8 * (i >> 2) + c_in;
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
// 64 positions x 64 columns of one head, 128-byte swizzled.
template <typename T>
bool make_map(CUtensorMap* map, const void* ptr, int b, int s, int heads,
              int width) {
  return tma::make_map(map,
                       hopper::is_f16<T>() ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       2, ptr, b, s, heads, width, CHUNK, 64);
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
// Shared memory: kStages stages of 32 KB, each Q's and K's chunk (two
// 64-row boxes each, K's at kKOff) or V's slice (four boxes), then the
// barriers (full[], empty[]).
struct WideSmem {
  static constexpr int kElem = 2, kChunk = CHUNK, kBQ = BQ, kBK = BK;
  static constexpr int kDChunk = 128;     // columns of d a stage holds
  static constexpr int kStages = 6;
  static constexpr int kQBox = BOX, kKBox = BOX;
  static constexpr int kKOff = (kDChunk / kChunk) * kQBox;
  static constexpr int kStage = kKOff + (kDChunk / kChunk) * kKBox;
  static constexpr int kBars = kStages * kStage;
  static constexpr int kBytes = 1024 + kBars + 8 * 2 * kStages;
  static_assert(wide::O_SLICE / kChunk * kKBox == kStage,
                "V's slice fills one stage");
};

template <typename T, bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const uint16_t* __restrict__ q,
                             const uint16_t* __restrict__ k,
                             const uint16_t* __restrict__ v,
                             T* __restrict__ o, int s, int h, int kvh, int d,
                             int dv, float scale_log2, int causal, int window,
                             int g) {
  using L = WideSmem;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_full = base + L::kBars;                // + 8 i
  const uint32_t bar_empty = bar_full + 8 * L::kStages;     // + 8 i
  const int tid = threadIdx.x;
  const wide::Cta<L> c(s, h, kvh, d, dv, causal, window);
  if (!c.live) return;                               // past the last pair

  if (tid == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      hopper::mbar_init(bar_full + 8 * i, TMA ? 1 : 32);
      hopper::mbar_init(bar_empty + 8 * i, CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    wide::produce<L, TMA>(c, &tm_q, &tm_k, &tm_v, q, k, v, s, h, kvh, d, dv,
                          g, base, bar_full, bar_empty, tid - CONSUMERS);
    return;
  }

  // ---- the consumer warpgroup ----
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r_lo = warp * 16 + (lane >> 2);  // this thread's rows: r_lo, +8
  const int c_in = 2 * (lane & 3);           // its columns in each 8-block
  const int k_steps = (d - 1) / 16 + 1;      // k16 steps of S that see data

  float acc[wide::O_SLICE / 2];
#pragma unroll
  for (int i = 0; i < wide::O_SLICE / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  int j = 0;  // the ring's stage (wide::produce)
  for (int t = c.t0; t < c.n_tiles; ++t) {
    // S = sum over d's chunks of Q_c K_c^T (f32), each stage freed as soon
    // as its product is retired
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    for (int ch = 0; ch < c.d_chunks; ++ch, ++j) {
      const int st = j % L::kStages;
      const uint32_t sd = base + st * L::kStage;
      hopper::mbar_wait(bar_full + 8 * st, (j / L::kStages) & 1);
      hopper::fence_regs(sc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < L::kDChunk / 16; ++kc) {
        if (ch * (L::kDChunk / 16) + kc < k_steps) {
          const uint32_t off = (kc / 4) * BOX + (kc % 4) * 32;
          hopper::wgmma_ss<T>(sc, hopper::smem_desc(sd + off, 16, 1024),
                              hopper::smem_desc(sd + L::kKOff + off, 16, 1024),
                              1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(sc);
      hopper::mbar_arrive(bar_empty + 8 * st);  // this stage may be refilled
    }

    float alpha[2];
    wide::softmax_tile(sc, m, l, alpha, c.q0, t * BK, r_lo, c_in, s, causal,
                       window, scale_log2);

    // O += P V over the slice: P rounded to T in place as the A fragment,
    // one m64n64 product a box of V that holds data
    const int st = j % L::kStages;
    const uint32_t sv = base + st * L::kStage;
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
    for (int i = 0; i < wide::O_SLICE / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    hopper::mbar_wait(bar_full + 8 * st, (j / L::kStages) & 1);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int ns = 0; ns < wide::O_SLICE / CHUNK; ++ns) {
        if (ns < c.v_boxes)
          hopper::wgmma_rs<T>(
              reinterpret_cast<float(&)[32]>(acc[32 * ns]), pa[kk],
              hopper::smem_desc(sv + ns * BOX + kk * 16 * 128, BOX, 1024), 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(bar_empty + 8 * st);
    ++j;
  }
  wide::store_slice(o, c, acc, l, TMA || dv % 2 == 0, r_lo, c_in, s, h, dv);
}

template <typename T, bool TMA>
int launch_wide(const Call& c) {
  const int smem = WideSmem::kBytes;
  auto kern = flash_attn_wgmma_wide_kernel<T, TMA>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = cta_grid(c.b * c.h, c.s, BQ,
                             (c.dv + wide::O_SLICE - 1) / wide::O_SLICE);
  kern<<<grid, THREADS, smem, c.stream>>>(
      c.tq, c.tk, c.tv, static_cast<const uint16_t*>(c.q),
      static_cast<const uint16_t*>(c.k), static_cast<const uint16_t*>(c.v),
      static_cast<T*>(c.o), c.s, c.h, c.kvh, c.d, c.dv, c.scale_log2,
      c.causal, c.window, c.g);
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
      !fits_grid(b, h, s, BQ, (dv + wide::O_SLICE - 1) / wide::O_SLICE))
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
// Shared memory: kStages stages of 48 KB, each Q's chunk (four 64-row
// boxes) and K's (four 32-row boxes, at kKOff) or V's slice (eight 32-row
// boxes); then the consumers' scratch at kLo: the lo parts of Q's and K's
// chunk, or V^T and its lo part over them; then the barriers (full[],
// empty[]).
struct WideSmem {
  static constexpr int kElem = 4, kChunk = CHUNK, kBQ = BQ;
  static constexpr int kBK = 32;           // keys a tile
  static constexpr int kDChunk = 128;      // columns of d a stage holds
  static constexpr int kStages = 3;
  static constexpr int kQBox = QBOX, kKBox = kBK * 128;
  static constexpr int kKOff = (kDChunk / kChunk) * kQBox;
  static constexpr int kStage = kKOff + (kDChunk / kChunk) * kKBox;
  static constexpr int kVT = wide::O_SLICE * 128;  // 256 rows of 32 keys
  static constexpr int kLo = kStages * kStage;
  static constexpr int kBars = kLo + (kStage > 2 * kVT ? kStage : 2 * kVT);
  static constexpr int kBytes = 1024 + kBars + 8 * 2 * kStages;
  static_assert(wide::O_SLICE / kChunk * kKBox <= kStage,
                "V's slice fits one stage");
  static_assert(kBytes <= 232448, "227 KB of shared memory a CTA");
};
static_assert(tile_keys<256>() == WideSmem::kBK, "the entry point's maps");

template <bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_tf32x3_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const uint32_t* __restrict__ q,
                              const uint32_t* __restrict__ k,
                              const uint32_t* __restrict__ v,
                              float* __restrict__ o, int s, int h, int kvh,
                              int d, int dv, float scale_log2, int causal,
                              int window, int g) {
  using L = WideSmem;
  constexpr int BK = L::kBK;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align every box to it
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const sm = smem_raw + (base - raw);  // the same bytes, generic
  const uint32_t bar_full = base + L::kBars;                // + 8 i
  const uint32_t bar_empty = bar_full + 8 * L::kStages;     // + 8 i
  const int tid = threadIdx.x;
  const wide::Cta<L> c(s, h, kvh, d, dv, causal, window);
  if (!c.live) return;                               // past the last pair

  if (tid == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      hopper::mbar_init(bar_full + 8 * i, TMA ? 1 : 32);
      hopper::mbar_init(bar_empty + 8 * i, CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    wide::produce<L, TMA>(c, &tm_q, &tm_k, &tm_v, q, k, v, s, h, kvh, d, dv,
                          g, base, bar_full, bar_empty, tid - CONSUMERS);
    return;
  }

  // ---- the consumer warpgroup ----
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r_lo = warp * 16 + (lane >> 2);  // this thread's rows: r_lo, +8
  const int c_in = 2 * (lane & 3);           // its columns in each 8-block
  const int k_steps = (d - 1) / 8 + 1;       // k8 steps of S that see data
  const int v_slices = (c.v_boxes + 1) / 2;  // n64 products of O that do
  uint8_t* const scratch = sm + L::kLo;
  const uint64_t desc_ql = hopper::smem_desc(base + L::kLo, 16, 1024);
  const uint64_t desc_kl =
      hopper::smem_desc(base + L::kLo + L::kKOff, 16, 1024);
  const uint64_t desc_vh = desc_ql;           // V^T over Q's lo part
  const uint64_t desc_vl = hopper::smem_desc(base + L::kLo + L::kVT, 16, 1024);

  float acc[wide::O_SLICE / 2];
#pragma unroll
  for (int i = 0; i < wide::O_SLICE / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum
  uint32_t ph[BK / 8][4], pl[BK / 8][4];  // P's A fragments, hi and lo

  // Every wgmma group is committed and retired within one stage.
  int j = 0;  // the ring's stage (wide::produce)
  for (int t = c.t0; t < c.n_tiles; ++t) {
    // S = sum over d's chunks of Q_c K_c^T (f32), each in three tf32
    // passes, the small terms first; the first product overwrites S
    float sc[BK / 2];
    for (int ch = 0; ch < c.d_chunks; ++ch, ++j) {
      const int st = j % L::kStages;
      const uint32_t sd = base + st * L::kStage;
      const int n = c.chunk_boxes(d, ch);
      hopper::mbar_wait(bar_full + 8 * st, (j / L::kStages) & 1);
      split(sm + st * L::kStage, scratch, n * QBOX / 16, tid);
      split(sm + st * L::kStage + L::kKOff, scratch + L::kKOff,
            n * L::kKBox / 16, tid);
      hopper::fence_proxy_async();
      hopper::bar_sync(1, CONSUMERS);  // the lo parts are written
      // the descriptors are made opaque each stage, as the narrow
      // instances' each tile: hoisted with their k8 offsets, they would
      // crowd out the accumulators
      const uint64_t dq = hopper::smem_desc(sd, 16, 1024);
      const uint64_t dk = hopper::smem_desc(sd + L::kKOff, 16, 1024);
      uint64_t dql = desc_ql, dkl = desc_kl;
      asm volatile("" : "+l"(dql), "+l"(dkl));
      hopper::wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
        const uint64_t a = pass == 1 ? dql : dq;   // Q hi, Q lo, Q hi
        const uint64_t b = pass == 0 ? dkl : dk;   // K lo, K hi, K hi
#pragma unroll
        for (int kc = 0; kc < L::kDChunk / 8; ++kc) {
          if (ch * (L::kDChunk / 8) + kc < k_steps)
            hopper::wgmma_tf32_ss(
                sc, a + (kc / 4) * (QBOX >> 4) + (kc % 4) * 2,
                b + (kc / 4) * (L::kKBox >> 4) + (kc % 4) * 2,
                ch + pass + kc > 0);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::bar_sync(1, CONSUMERS);  // every warp's S has read the scratch
      hopper::mbar_arrive(bar_empty + 8 * st);  // this stage may be refilled
    }

    // V's slice as V^T and its lo part, over the scratch
    const int st = j % L::kStages;
    hopper::mbar_wait(bar_full + 8 * st, (j / L::kStages) & 1);
    transpose_v<wide::O_SLICE, BK>(sm + st * L::kStage, scratch,
                                   scratch + L::kVT, c.v_boxes, warp, lane);
    hopper::fence_proxy_async();
    hopper::mbar_arrive(bar_empty + 8 * st);  // V may be refilled
    ++j;
    hopper::bar_sync(1, CONSUMERS);  // V^T is written

    float alpha[2];
    wide::softmax_tile(sc, m, l, alpha, c.q0, t * BK, r_lo, c_in, s, causal,
                       window, scale_log2);

    // P's A fragments, p and its lo part (the key order of the narrow
    // instances: column c is key 2c, c + 4 is key 2c + 1)
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

    // O = alpha O + P V in three tf32 passes (P hi V lo, P lo V hi, P hi
    // V hi), one m64n64 product per 64 columns of the slice that hold data
#pragma unroll
    for (int i = 0; i < wide::O_SLICE / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
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
        for (int ns = 0; ns < wide::O_SLICE / 64; ++ns) {
          if (ns < v_slices)
            hopper::wgmma_tf32_rs(
                reinterpret_cast<float(&)[32]>(acc[32 * ns]),
                pass == 1 ? pl[kk] : ph[kk],
                b + (kk % 4) * 2 + ns * (64 * 128 >> 4), 1);
        }
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::bar_sync(1, CONSUMERS);  // P V has read V^T: the scratch is free
  }
  wide::store_slice(o, c, acc, l, TMA || dv % 2 == 0, r_lo, c_in, s, h, dv);
}

template <bool TMA>
int launch_wide(const Call& c) {
  const int smem = WideSmem::kBytes;
  auto kern = flash_attn_tf32x3_wide_kernel<TMA>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = cta_grid(c.b * c.h, c.s, BQ,
                             (c.dv + wide::O_SLICE - 1) / wide::O_SLICE);
  kern<<<grid, THREADS, smem, c.stream>>>(
      c.tq, c.tk, c.tv, static_cast<const uint32_t*>(c.q),
      static_cast<const uint32_t*>(c.k), static_cast<const uint32_t*>(c.v),
      static_cast<float*>(c.o), c.s, c.h, c.kvh, c.d, c.dv, c.scale_log2,
      c.causal, c.window, c.g);
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
// the TMA route where d and dv are multiples of 4. Returns
// cudaErrorInvalidValue where cuTensorMapEncodeTiled refuses a tensor map.
int fa_forward_tf32x3(const void* q, const void* k, const void* v, void* o,
                      int b, int s, int h, int kvh, int d, int dv,
                      float scale, int causal, int window, void* stream) {
  if (d < 1 || dv < 1 || kvh <= 0 || h % kvh || window < 0 ||
      (window > 0 && !causal) ||
      !fits_grid(b, h, s, tf::BQ, (dv + wide::O_SLICE - 1) / wide::O_SLICE))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0 || h == 0) return 0;
  const int p = d > dv ? d : dv;
  const int bk = p <= 128 ? tf::tile_keys<128>() : tf::tile_keys<256>();
  Call c = {d % 4 == 0 && dv % 4 == 0,  // 16-byte rows: TMA
            {}, {}, {}, q, k, v, o, b, s, h, kvh, d, dv,
            scale * 1.4426950408889634f, causal, window,
            granule(4, d, dv, q, k, v), static_cast<cudaStream_t>(stream)};
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (c.tma &&
      (!tma::make_map(&c.tq, f32, 4, q, b, s, h, d, tf::CHUNK, tf::BQ) ||
       !tma::make_map(&c.tk, f32, 4, k, b, s, kvh, d, tf::CHUNK, bk) ||
       !tma::make_map(&c.tv, f32, 4, v, b, s, kvh, dv, tf::CHUNK, bk)))
    return (int)cudaErrorInvalidValue;
  if (p <= 64) return tf::route<64>(c);
  if (p <= 128) return tf::route<128>(c);
  if (p <= 256) return tf::route<256>(c);
  return c.tma ? tf::launch_wide<true>(c) : tf::launch_wide<false>(c);
}

}  // extern "C"
