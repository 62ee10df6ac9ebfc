// Flash attention for Hopper (sm_90a): the forward kernel and the
// single-query decode kernel behind the `fused_attention` op.
//
// Built by paddle_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes: every entry point below is `extern "C"`, takes
// raw device pointers and a stream, launches on that stream without
// synchronising, allocates nothing, and returns the cudaError_t of the
// launch (0 on success).
//
// Layout is the JAX package's: q, k, v are [batch, heads, seq, head_dim]
// float32 (or bfloat16 for flash_attention_fwd_bf16), contiguous.
// Masked scores take the same finite mask value as
// the TPU kernels (-0.7 * FLT_MAX), so a row whose keys are all masked
// averages V exactly as the reference does; keys past the end of the
// sequence (the ragged edge) or past a cache row's length are excluded
// outright. A row that sees no key at all outputs 0 (the l == 0 guard).
//
// ---------------------------------------------------------------------
// flash_attention_fwd
//   Replaces paddle_tpu/kernels/flash_attention.py `_fwd_kernel` (the
//   pallas_call in `_fwd_pallas`): causal and/or segment-masked online
//   softmax attention that writes O and the per-row log-sum-exp.
//   Bound on the H100: at the serving path's shapes ([1, 8, <=160, 64])
//   the whole call moves well under a megabyte and does a few MFLOP, so
//   it is bound by launch latency and by the serial chain of each query
//   tile's online softmax, not by bytes or FLOPs. At the training shape
//   [16, 8, 512, 64] the operations bound it.
//   Design (FlashAttention-2 warp tiles): one block of 4 warps per
//   (batch*head, 16-query tile), the diagonal-most tiles issued first.
//   All 4 warps own the tile's 16 rows and split its 16-key tiles up to
//   the causal diagonal between them (warp w takes tiles w, w + 4, ...;
//   tiles wholly above the diagonal are never loaded), so the critical
//   path is a quarter of the longest row's keys. Each warp streams its
//   K and V tiles through its own 2-stage ring of cp.async copies (16
//   bytes where rows start on 16-byte boundaries, 4 otherwise) and forms
//   S = Q K^T and O += P V on the tensor cores with mma.sync.m16n8k8 in
//   3xTF32 (each float32 operand split into big = a cut to TF32 and
//   small = a - big; small*big + big*small + big*big in float32 keeps the
//   float32 tolerances), S and P in registers: the key order inside each
//   8-key group of S is permuted so that the S fragment is already the
//   A fragment of P V. Row max and sum are shuffles across the four
//   lanes that share a row. The warps' (m, l, acc) merge once through
//   shared memory in warp order. The ragged edge is masked in the
//   kernel, so seq need not divide the tile.
//
// flash_attention_fwd_bf16
//   The same function on bfloat16 q, k, v and O (float32 lse; the mixed
//   precision path of training), replacing the same Pallas kernel on
//   bf16 inputs, P rounded to bf16 before P V as the TPU kernel rounds it
//   to V's dtype. Two kernels, chosen by shape (kernels/flash_attention.py
//   `fwd_plan`): flash_fwd_wgmma_kernel (wgmma fed by TMA, 128 query rows
//   a block; below) wherever TMA can address the rows, and
//   flash_fwd_bf16_kernel (the float32 kernel's blocking with one
//   mma.sync.m16n8k16 pass on bf16 operands) for head_dim not a multiple
//   of 8 or unaligned tensors.
//   Bound on the H100 at the training shape [16, 8, 512, 64] causal: the
//   bytes (q, k, v, o in bf16, 33.6 MB, ~10 us at 3.35 TB/s; the products
//   need 4.3 GFLOP, ~4.3 us at 989 TFLOP/s). The wgmma kernel is bound by
//   each warpgroup's chain of a tile (S product, softmax on the special
//   function unit, P V product), not by either: PERF.md.
//
// flash_decode
//   Replaces paddle_tpu/kernels/flash_attention.py `_decode_kernel` (the
//   pallas_call in `_decode_pallas`): one query per (batch, head) against
//   a KV cache, masked to the first cache_len[b] positions.
//   Bound on the H100: memory. It reads each valid K and V row once;
//   at [16, 8, 512, 64] that is 33.6 MB, about 10 us at 3.35 TB/s.
//   Design (split-K over a thread-block cluster, one launch): each
//   (batch, head) row takes a cluster of n blocks (decode_plan: n = 2 at
//   the serving path's 128 rows on 132 SMs). Each block reads L =
//   clamp(cache_len[b], 0, S) itself and walks its own chunk [rank L / n,
//   (rank + 1) L / n) of the valid prefix, so the chunks follow L and no
//   block of a row whose L >= n is idle; positions >= L are never read.
//   Its 4 warps take the chunk's tiles of 8 keys in turn (warp w: tiles
//   w, w + 4, ...), each through its own 2-stage ring of cp.async copies
//   (16 bytes a copy where rows start on 16-byte boundaries, 4
//   otherwise): 64 KB in flight an SM at the path's shape. Four lanes
//   own a key of a tile and a quarter of head_dim each: a score is 2
//   shuffles, a tile's max one 3-step butterfly, and each lane keeps its
//   key slot's share of the sum and of O (an XOR swizzle of the rows'
//   16-byte words keeps the reads conflict-free). Each warp stores its
//   (m, l, acc) into rank 0's shared memory (distributed shared memory);
//   after one cluster barrier rank 0 merges each block's warps in warp
//   order, the blocks in rank order, and writes the row once. No
//   workspace, no counter, no atomics: two runs give the same bits.
//   What bounds it on the card is measured in PERF.md
//   (lstm_breakdown.py --decode).
//   The kernel is a template over the cache's element type: float32, or
//   bfloat16 (flash_decode_bf16: q and the output stay float32, as the
//   JAX kernel's out_shape is q's dtype). A bf16 cache halves the bytes
//   (16.8 MB at the path's shape, ~5 us): the same walk reads 16-byte
//   words of 8 elements, widens them to float32 in registers, and rounds
//   p = exp(s - m) to bf16 before the P V sum as the JAX kernel does
//   (`p.astype(v_ref.dtype)`), while l sums the unrounded p. A bf16 row
//   whose head_dim is not a multiple of 8, or a cache not on a 16-byte
//   boundary, is staged by 2-byte loads through registers (cp.async
//   copies 4 bytes at least).
// ---------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tf32x3;

constexpr unsigned kFull = 0xffffffffu;
// -0.7 * FLT_MAX rounded to float32, the TPU kernels' DEFAULT_MASK_VALUE
constexpr float kMask = -0x1.666664p+127f;

// ---- forward ---------------------------------------------------------

constexpr int kFwdWarps = 4;     // warps a block; they split the key tiles
constexpr int kFwdBlockQ = 16;   // query rows a block: one m16 tile
constexpr int kFwdBlockK = 16;   // keys a tile: two n8 tiles
constexpr int kFwdStages = 2;    // each warp's K/V ring
constexpr int kPvGroup = 4;      // output n8 tiles a P V sweep (registers)

// G tiles c[i0 .. i0 + G) sharing one A fragment, in three sweeps so
// that no product waits on the one before it: each tile adds small*big,
// big*small, big*big in that order
template <int G, int N>
__device__ __forceinline__ void mma3(float (&c)[N][4], int i0,
                                     const unsigned (&ab)[4],
                                     const unsigned (&as)[4],
                                     const unsigned (&bb)[G][2],
                                     const unsigned (&bs)[G][2]) {
#pragma unroll
  for (int i = 0; i < G; ++i) mma(c[i0 + i], as, bb[i]);
#pragma unroll
  for (int i = 0; i < G; ++i) mma(c[i0 + i], ab, bs[i]);
#pragma unroll
  for (int i = 0; i < G; ++i) mma(c[i0 + i], ab, bb[i]);
}

template <int DMAX>
struct FwdSmem {
  static constexpr int LDQ = DMAX + 4;   // Q and K rows: banks 4g + t
  static constexpr int LDV = DMAX + 8;   // V rows: banks 8t + g
  static constexpr int K_ELEMS = kFwdBlockK * LDQ;
  static constexpr int STAGE = K_ELEMS + kFwdBlockK * LDV;
  static constexpr int Q_ELEMS = kFwdBlockQ * LDQ;
  static constexpr int RING = kFwdWarps * kFwdStages * STAGE;
  // after the loop the ring holds the warps' (acc, m, l) for the merge
  static constexpr int MERGE = kFwdWarps * kFwdBlockQ * (DMAX + 2);
  static constexpr int ELEMS = Q_ELEMS + (RING > MERGE ? RING : MERGE);
  static constexpr int BYTES = ELEMS * 4;
};

// Stage rows [r0, r0 + rows) of a [n, D] matrix into s[rows][ld], the
// columns D..DMAX-1 and the rows past n zero-filled; `lanes` threads
// starting at `lane` share the work.
template <int DMAX>
__device__ __forceinline__ void stage_rows(float* s, int ld,
                                           const float* src, int r0,
                                           int rows, int n, int D, bool vec,
                                           int lane, int lanes) {
  if (vec) {
    for (int i = lane; i < rows * (DMAX / 4); i += lanes) {
      const int r = i / (DMAX / 4), d = (i % (DMAX / 4)) * 4;
      const bool ok = r0 + r < n && d < D;
      cp16(&s[r * ld + d], ok ? src + (size_t)(r0 + r) * D + d : src, ok);
    }
  } else {
    for (int i = lane; i < rows * DMAX; i += lanes) {
      const int r = i / DMAX, d = i % DMAX;
      const bool ok = r0 + r < n && d < D;
      cp4(&s[r * ld + d], ok ? src + (size_t)(r0 + r) * D + d : src, ok);
    }
  }
}

// A warp stages key tile kt of K and V into its ring slot s.
template <int DMAX>
__device__ __forceinline__ void load_kv(float* s, const float* kb,
                                        const float* vb, int kt, int Sk,
                                        int D, bool vec, int lane) {
  using SM = FwdSmem<DMAX>;
  const int k0 = kt * kFwdBlockK;
  stage_rows<DMAX>(s, SM::LDQ, kb, k0, kFwdBlockK, Sk, D, vec, lane, 32);
  stage_rows<DMAX>(s + SM::K_ELEMS, SM::LDV, vb, k0, kFwdBlockK, Sk, D, vec,
                   lane, 32);
}

// After a block's walk: its warps' (m, l, acc) merge in warp order
// through shared memory `mem` (the ring, free by then), and the block
// writes its rows of O, through put(index, value), and their
// log-sum-exp. acc[i][e] is the mma C fragment of output columns
// i 8 .. i 8 + 7: row g + 8 (e >> 1), column i 8 + 2 t + (e & 1); each
// thread holds its share of the rows' sums l.
template <int DMAX, typename Put>
__device__ __forceinline__ void merge_rows(float* mem,
                                           float (&acc)[DMAX / 8][4],
                                           const float (&m)[2], float (&l)[2],
                                           int bh, int q0, int Sq, int D,
                                           float* __restrict__ lse, Put put) {
  constexpr int ND = DMAX / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
  }
  __syncthreads();   // every warp is done with the ring (and with Q)
  float* macc = mem;                                     // [w][16][DMAX]
  float* mm = mem + kFwdWarps * kFwdBlockQ * DMAX;       // [w][16]
  float* ml = mm + kFwdWarps * kFwdBlockQ;               // [w][16]
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      macc[(warp * kFwdBlockQ + g + 8 * (e >> 1)) * DMAX + i * 8 + 2 * t +
           (e & 1)] = acc[i][e];
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mm[warp * kFwdBlockQ + g + 8 * h] = m[h];
      ml[warp * kFwdBlockQ + g + 8 * h] = l[h];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kFwdBlockQ * DMAX; idx += kFwdWarps * 32) {
    const int r = idx / DMAX, d = idx % DMAX;
    if (q0 + r >= Sq || d >= D) continue;
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < kFwdWarps; ++w)
      m_all = fmaxf(m_all, mm[w * kFwdBlockQ + r]);
    float l_all = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < kFwdWarps; ++w) {
      const float mw = mm[w * kFwdBlockQ + r];
      // a warp that saw no key has m = -inf and adds nothing
      const float c = mw == -INFINITY ? 0.f : expf(mw - m_all);
      l_all += ml[w * kFwdBlockQ + r] * c;
      out += macc[(w * kFwdBlockQ + r) * DMAX + d] * c;
    }
    const float l_safe = l_all == 0.f ? 1.f : l_all;
    put(((size_t)bh * Sq + q0 + r) * D + d, out / l_safe);
    if (d == 0) lse[(size_t)bh * Sq + q0 + r] = m_all + logf(l_safe);
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kFwdWarps * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const int* __restrict__ q_seg,
                 const int* __restrict__ k_seg,
                 float* __restrict__ o, float* __restrict__ lse,
                 int H, int Sq, int Sk, int D, float scale, int causal,
                 int vec) {
  using SM = FwdSmem<DMAX>;
  constexpr int ND = DMAX / 8;   // n8 tiles of the output row
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ring = smem + SM::Q_ELEMS;

  const int bh = blockIdx.x;
  const int b = bh / H;
  // the diagonal-most query tiles, which walk the most keys, go first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool have_seg = q_seg != nullptr;

  const float* qb = q + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)bh * Sk * D;
  const float* vb = v + (size_t)bh * Sk * D;

  stage_rows<DMAX>(qs, SM::LDQ, qb, q0, kFwdBlockQ, Sq, D, vec, tid,
                   kFwdWarps * 32);
  cp_commit();

  // this thread's rows g and g + 8 of the tile
  int qi[2], qseg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qi[h] = q0 + g + 8 * h;
    qseg[h] = (have_seg && qi[h] < Sq) ? q_seg[(size_t)b * Sq + qi[h]] : 0;
  }

  // key tiles wholly above the causal diagonal are never loaded; warp w
  // takes tiles w, w + kFwdWarps, ...
  const int k_end = causal ? min(Sk, q0 + kFwdBlockQ) : Sk;
  const int n_kt = (k_end + kFwdBlockK - 1) / kFwdBlockK;
  float* my_ring = ring + warp * kFwdStages * SM::STAGE;
  if (warp < n_kt) load_kv<DMAX>(my_ring, kb, vb, warp, Sk, D, vec, lane);
  cp_commit();
  cp_wait<1>();      // this thread's part of Q has landed ...
  __syncthreads();   // ... and everyone's

  float m[2] = {-INFINITY, -INFINITY};   // running max of rows g, g + 8
  float l[2] = {0.f, 0.f};               // this thread's share of the sums
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  // key of S column c inside an n8 tile: c = 2 t' + e holds key t' + 4 e,
  // so that the S fragment is already the A fragment of P.V (columns t
  // and t + 4), with no shuffles
  const int perm_g = (g >> 1) + 4 * (g & 1);
  int it = 0;
  for (int kt = warp; kt < n_kt; kt += kFwdWarps, ++it) {
    if (kt + kFwdWarps < n_kt) {
      load_kv<DMAX>(my_ring + ((it + 1) % kFwdStages) * SM::STAGE, kb, vb,
                    kt + kFwdWarps, Sk, D, vec, lane);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncwarp();   // the tile, staged by the warp's 32 lanes
    const float* ks = my_ring + (it % kFwdStages) * SM::STAGE;
    const float* vs = ks + SM::K_ELEMS;
    const int k0 = kt * kFwdBlockK;

    // S = Q K^T: 16 rows x 16 keys, depth DMAX
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < DMAX; kk += 8) {
      unsigned ab[4], as[4];
      split(qs[g * SM::LDQ + kk + t], ab[0], as[0]);
      split(qs[(g + 8) * SM::LDQ + kk + t], ab[1], as[1]);
      split(qs[g * SM::LDQ + kk + t + 4], ab[2], as[2]);
      split(qs[(g + 8) * SM::LDQ + kk + t + 4], ab[3], as[3]);
      unsigned bb[2][2], bs[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* krow = ks + (nt * 8 + perm_g) * SM::LDQ + kk;
        split(krow[t], bb[nt][0], bs[nt][0]);
        split(krow[t + 4], bb[nt][1], bs[nt][1]);
      }
      mma3<2>(s, 0, ab, as, bb, bs);
    }
    // scale and mask; s[nt][2 h + e] is row g + 8 h, key k0 + nt 8 + t + 4 e
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = k0 + nt * 8 + t + 4 * e;
        const bool j_in = j < Sk;
        const int kseg = (have_seg && j_in) ? k_seg[(size_t)b * Sk + j] : 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x = s[nt][2 * h + e] * scale;
          if (causal && qi[h] < j) x = kMask;
          if (have_seg && qseg[h] != kseg) x = kMask;
          if (!j_in) x = -INFINITY;   // past the ragged edge: no key
          s[nt][2 * h + e] = x;
          tmax[h] = fmaxf(tmax[h], x);
        }
      }
    // online softmax; key k0 < Sk, so each row's max is finite
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(kFull, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(kFull, tmax[h], 2));
      const float m_new = fmaxf(m[h], tmax[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha[e >> 1];
    // O += P V: depth 16 keys (two k8 steps), ND n8 tiles of columns
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      unsigned ab[4], as[4];
      split(s[nt][0], ab[0], as[0]);   // row g,     key t
      split(s[nt][2], ab[1], as[1]);   // row g + 8, key t
      split(s[nt][1], ab[2], as[2]);   // row g,     key t + 4
      split(s[nt][3], ab[3], as[3]);   // row g + 8, key t + 4
      const float* v0 = vs + (nt * 8 + t) * SM::LDV + g;
#pragma unroll
      for (int i0 = 0; i0 < ND; i0 += kPvGroup) {   // kPvGroup tiles a sweep
        unsigned bb[kPvGroup][2], bs[kPvGroup][2];
#pragma unroll
        for (int i = 0; i < kPvGroup; ++i) {
          split(v0[(i0 + i) * 8], bb[i][0], bs[i][0]);
          split(v0[4 * SM::LDV + (i0 + i) * 8], bb[i][1], bs[i][1]);
        }
        mma3<kPvGroup>(acc, i0, ab, as, bb, bs);
      }
    }
    __syncwarp();   // this stage is consumed before it is refilled
  }
  cp_wait<0>();
  merge_rows<DMAX>(ring, acc, m, l, bh, q0, Sq, D, lse,
                   [&](size_t i, float x) { o[i] = x; });
}
// ---- forward, bfloat16, on mma.sync (shapes TMA cannot take) ----
//
// The same blocking as the float32 kernel (a block of 4 warps per 16
// query rows, the warps taking the 16-key tiles in turn through their
// own 2-stage cp.async rings, the causal tile skip, the masks, the merge
// in warp order), with bf16 operands: S = Q K^T and O += P V on
// mma.sync.m16n8k16 in one pass (a bf16 operand is exact, so there is no
// split), float32 accumulators, m, l and lse. A 16-key tile is exactly
// one k16 step of P V, and S's C fragments (row g and g + 8, keys 2 t and
// 2 t + 1 of each n8 tile) are already P's A fragment once rounded to
// bf16, as the JAX kernel rounds P to V's dtype before P V; l sums the
// unrounded float32 P. Q's A fragments stay in registers for the whole
// walk. K's B fragment is a 32-bit pair of a key row; V's pairs two
// rows, read as 16-bit halves (ldmatrix.trans would read them in one:
// a later change). Rows padded by 8 bf16 keep every fragment read free
// of bank conflicts.

template <int DMAX>
struct FwdSmemBf16 {
  static constexpr int LD = DMAX + 8;                 // bf16 a row
  static constexpr int TILE = kFwdBlockK * LD;        // K or V tile
  static constexpr int STAGE = 2 * TILE;              // K, then V
  static constexpr int Q_ELEMS = kFwdBlockQ * LD;
  static constexpr int RING = kFwdWarps * kFwdStages * STAGE;
  static constexpr int RING_BYTES = 2 * RING;
  // after the loop the ring holds the warps' float (acc, m, l)
  static constexpr int MERGE_BYTES = 4 * kFwdWarps * kFwdBlockQ * (DMAX + 2);
  static constexpr int BYTES =
      2 * Q_ELEMS + (RING_BYTES > MERGE_BYTES ? RING_BYTES : MERGE_BYTES);
};

// Stage rows [r0, r0 + rows) of a [n, D] bf16 matrix into s[rows][LD],
// the columns D..DMAX-1 and the rows past n zero-filled: 16-byte
// cp.async copies where rows start on 16-byte boundaries (D % 8 == 0),
// else element by element through registers (cp.async copies 4 bytes or
// more, a row here may start on a 2-byte boundary).
template <int DMAX>
__device__ __forceinline__ void stage_rows_bf16(uint16_t* s,
                                                const uint16_t* src, int r0,
                                                int rows, int n, int D,
                                                bool vec, int lane,
                                                int lanes) {
  constexpr int LD = FwdSmemBf16<DMAX>::LD;
  if (vec) {
    for (int i = lane; i < rows * (DMAX / 8); i += lanes) {
      const int r = i / (DMAX / 8), d = (i % (DMAX / 8)) * 8;
      const bool ok = r0 + r < n && d < D;
      cp16(&s[r * LD + d], ok ? src + (size_t)(r0 + r) * D + d : src, ok);
    }
  } else {
    for (int i = lane; i < rows * DMAX; i += lanes) {
      const int r = i / DMAX, d = i % DMAX;
      s[r * LD + d] =
          (r0 + r < n && d < D) ? src[(size_t)(r0 + r) * D + d] : 0;
    }
  }
}

// c += a b, one m16n8k16 bf16 product with float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld_pair(const uint16_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// two floats rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

template <int DMAX>
__global__ void __launch_bounds__(kFwdWarps * 32)
flash_fwd_bf16_kernel(const uint16_t* __restrict__ q,
                      const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v,
                      const int* __restrict__ q_seg,
                      const int* __restrict__ k_seg,
                      uint16_t* __restrict__ o, float* __restrict__ lse,
                      int H, int Sq, int Sk, int D, float scale, int causal,
                      int vec) {
  using SM = FwdSmemBf16<DMAX>;
  constexpr int LD = SM::LD;
  constexpr int ND = DMAX / 8;    // n8 tiles of the output row
  constexpr int NK = DMAX / 16;   // k16 steps of Q K^T
  extern __shared__ __align__(16) float smem[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* ring = qs + SM::Q_ELEMS;

  const int bh = blockIdx.x;
  const int b = bh / H;
  // the diagonal-most query tiles, which walk the most keys, go first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool have_seg = q_seg != nullptr;

  const uint16_t* qb = q + (size_t)bh * Sq * D;
  const uint16_t* kb = k + (size_t)bh * Sk * D;
  const uint16_t* vb = v + (size_t)bh * Sk * D;

  stage_rows_bf16<DMAX>(qs, qb, q0, kFwdBlockQ, Sq, D, vec, tid,
                        kFwdWarps * 32);
  cp_commit();

  int qi[2], qseg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qi[h] = q0 + g + 8 * h;
    qseg[h] = (have_seg && qi[h] < Sq) ? q_seg[(size_t)b * Sq + qi[h]] : 0;
  }

  const int k_end = causal ? min(Sk, q0 + kFwdBlockQ) : Sk;
  const int n_kt = (k_end + kFwdBlockK - 1) / kFwdBlockK;
  uint16_t* my_ring = ring + warp * kFwdStages * SM::STAGE;
  auto load_kv = [&](uint16_t* slot, int kt) {
    const int k0 = kt * kFwdBlockK;
    stage_rows_bf16<DMAX>(slot, kb, k0, kFwdBlockK, Sk, D, vec, lane, 32);
    stage_rows_bf16<DMAX>(slot + SM::TILE, vb, k0, kFwdBlockK, Sk, D, vec,
                          lane, 32);
  };
  if (warp < n_kt) load_kv(my_ring, warp);
  cp_commit();
  cp_wait<1>();      // this thread's part of Q has landed ...
  __syncthreads();   // ... and everyone's

  // Q's A fragments: rows g, g + 8; depth 2 t, 2 t + 1 and 2 t + 8, + 9
  unsigned qa[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint16_t* r0 = qs + g * LD + kk * 16 + 2 * t;
    qa[kk][0] = ld_pair(r0);
    qa[kk][1] = ld_pair(r0 + 8 * LD);
    qa[kk][2] = ld_pair(r0 + 8);
    qa[kk][3] = ld_pair(r0 + 8 * LD + 8);
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  int it = 0;
  for (int kt = warp; kt < n_kt; kt += kFwdWarps, ++it) {
    if (kt + kFwdWarps < n_kt) {
      load_kv(my_ring + ((it + 1) % kFwdStages) * SM::STAGE, kt + kFwdWarps);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncwarp();   // the tile, staged by the warp's 32 lanes
    const uint16_t* ks = my_ring + (it % kFwdStages) * SM::STAGE;
    const uint16_t* vs = ks + SM::TILE;
    const int k0 = kt * kFwdBlockK;

    // S = Q K^T: 16 rows x 16 keys (two n8 tiles), depth DMAX
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint16_t* krow = ks + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        const unsigned kf[2] = {ld_pair(krow), ld_pair(krow + 8)};
        mma_bf16(s[nt], qa[kk], kf);
      }
    // scale and mask; s[nt][2 h + e] is row g + 8 h, key k0 + nt 8 + 2 t + e
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = k0 + nt * 8 + 2 * t + e;
        const bool j_in = j < Sk;
        const int kseg = (have_seg && j_in) ? k_seg[(size_t)b * Sk + j] : 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x = s[nt][2 * h + e] * scale;
          if (causal && qi[h] < j) x = kMask;
          if (have_seg && qseg[h] != kseg) x = kMask;
          if (!j_in) x = -INFINITY;   // past the ragged edge: no key
          s[nt][2 * h + e] = x;
          tmax[h] = fmaxf(tmax[h], x);
        }
      }
    // online softmax; key k0 < Sk, so each row's max is finite
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(kFull, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(kFull, tmax[h], 2));
      const float m_new = fmaxf(m[h], tmax[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha[e >> 1];
    // O += P V: one k16 step; P's A fragment from S's C fragments
    const unsigned pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
    // V's B fragment of columns i 8 + g: keys 2 t, 2 t + 1 and 2 t + 8, + 9
    const uint16_t* v0 = vs + 2 * t * LD + g;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const unsigned vf[2] = {
          (unsigned)v0[i * 8] | ((unsigned)v0[LD + i * 8] << 16),
          (unsigned)v0[8 * LD + i * 8] | ((unsigned)v0[9 * LD + i * 8] << 16)};
      mma_bf16(acc[i], pa, vf);
    }
    __syncwarp();   // this stage is consumed before it is refilled
  }
  cp_wait<0>();
  merge_rows<DMAX>(reinterpret_cast<float*>(ring), acc, m, l, bh, q0, Sq, D,
                   lse, [&](size_t i, float x) {
                     o[i] = __bfloat16_as_ushort(__float2bfloat16_rn(x));
                   });
}

// ---- forward, bfloat16, on wgmma fed by TMA ----
//
// The bfloat16 forward at every shape whose rows TMA can address (head_dim
// a multiple of 8, up to 128, and 16-byte aligned q, k, v; the plan,
// kernels/flash_attention.py `fwd_plan`, says which kernel a call takes:
// the others take flash_fwd_bf16_kernel above). A block takes 128 query
// rows of one (batch, head): two warpgroups of 64 rows each. Thread 0
// loads Q once and streams the 64-key tiles of K and V through a ring of
// kWgStages stages with TMA, each stage guarded by a "full" mbarrier (the
// TMA's transactions) and an "empty" one (an arrival from each of the 8
// warps; thread 0 refills a slot once both warpgroups are done with it,
// kWgStages - 1 tiles ahead of the one it multiplies). Both
// warpgroups read every tile, so a K or V byte crosses from L2 once for
// 128 query rows, and no warp merges with another. Tiles wholly above
// the causal diagonal are never loaded (a warpgroup skips the last one
// where it lies wholly above its own 64 rows), and the query blocks with
// the most tiles are issued first.
//   S = Q K^T is wgmma.m64n64k16 bf16 -> float32 with both operands in
// shared memory (K-major: head_dim contiguous); the online softmax runs
// in float32 on S's accumulator, whose fragments, rounded to bf16 pairs,
// are already the register A operand of O += P V, as the JAX kernel
// rounds P to V's dtype (l sums the unrounded P). V is read MN-major
// (head_dim contiguous) through the descriptor's transpose. Shared
// memory is in the swizzle that TMA writes and wgmma reads (hopper.cuh):
// 128-byte rows of 64 columns, head_dim 128 as two such sub-tiles,
// head_dim <= 32 as 64-byte rows. Columns past head_dim and keys past the
// sequence arrive as zeros (the tensor maps are 3-D, [bh][seq][dim], so a
// box never reads the next head); keys past the sequence are excluded.
// O leaves through shared memory (each warpgroup's rows of Q's tile) by
// TMA stores, which drop rows past Sq and columns past head_dim.
// Registers: two blocks an SM at head_dim <= 64 (no setmaxnreg: there is
// no producer warp to give registers up).

constexpr int kWgRows = 128;     // query rows a block
constexpr int kWgKeys = 64;      // keys a tile
constexpr int kWgStages = 4;     // the K/V ring
constexpr int kWgThreads = 2 * 128;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special function unit (flushes denormal results to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DMAX>
struct WgFwd {
  static constexpr int SW = DMAX == 32 ? 64 : 128;   // bytes a sub-tile row
  static constexpr int LAYOUT = SW == 128 ? 1 : 2;   // the descriptor's
  static constexpr int COLS = SW / 2;                // columns a sub-tile
  static constexpr int NSUB = DMAX / COLS;           // sub-tiles of a row
  static constexpr int GROUP = 8 * SW;               // an 8-row group
  static constexpr int Q_SUB = kWgRows * SW;
  static constexpr int KV_SUB = kWgKeys * SW;
  static constexpr int Q_BYTES = NSUB * Q_SUB;
  static constexpr int KV_BYTES = NSUB * KV_SUB;     // a K (or V) tile
  static constexpr int STAGE = 2 * KV_BYTES;         // K, then V
  static constexpr int NO = DMAX == 32 ? 1 : DMAX / 64;   // P V products
  static constexpr int OREG = DMAX == 32 ? 16 : 32;       // a product's
  // the alignment slack, Q, the ring; the barriers are static
  static constexpr int BYTES = 1024 + Q_BYTES + kWgStages * STAGE;
  // two blocks an SM where the registers allow
  static constexpr int MIN_BLOCKS = DMAX <= 64 ? 2 : 1;
};

template <int DMAX>
__global__ void __launch_bounds__(kWgThreads, WgFwd<DMAX>::MIN_BLOCKS)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o,
                       const int* __restrict__ q_seg,
                       const int* __restrict__ k_seg,
                       float* __restrict__ lse,
                       int H, int Sq, int Sk, int D, float scale,
                       int causal) {
  using W = WgFwd<DMAX>;
  using hopper::desc;
  using hopper::fence_regs;
  using hopper::mbar_arrive;
  using hopper::mbar_expect_tx;
  using hopper::mbar_init;
  using hopper::mbar_wait;
  using hopper::smem_u32;
  using hopper::tma_load_3d;
  using hopper::wgmma_commit;
  using hopper::wgmma_fence;
  extern __shared__ unsigned char wg_smem_raw[];
  __shared__ uint64_t bar_q, bar_full[kWgStages], bar_empty[kWgStages];
  // the swizzled tiles start on a 1024-byte boundary
  const unsigned raw = smem_u32(wg_smem_raw);
  unsigned char* smem = wg_smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* qs = smem;
  unsigned char* ring = smem + W::Q_BYTES;

  const int bh = blockIdx.x;
  const int b = bh / H;
  // the diagonal-most query blocks, which walk the most keys, go first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgRows;
  const int k_end = causal ? min(Sk, q0 + kWgRows) : Sk;
  const int n_kt = (k_end + kWgKeys - 1) / kWgKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // thread 0 loads: Q, and key tile kt into ring slot kt % kWgStages
  auto load_kv = [&](int kt) {
    const int st = kt % kWgStages;
    unsigned char* ks = ring + st * W::STAGE;
    mbar_expect_tx(&bar_full[st], W::STAGE);
#pragma unroll
    for (int s = 0; s < W::NSUB; ++s) {
      tma_load_3d(ks + s * W::KV_SUB, &tm_k, &bar_full[st], s * W::COLS,
                  kt * kWgKeys, bh);
      tma_load_3d(ks + W::KV_BYTES + s * W::KV_SUB, &tm_v, &bar_full[st],
                  s * W::COLS, kt * kWgKeys, bh);
    }
  };
  if (threadIdx.x == 0) {
    hopper::prefetch_map(&tm_q);
    hopper::prefetch_map(&tm_k);
    hopper::prefetch_map(&tm_v);
    mbar_init(&bar_q, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_empty[s], 8);   // one arrival a warp
    }
    hopper::mbar_fence_init();
    mbar_expect_tx(&bar_q, W::Q_BYTES);
#pragma unroll
    for (int s = 0; s < W::NSUB; ++s)
      tma_load_3d(qs + s * W::Q_SUB, &tm_q, &bar_q, s * W::COLS, q0, bh);
    for (int kt = 0; kt < kWgStages && kt < n_kt; ++kt) load_kv(kt);
  }
  __syncthreads();

  // ---- consumers: warpgroup wg owns rows r0 .. r0 + 63 ----
  const int wg = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + wg * 64;
  const bool have_seg = q_seg != nullptr;
  int qi[2], qseg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qi[h] = r0 + wi * 16 + g + 8 * h;
    qseg[h] = (have_seg && qi[h] < Sq) ? q_seg[(size_t)b * Sq + qi[h]] : 0;
  }
  // tiles past this warpgroup's own diagonal are only waited for
  const int my_kt = causal ? (min(Sk, r0 + 64) + kWgKeys - 1) / kWgKeys
                           : n_kt;
  const unsigned q_addr = smem_u32(qs) + wg * 64 * W::SW;

  float m[2] = {-INFINITY, -INFINITY};   // running max of rows g, g + 8
  float l[2] = {0.f, 0.f};               // this thread's share of the sums
  float acc[W::NO][W::OREG];
#pragma unroll
  for (int n = 0; n < W::NO; ++n)
#pragma unroll
    for (int i = 0; i < W::OREG; ++i) acc[n][i] = 0.f;

  mbar_wait(&bar_q, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kWgStages;
    // thread 0 refills the slot of tile kt - 1 with tile kt - 1 +
    // kWgStages once both warpgroups are done with it
    if (threadIdx.x == 0 && kt >= 1 && kt - 1 + kWgStages < n_kt) {
      mbar_wait(&bar_empty[(kt - 1) % kWgStages],
                ((kt - 1) / kWgStages) & 1);
      load_kv(kt - 1 + kWgStages);
    }
    mbar_wait(&bar_full[st], (kt / kWgStages) & 1);
    __syncwarp();   // the warp converges before the warpgroup's products
    if (kt < my_kt) {
      const unsigned k_addr = smem_u32(ring + st * W::STAGE);
      const unsigned v_addr = k_addr + W::KV_BYTES;
      const int k0 = kt * kWgKeys;
      // S = Q K^T: 64 rows x 64 keys, depth DMAX
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        const int sub = kk * 16 / W::COLS, off = (kk * 16 % W::COLS) * 2;
        hopper::wgmma_ss_n64<0, 0>(
            s, desc(q_addr + sub * W::Q_SUB + off, W::GROUP, W::LAYOUT),
            desc(k_addr + sub * W::KV_SUB + off, W::GROUP, W::LAYOUT), 1);
      }
      wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_regs(s);
      // scale, and mask where the tile needs it (segments, the ragged
      // edge, or keys past the warpgroup's first row); s[4 i + 2 h + e]
      // is row g + 8 h, key k0 + 8 i + 2 t + e
      float tmax[2] = {-INFINITY, -INFINITY};
      const bool edge = have_seg || k0 + kWgKeys > Sk ||
                        (causal && k0 + kWgKeys - 1 > r0);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = k0 + 8 * i + 2 * t + e;
            const bool j_in = j < Sk;
            const int kseg =
                (have_seg && j_in) ? k_seg[(size_t)b * Sk + j] : 0;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float x = s[4 * i + 2 * h + e] * scale;
              if (causal && qi[h] < j) x = kMask;
              if (have_seg && qseg[h] != kseg) x = kMask;
              if (!j_in) x = -INFINITY;   // past the ragged edge: no key
              s[4 * i + 2 * h + e] = x;
            }
          }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] *= scale;
      }
      // each row's max over this thread's 16 keys, as a tree
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = fmaxf(s[4 * i + 2 * h], s[4 * i + 2 * h + 1]);
#pragma unroll
        for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
          for (int i = 0; i < w; ++i) v[i] = fmaxf(v[i], v[i + w]);
        tmax[h] = v[0];
      }
      // online softmax; key k0 < Sk, so each row's max is finite
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(kFull, tmax[h], 1));
        tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(kFull, tmax[h], 2));
        const float m_new = fmaxf(m[h], tmax[h]);
        alpha[h] = ex2((m[h] - m_new) * kLog2e);
        m[h] = m_new;
      }
      // p = 2^(x log2 e - m log2 e), one FMA; with segments a row's max
      // may be the mask value, whose product with log2 e overflows, so
      // there (x - m) comes first. This thread's share of each row's sum
      // as a tree.
      if (have_seg) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = ex2((s[i] - m[(i >> 1) & 1]) * kLog2e);
      } else {
        const float ml[2] = {m[0] * kLog2e, m[1] * kLog2e};
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = ex2(fmaf(s[i], kLog2e, -ml[(i >> 1) & 1]));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = s[4 * i + 2 * h] + s[4 * i + 2 * h + 1];
#pragma unroll
        for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
          for (int i = 0; i < w; ++i) v[i] += v[i + w];
        l[h] = fmaf(l[h], alpha[h], v[0]);
      }
      // P's A operand: keys 16 c .. 16 c + 15 of rows g, g + 8
      unsigned pa[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        pa[c][0] = pack_bf16(s[8 * c + 0], s[8 * c + 1]);
        pa[c][1] = pack_bf16(s[8 * c + 2], s[8 * c + 3]);
        pa[c][2] = pack_bf16(s[8 * c + 4], s[8 * c + 5]);
        pa[c][3] = pack_bf16(s[8 * c + 6], s[8 * c + 7]);
      }
#pragma unroll
      for (int n = 0; n < W::NO; ++n)
#pragma unroll
        for (int i = 0; i < W::OREG; ++i) acc[n][i] *= alpha[(i >> 1) & 1];
      // O += P V: 4 k16 steps of 16 keys; V MN-major, 16 keys = 16 rows
#pragma unroll
      for (int n = 0; n < W::NO; ++n) fence_regs(acc[n]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int n = 0; n < W::NO; ++n) {
          const uint64_t dv = desc(v_addr + n * W::KV_SUB + c * 16 * W::SW,
                                   W::GROUP, W::LAYOUT);
          if constexpr (W::OREG == 32)
            hopper::wgmma_rs_n64<1>(acc[n], pa[c], dv, 1);
          else
            hopper::wgmma_rs_n32<1>(acc[n], pa[c], dv, 1);
        }
      wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int n = 0; n < W::NO; ++n) fence_regs(acc[n]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar_empty[st]);   // this warp is done
  }

  // the rows' sums over their 4 lanes, then O / l into the warpgroup's
  // rows of Q's tile (free: its last product has read them), in the same
  // swizzle, and out by one TMA store a sub-tile (rows past Sq and
  // columns past D are not written); the log-sum-exp by the t == 0 lanes
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    const float inv = 1.f / l_safe;
    const int r = wg * 64 + wi * 16 + g + 8 * h;   // row of the block
#pragma unroll
    for (int n = 0; n < W::NO; ++n)
#pragma unroll
      for (int i = 0; i < W::OREG / 4; ++i) {
        const int c = n * 64 + 8 * i + 2 * t;        // column of the row
        const int sub = c / W::COLS, cb = (c % W::COLS) * 2;
        const int chunk = (cb >> 4) ^ ((r * W::SW >> 7) & (W::SW / 16 - 1));
        *reinterpret_cast<unsigned*>(qs + sub * W::Q_SUB + r * W::SW +
                                     chunk * 16 + (cb & 15)) =
            pack_bf16(acc[n][4 * i + 2 * h] * inv,
                      acc[n][4 * i + 2 * h + 1] * inv);
      }
    if (t == 0 && qi[h] < Sq)
      lse[(size_t)bh * Sq + qi[h]] = m[h] + logf(l_safe);
  }
  hopper::fence_proxy_async();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if (wi == 0 && lane == 0) {
#pragma unroll
    for (int sub = 0; sub < W::NSUB; ++sub)
      asm volatile(
          "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, "
          "%3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_o)),
          "r"(smem_u32(qs + sub * W::Q_SUB + wg * 64 * W::SW)),
          "r"(sub * W::COLS), "r"(r0), "r"(bh)
          : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---- decode ----

constexpr int kDecWarps = 4;      // warps a block; they take tiles in turn
constexpr int kDecTile = 8;       // keys a warp's tile: 4 lanes a key
constexpr int kDecMaxCluster = 8; // the portable cluster size
// a warp's ring: the next tile flies while the warp reads this one; 4
// stages take the same time on the H100 as 2 (lstm_breakdown.py
// --decode, PERF.md), and 2 keep a block at 34 KB at head_dim 64
constexpr int kDecStages = 2;

template <int DMAX, typename T>
struct DecSmem {
  // elements of a 16-byte word, 16-byte words of a row
  static constexpr int E = 16 / (int)sizeof(T);
  static constexpr int WORDS = DMAX / E;
  static constexpr int TILE = kDecTile * DMAX;    // elements of K (or V)
  static constexpr int STAGE = 2 * TILE;          // K, then V
  static constexpr int RING = kDecWarps * kDecStages * STAGE;
  // a warp's partial (acc[DMAX], m, l) in rank 0's slots, in floats
  static constexpr int SLOT = DMAX + 4;
  // bytes of a block of a cluster of n: rank 0 takes every warp's slot
  static constexpr int bytes(int n) {
    return 4 * n * kDecWarps * SLOT + (int)sizeof(T) * RING;
  }
};

// element index of 16-byte word j of key row r of a tile: the words of
// odd rows are swizzled by 4 where a row holds 8 words or more, so that
// the 8 lanes of a quarter warp (keys 2i, 2i + 1, quarters 0..3) read 8
// distinct bank groups (a row of 4 words, bf16 at head_dim 32, needs
// none: keys 2i and 2i + 1 already sit in different banks)
template <int DMAX, typename T>
__device__ __forceinline__ int dec_word(int r, int j) {
  using SM = DecSmem<DMAX, T>;
  return SM::E * (SM::WORDS >= 8 ? j ^ ((r & 1) << 2) : j);
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

// the 16-byte word at p as float32: 4 floats, or 8 bfloat16 widened
__device__ __forceinline__ void widen(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void widen(const uint16_t* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = bf16_bits_to_float(w[i] & 0xffffu);
    x[2 * i + 1] = bf16_bits_to_float(w[i] >> 16);
  }
}

// p as the P V product takes it: float32 as it is, or rounded to bf16
// (round to nearest even) and widened again
__device__ __forceinline__ float round_p(float p, const float*) { return p; }
__device__ __forceinline__ float round_p(float p, const uint16_t*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// A warp stages keys [k0, k0 + kDecTile) of a [S, D] cache row into a
// tile s[kDecTile][DMAX]; keys >= k_end and columns >= D are zero-filled
// and never read. vec: 16-byte copies (D a multiple of the word's
// elements, rows on 16-byte boundaries); else 4-byte copies (float32) or
// 2-byte loads through registers (bfloat16).
template <int DMAX, typename T>
__device__ __forceinline__ void stage_keys(T* s, const T* src, int k0,
                                           int k_end, int D, bool vec,
                                           int lane) {
  using SM = DecSmem<DMAX, T>;
  if (vec) {
#pragma unroll
    for (int it = 0; it < kDecTile * SM::WORDS / 32; ++it) {
      const int i = lane + 32 * it;
      const int r = i / SM::WORDS, j = i % SM::WORDS;
      const bool ok = k0 + r < k_end && SM::E * j < D;
      cp16(&s[r * DMAX + dec_word<DMAX, T>(r, j)],
           ok ? src + (size_t)(k0 + r) * D + SM::E * j : src, ok);
    }
  } else {
#pragma unroll 8
    for (int it = 0; it < kDecTile * DMAX / 32; ++it) {
      const int i = lane + 32 * it;
      const int r = i / DMAX, d = i % DMAX;
      const bool ok = k0 + r < k_end && d < D;
      T* dst = &s[r * DMAX + dec_word<DMAX, T>(r, d / SM::E) + d % SM::E];
      if constexpr (sizeof(T) == 4) {
        cp4(dst, ok ? src + (size_t)(k0 + r) * D + d : src, ok);
      } else {
        *dst = ok ? src[(size_t)(k0 + r) * D + d] : T(0);
      }
    }
  }
}

template <int DMAX, typename T>
__global__ void __launch_bounds__(kDecWarps * 32)
flash_decode_kernel(const float* __restrict__ q,
                    const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache,
                    const int* __restrict__ cache_len,
                    float* __restrict__ out, int H, int S, int D,
                    float scale, int vec) {
  using SM = DecSmem<DMAX, T>;
  constexpr int E = SM::E;
  constexpr int NW = DMAX / (4 * E);  // 16-byte words of a row a lane owns
  extern __shared__ __align__(16) float smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  float* slots = smem;                            // [n][warp][SLOT]
  T* ring = reinterpret_cast<T*>(smem + n * kDecWarps * SM::SLOT);
  // this block has started; rank 0's slots are written only after every
  // block of the cluster has (the wait below)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int bh = blockIdx.x / n;
  const int b = bh / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // the lane's key, its quarter
  // this block's chunk of the valid prefix [0, L)
  const int L = max(0, min(cache_len[b], S));
  const int c0 = rank * L / n, c1 = (rank + 1) * L / n;
  const int n_tiles = (c1 - c0 + kDecTile - 1) / kDecTile;
  const int my_tiles =
      warp < n_tiles ? (n_tiles - warp + kDecWarps - 1) / kDecWarps : 0;

  const T* kb = k_cache + (size_t)bh * S * D;
  const T* vb = v_cache + (size_t)bh * S * D;
  T* my_ring = ring + warp * kDecStages * SM::STAGE;
  // the warp's i-th tile: tile warp + i kDecWarps of the chunk
  auto load = [&](int i) {
    T* st = my_ring + (i % kDecStages) * SM::STAGE;
    const int k0 = c0 + (warp + i * kDecWarps) * kDecTile;
    stage_keys<DMAX, T>(st, kb, k0, c1, D, vec, lane);
    stage_keys<DMAX, T>(st + SM::TILE, vb, k0, c1, D, vec, lane);
  };
#pragma unroll
  for (int i = 0; i < kDecStages - 1; ++i) {
    if (i < my_tiles) load(i);
    cp_commit();
  }

  // the lane's words of q: columns E (t + 4 i) .. + E - 1
  float qr[NW][E];
#pragma unroll
  for (int i = 0; i < NW; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = E * (t + 4 * i) + e;
      qr[i][e] = d < D ? q[(size_t)bh * D + d] : 0.f;
    }

  // the warp's running max (the same in every lane), the lane's key
  // slot's share of the sum and of O over its columns
  float m = -INFINITY, l = 0.f, acc[NW][E];
#pragma unroll
  for (int i = 0; i < NW; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;

  for (int it = 0; it < my_tiles; ++it) {
    if (it + kDecStages - 1 < my_tiles) load(it + kDecStages - 1);
    cp_commit();
    cp_wait<kDecStages - 1>();
    __syncwarp();   // the tile, staged by the warp's 32 lanes
    const T* ks = my_ring + (it % kDecStages) * SM::STAGE;
    const T* vs = ks + SM::TILE;
    const int key = c0 + (warp + it * kDecWarps) * kDecTile + g;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      float kv[E];
      widen(&ks[g * DMAX + dec_word<DMAX, T>(g, t + 4 * i)], kv);
#pragma unroll
      for (int e = 0; e < E; ++e) s = fmaf(qr[i][e], kv[e], s);
    }
    s += __shfl_xor_sync(kFull, s, 1);
    s += __shfl_xor_sync(kFull, s, 2);
    s = key < c1 ? s * scale : -INFINITY;
    float tmax = s;
    tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 4));
    tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 8));
    tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 16));
    // the tile's first key is < c1, so m_new is finite
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);   // 0 past the chunk
    l = fmaf(l, alpha, p);
    const float pv = round_p(p, ks);
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      float vv[E];
      widen(&vs[g * DMAX + dec_word<DMAX, T>(g, t + 4 * i)], vv);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] = fmaf(pv, vv[e], acc[i][e] * alpha);
    }
    m = m_new;
    __syncwarp();   // this stage is consumed before it is refilled
  }
  cp_wait<0>();

  // the warp's sums over its 8 key slots
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    l += __shfl_xor_sync(kFull, l, off);
#pragma unroll
    for (int i = 0; i < NW; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[i][e] += __shfl_xor_sync(kFull, acc[i][e], off);
  }

  // each warp's (acc, m, l) into its slot in rank 0, then one cluster
  // barrier (release, acquire) before rank 0 reads them
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* slot = cluster.map_shared_rank(
      slots + (rank * kDecWarps + warp) * SM::SLOT, 0);
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < NW; ++i)
#pragma unroll
      for (int e = 0; e < E; e += 4)
        *reinterpret_cast<float4*>(&slot[E * (t + 4 * i) + e]) =
            make_float4(acc[i][e], acc[i][e + 1], acc[i][e + 2],
                        acc[i][e + 3]);
    if (t == 0) {
      slot[DMAX] = m;
      slot[DMAX + 1] = l;
    }
  }
  cluster.sync();
  if (rank != 0) return;

  // rank 0: each block's warps merge in warp order, the blocks in rank
  // order; a warp or block that saw no key has m = -inf and adds nothing
  const int d = threadIdx.x;
  if (d >= D) return;
  auto block_max = [&](int j) {
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w)
      mb = fmaxf(mb, slots[(j * kDecWarps + w) * SM::SLOT + DMAX]);
    return mb;
  };
  float m_all = -INFINITY;
  for (int j = 0; j < n; ++j) m_all = fmaxf(m_all, block_max(j));
  float l_all = 0.f, o = 0.f;
  for (int j = 0; j < n; ++j) {
    const float m_b = block_max(j);
    float l_b = 0.f, a_b = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float* sw = slots + (j * kDecWarps + w) * SM::SLOT;
      const float c = sw[DMAX] == -INFINITY ? 0.f : expf(sw[DMAX] - m_b);
      l_b = fmaf(sw[DMAX + 1], c, l_b);
      a_b = fmaf(sw[d], c, a_b);
    }
    const float c = m_b == -INFINITY ? 0.f : expf(m_b - m_all);
    l_all = fmaf(l_b, c, l_all);
    o = fmaf(a_b, c, o);
  }
  out[(size_t)bh * D + d] = l_all == 0.f ? 0.f : o / l_all;
}

// B2's launch plan: out[0] blocks a (batch, head) row, the cluster size
// n; out[1] threads a block; out[2] ring stages a warp; out[3] shared
// bytes a block (for cache elements of `esize` bytes); out[4] keys a
// warp's tile. n doubles from 1 while the grid holds fewer than 1.5
// blocks an SM, a chunk of a full row keeps at least two tiles a warp
// and n stays within the portable cluster size.
// kernels.flash_attention.decode_plan mirrors it.
template <typename T>
int dec_bytes(int D, int n) {
  return D <= 32   ? DecSmem<32, T>::bytes(n)
         : D <= 64 ? DecSmem<64, T>::bytes(n)
                   : DecSmem<128, T>::bytes(n);
}

void dec_plan(int B, int H, int S, int D, int sms, int esize, int* out) {
  int n = 1;
  while (n < kDecMaxCluster && 2 * n * kDecWarps * kDecTile <= S &&
         2LL * B * H * n < 3LL * sms)
    n *= 2;
  out[0] = n;
  out[1] = kDecWarps * 32;
  out[2] = kDecStages;
  out[3] = esize == 2 ? dec_bytes<uint16_t>(D, n) : dec_bytes<float>(D, n);
  out[4] = kDecTile;
}

template <int DMAX, typename T>
cudaError_t launch_decode(const float* q, const T* k, const T* v,
                          const int* cache_len, float* out, int B, int H,
                          int S, int D, float scale, int vec, const int* p,
                          cudaStream_t stream) {
  const int n = p[0], bytes = p[3];
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_decode_kernel<DMAX, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * B * H);
  cfg.blockDim = dim3(kDecWarps * 32);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = n;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, flash_decode_kernel<DMAX, T>, q, k, v,
                         cache_len, out, H, S, D, scale, vec);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the decode launch for caches of element type T: plan, then the
// instantiation of the smallest DMAX >= D
template <typename T>
cudaError_t decode(const float* q, const T* k_cache, const T* v_cache,
                   const int* cache_len, float* out, int B, int H, int S,
                   int D, float scale, cudaStream_t stream) {
  if (B * H == 0) return cudaSuccess;
  if (D < 1 || D > 128) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, p[5];
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  dec_plan(B, H, S, D, sms, (int)sizeof(T), p);
  // 16-byte copies where every row starts on a 16-byte boundary
  constexpr int E = 16 / (int)sizeof(T);
  const int vec = D % E == 0 &&
                  ((reinterpret_cast<uintptr_t>(k_cache) |
                    reinterpret_cast<uintptr_t>(v_cache)) & 15) == 0;
  if (D <= 32)
    return launch_decode<32, T>(q, k_cache, v_cache, cache_len, out, B, H,
                                S, D, scale, vec, p, stream);
  if (D <= 64)
    return launch_decode<64, T>(q, k_cache, v_cache, cache_len, out, B, H,
                                S, D, scale, vec, p, stream);
  return launch_decode<128, T>(q, k_cache, v_cache, cache_len, out, B, H,
                               S, D, scale, vec, p, stream);
}

template <int DMAX>
cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                       const int* q_seg, const int* k_seg, float* o,
                       float* lse, int B, int H, int Sq, int Sk, int D,
                       float scale, int causal, int vec,
                       cudaStream_t stream) {
  constexpr int kBytes = FwdSmem<DMAX>::BYTES;
  static_assert(kBytes <= 227 * 1024, "ring exceeds shared memory");
  // an attribute of the kernel on the current device: set at every
  // launch, so that a launch on another card has it too
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * H, (Sq + kFwdBlockQ - 1) / kFwdBlockQ);
  flash_fwd_kernel<DMAX><<<grid, kFwdWarps * 32, kBytes, stream>>>(
      q, k, v, q_seg, k_seg, o, lse, H, Sq, Sk, D, scale, causal, vec);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_fwd_bf16(const uint16_t* q, const uint16_t* k,
                            const uint16_t* v, const int* q_seg,
                            const int* k_seg, uint16_t* o, float* lse, int B,
                            int H, int Sq, int Sk, int D, float scale,
                            int causal, int vec, cudaStream_t stream) {
  constexpr int kBytes = FwdSmemBf16<DMAX>::BYTES;
  static_assert(kBytes <= 227 * 1024, "ring exceeds shared memory");
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * H, (Sq + kFwdBlockQ - 1) / kFwdBlockQ);
  flash_fwd_bf16_kernel<DMAX><<<grid, kFwdWarps * 32, kBytes, stream>>>(
      q, k, v, q_seg, k_seg, o, lse, H, Sq, Sk, D, scale, causal, vec);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v,
                             const int* q_seg, const int* k_seg, uint16_t* o,
                             float* lse, int B, int H, int Sq, int Sk, int D,
                             float scale, int causal, cudaStream_t stream) {
  using W = WgFwd<DMAX>;
  static_assert(W::BYTES <= 227 * 1024, "ring exceeds shared memory");
  // [bh][seq][dim] maps: a box never reads past its head's rows, and rows
  // and columns outside the tensor read as zero
  const uint64_t bh = (uint64_t)B * H, d = (uint64_t)D;
  const uint64_t q_dims[3] = {d, (uint64_t)Sq, bh};
  const uint64_t q_strides[2] = {2 * d, 2 * d * Sq};
  const uint64_t kv_dims[3] = {d, (uint64_t)Sk, bh};
  const uint64_t kv_strides[2] = {2 * d, 2 * d * Sk};
  const uint32_t q_box[3] = {W::COLS, kWgRows, 1};
  const uint32_t kv_box[3] = {W::COLS, kWgKeys, 1};
  const uint32_t o_box[3] = {W::COLS, 64, 1};   // a warpgroup's rows
  CUtensorMap mq, mk, mv, mo;
  if (!hopper::make_map(&mq, q, 3, q_dims, q_strides, q_box, W::SW) ||
      !hopper::make_map(&mk, k, 3, kv_dims, kv_strides, kv_box, W::SW) ||
      !hopper::make_map(&mv, v, 3, kv_dims, kv_strides, kv_box, W::SW) ||
      !hopper::make_map(&mo, o, 3, q_dims, q_strides, o_box, W::SW))
    return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, W::BYTES);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * H, (Sq + kWgRows - 1) / kWgRows);
  flash_fwd_wgmma_kernel<DMAX><<<grid, kWgThreads, W::BYTES, stream>>>(
      mq, mk, mv, mo, q_seg, k_seg, lse, H, Sq, Sk, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B,H,Sq,D], k/v [B,H,Sk,D], o [B,H,Sq,D], lse [B,H,Sq]; q_seg
// [B,Sq] and k_seg [B,Sk] int32, both null when there are no segments.
cudaError_t flash_attention_fwd(const float* q, const float* k,
                                const float* v, const int* q_seg,
                                const int* k_seg, float* o, float* lse,
                                int B, int H, int Sq, int Sk, int D,
                                float scale, int causal,
                                cudaStream_t stream) {
  if (B * H == 0 || Sq == 0) return cudaSuccess;
  if (D < 1 || D > 128 || (q_seg == nullptr) != (k_seg == nullptr))
    return cudaErrorInvalidValue;
  // 16-byte copies where every row starts on a 16-byte boundary
  const int vec = D % 4 == 0 &&
                  ((reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  if (D <= 32)
    return launch_fwd<32>(q, k, v, q_seg, k_seg, o, lse, B, H, Sq, Sk, D,
                          scale, causal, vec, stream);
  if (D <= 64)
    return launch_fwd<64>(q, k, v, q_seg, k_seg, o, lse, B, H, Sq, Sk, D,
                          scale, causal, vec, stream);
  return launch_fwd<128>(q, k, v, q_seg, k_seg, o, lse, B, H, Sq, Sk, D,
                         scale, causal, vec, stream);
}

// The same in bfloat16: q, k, v, o bfloat16 (as raw 16-bit words), lse
// float32. loader 1: the wgmma kernel fed by TMA, which needs head_dim a
// multiple of 8, q, k and v on 16-byte boundaries and Sk >= 1; loader 0:
// the mma.sync kernel, which takes any shape (kernels/flash_attention.py
// `fwd_plan` chooses).
cudaError_t flash_attention_fwd_bf16(const void* q, const void* k,
                                     const void* v, const int* q_seg,
                                     const int* k_seg, void* o, float* lse,
                                     int B, int H, int Sq, int Sk, int D,
                                     float scale, int causal, int loader,
                                     cudaStream_t stream) {
  if (B * H == 0 || Sq == 0) return cudaSuccess;
  if (D < 1 || D > 128 || (q_seg == nullptr) != (k_seg == nullptr) ||
      loader < 0 || loader > 1)
    return cudaErrorInvalidValue;
  const uint16_t* qh = static_cast<const uint16_t*>(q);
  const uint16_t* kh = static_cast<const uint16_t*>(k);
  const uint16_t* vh = static_cast<const uint16_t*>(v);
  uint16_t* oh = static_cast<uint16_t*>(o);
  // rows on 16-byte boundaries
  const bool aligned = D % 8 == 0 &&
                       ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  if (loader == 1) {
    if (!aligned || Sk < 1) return cudaErrorInvalidValue;
    if (D <= 32)
      return launch_fwd_wgmma<32>(q, k, v, q_seg, k_seg, oh, lse, B, H, Sq,
                                  Sk, D, scale, causal, stream);
    if (D <= 64)
      return launch_fwd_wgmma<64>(q, k, v, q_seg, k_seg, oh, lse, B, H, Sq,
                                  Sk, D, scale, causal, stream);
    return launch_fwd_wgmma<128>(q, k, v, q_seg, k_seg, oh, lse, B, H, Sq,
                                 Sk, D, scale, causal, stream);
  }
  const int vec = aligned;   // 16-byte copies
  if (D <= 32)
    return launch_fwd_bf16<32>(qh, kh, vh, q_seg, k_seg, oh, lse, B, H, Sq,
                               Sk, D, scale, causal, vec, stream);
  if (D <= 64)
    return launch_fwd_bf16<64>(qh, kh, vh, q_seg, k_seg, oh, lse, B, H, Sq,
                               Sk, D, scale, causal, vec, stream);
  return launch_fwd_bf16<128>(qh, kh, vh, q_seg, k_seg, oh, lse, B, H, Sq,
                              Sk, D, scale, causal, vec, stream);
}

// B2's launch plan at (B, H, S, D) on a card of `sms` SMs, for cache
// elements of `esize` bytes (4: float32, 2: bfloat16): out[0] blocks a
// row (the cluster size), out[1] threads a block, out[2] ring stages a
// warp, out[3] shared bytes a block, out[4] keys a warp's tile.
cudaError_t decode_plan(int B, int H, int S, int D, int sms, int esize,
                        int* out) {
  if (D < 1 || D > 128 || sms < 1 || (esize != 4 && esize != 2))
    return cudaErrorInvalidValue;
  dec_plan(B, H, S, D, sms, esize, out);
  return cudaSuccess;
}

// q [B,H,D], caches [B,H,S,D], cache_len [B] int32, out [B,H,D].
cudaError_t flash_decode(const float* q, const float* k_cache,
                         const float* v_cache, const int* cache_len,
                         float* out, int B, int H, int S, int D,
                         float scale, cudaStream_t stream) {
  return decode<float>(q, k_cache, v_cache, cache_len, out, B, H, S, D,
                       scale, stream);
}

// The same over bfloat16 caches (raw 16-bit words); q and out float32.
cudaError_t flash_decode_bf16(const float* q, const void* k_cache,
                              const void* v_cache, const int* cache_len,
                              float* out, int B, int H, int S, int D,
                              float scale, cudaStream_t stream) {
  return decode<uint16_t>(q, static_cast<const uint16_t*>(k_cache),
                          static_cast<const uint16_t*>(v_cache), cache_len,
                          out, B, H, S, D, scale, stream);
}

}  // extern "C"
