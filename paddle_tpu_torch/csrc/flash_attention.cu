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
// float32, contiguous. Masked scores take the same finite mask value as
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
// flash_decode
//   Replaces paddle_tpu/kernels/flash_attention.py `_decode_kernel` (the
//   pallas_call in `_decode_pallas`): one query per (batch, head) against
//   a KV cache, masked to the first cache_len[b] positions.
//   Bound on the H100: memory. It reads each valid K and V row once;
//   at [16, 8, 512, 64] that is 33.6 MB, about 10 us at 3.35 TB/s.
//   Design: one block of 8 warps per (batch, head). Warps take the
//   valid keys in interleaved groups of 4 (positions past cache_len are
//   never read); lanes hold head_dim/32 elements of q, K and V, so each
//   warp's loads are coalesced 128-byte rows; a butterfly of warp
//   shuffles reduces each dot product, four keys at a time for
//   instruction-level parallelism. Each warp keeps its own (m, l, acc);
//   the warps merge through shared memory and each row writes its
//   output once. 128 blocks do not fill 132 SMs for long at long cache
//   lengths: a split-K variant with a combine pass is the later fix.
// ---------------------------------------------------------------------

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr unsigned kFull = 0xffffffffu;
// -0.7 * FLT_MAX rounded to float32, the TPU kernels' DEFAULT_MASK_VALUE
constexpr float kMask = -0x1.666664p+127f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

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

  // merge the warps' (m, l, acc) in warp order through shared memory
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
  }
  __syncthreads();   // every warp is done with the ring (and with Q)
  float* macc = ring;                                    // [w][16][DMAX]
  float* mm = ring + kFwdWarps * kFwdBlockQ * DMAX;      // [w][16]
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
    o[((size_t)bh * Sq + q0 + r) * D + d] = out / l_safe;
    if (d == 0) lse[(size_t)bh * Sq + q0 + r] = m_all + logf(l_safe);
  }
}

// ---- decode ----------------------------------------------------------

constexpr int kDecWarps = 8;
constexpr int kDecUnroll = 4;  // keys in flight per warp

template <int DMAX>
__global__ void __launch_bounds__(kDecWarps * 32)
flash_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ k_cache,
                    const float* __restrict__ v_cache,
                    const int* __restrict__ cache_len,
                    float* __restrict__ out, int H, int S, int D,
                    float scale) {
  constexpr int VEC = DMAX / 32;
  __shared__ float sm_m[kDecWarps];
  __shared__ float sm_l[kDecWarps];
  __shared__ float sm_acc[kDecWarps][DMAX];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int L = max(0, min(cache_len[b], S));

  const float* kb = k_cache + (size_t)bh * S * D;
  const float* vb = v_cache + (size_t)bh * S * D;

  float qr[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < D ? q[(size_t)bh * D + d] : 0.f;
  }

  float m = -INFINITY, l = 0.f, acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  for (int j0 = warp * kDecUnroll; j0 < L; j0 += kDecWarps * kDecUnroll) {
    float s[kDecUnroll];
    float vv[kDecUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      const int j = j0 + u;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int d = lane + 32 * i;
        const bool in = j < L && d < D;
        part = fmaf(qr[i], in ? kb[(size_t)j * D + d] : 0.f, part);
        vv[u][i] = in ? vb[(size_t)j * D + d] : 0.f;
      }
      s[u] = part;
    }
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) s[u] = warp_sum(s[u]);
    // key j0 < L always, so m_new is finite
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      s[u] *= scale;
      if (j0 + u < L) m_new = fmaxf(m_new, s[u]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      if (j0 + u < L) {
        const float p = expf(s[u] - m_new);
        l += p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, vv[u][i], acc[i]);
      }
    }
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) sm_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();

  for (int d = threadIdx.x; d < D; d += kDecWarps * 32) {
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) m_all = fmaxf(m_all, sm_m[w]);
    float l_all = 0.f, o = 0.f;
    if (m_all != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) {
        if (sm_l[w] > 0.f) {  // a warp that saw no key has m = -inf
          const float c = expf(sm_m[w] - m_all);
          l_all = fmaf(sm_l[w], c, l_all);
          o = fmaf(sm_acc[w][d], c, o);
        }
      }
    }
    out[(size_t)bh * D + d] = l_all == 0.f ? 0.f : o / l_all;
  }
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

// q [B,H,D], caches [B,H,S,D], cache_len [B] int32, out [B,H,D].
cudaError_t flash_decode(const float* q, const float* k_cache,
                         const float* v_cache, const int* cache_len,
                         float* out, int B, int H, int S, int D,
                         float scale, cudaStream_t stream) {
  if (B * H == 0) return cudaSuccess;
  if (D < 1 || D > 128) return cudaErrorInvalidValue;
  const dim3 grid(B * H);
  const dim3 block(kDecWarps * 32);
  if (D <= 32)
    flash_decode_kernel<32><<<grid, block, 0, stream>>>(
        q, k_cache, v_cache, cache_len, out, H, S, D, scale);
  else if (D <= 64)
    flash_decode_kernel<64><<<grid, block, 0, stream>>>(
        q, k_cache, v_cache, cache_len, out, H, S, D, scale);
  else
    flash_decode_kernel<128><<<grid, block, 0, stream>>>(
        q, k_cache, v_cache, cache_len, out, H, S, D, scale);
  return cudaGetLastError();
}

}  // extern "C"
