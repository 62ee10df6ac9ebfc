// Fused dx + dw backward of a 1x1, stride-1, NCHW convolution for Hopper
// (sm_90a) (B8): a float32 kernel on 3xTF32 mma.sync and a bfloat16 one
// on wgmma.
//
// Built by paddle_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes: the entry points below are `extern "C"`, take raw
// device pointers and a stream, launch on that stream without
// synchronising, allocate nothing, and return the cudaError_t of the
// launch (0 on success).
//
// Replaces paddle_tpu/kernels/conv1x1_bwd.py `_bwd_kernel` (the
// pallas_call in `_bwd_fused`). With x [B, Ci, HW], w [Co, Ci] and
// dy [B, Co, HW], float32 or bfloat16, float32 accumulation:
//   dx[b] = w^T dy[b]            [Ci, HW], in x's type
//   dw    = sum_b dy[b] x[b]^T   [Co, Ci], in w's type
// Both products are computed here, in the kernel's own body, in ONE
// launch.
//
// Bound on the H100: 4 B HW Ci Co floating-point operations. The
// products run on the tensor cores in 3xTF32 (below), three TF32
// products for each fp32 one, so the least time for the operations is
// 3 x 4 B HW Ci Co / 495 TFLOP/s; the bytes are x, dy, dx, w and dw once
// each at 3.35 TB/s. At the ResNet-50 path's 56x56 shapes the bytes bound
// it, elsewhere the operations.
//
// Precision: 3xTF32. TF32 keeps 10 mantissa bits, too few for the
// path's float32 tolerances (one TF32 product of dw's 200704-deep sums
// lands over 1e-4 of max|dw| off float64). Each float32 operand is split
// into a TF32 big part and the rest (tf32x3.cuh), and the fragments
// accumulate small*big + big*small + big*big. The tensor core's float32
// accumulation drifts as rounding toward zero does, so one chain over a
// whole dw chunk drifted in proportion to its length (on the card,
// 7.1e-6 of max|dw| at 1024-position chunks, 2.7e-5 at 4096). Each
// 32-deep stage's products therefore start from zero and are added to
// the block's sum in float32: 5-6e-7 of max|dw| at every chunk length,
// under the cuBLAS einsums' 1e-6 (PERF.md; chip_smoke.py sweeps the
// chunk length).
// The bfloat16 kernel (conv1x1_bwd_bf16_kernel, below) keeps this plan
// and runs its products on bf16 wgmma, fed by TMA (see there).
//
// Design. The TPU kernel walks the images one after another, keeps one
// image's dy block and ALL of dw resident in fast memory, and forms both
// products from the one dy block. Neither fits a GPU block: dw reaches
// 2048 x 512 floats (4 MB), against 227 KB of shared memory. And the two
// products want different grids: dx parallelises over positions and
// reduces over Co, dw parallelises over (Co, Ci) and reduces over every
// image and position. So one grid holds both roles, with images and
// positions flattened into one index j = b HW + p so that HW = 49 wastes
// no tile:
//
//   dx role  C[ci, j]  = sum_co w[co, ci] dy[j, co]    M = Ci, N = B HW,
//            K = Co; one block per (ci tile, j tile).
//   dw role  C[co, ci] = sum_j dy[j, co] x[j, ci]      M = Co, N = Ci,
//            K = B HW, cut into `splits` chunks (a multiple of the
//            32-deep stage) so that the role has enough blocks; one
//            block per (chunk, co tile, ci tile).
//
// Each block is 8 warps (2 along M x 4 along N) over a 64- or 128-wide
// tile in each dimension (128 x 128 where both output dims reach 128:
// 64 x 32 a warp), issuing mma.sync.m16n8k8 TF32 products, the three
// products of 3xTF32 in three sweeps over the warp's tiles so that no
// product waits on the one before it. dw's operands lie K-major
// (positions contiguous) and load their fragments with ldmatrix; dx's
// do not (Co is the strided axis of w and of dy) and load theirs one
// element a lane, which any layout allows. Tiles arrive through a
// 4-stage ring of cp.async copies in dynamic shared memory, so three
// stages are in flight while one is multiplied, with one barrier a
// stage: 16-byte copies where every staged row starts on a 16-byte
// boundary (HW and Ci multiples of 16 bytes' worth of elements, and the
// tensors 16-byte aligned), 4-byte copies otherwise (HW = 49 and the
// odd test shapes). Rows are padded so that the fragment loads hit 32
// banks.
//
// A dx tile leaves through shared memory as 16-byte stores along the
// positions.
//
// Sharing dy: the two roles are interleaved in block order, both sweeping
// j upwards at the same relative pace, so a dy column block that a dx
// block pulls from device memory is, in most cases, still in the 50 MB L2
// when the dw block of the same j chunk asks for it. Nothing forces the
// sharing. Where x and dy stay in L2 whatever the order (7x7), the role
// with the longer blocks goes first instead, so that none starts last.
//
// dw is a sum across blocks. No float atomics: with splits > 1 each dw
// block owns its tile of partial [splits, Co, Ci]. The chunks form groups
// of `group` (about sqrt(splits)); the block that finishes a group last
// (an integer ticket per group, after a __threadfence) adds the group's
// partial tiles in chunk order into the group's first slot, and the
// block that finishes the last group (a ticket per tile) adds the
// groups' sums in order and writes dw. Two levels, so that no one block
// reads every chunk's partial tile (196 of them at 64 -> 256 at 56x56)
// while the rest of the card idles. The sums' order is fixed, so the
// result does not change from run to run. With splits == 1 the block
// writes dw itself.
//
// The host-side plan (tile widths, chunks, copy width) is
// paddle_tpu_torch/kernels/conv1x1_bwd.py `plan`; this file checks it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

using tf32x3::cp16;
using tf32x3::cp4;
using tf32x3::cp_commit;
using tf32x3::cp_wait;
using tf32x3::mma;
using tf32x3::smem_u32;
using tf32x3::split;

constexpr int kThreads = 256;
constexpr int kWarpsM = 2, kWarpsN = 4;
constexpr int BK = 32;       // depth of one stage
constexpr int kStages = 4;
constexpr int kDxBN = 128;   // positions per dx block
// block orders of the two roles (the plan's `order`)
constexpr int kInterleave = 0, kDxFirst = 1, kDwFirst = 2;

template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int kPadK = 4;    // 36-float rows: banks 4g + t
};
constexpr int kPadMN = 8;            // BM + 8 floats: banks 8t + g

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// one element
__device__ __forceinline__ void cp1(float* dst, const float* src, bool ok) {
  cp4(dst, src, ok);
}

// Four 8 x 4 float32 matrices from shared memory, one register each:
// lane l gives the address of row l % 8 of matrix l / 8 (16 bytes), and
// gets row l / 4, column l % 4 of every matrix, which is the (g, t)
// element of an mma.m16n8k8 .tf32 fragment.
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// One stage of a role: the A tile [BM x BK] then the B tile [BK x BN].
// K-major tiles (dw) are stored [rows][BK + pad], the others (dx)
// [BK][cols + 8].
template <typename T, int BM_, int BN_, bool KMAJ_>
struct Stage {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr bool KMAJ = KMAJ_;
  static constexpr int LDA = KMAJ ? BK + Elem<T>::kPadK : BM + kPadMN;
  static constexpr int LDB = KMAJ ? BK + Elem<T>::kPadK : BN + kPadMN;
  static constexpr int A_ELEMS = KMAJ ? BM * LDA : BK * LDA;
  static constexpr int ELEMS = A_ELEMS + (KMAJ ? BN * LDB : BK * LDB);
  static constexpr int MT = BM / kWarpsM / 16;   // m16 tiles a warp
  static constexpr int NT = BN / kWarpsN / 8;    // n8 tiles a warp
  static __device__ __forceinline__ float a(const T* s, int m, int k) {
    return to_f(KMAJ ? s[m * LDA + k] : s[k * LDA + m]);
  }
  static __device__ __forceinline__ float b(const T* s, int k, int n) {
    return to_f(KMAJ ? s[A_ELEMS + n * LDB + k] : s[A_ELEMS + k * LDB + n]);
  }
};

// V elements: one 16-byte copy (V = 4) or one element
template <int V, typename T>
__device__ __forceinline__ void copy(T* dst, const T* src, bool ok) {
  if constexpr (V == 1)
    cp1(dst, src, ok);
  else
    cp16(dst, src, ok);
}

// The warp's share of one stage: BK / 8 steps of MT x NT mma tiles.
// Fragments (PTX ISA, m16n8k8 .tf32): g = lane / 4, t = lane % 4;
// A rows g, g + 8 and columns t, t + 4; B rows t, t + 4, column g;
// C rows g, g + 8, columns 2t, 2t + 1. The three products of 3xTF32 go
// in three sweeps over the tiles, so that no product waits on the one
// before it (each accumulator still adds small*big, big*small, big*big
// in that order).
template <typename T, typename S>
__device__ __forceinline__ void stage_mma(const T* s, int wm0, int wn0,
                                          int lane,
                                          float (&acc)[S::MT][S::NT][4]) {
  // K-major tiles (dw) load their fragments with ldmatrix
  constexpr bool LDSM = S::KMAJ;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    unsigned ab[S::MT][4], as[S::MT][4], bb[S::NT][2], bs[S::NT][2];
    if constexpr (LDSM) {
      const float* f = reinterpret_cast<const float*>(s);
      const int r8 = lane & 7, q = lane >> 3;
#pragma unroll
      for (int mt = 0; mt < S::MT; ++mt) {
        unsigned v[4];
        ldsm4(v, f + (wm0 + mt * 16 + r8 + 8 * (q & 1)) * S::LDA + kk +
                     4 * (q >> 1));
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split(__uint_as_float(v[i]), ab[mt][i], as[mt][i]);
      }
#pragma unroll
      for (int nt = 0; nt < S::NT; nt += 2) {
        unsigned v[4];
        ldsm4(v, f + S::A_ELEMS + (wn0 + nt * 8 + r8 + 8 * (q >> 1)) * S::LDB +
                     kk + 4 * (q & 1));
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split(__uint_as_float(v[i]), bb[nt + (i >> 1)][i & 1],
                       bs[nt + (i >> 1)][i & 1]);
      }
    } else {
#pragma unroll
      for (int mt = 0; mt < S::MT; ++mt) {
        const int m = wm0 + mt * 16 + g;
        split(S::a(s, m, kk + t), ab[mt][0], as[mt][0]);
        split(S::a(s, m + 8, kk + t), ab[mt][1], as[mt][1]);
        split(S::a(s, m, kk + t + 4), ab[mt][2], as[mt][2]);
        split(S::a(s, m + 8, kk + t + 4), ab[mt][3], as[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt) {
        const int n = wn0 + nt * 8 + g;
        split(S::b(s, kk + t, n), bb[nt][0], bs[nt][0]);
        split(S::b(s, kk + t + 4, n), bb[nt][1], bs[nt][1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt) mma(acc[mt][nt], as[mt], bb[nt]);
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt) mma(acc[mt][nt], ab[mt], bs[nt]);
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt) mma(acc[mt][nt], ab[mt], bb[nt]);
  }
}

// The ring: stages k_begin, k_begin + BK, ... < k_end, kStages - 1 of
// them in flight ahead of the one being multiplied, one barrier a stage.
// The tensor core's accumulation drifts as rounding toward zero does,
// the further the longer the chain (PERF.md): each stage's products go
// into a fresh accumulator, which is then added to acc in float32
// (rounded to nearest), so that no chain is longer than one stage's
// BK / 8 x 3 products.
template <typename T, typename S, typename Loader>
__device__ __forceinline__ void mainloop(T* smem, const Loader& ld,
                                         int k_begin, int k_end, int wm0,
                                         int wn0, int lane,
                                         float (&acc)[S::MT][S::NT][4]) {
  const int nk = (k_end - k_begin + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) ld.load(smem + s * S::ELEMS, k_begin + s * BK);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStages - 2>();   // stage kt has landed (this thread's part)
    __syncthreads();          // ... everyone's; stage kt - 1 is consumed
    const int nx = kt + kStages - 1;
    if (nx < nk) ld.load(smem + (nx % kStages) * S::ELEMS, k_begin + nx * BK);
    cp_commit();
    float part[S::MT][S::NT][4] = {};
    stage_mma<T, S>(smem + (kt % kStages) * S::ELEMS, wm0, wn0, lane, part);
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }
  cp_wait<0>();
}

// dx role: A[ci][co] = w[co][ci] stored [k = co][m = ci], B[co][j] =
// dy[b, co, p] stored [k = co][n = j]. A thread copies the same column
// (group of V) of both tiles at every stage, rows kThreads / (width / V)
// apart, so its addresses are set once and step by whole rows.
template <typename T, int V, typename S>
struct DxLoader {
  static constexpr int AG = S::BM / V, BG = S::BN / V;   // copies a row
  static constexpr int AR = kThreads / AG, BR = kThreads / BG;  // row step
  static_assert(kThreads % AG == 0 && kThreads % BG == 0 &&
                    BK % AR == 0 && BK % BR == 0,
                "a stage is not a whole number of copies a thread");
  const T* w;
  const T* dy;
  const T* a_src;   // w[ka][m0 + ma], at k0 = 0
  const T* b_src;   // dy[b, kb, p] of this thread's column j
  int Ci, HW, Co, ka, kb, a_dst, b_dst;
  bool a_ok, b_ok;
  __device__ void init(const T* w_, const T* dy_, int Ci_, int Co_, int HW_,
                       int J, int m0, int n0, int tid) {
    w = w_;
    dy = dy_;
    Ci = Ci_;
    Co = Co_;
    HW = HW_;
    const int ma = (tid % AG) * V;
    ka = tid / AG;
    a_ok = m0 + ma < Ci;
    a_src = w + (size_t)ka * Ci + m0 + ma;
    a_dst = ka * S::LDA + ma;
    const int nb = (tid % BG) * V, j = n0 + nb;
    kb = tid / BG;
    b_ok = j < J;
    const int bi = b_ok ? j / HW : 0, p = b_ok ? j - bi * HW : 0;
    b_src = dy + ((size_t)bi * Co + kb) * HW + p;
    b_dst = S::A_ELEMS + kb * S::LDB + nb;
  }
  __device__ __forceinline__ void load(T* st, int k0) const {
#pragma unroll
    for (int r = 0; r < BK / AR; ++r) {
      const bool ok = a_ok && k0 + ka + r * AR < Co;
      copy<V>(st + a_dst + r * AR * S::LDA,
              ok ? a_src + (size_t)(k0 + r * AR) * Ci : w, ok);
    }
#pragma unroll
    for (int r = 0; r < BK / BR; ++r) {
      const bool ok = b_ok && k0 + kb + r * BR < Co;
      copy<V>(st + b_dst + r * BR * S::LDB,
              ok ? b_src + (size_t)(k0 + r * BR) * HW : dy, ok);
    }
  }
};

// dw role: A[co][j] = dy[b, co, p] stored [m = co][k = j], B[j][ci] =
// x[b, ci, p] stored [n = ci][k = j]. A thread copies the same depth
// (group of V) of rows kThreads / (BK / V) apart at every stage.
template <typename T, int V, typename S>
struct DwLoader {
  static constexpr int KG = BK / V;          // copies along a row
  static constexpr int RS = kThreads / KG;   // row step
  static_assert(kThreads % KG == 0 && S::BM % RS == 0 && S::BN % RS == 0,
                "a stage is not a whole number of copies a thread");
  const T* x;
  const T* dy;
  int Ci, Co, HW, j_end, kv, am, bn, a_dst, b_dst;
  __device__ void init(const T* x_, const T* dy_, int Ci_, int Co_, int HW_,
                       int j_end_, int m0, int n0, int tid) {
    x = x_;
    dy = dy_;
    Ci = Ci_;
    Co = Co_;
    HW = HW_;
    j_end = j_end_;
    kv = (tid % KG) * V;
    am = m0 + tid / KG;
    bn = n0 + tid / KG;
    a_dst = (tid / KG) * S::LDA + kv;
    b_dst = S::A_ELEMS + (tid / KG) * S::LDB + kv;
  }
  __device__ __forceinline__ void load(T* st, int k0) const {
    const int j = k0 + kv;
    const bool j_ok = j < j_end;
    const int b = j_ok ? j / HW : 0, p = j_ok ? j - b * HW : 0;
    const T* a = dy + ((size_t)b * Co + am) * HW + p;
    const T* bs = x + ((size_t)b * Ci + bn) * HW + p;
#pragma unroll
    for (int r = 0; r < S::BM / RS; ++r) {
      const bool ok = j_ok && am + r * RS < Co;
      copy<V>(st + a_dst + r * RS * S::LDA,
              ok ? a + (size_t)r * RS * HW : dy, ok);
    }
#pragma unroll
    for (int r = 0; r < S::BN / RS; ++r) {
      const bool ok = j_ok && bn + r * RS < Ci;
      copy<V>(st + b_dst + r * RS * S::LDB,
              ok ? bs + (size_t)r * RS * HW : x, ok);
    }
  }
};

__device__ __forceinline__ void store4(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* src) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(src[0], src[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(src[2], src[3]);
  uint2 v;
  v.x = *reinterpret_cast<unsigned*>(&lo);
  v.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(dst) = v;
}

__device__ __forceinline__ void put(float* p, float v) { __stcg(p, v); }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// out = the sum, in order, of the partial tiles first, first + stride,
// ... (count of them), over this thread's outputs of a dw tile whose
// warp corner is (r0, c0): rows r0 + mt 16 + g + 8 h, columns c0 + nt 8
// + 2 t + e. A pass issues all of the thread's loads of one tile before
// it adds them.
template <typename S, typename D>
__device__ __forceinline__ void sum_partials(const float* __restrict__ partial,
                                             int first, int count, int stride,
                                             int Co, int Ci, int r0, int c0,
                                             int g, int t, D* out) {
  const size_t plane = (size_t)Co * Ci;
  float sum[S::MT][2][S::NT][2] = {};
  for (int i = 0; i < count; ++i) {
    const float* src = partial + (size_t)(first + i * stride) * plane;
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = r0 + mt * 16 + g + 8 * h;
#pragma unroll
        for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ci = c0 + nt * 8 + 2 * t + e;
            if (co < Co && ci < Ci)
              sum[mt][h][nt][e] += __ldcg(&src[(size_t)co * Ci + ci]);
          }
      }
  }
#pragma unroll
  for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = r0 + mt * 16 + g + 8 * h;
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ci = c0 + nt * 8 + 2 * t + e;
          if (co < Co && ci < Ci)
            put(&out[(size_t)co * Ci + ci], sum[mt][h][nt][e]);
        }
    }
}

// CI_T: the tile over Ci (dx rows, dw columns); CO_T: over Co (dw rows).
// V: elements a copy, 4 (16 bytes) or 1.
template <typename T, int V, int CI_T, int CO_T>
__global__ void __launch_bounds__(kThreads, 1)
conv1x1_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   T* __restrict__ dw, float* __restrict__ partial,
                   int* __restrict__ tickets, int B, int Ci, int Co, int HW,
                   int splits, int chunk, int group, int order,
                   int n_dx, int n_dw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int J = B * HW;   // the entry point bounds it
  const int ci_tiles = (Ci + CI_T - 1) / CI_T;

  // the roles in block order (see the header): interleaved, or the role
  // with the longer blocks first; dw_before counts the dw blocks ahead
  const long long L = blockIdx.x, total = (long long)n_dx + n_dw;
  int dw_before;
  bool is_dw;
  if (order == kInterleave) {
    dw_before = (int)(L * n_dw / total);
    is_dw = (int)((L + 1) * n_dw / total) > dw_before;
  } else if (order == kDxFirst) {
    is_dw = L >= n_dx;
    dw_before = is_dw ? (int)(L - n_dx) : 0;
  } else {
    is_dw = L < n_dw;
    dw_before = is_dw ? (int)L : n_dw;
  }

  if (!is_dw) {
    // ---- dx role: rows m = ci, columns n = j, depth k = co ----
    using S = Stage<T, CI_T, kDxBN, false>;
    const int idx = (int)L - dw_before;
    const int m0 = (idx % ci_tiles) * CI_T;
    const int n0 = (idx / ci_tiles) * kDxBN;
    const int wm0 = (warp / kWarpsN) * (CI_T / kWarpsM);
    const int wn0 = (warp % kWarpsN) * (kDxBN / kWarpsN);
    DxLoader<T, V, S> ld;
    ld.init(w, dy, Ci, Co, HW, J, m0, n0, tid);
    float acc[S::MT][S::NT][4] = {};
    mainloop<T, S>(smem, ld, 0, Co, wm0, wn0, lane, acc);
    // The tile goes out through shared memory: rows of kDxBN positions
    // leave as 16-byte stores (4 positions of one image where HW % 4 ==
    // 0), where the fragments' own layout would scatter 4-byte stores
    // across 8 channel planes.
    constexpr int LDC = kDxBN + kPadMN;
    float* ct = reinterpret_cast<float*>(smem_raw);
    __syncthreads();   // every warp is done with the ring
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < S::NT; ++nt)
          *reinterpret_cast<float2*>(
              &ct[(wm0 + mt * 16 + g + 8 * h) * LDC + wn0 + nt * 8 + 2 * t]) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
    __syncthreads();
    constexpr int QG = kDxBN / 4;   // 4-position groups a row
    const int c4 = (tid % QG) * 4, j4 = n0 + c4;
    int bq[4], pq[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = min(j4 + u, J - 1);
      bq[u] = j / HW;
      pq[u] = j - bq[u] * HW;
    }
    // four positions of one image, on an aligned address
    const bool whole = HW % 4 == 0 && j4 < J &&
                       reinterpret_cast<uintptr_t>(dx) % (4 * sizeof(T)) == 0;
#pragma unroll 4
    for (int r = tid / QG; r < CI_T; r += kThreads / QG) {
      const int ci = m0 + r;
      if (ci >= Ci) break;
      const float* src = &ct[r * LDC + c4];
      if (whole) {
        store4(dx + ((size_t)bq[0] * Ci + ci) * HW + pq[0], src);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (j4 + u < J)
            from_f(&dx[((size_t)bq[u] * Ci + ci) * HW + pq[u]], src[u]);
      }
    }
    return;
  }

  // ---- dw role: rows m = co, columns n = ci, depth k = j in a chunk ----
  using S = Stage<T, CO_T, CI_T, true>;
  const int tiles = ((Co + CO_T - 1) / CO_T) * ci_tiles;
  const int split_i = dw_before / tiles;
  const int tile = dw_before % tiles;
  const int m0 = (tile / ci_tiles) * CO_T;
  const int n0 = (tile % ci_tiles) * CI_T;
  const int wm0 = (warp / kWarpsN) * (CO_T / kWarpsM);
  const int wn0 = (warp % kWarpsN) * (CI_T / kWarpsN);
  const int j_begin = split_i * chunk;
  const int j_end = min(j_begin + chunk, J);
  DwLoader<T, V, S> ld;
  ld.init(x, dy, Ci, Co, HW, j_end, m0, n0, tid);
  float acc[S::MT][S::NT][4] = {};
  mainloop<T, S>(smem, ld, j_begin, j_end, wm0, wn0, lane, acc);

  // this thread's outputs: (co, ci) = (m0 + wm0 + mt 16 + g + 8 h,
  // n0 + wn0 + nt 8 + 2 t + e), accumulator element 2 h + e
  if (splits == 1) {
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = m0 + wm0 + mt * 16 + g + 8 * h;
        if (co >= Co) continue;
#pragma unroll
        for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ci = n0 + wn0 + nt * 8 + 2 * t + e;
            if (ci < Ci)
              from_f(&dw[(size_t)co * Ci + ci], acc[mt][nt][2 * h + e]);
          }
      }
    return;
  }
  // this block's tile of partial[split_i]
  const size_t plane = (size_t)Co * Ci;
  float* mine = partial + (size_t)split_i * plane;
#pragma unroll
  for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = m0 + wm0 + mt * 16 + g + 8 * h;
      if (co >= Co) continue;
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ci = n0 + wn0 + nt * 8 + 2 * t + e;
          if (ci < Ci)
            __stcg(&mine[(size_t)co * Ci + ci], acc[mt][nt][2 * h + e]);
        }
    }
  // Two levels, so that no one block reads every chunk: the last block
  // of each group of `group` chunks adds the group's partial tiles in
  // order into the group's first slot; the last group to finish adds the
  // groups' sums in order and writes dw.
  const int n_groups = (splits + group - 1) / group;
  const int grp = split_i / group, first = grp * group;
  const int members = min(group, splits - first);
  int* tk = tickets + (size_t)tile * (n_groups + 1);
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&tk[grp], 1) == members - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (n_groups == 1) {
    sum_partials<S>(partial, 0, splits, 1, Co, Ci, m0 + wm0, n0 + wn0, g, t,
                    dw);
    return;
  }
  sum_partials<S>(partial, first, members, 1, Co, Ci, m0 + wm0, n0 + wn0, g,
                  t, partial + (size_t)first * plane);
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&tk[n_groups], 1) == n_groups - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  sum_partials<S>(partial, 0, n_groups, group, Co, Ci, m0 + wm0, n0 + wn0, g,
                  t, dw);
}

template <typename T, int V, int CI_T, int CO_T>
cudaError_t launch(const void* x, const void* w, const void* dy, void* dx,
                   void* dw, float* partial, int* tickets, int B, int Ci,
                   int Co, int HW, int splits, int chunk, int group,
                   int order, cudaStream_t stream) {
  using SX = Stage<T, CI_T, kDxBN, false>;
  using SW = Stage<T, CO_T, CI_T, true>;
  constexpr int kElems = SX::ELEMS > SW::ELEMS ? SX::ELEMS : SW::ELEMS;
  constexpr int kSmem = kStages * kElems * (int)sizeof(T);
  static_assert(kSmem <= 227 * 1024, "stage ring exceeds shared memory");
  static_assert(CI_T * (kDxBN + kPadMN) * 4 <= kSmem,
                "the dx tile does not fit the ring");
  auto kernel = conv1x1_bwd_kernel<T, V, CI_T, CO_T>;
  // an attribute of the kernel on the current device: set at every
  // launch, so that a launch on another card has it too
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const long long J = (long long)B * HW;
  const long long n_dx = ((Ci + CI_T - 1) / CI_T) * ((J + kDxBN - 1) / kDxBN);
  const long long n_dw = (long long)((Co + CO_T - 1) / CO_T) *
                         ((Ci + CI_T - 1) / CI_T) * splits;
  if (n_dx + n_dw > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)(n_dx + n_dw), kThreads, kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(dy), static_cast<T*>(dx), static_cast<T*>(dw),
      partial, tickets, B, Ci, Co, HW, splits, chunk, group, order,
      (int)n_dx, (int)n_dw);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t pick(int ci_tile, int co_tile, const void* x, const void* w,
                 const void* dy, void* dx, void* dw, float* p, int* tk,
                 int B, int Ci, int Co, int HW, int splits, int chunk,
                 int group, int order, cudaStream_t s) {
  if (ci_tile == 64 && co_tile == 64)
    return launch<T, V, 64, 64>(x, w, dy, dx, dw, p, tk, B, Ci, Co, HW,
                                splits, chunk, group, order, s);
  if (ci_tile == 64)
    return launch<T, V, 64, 128>(x, w, dy, dx, dw, p, tk, B, Ci, Co, HW,
                                 splits, chunk, group, order, s);
  if (co_tile == 64)
    return launch<T, V, 128, 64>(x, w, dy, dx, dw, p, tk, B, Ci, Co, HW,
                                 splits, chunk, group, order, s);
  return launch<T, V, 128, 128>(x, w, dy, dx, dw, p, tk, B, Ci, Co, HW,
                                splits, chunk, group, order, s);
}

bool tile_ok(int v) { return v == 64 || v == 128; }

// ---- bfloat16: wgmma, fed by TMA where the rows allow it ----
//
// The bfloat16 kernel keeps the float32 kernel's plan (the two roles in
// one grid, their block order, dw's chunks and its two-level sum with
// tickets) and runs its products as wgmma.m64nNk16 bf16 -> float32, both
// operands read from shared memory by descriptor: no fragment is loaded
// by a lane. A stage is 64 deep (one 128-byte swizzle row of bf16) and
// every tile is a stack of [64 rows][64 columns] sub-tiles in the
// 128-byte swizzle (hopper.cuh), the columns being the operand's
// contiguous dim in device memory:
//   dx role  A = w^T: sub-tiles [64 co][64 ci], MN-major (ci contiguous);
//            B = dy:  sub-tiles [64 co][64 positions], MN-major;
//   dw role  A = dy:  sub-tiles [64 co][64 positions], K-major;
//            B = x:   sub-tiles [64 ci][64 positions], K-major.
// The block's two warpgroups split the tile: 64 rows each where it has
// 128, else half of its columns each.
//   Loaders (kernels/conv1x1_bwd.py `plan` chooses by shape, never on a
// failed launch):
// * TMA where every row starts on a 16-byte boundary (HW and Ci multiples
//   of 8, the tensors 16-byte aligned: 56x56 and 28x28). One thread
//   issues a stage's boxes of [b][channel][position] maps against the
//   slot's "full" mbarrier; a __syncthreads a stage frees the slot it
//   refills. A box never crosses an image, so each image's positions are
//   cut into tiles of their own (the last zero-filled past HW).
// * bulk copies where an image's rows of 64 channels lie in one 16-byte
//   aligned run (HW <= 64, Ci and Co multiples of 8: 7x7 and the odd
//   test shapes): one cp.async.bulk a run, as it lies (w still by TMA),
//   then the block's threads swizzle it in shared memory (relayout) and
//   fence it for wgmma. A dx tile takes 128 / HW whole images.
// * 8-byte cp.async copies where the rows start on 8-byte boundaries (HW
//   and Ci multiples of 4: 14x14), else one element a thread through
//   registers, over positions j = b HW + p taken straight across images.
//   Accumulation: one float32 accumulator per chunk of dw's depth. The
// float32 kernel sums each 32-deep stage apart because its 3xTF32 sums
// must hold 1e-4 of max|dw|; a chain over a whole chunk drifts by about
// 1e-5 of max|dw| (PERF.md), far inside the bfloat16 tolerance (4e-3 of
// max|dw|), and chip_smoke.py's chunk sweep prints it for this kernel.

constexpr int kBK = 64;               // depth of a bf16 stage
constexpr int kSubBytes = 64 * 128;   // a [64][64] bf16 sub-tile
constexpr int kBfStages = 3;        // two blocks an SM fit
constexpr int kBulkStages = 2;      // the same with the swizzled tiles
// the loaders (the plan's `loader`)
constexpr int kTma = 0, kCpAsync = 1, kRegisters = 2, kBulk = 3;
using bf16 = __nv_bfloat16;

template <int CI_T, int CO_T>
struct Bf16Tiles {
  static constexpr int DX_SUBS = CI_T / 64 + kDxBN / 64;   // w, then dy
  static constexpr int DW_SUBS = CO_T / 64 + CI_T / 64;    // dy, then x
  static constexpr int STAGE =
      (DX_SUBS > DW_SUBS ? DX_SUBS : DW_SUBS) * kSubBytes;
  static constexpr int BYTES = 1024 + kBfStages * STAGE;
  // kBulk: a ring of kBulkStages holds the copies as they lie in device
  // memory, and one more stage's room takes the swizzled tiles
  static constexpr int BULK_BYTES = 1024 + (kBulkStages + 1) * STAGE;
  static constexpr int LDC = kDxBN + kPadMN;   // the dx tile's float rows
};

// byte offset of element (r, c) of a [64][64] bf16 sub-tile in the
// 128-byte swizzle
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// 16 bytes of shared memory from byte address b (2-byte aligned): five
// aligned words, shifted into place
__device__ __forceinline__ uint4 ld16_at(unsigned b) {
  const unsigned a = b & ~3u, sh = (b & 2u) * 8;
  unsigned w[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(w[i]) : "r"(a + 4 * i));
  return make_uint4(__funnelshift_r(w[0], w[1], sh),
                    __funnelshift_r(w[1], w[2], sh),
                    __funnelshift_r(w[2], w[3], sh),
                    __funnelshift_r(w[3], w[4], sh));
}

// element e of a 16-byte chunk (8 bf16), as the low or high half of its word
__device__ __forceinline__ unsigned word_of(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// kBulk, dw role: rows [0, rows_valid) of a [rows][HW] chunk as it lies
// in shared memory at `src` (HW <= 64) into the swizzled tile at `dst`,
// element (r, p) at row r, column p; 16 bytes at a time: the 8 columns
// of a destination chunk are 8 positions in a row of the source, read as
// 5 aligned words and shifted into place (the source rows start on
// 2-byte boundaries). Columns past HW are written as zeros; rows past
// rows_valid and chunks wholly past HW are left as they are (zero: the
// tile is zeroed once, and no stage writes there).
__device__ __forceinline__ void relayout_rows(unsigned char* dst,
                                              const bf16* src, int rows_valid,
                                              int HW, int tid) {
  // thread tid: chunk tid % 8 of rows tid / 8, + 32, ... (a row has at
  // most 8 chunks, HW <= 64)
  const int k = tid % 8;
  if (8 * k >= HW) return;
  const unsigned base = tf32x3::smem_u32(src);
  for (int r = tid / 8; r < rows_valid; r += kThreads / 8) {
    const uint4 x = ld16_at(base + 2 * (r * HW + 8 * k));
    const int nv = min(8, HW - 8 * k);   // positions in the chunk
    uint4 v;
    unsigned* o = &v.x;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int left = nv - 2 * j;   // valid elements from this word on
      o[j] = left >= 2 ? word_of(x, j)
                       : left == 1 ? (word_of(x, j) & 0xffffu) : 0u;
    }
    *reinterpret_cast<uint4*>(dst + (r >> 6) * kSubBytes +
                              swz(r & 63, 8 * k)) = v;
  }
}

// kBulk, dx role: the 64 rows of a [64][HW] chunk as it lies in shared
// memory (HW <= 64; rows_valid of them copied, the rest zero) into the
// swizzled [64][128] tile at `dst`, element (r, p) at row r, column col0
// + p (image i of the tile at col0 = i HW: a destination chunk may hold
// positions of two images, so this goes element by element). Warp w
// moves rows w, w + 8, ...; every load of the thread is issued before
// its first store.
__device__ __forceinline__ void relayout(unsigned char* dst, const bf16* src,
                                         int rows_valid, int HW, int col0,
                                         int warp, int lane) {
  constexpr int R = 64 / (kThreads / 32);   // rows a warp
  bf16 v[R][2];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = warp + i * (kThreads / 32);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = lane + 32 * h;
      v[i][h] = r < rows_valid && p < HW ? src[r * HW + p]
                                         : __float2bfloat16(0.f);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = warp + i * (kThreads / 32);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = lane + 32 * h, c = col0 + p;
      if (p < HW)
        *reinterpret_cast<bf16*>(dst + (c >> 6) * kSubBytes + swz(r, c & 63)) =
            v[i][h];
    }
  }
}

// kBulk: `bytes` (a multiple of 16) from device memory to shared memory
// in one asynchronous bulk copy, completing `bar`'s transactions
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(tf32x3::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(tf32x3::smem_u32(bar))
      : "memory");
}

// Stage a [64 rows][64 columns] sub-tile at `dst` through the block's
// threads (the manual loaders): element (r, c) from src.at(r, c), or zero
// where it falls outside. V = 4: one 8-byte cp.async of 4 columns; V = 1:
// one element through registers, every load of the thread issued before
// its first store. A thread's column is fixed, so its address is worked
// out once and steps by whole rows.
template <int V, typename Src>
__device__ __forceinline__ void stage_sub(unsigned char* dst, int tid,
                                          const Src& src) {
  constexpr int COLS_T = 64 / V;              // threads along a row
  constexpr int RSTEP = kThreads / COLS_T;    // rows between a thread's
  constexpr int N = 64 / RSTEP;               // rows a thread
  const int c = (tid % COLS_T) * V, r0 = tid / COLS_T;
  const bf16* p = src.at(r0, c);   // null: the column lies outside
  const size_t step = src.row_step() * RSTEP;
  if constexpr (V == 4) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool ok = p != nullptr && src.row_ok(r0 + i * RSTEP);
      const unsigned a = tf32x3::smem_u32(dst + swz(r0 + i * RSTEP, c));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(a),
                   "l"(ok ? p + i * step : src.base), "r"(ok ? 8 : 0));
    }
  } else {
    bf16 v[N];
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] = p != nullptr && src.row_ok(r0 + i * RSTEP) ? __ldg(p + i * step)
                                                       : __float2bfloat16(0.f);
#pragma unroll
    for (int i = 0; i < N; ++i)
      *reinterpret_cast<bf16*>(dst + swz(r0 + i * RSTEP, c)) = v[i];
  }
}

// rows: channels ch0 + r (< C) of x or dy; columns: positions j0 + c of
// the flattened j = b HW + p (c < n)
struct ChanPos {
  const bf16* base;
  int C, HW, ch0, j0, n;
  __device__ const bf16* at(int r, int c) const {
    if (c >= n) return nullptr;
    const int j = j0 + c, b = j / HW;
    return base + ((size_t)b * C + ch0 + r) * HW + (j - b * HW);
  }
  __device__ bool row_ok(int r) const { return ch0 + r < C; }
  __device__ size_t row_step() const { return HW; }
};
// rows: co = co0 + r (< Co); columns: ci = ci0 + c (< Ci) of w [Co][Ci]
struct WRows {
  const bf16* base;
  int Ci, Co, co0, ci0;
  __device__ const bf16* at(int r, int c) const {
    if (ci0 + c >= Ci) return nullptr;
    return base + (size_t)(co0 + r) * Ci + ci0 + c;
  }
  __device__ bool row_ok(int r) const { return co0 + r < Co; }
  __device__ size_t row_step() const { return Ci; }
};

// out = the sum, in order, of the partial tiles first, first + stride,
// ... (count of them) over a CO_T x CI_T tile at (m0, n0): thread tid
// owns column tid % CI_T of every (kThreads / CI_T)-th row, and issues
// its loads of 16 rows of a partial tile before it adds them.
template <int CO_T, int CI_T, typename D>
__device__ __forceinline__ void sum_tile(const float* __restrict__ partial,
                                         int first, int count, int stride,
                                         int Co, int Ci, int m0, int n0,
                                         int tid, D* out) {
  constexpr int STEP = kThreads / CI_T;        // rows between a thread's
  constexpr int E = 16;                        // rows a pass
  static_assert(CO_T % (STEP * E) == 0, "passes do not tile the rows");
  const size_t plane = (size_t)Co * Ci;
  const int ci = n0 + tid % CI_T;
  if (ci >= Ci) return;
#pragma unroll 1
  for (int r0 = m0 + tid / CI_T; r0 < m0 + CO_T; r0 += STEP * E) {
    float sum[E];
#pragma unroll
    for (int e = 0; e < E; ++e) sum[e] = 0.f;
    for (int i = 0; i < count; ++i) {
      const float* src =
          partial + (size_t)(first + i * stride) * plane + ci;
      float v[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int co = r0 + e * STEP;
        v[e] = co < Co ? __ldcg(src + (size_t)co * Ci) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) sum[e] += v[e];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int co = r0 + e * STEP;
      if (co < Co) put(&out[(size_t)co * Ci + ci], sum[e]);
    }
  }
}

// The products of one stage into the warpgroup's accumulators: 4 k16
// steps of NB products m64nN, A at a_addr, product n's B at b_addr + n
// b_step (shared addresses); TA / TB: MN-major operands step 16 rows a
// k16 step, K-major ones 32 bytes.
template <int NB, int R, int TA, int TB>
__device__ __forceinline__ void stage_wgmma(float (&acc)[NB][R],
                                            unsigned a_addr, unsigned b_addr,
                                            unsigned b_step) {
#pragma unroll
  for (int n = 0; n < NB; ++n) hopper::fence_regs(acc[n]);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t da =
        hopper::desc(a_addr + kk * (TA ? 16 * 128 : 32), 1024, 1);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const uint64_t db = hopper::desc(
          b_addr + n * b_step + kk * (TB ? 16 * 128 : 32), 1024, 1);
      if constexpr (R == 32)
        hopper::wgmma_ss_n64<TA, TB>(acc[n], da, db, 1);
      else
        hopper::wgmma_ss_n32<TA, TB>(acc[n], da, db, 1);
    }
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < NB; ++n) hopper::fence_regs(acc[n]);
}

// The ring of S stages over steps 0 .. nk - 1: load(slot, step)
// fills a slot, mma(slot) multiplies one. TMA: thread 0 issues the loads
// against the slots' "full" mbarriers; the manual loaders: every thread
// copies its share, then makes it visible to wgmma (the async proxy).
template <int LOADER, typename Load, typename Mma>
__device__ __forceinline__ void bf16_mainloop(unsigned char* ring,
                                              uint64_t* full, int nk,
                                              int tid, const Load& load,
                                              const Mma& mma) {
  constexpr int S = LOADER == kBulk ? kBulkStages : kBfStages;
  if constexpr (LOADER == kTma || LOADER == kBulk) {
    if (tid == 0)
      for (int s = 0; s < S - 1 && s < nk; ++s) load(s, s);
    for (int kt = 0; kt < nk; ++kt) {
      __syncthreads();   // stage kt - 1 is consumed: its slot is free
      const int nx = kt + S - 1;
      if (tid == 0 && nx < nk) load(nx % S, nx);
      hopper::mbar_wait(&full[kt % S], (kt / S) & 1);
      mma(kt % S);
    }
  } else {
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
      if (s < nk) load(s, s);
      cp_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_wait<S - 2>();   // this thread's copies of stage kt ...
      hopper::fence_proxy_async();
      __syncthreads();            // ... and everyone's; kt - 1 consumed
      const int nx = kt + S - 1;
      if (nx < nk) load(nx % S, nx);
      cp_commit();
      mma(kt % S);
    }
    cp_wait<0>();
  }
}

// CI_T: the tile over Ci (dx rows, dw columns); CO_T: over Co (dw rows).
template <int CI_T, int CO_T, int LOADER>
__global__ void __launch_bounds__(kThreads, LOADER == kRegisters ? 1 : 2)
conv1x1_bwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_w,
                        const __grid_constant__ CUtensorMap tm_dy,
                        const bf16* __restrict__ x,
                        const bf16* __restrict__ w,
                        const bf16* __restrict__ dy, bf16* __restrict__ dx,
                        bf16* __restrict__ dw, float* __restrict__ partial,
                        int* __restrict__ tickets, int B, int Ci, int Co,
                        int HW, int splits, int chunk, int group, int order,
                        int n_dx, int n_dw) {
  using TT = Bf16Tiles<CI_T, CO_T>;
  constexpr int V = LOADER == kCpAsync ? 4 : 1;
  extern __shared__ unsigned char c1_smem_raw[];
  __shared__ uint64_t full[kBfStages];
  __shared__ int s_last;
  const unsigned raw = tf32x3::smem_u32(c1_smem_raw);
  unsigned char* ring = c1_smem_raw + (((raw + 1023) & ~1023u) - raw);
  const unsigned ring_addr = tf32x3::smem_u32(ring);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wi = warp & 3;
  const int J = B * HW;   // the entry point bounds it
  const int ci_tiles = (Ci + CI_T - 1) / CI_T;

  // kBulk: the swizzled tiles past the ring, zeroed once (what the block's
  // chunks leave unwritten stays zero)
  unsigned char* swzbuf = ring + kBulkStages * TT::STAGE;
  const unsigned swz_addr = ring_addr + kBulkStages * TT::STAGE;
  if constexpr (LOADER == kBulk)
    for (int i = tid; i < TT::STAGE / 16; i += kThreads)
      reinterpret_cast<uint4*>(swzbuf)[i] = make_uint4(0, 0, 0, 0);
  if ((LOADER == kTma || LOADER == kBulk) && tid == 0) {
    hopper::prefetch_map(&tm_w);
    if (LOADER == kTma) {
      hopper::prefetch_map(&tm_x);
      hopper::prefetch_map(&tm_dy);
    }
    for (int s = 0; s < kBfStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // the roles in block order, as the float32 kernel takes them
  const long long L = blockIdx.x, total = (long long)n_dx + n_dw;
  int dw_before;
  bool is_dw;
  if (order == kInterleave) {
    dw_before = (int)(L * n_dw / total);
    is_dw = (int)((L + 1) * n_dw / total) > dw_before;
  } else if (order == kDxFirst) {
    is_dw = L >= n_dx;
    dw_before = is_dw ? (int)(L - n_dx) : 0;
  } else {
    is_dw = L < n_dw;
    dw_before = is_dw ? (int)L : n_dw;
  }

  if (!is_dw) {
    // ---- dx role: rows m = ci, columns n = positions, depth k = co ----
    const int idx = (int)L - dw_before;
    const int m0 = (idx % ci_tiles) * CI_T;
    const int tile = idx / ci_tiles;
    // the tile's positions: j0 .. j0 + n - 1 (one image with TMA; kBulk:
    // the imgs whole images from b0)
    int b0 = 0, p0 = 0, imgs = 1, j0, n;
    if (LOADER == kTma) {
      const int per = (HW + kDxBN - 1) / kDxBN;
      b0 = tile / per;
      p0 = (tile - b0 * per) * kDxBN;
      j0 = b0 * HW + p0;
      n = min(kDxBN, HW - p0);
    } else if (LOADER == kBulk) {
      const int k = kDxBN / HW;
      b0 = tile * k;
      imgs = min(k, B - b0);
      j0 = b0 * HW;
      n = imgs * HW;
    } else {
      j0 = tile * kDxBN;
      n = min(kDxBN, J - j0);
    }
    constexpr int A_SUBS = CI_T / 64;
    auto load = [&](int slot, int step) {
      unsigned char* st = ring + slot * TT::STAGE;
      const int k0 = step * kBK;
      if constexpr (LOADER == kTma) {
        const int halves = n > 64 ? 2 : 1;   // boxes wholly past HW: none
        hopper::mbar_expect_tx(&full[slot], (A_SUBS + halves) * kSubBytes);
#pragma unroll
        for (int s = 0; s < A_SUBS; ++s)
          hopper::tma_load_2d(st + s * kSubBytes, &tm_w, &full[slot],
                              m0 + 64 * s, k0);
        for (int h = 0; h < halves; ++h)
          hopper::tma_load_3d(st + (A_SUBS + h) * kSubBytes, &tm_dy,
                              &full[slot], p0 + 64 * h, k0, b0);
      } else if constexpr (LOADER == kBulk) {
        // w by TMA; dy's rows k0 .. of each image, as they lie
        const unsigned rows = min(kBK, Co - k0), bytes = rows * HW * 2;
        hopper::mbar_expect_tx(&full[slot],
                               A_SUBS * kSubBytes + imgs * bytes);
#pragma unroll
        for (int s = 0; s < A_SUBS; ++s)
          hopper::tma_load_2d(st + s * kSubBytes, &tm_w, &full[slot],
                              m0 + 64 * s, k0);
        for (int i = 0; i < imgs; ++i)
          bulk_copy(st + A_SUBS * kSubBytes + i * kBK * HW * 2,
                    dy + ((size_t)(b0 + i) * Co + k0) * HW, bytes,
                    &full[slot]);
      } else {
#pragma unroll
        for (int s = 0; s < A_SUBS; ++s)
          stage_sub<V>(st + s * kSubBytes, tid,
                       WRows{w, Ci, Co, k0, m0 + 64 * s});
#pragma unroll
        for (int h = 0; h < 2; ++h)
          stage_sub<V>(st + (A_SUBS + h) * kSubBytes, tid,
                       ChanPos{dy, Co, HW, k0, j0 + 64 * h, n - 64 * h});
      }
    };
    // warpgroup wg: rows 64 wg .. of a 128-row tile and both position
    // halves, or all 64 rows and position half wg
    constexpr int NB = CI_T == 128 ? 2 : 1;
    float acc[NB][32];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
    const int a_sub = CI_T == 128 ? wg : 0;
    const int b_sub = A_SUBS + (CI_T == 128 ? 0 : wg);
    int kt = 0;
    auto mma = [&](int slot) {
      const unsigned st = ring_addr + slot * TT::STAGE;
      if constexpr (LOADER == kBulk) {
        // dy's chunks into the swizzled tile: image i at columns i HW ..
        const bf16* lin = reinterpret_cast<const bf16*>(
            ring + slot * TT::STAGE + A_SUBS * kSubBytes);
        const int rows = min(kBK, Co - kt * kBK);
        for (int i = 0; i < imgs; ++i)
          relayout(swzbuf, lin + i * kBK * HW, rows, HW, i * HW, warp, lane);
        hopper::fence_proxy_async();
        __syncthreads();
        ++kt;
        stage_wgmma<NB, 32, 1, 1>(acc, st + a_sub * kSubBytes,
                                  swz_addr + (b_sub - A_SUBS) * kSubBytes,
                                  kSubBytes);
      } else {
        stage_wgmma<NB, 32, 1, 1>(acc, st + a_sub * kSubBytes,
                                  st + b_sub * kSubBytes, kSubBytes);
      }
    };
    bf16_mainloop<LOADER>(ring, full, (Co + kBK - 1) / kBK, tid, load, mma);

    // The tile leaves through shared memory (the ring, free by now): rows
    // of kDxBN positions go out as 8-byte stores of 4 positions of one
    // image where they can.
    float* ct = reinterpret_cast<float*>(ring);
    __syncthreads();   // every warpgroup is done with the ring
    const int row0 = (CI_T == 128 ? wg * 64 : 0) + wi * 16 + g;
    const int col0 = (CI_T == 128 ? 0 : wg * 64) + 2 * t;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              &ct[(row0 + 8 * h) * TT::LDC + col0 + nb * 64 + 8 * i]) =
              make_float2(acc[nb][4 * i + 2 * h], acc[nb][4 * i + 2 * h + 1]);
    __syncthreads();
    constexpr int QG = kDxBN / 4;   // 4-position groups a row
    const int c4 = (tid % QG) * 4;
    int bq[4], pq[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + min(c4 + u, n - 1);
      bq[u] = j / HW;
      pq[u] = j - bq[u] * HW;
    }
    // four positions of one image, on an 8-byte boundary
    const bool whole = HW % 4 == 0 && c4 + 3 < n &&
                       reinterpret_cast<uintptr_t>(dx) % 8 == 0;
#pragma unroll 4
    for (int r = tid / QG; r < CI_T; r += kThreads / QG) {
      const int ci = m0 + r;
      if (ci >= Ci) break;
      const float* src = &ct[r * TT::LDC + c4];
      if (whole) {
        store4(dx + ((size_t)bq[0] * Ci + ci) * HW + pq[0], src);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c4 + u < n)
            from_f(&dx[((size_t)bq[u] * Ci + ci) * HW + pq[u]], src[u]);
      }
    }
    return;
  }

  // ---- dw role: rows m = co, columns n = ci, depth k = positions ----
  const int tiles = ((Co + CO_T - 1) / CO_T) * ci_tiles;
  const int split_i = dw_before / tiles;
  const int tile = dw_before % tiles;
  const int m0 = (tile / ci_tiles) * CO_T;
  const int n0 = (tile % ci_tiles) * CI_T;
  // the chunk's stages: chunk positions of the padded depth (TMA: each
  // image's positions padded to whole stages)
  // stages an image (TMA; kBulk: HW <= 64, one)
  const int per = (HW + kBK - 1) / kBK;
  const bool per_image = LOADER == kTma || LOADER == kBulk;
  const int steps = per_image ? B * per : (J + kBK - 1) / kBK;
  const int s_begin = split_i * (chunk / kBK);
  const int nk = min(chunk / kBK, steps - s_begin);
  constexpr int A_SUBS = CO_T / 64, B_SUBS = CI_T / 64;
  auto load = [&](int slot, int kt) {
    unsigned char* st = ring + slot * TT::STAGE;
    const int step = s_begin + kt;
    if constexpr (LOADER == kTma) {
      const int b = step / per, p0 = (step - b * per) * kBK;
      hopper::mbar_expect_tx(&full[slot], (A_SUBS + B_SUBS) * kSubBytes);
#pragma unroll
      for (int s = 0; s < A_SUBS; ++s)
        hopper::tma_load_3d(st + s * kSubBytes, &tm_dy, &full[slot], p0,
                            m0 + 64 * s, b);
#pragma unroll
      for (int s = 0; s < B_SUBS; ++s)
        hopper::tma_load_3d(st + (A_SUBS + s) * kSubBytes, &tm_x,
                            &full[slot], p0, n0 + 64 * s, b);
    } else if constexpr (LOADER == kBulk) {
      // image `step`'s rows of dy (co) and x (ci), as they lie
      const unsigned a_bytes = min(CO_T, Co - m0) * HW * 2;
      const unsigned b_bytes = min(CI_T, Ci - n0) * HW * 2;
      hopper::mbar_expect_tx(&full[slot], a_bytes + b_bytes);
      bulk_copy(st, dy + ((size_t)step * Co + m0) * HW, a_bytes, &full[slot]);
      bulk_copy(st + CO_T * HW * 2, x + ((size_t)step * Ci + n0) * HW,
                b_bytes, &full[slot]);
    } else {
      const int j0 = step * kBK, nj = min(kBK, J - j0);
#pragma unroll
      for (int s = 0; s < A_SUBS; ++s)
        stage_sub<V>(st + s * kSubBytes, tid,
                     ChanPos{dy, Co, HW, m0 + 64 * s, j0, nj});
#pragma unroll
      for (int s = 0; s < B_SUBS; ++s)
        stage_sub<V>(st + (A_SUBS + s) * kSubBytes, tid,
                     ChanPos{x, Ci, HW, n0 + 64 * s, j0, nj});
    }
  };
  // warpgroup wg: rows 64 wg .. of a 128-row tile and every column, or
  // all 64 rows and column half wg (64 or 32 wide)
  constexpr int NB = CO_T == 128 ? CI_T / 64 : 1;
  constexpr int R = (CO_T == 64 && CI_T == 64) ? 16 : 32;
  constexpr int NW = R * 2;   // columns a product
  float acc[NB][R];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < R; ++i) acc[nb][i] = 0.f;
  const int a_off = (CO_T == 128 ? wg : 0) * kSubBytes;
  const int b_off = A_SUBS * kSubBytes + (CO_T == 128 ? 0 : wg * NW * 128);
  auto mma = [&](int slot) {
    unsigned st = ring_addr + slot * TT::STAGE;
    if constexpr (LOADER == kBulk) {
      const bf16* lin =
          reinterpret_cast<const bf16*>(ring + slot * TT::STAGE);
      relayout_rows(swzbuf, lin, min(CO_T, Co - m0), HW, tid);
      relayout_rows(swzbuf + A_SUBS * kSubBytes, lin + CO_T * HW,
                    min(CI_T, Ci - n0), HW, tid);
      hopper::fence_proxy_async();
      __syncthreads();
      st = swz_addr;
    }
    stage_wgmma<NB, R, 0, 0>(acc, st + a_off, st + b_off, kSubBytes);
  };
  bf16_mainloop<LOADER>(ring, full, nk, tid, load, mma);

  // this thread's outputs: (co, ci) = (m0 + row0 + 8 h, n0 + col0 + nb NW
  // + 8 i + 2 t + e), accumulator element 4 i + 2 h + e
  const int row0 = (CO_T == 128 ? wg * 64 : 0) + wi * 16 + g;
  const int col0 = (CO_T == 128 ? 0 : wg * NW) + 2 * t;
  auto each = [&](auto&& f) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < R / 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = m0 + row0 + 8 * h;
            const int ci = n0 + col0 + nb * NW + 8 * i + e;
            if (co < Co && ci < Ci)
              f((size_t)co * Ci + ci, acc[nb][4 * i + 2 * h + e]);
          }
  };
  if (splits == 1) {
    each([&](size_t o, float v) { from_f(&dw[o], v); });
    return;
  }
  // this block's tile of partial[split_i], then the two-level sum as the
  // float32 kernel does it
  const size_t plane = (size_t)Co * Ci;
  float* mine = partial + (size_t)split_i * plane;
  each([&](size_t o, float v) { __stcg(&mine[o], v); });
  const int n_groups = (splits + group - 1) / group;
  const int grp = split_i / group, first = grp * group;
  const int members = min(group, splits - first);
  int* tk = tickets + (size_t)tile * (n_groups + 1);
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&tk[grp], 1) == members - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (n_groups == 1) {
    sum_tile<CO_T, CI_T>(partial, 0, splits, 1, Co, Ci, m0, n0, tid, dw);
    return;
  }
  sum_tile<CO_T, CI_T>(partial, first, members, 1, Co, Ci, m0, n0, tid,
                       partial + (size_t)first * plane);
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&tk[n_groups], 1) == n_groups - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  sum_tile<CO_T, CI_T>(partial, 0, n_groups, group, Co, Ci, m0, n0, tid, dw);
}

template <int CI_T, int CO_T, int LOADER>
cudaError_t launch_bf16(const void* x, const void* w, const void* dy,
                        void* dx, void* dw, float* partial, int* tickets,
                        int B, int Ci, int Co, int HW, int splits, int chunk,
                        int group, int order, cudaStream_t stream) {
  using TT = Bf16Tiles<CI_T, CO_T>;
  static_assert(TT::BYTES <= 227 * 1024, "stage ring exceeds shared memory");
  static_assert(CI_T * TT::LDC * 4 <= kBfStages * TT::STAGE,
                "the dx tile does not fit the ring");
  // the manual loaders read no map; kBulk only w's
  CUtensorMap mx = {}, mw = {}, mdy = {};
  if (LOADER == kBulk) {
    const uint64_t w_dims[2] = {(uint64_t)Ci, (uint64_t)Co};
    const uint64_t w_strides[1] = {2 * (uint64_t)Ci};
    const uint32_t box[2] = {64, 64};
    if (!hopper::make_map(&mw, w, 2, w_dims, w_strides, box, 128))
      return cudaErrorInvalidValue;
  }
  if (LOADER == kTma) {
    const uint64_t hw = HW;
    const uint64_t x_dims[3] = {hw, (uint64_t)Ci, (uint64_t)B};
    const uint64_t x_strides[2] = {2 * hw, 2 * hw * Ci};
    const uint64_t dy_dims[3] = {hw, (uint64_t)Co, (uint64_t)B};
    const uint64_t dy_strides[2] = {2 * hw, 2 * hw * Co};
    const uint64_t w_dims[2] = {(uint64_t)Ci, (uint64_t)Co};
    const uint64_t w_strides[1] = {2 * (uint64_t)Ci};
    const uint32_t box[3] = {64, 64, 1};
    if (!hopper::make_map(&mx, x, 3, x_dims, x_strides, box, 128) ||
        !hopper::make_map(&mdy, dy, 3, dy_dims, dy_strides, box, 128) ||
        !hopper::make_map(&mw, w, 2, w_dims, w_strides, box, 128))
      return cudaErrorInvalidValue;
  }
  auto kernel = conv1x1_bwd_bf16_kernel<CI_T, CO_T, LOADER>;
  const int bytes = LOADER == kBulk ? TT::BULK_BYTES : TT::BYTES;
  static_assert(TT::BULK_BYTES <= 227 * 1024, "kBulk exceeds shared memory");
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const long long J = (long long)B * HW;
  const long long pos_tiles =
      LOADER == kTma    ? (long long)B * ((HW + kDxBN - 1) / kDxBN)
      : LOADER == kBulk ? (B + kDxBN / HW - 1) / (kDxBN / HW)
                        : (J + kDxBN - 1) / kDxBN;
  const long long n_dx = ((Ci + CI_T - 1) / CI_T) * pos_tiles;
  const long long n_dw = (long long)((Co + CO_T - 1) / CO_T) *
                         ((Ci + CI_T - 1) / CI_T) * splits;
  if (n_dx + n_dw > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)(n_dx + n_dw), kThreads, bytes, stream>>>(
      mx, mw, mdy, static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
      static_cast<bf16*>(dw), partial, tickets, B, Ci, Co, HW, splits, chunk,
      group, order, (int)n_dx, (int)n_dw);
  return cudaGetLastError();
}

template <int LOADER>
cudaError_t pick_bf16(int ci_tile, int co_tile, const void* x, const void* w,
                      const void* dy, void* dx, void* dw, float* p, int* tk,
                      int B, int Ci, int Co, int HW, int splits, int chunk,
                      int group, int order, cudaStream_t s) {
  if (ci_tile == 64 && co_tile == 64)
    return launch_bf16<64, 64, LOADER>(x, w, dy, dx, dw, p, tk, B, Ci, Co,
                                       HW, splits, chunk, group, order, s);
  if (ci_tile == 64)
    return launch_bf16<64, 128, LOADER>(x, w, dy, dx, dw, p, tk, B, Ci, Co,
                                        HW, splits, chunk, group, order, s);
  if (co_tile == 64)
    return launch_bf16<128, 64, LOADER>(x, w, dy, dx, dw, p, tk, B, Ci, Co,
                                        HW, splits, chunk, group, order, s);
  return launch_bf16<128, 128, LOADER>(x, w, dy, dx, dw, p, tk, B, Ci, Co,
                                       HW, splits, chunk, group, order, s);
}


}  // namespace

// x [B, Ci, HW], w [Co, Ci], dy [B, Co, HW], dx [B, Ci, HW], dw [Co, Ci]:
// contiguous float32. The plan: ci_tile (64 or 128) channels of Ci a dx
// block (beside 128 positions) and a dw block, co_tile (64 or 128)
// channels of Co a dw block; dw's depth B*HW cut into `splits` chunks of
// `chunk` positions (a multiple of 32; splits * chunk >= B*HW, every
// chunk non-empty), summed in groups of `group`; order: the roles
// interleaved in block order (0), the dx blocks first (1) or the dw
// blocks first (2); vec = 1 stages with 16-byte copies, which needs HW
// and Ci multiples of 4 and 16-byte aligned x, w and dy. With splits > 1,
// partial is [splits, Co, Ci] float32 scratch and tickets (ceil(splits /
// group) + 1) ints per dw tile, zeroed by the caller; with splits == 1
// neither is read.
extern "C" int conv1x1_bwd(const void* x, const void* w, const void* dy,
                           void* dx, void* dw, void* partial, void* tickets,
                           int B, int Ci, int Co, int HW, int splits,
                           int chunk, int group, int order, int ci_tile,
                           int co_tile, int vec, void* stream) {
  const long long J = (long long)B * HW;
  const bool aligned =
      (((uintptr_t)x | (uintptr_t)w | (uintptr_t)dy) & 15) == 0;
  if (B <= 0 || Ci <= 0 || Co <= 0 || HW <= 0 || splits < 1 || chunk < 1 ||
      chunk % BK != 0 || group < 1 || order < kInterleave ||
      order > kDwFirst || J + kDxBN > 0x7fffffffLL ||
      (long long)splits * chunk < J ||
      (long long)(splits - 1) * chunk >= J || !tile_ok(ci_tile) ||
      !tile_ok(co_tile) || (vec && (HW % 4 != 0 || Ci % 4 != 0 || !aligned)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  int* tk = static_cast<int*>(tickets);
  return (int)(vec ? pick<float, 4>(ci_tile, co_tile, x, w, dy, dx, dw, p,
                                    tk, B, Ci, Co, HW, splits, chunk, group,
                                    order, s)
                   : pick<float, 1>(ci_tile, co_tile, x, w, dy, dx, dw, p,
                                    tk, B, Ci, Co, HW, splits, chunk, group,
                                    order, s));
}

// The same in bfloat16 (x, w, dy, dx, dw raw 16-bit words; partial
// float32). loader: 0 TMA (HW and Ci multiples of 8, x, w and dy
// 16-byte aligned), 1 8-byte cp.async copies (HW and Ci multiples of 4,
// 8-byte aligned), 2 through registers (any shape), 3 bulk copies of
// whole images (HW <= 64, Ci and Co multiples of 8, 16-byte aligned).
// The depth is B * hw_pad positions, hw_pad = HW rounded up to a multiple
// of 64 with TMA and bulk copies (each image's positions in whole stages)
// and HW otherwise; `chunk`
// counts positions of that depth, a multiple of 64 (splits * chunk >=
// the depth, every chunk non-empty).
extern "C" int conv1x1_bwd_bf16(const void* x, const void* w, const void* dy,
                                void* dx, void* dw, void* partial,
                                void* tickets, int B, int Ci, int Co, int HW,
                                int splits, int chunk, int group, int order,
                                int ci_tile, int co_tile, int loader,
                                void* stream) {
  const uintptr_t addr = (uintptr_t)x | (uintptr_t)w | (uintptr_t)dy;
  const bool rows_ok =
      loader == kTma ? HW % 8 == 0 && Ci % 8 == 0 && (addr & 15) == 0
      : loader == kCpAsync ? HW % 4 == 0 && Ci % 4 == 0 && (addr & 7) == 0
      : loader == kBulk
          ? HW <= kBK && Ci % 8 == 0 && Co % 8 == 0 && (addr & 15) == 0
          : loader == kRegisters;
  const long long hw_pad = loader == kTma || loader == kBulk
                               ? (HW + kBK - 1) / kBK * (long long)kBK
                               : HW;
  const long long depth = B * hw_pad;
  if (B <= 0 || Ci <= 0 || Co <= 0 || HW <= 0 || !rows_ok || splits < 1 ||
      chunk < 1 || chunk % kBK != 0 || group < 1 || order < kInterleave ||
      order > kDwFirst || depth + 2 * kDxBN > 0x7fffffffLL ||
      (long long)splits * chunk < depth ||
      (long long)(splits - 1) * chunk >= depth || !tile_ok(ci_tile) ||
      !tile_ok(co_tile))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  int* tk = static_cast<int*>(tickets);
  if (loader == kTma)
    return (int)pick_bf16<kTma>(ci_tile, co_tile, x, w, dy, dx, dw, p, tk, B,
                                Ci, Co, HW, splits, chunk, group, order, s);
  if (loader == kBulk)
    return (int)pick_bf16<kBulk>(ci_tile, co_tile, x, w, dy, dx, dw, p, tk, B,
                                 Ci, Co, HW, splits, chunk, group, order, s);
  if (loader == kCpAsync)
    return (int)pick_bf16<kCpAsync>(ci_tile, co_tile, x, w, dy, dx, dw, p, tk,
                                    B, Ci, Co, HW, splits, chunk, group,
                                    order, s);
  return (int)pick_bf16<kRegisters>(ci_tile, co_tile, x, w, dy, dx, dw, p,
                                    tk, B, Ci, Co, HW, splits, chunk, group,
                                    order, s);
}
