// Fused dx + dw backward of a 1x1, stride-1, NCHW convolution for Hopper
// (sm_90a) (B8).
//
// Built by paddle_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes: the entry point below is `extern "C"`, takes raw
// device pointers and a stream, launches on that stream without
// synchronising, allocates nothing, and returns the cudaError_t of the
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
// bfloat16 values are exact in TF32, so the bfloat16 kernel does the one
// big*big product.
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
// odd test shapes; bfloat16 rows there start on 2-byte boundaries,
// below cp.async's grain, and go through registers). Rows are padded so
// that the fragment loads hit 32 banks.
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

#include "tf32x3.cuh"

namespace {

using tf32x3::cp16;
using tf32x3::cp4;
using tf32x3::cp_commit;
using tf32x3::cp_wait;
using tf32x3::mma;
using tf32x3::smem_u32;

constexpr int kThreads = 256;
constexpr int kWarpsM = 2, kWarpsN = 4;
constexpr int BK = 32;       // depth of one stage
constexpr int kStages = 4;
constexpr int kDxBN = 128;   // positions per dx block
// block orders of the two roles (the plan's `order`)
constexpr int kInterleave = 0, kDxFirst = 1, kDwFirst = 2;

template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int kVec = 4;     // elements in 16 bytes
  static constexpr int kPadK = 4;    // 36-float rows: banks 4g + t
  static constexpr bool kSplit = true;
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr int kPadK = 8;    // rows stay 16-byte aligned
  static constexpr bool kSplit = false;
};
constexpr int kPadMN = 8;            // BM + 8 floats: banks 8t + g

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// one element
__device__ __forceinline__ void cp1(float* dst, const float* src, bool ok) {
  cp4(dst, src, ok);
}
// bfloat16 rows may start on 2-byte boundaries, below cp.async's grain
__device__ __forceinline__ void cp1(__nv_bfloat16* dst,
                                    const __nv_bfloat16* src, bool ok) {
  *dst = ok ? *src : __float2bfloat16(0.f);
}

// the 3xTF32 split (tf32x3.cuh) of a float32 operand; a bfloat16 value is
// exact in TF32 and needs no small part
template <bool SPLIT>
__device__ __forceinline__ void split(float v, unsigned& big,
                                      unsigned& small) {
  if (SPLIT) {
    tf32x3::split(v, big, small);
  } else {
    big = __float_as_uint(v);
    small = 0u;
  }
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

// V elements: one 16-byte copy (V = Elem<T>::kVec) or one element
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
  constexpr bool SPLIT = Elem<T>::kSplit;
  // float32 K-major tiles (dw) load their fragments with ldmatrix
  constexpr bool LDSM = S::KMAJ && sizeof(T) == 4;
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
          split<SPLIT>(__uint_as_float(v[i]), ab[mt][i], as[mt][i]);
      }
#pragma unroll
      for (int nt = 0; nt < S::NT; nt += 2) {
        unsigned v[4];
        ldsm4(v, f + S::A_ELEMS + (wn0 + nt * 8 + r8 + 8 * (q >> 1)) * S::LDB +
                     kk + 4 * (q & 1));
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split<SPLIT>(__uint_as_float(v[i]), bb[nt + (i >> 1)][i & 1],
                       bs[nt + (i >> 1)][i & 1]);
      }
    } else {
#pragma unroll
      for (int mt = 0; mt < S::MT; ++mt) {
        const int m = wm0 + mt * 16 + g;
        split<SPLIT>(S::a(s, m, kk + t), ab[mt][0], as[mt][0]);
        split<SPLIT>(S::a(s, m + 8, kk + t), ab[mt][1], as[mt][1]);
        split<SPLIT>(S::a(s, m, kk + t + 4), ab[mt][2], as[mt][2]);
        split<SPLIT>(S::a(s, m + 8, kk + t + 4), ab[mt][3], as[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt) {
        const int n = wn0 + nt * 8 + g;
        split<SPLIT>(S::b(s, kk + t, n), bb[nt][0], bs[nt][0]);
        split<SPLIT>(S::b(s, kk + t + 4, n), bb[nt][1], bs[nt][1]);
      }
    }
    if (SPLIT) {
#pragma unroll
      for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < S::NT; ++nt) mma(acc[mt][nt], as[mt], bb[nt]);
#pragma unroll
      for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < S::NT; ++nt) mma(acc[mt][nt], ab[mt], bs[nt]);
    }
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
// V: elements a copy, Elem<T>::kVec (16 bytes) or 1.
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

}  // namespace

// x [B, Ci, HW], w [Co, Ci], dy [B, Co, HW], dx [B, Ci, HW], dw [Co, Ci]:
// contiguous, all float32 (is_bf16 = 0) or all bfloat16 (1). The plan:
// ci_tile (64 or 128) channels of Ci a dx block (beside 128 positions)
// and a dw block, co_tile (64 or 128) channels of Co a dw block; dw's
// depth B*HW cut into `splits` chunks of `chunk` positions (a multiple
// of 32; splits * chunk >= B*HW, every chunk non-empty), summed in
// groups of `group`; order: the roles interleaved in block order (0),
// the dx blocks first (1) or the dw blocks first (2); vec = 1 stages
// with 16-byte copies, which needs HW
// and Ci multiples of 16 bytes' worth of elements and 16-byte aligned x,
// w and dy. With splits > 1, partial is [splits, Co, Ci] float32 scratch
// and tickets (ceil(splits / group) + 1) ints per dw tile, zeroed by the
// caller; with splits == 1 neither is read.
extern "C" int conv1x1_bwd(const void* x, const void* w, const void* dy,
                           void* dx, void* dw, void* partial, void* tickets,
                           int B, int Ci, int Co, int HW, int splits,
                           int chunk, int group, int order, int is_bf16,
                           int ci_tile, int co_tile, int vec,
                           void* stream) {
  const long long J = (long long)B * HW;
  const int V = is_bf16 ? 8 : 4;
  const bool aligned =
      (((uintptr_t)x | (uintptr_t)w | (uintptr_t)dy) & 15) == 0;
  if (B <= 0 || Ci <= 0 || Co <= 0 || HW <= 0 || splits < 1 || chunk < 1 ||
      chunk % BK != 0 || group < 1 || order < kInterleave ||
      order > kDwFirst || J + kDxBN > 0x7fffffffLL ||
      (long long)splits * chunk < J ||
      (long long)(splits - 1) * chunk >= J || !tile_ok(ci_tile) ||
      !tile_ok(co_tile) ||
      (vec && (HW % V != 0 || Ci % V != 0 || !aligned)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  int* tk = static_cast<int*>(tickets);
  cudaError_t e;
  if (is_bf16)
    e = vec ? pick<__nv_bfloat16, 8>(ci_tile, co_tile, x, w, dy, dx, dw, p,
                                     tk, B, Ci, Co, HW, splits, chunk, group,
                                     order, s)
            : pick<__nv_bfloat16, 1>(ci_tile, co_tile, x, w, dy, dx, dw, p,
                                     tk, B, Ci, Co, HW, splits, chunk, group,
                                     order, s);
  else
    e = vec ? pick<float, 4>(ci_tile, co_tile, x, w, dy, dx, dw, p, tk, B,
                             Ci, Co, HW, splits, chunk, group, order, s)
            : pick<float, 1>(ci_tile, co_tile, x, w, dy, dx, dw, p, tk, B,
                             Ci, Co, HW, splits, chunk, group, order, s);
  return (int)e;
}
