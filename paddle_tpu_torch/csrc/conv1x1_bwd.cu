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
// Bound on the H100: 4 B HW Ci Co floating-point operations at the
// float32 FMA rate (67 TFLOP/s; TF32 stays off) against the bytes of x,
// dy, dx, w and dw once each. At the ResNet-50 path's shapes the
// operations bound it except at Ci = Co = 64.
//
// Design. The TPU kernel walks the images one after another, keeps one
// image's dy block and ALL of dw resident in fast memory, and forms both
// products from the one dy block. Neither fits a GPU block: dw reaches
// 2048 x 512 floats (4 MB) and a dy column tile over all Co 512 KB,
// against 227 KB of shared memory. And the two products want different
// grids: dx parallelises over positions and reduces over Co, dw
// parallelises over (Co, Ci) and reduces over every image and position.
// So one grid holds both roles, as plain 64 x 64 x 16 register-tiled
// float32 FMA products (256 threads, a 4 x 4 tile each, operands staged
// through shared memory), with images and positions flattened into one
// index j = b HW + p so that HW = 49 wastes no tile:
//
//   dx role  C[ci, j]  = sum_co w[co, ci] dy[j, co]    M = Ci, N = B HW,
//            K = Co; one block per (ci tile, j tile).
//   dw role  C[co, ci] = sum_j dy[j, co] x[j, ci]      M = Co, N = Ci,
//            K = B HW, cut into `splits` chunks so that the role has
//            enough blocks when Co Ci is small (64 x 64 is one tile);
//            one block per (chunk, co tile, ci tile).
//
// Sharing dy: the two roles are interleaved in block order, both sweeping
// j upwards at the same relative pace, so a dy column block that a dx
// block pulls from device memory is, in most cases, still in the 50 MB L2
// when the dw block of the same j chunk asks for it (and the other way
// round). The re-reads inside a role (Ci/64 dx tiles and Ci/64 dw tiles
// read the same dy block) are served the same way. It is a first
// version: nothing forces the sharing, PERF.md holds the measured times.
//
// dw is a sum across blocks. No float atomics: with splits > 1 each dw
// block owns its tile of partial [splits, Co, Ci], and the block that
// finishes a tile last (an integer ticket per tile, after a
// __threadfence) adds the `splits` partial tiles in chunk order and
// writes dw. The sum's order is fixed, so the result does not change from
// run to run. With splits == 1 the block writes dw itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64, TN = 64, TK = 16;
constexpr int kThreads = 256;
constexpr int LD = TM + 4;   // padded, and a multiple of 4 for float4 reads

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// one k-step of the 64 x 64 tile:
//   acc[i][j] += As[k][ty*4 + i] * Bs[k][tx + 16*j]
// Columns are dealt out 16 apart so that the 16 threads of a row write 16
// neighbouring output addresses (columns run along memory in dx and dw).
__device__ __forceinline__ void tile_fma(const float (*As)[LD],
                                         const float (*Bs)[LD], int ty,
                                         int tx, float (&acc)[4][4]) {
#pragma unroll
  for (int k = 0; k < TK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {Bs[k][tx], Bs[k][tx + 16], Bs[k][tx + 32],
                         Bs[k][tx + 48]};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv1x1_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   T* __restrict__ dw, float* __restrict__ partial,
                   int* __restrict__ tickets, int B, int Ci, int Co, int HW,
                   int splits, int chunk, int n_dx, int n_dw) {
  __shared__ __align__(16) float As[TK][LD];
  __shared__ __align__(16) float Bs[TK][LD];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int J = B * HW;                      // the entry point bounds it
  const int ci_tiles = (Ci + TN - 1) / TN;   // 64-wide tiles over Ci
  const int co_tiles = (Co + TM - 1) / TM;

  // interleave the roles in block order (see the header)
  const long long L = blockIdx.x, total = (long long)n_dx + n_dw;
  const int dw_before = (int)(L * n_dw / total);
  const bool is_dw = (int)((L + 1) * n_dw / total) > dw_before;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (!is_dw) {
    // ---- dx role: rows m = ci, columns n = j, depth k = co ----
    const int idx = (int)L - dw_before;
    const int m0 = (idx % ci_tiles) * TM;
    const int n0 = (idx / ci_tiles) * TN;
    // this thread's load slots: column m of rows k = tid/64 + 4 i of each
    // 16 x 64 operand tile (neighbouring threads, neighbouring addresses)
    const int m = tid % TM, kk = tid / TM;
    const int ci = m0 + m, jl = n0 + m;
    const bool j_ok = jl < J;
    const int bl = j_ok ? jl / HW : 0, pl = j_ok ? jl - bl * HW : 0;
    const T* dy_col = dy + (size_t)bl * Co * HW + pl;
    for (int k0 = 0; k0 < Co; k0 += TK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = kk + 4 * i;
        const int co = k0 + k;
        As[k][m] = (co < Co && ci < Ci)
                       ? to_f(w[(size_t)co * Ci + ci]) : 0.f;
        Bs[k][m] = (co < Co && j_ok) ? to_f(dy_col[(size_t)co * HW]) : 0.f;
      }
      __syncthreads();
      tile_fma(As, Bs, ty, tx, acc);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = n0 + tx + 16 * j;
      if (jj >= J) continue;
      const int b = jj / HW, p = jj - b * HW;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = m0 + ty * 4 + i;
        if (c < Ci) from_f(&dx[((size_t)b * Ci + c) * HW + p], acc[i][j]);
      }
    }
    return;
  }

  // ---- dw role: rows m = co, columns n = ci, depth k = j in a chunk ----
  const int tiles = co_tiles * ci_tiles;
  const int split = dw_before / tiles;
  const int tile = dw_before % tiles;
  const int m0 = (tile / ci_tiles) * TM;
  const int n0 = (tile % ci_tiles) * TN;
  const int j_begin = split * chunk;
  const int j_end = min(j_begin + chunk, J);
  // depth runs along memory here: 16 neighbouring threads read 16
  // neighbouring positions of one channel. This thread loads depth
  // k = tid % 16 of channels tid/16 + 16 i; its position (b, p) steps by
  // 16 a trip.
  const int k = tid % TK, mm = tid / TK;
  int b = (j_begin + k) / HW, p = (j_begin + k) - b * HW;
  for (int k0 = j_begin; k0 < j_end; k0 += TK) {
    const bool ok = k0 + k < j_end;
    const size_t img = (size_t)b * HW;   // times the channel count below
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = mm + 16 * i;
      const int co = m0 + m, ci = n0 + m;
      As[k][m] = (ok && co < Co)
                     ? to_f(dy[(img * Co + (size_t)co * HW) + p]) : 0.f;
      Bs[k][m] = (ok && ci < Ci)
                     ? to_f(x[(img * Ci + (size_t)ci * HW) + p]) : 0.f;
    }
    p += TK;
    while (p >= HW) { p -= HW; ++b; }
    __syncthreads();
    tile_fma(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int co = m0 + ty * 4 + i;
      if (co >= Co) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ci = n0 + tx + 16 * j;
        if (ci < Ci) from_f(&dw[(size_t)co * Ci + ci], acc[i][j]);
      }
    }
    return;
  }

  // this block's tile of partial[split]
  float* mine = partial + (size_t)split * Co * Ci;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = m0 + ty * 4 + i;
    if (co >= Co) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = n0 + tx + 16 * j;
      if (ci < Ci) __stcg(&mine[(size_t)co * Ci + ci], acc[i][j]);
    }
  }
  // the last block to finish this tile adds the partial tiles in chunk
  // order
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&tickets[tile], 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = m0 + ty * 4 + i;
    if (co >= Co) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = n0 + tx + 16 * j;
      if (ci >= Ci) continue;
      const size_t o = (size_t)co * Ci + ci;
      float s = 0.f;
      for (int sp = 0; sp < splits; ++sp)
        s += __ldcg(&partial[(size_t)sp * Co * Ci + o]);
      from_f(&dw[o], s);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* dy, void* dx,
                   void* dw, float* partial, int* tickets, int B, int Ci,
                   int Co, int HW, int splits, int chunk,
                   cudaStream_t stream) {
  const long long J = (long long)B * HW;
  const long long ci_tiles = (Ci + TN - 1) / TN;
  const long long co_tiles = (Co + TM - 1) / TM;
  const long long n_dx = ci_tiles * ((J + TN - 1) / TN);
  const long long n_dw = co_tiles * ci_tiles * splits;
  if (n_dx + n_dw > 0x7fffffffLL) return cudaErrorInvalidValue;
  conv1x1_bwd_kernel<T><<<(unsigned)(n_dx + n_dw), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(dy), static_cast<T*>(dx), static_cast<T*>(dw),
      partial, tickets, B, Ci, Co, HW, splits, chunk, (int)n_dx, (int)n_dw);
  return cudaGetLastError();
}

}  // namespace

// x [B, Ci, HW], w [Co, Ci], dy [B, Co, HW], dx [B, Ci, HW], dw [Co, Ci]:
// contiguous, all float32 (is_bf16 = 0) or all bfloat16 (1). The depth
// B*HW of dw is cut into `splits` chunks of `chunk` positions (a multiple
// of 16; splits * chunk >= B*HW, and every chunk non-empty). With
// splits > 1, partial is [splits, Co, Ci] float32 scratch and tickets is
// one int per 64 x 64 tile of dw, zeroed by the caller; with splits == 1
// neither is read.
extern "C" int conv1x1_bwd(const void* x, const void* w, const void* dy,
                           void* dx, void* dw, void* partial, void* tickets,
                           int B, int Ci, int Co, int HW, int splits,
                           int chunk, int is_bf16, void* stream) {
  const long long J = (long long)B * HW;
  if (B <= 0 || Ci <= 0 || Co <= 0 || HW <= 0 || splits < 1 || chunk < 1 ||
      chunk % TK != 0 || J + TN > 0x7fffffffLL ||
      (long long)splits * chunk < J ||
      (long long)(splits - 1) * chunk >= J)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (is_bf16)
    e = launch<__nv_bfloat16>(x, w, dy, dx, dw, static_cast<float*>(partial),
                              static_cast<int*>(tickets), B, Ci, Co, HW,
                              splits, chunk, s);
  else
    e = launch<float>(x, w, dy, dx, dw, static_cast<float*>(partial),
                      static_cast<int*>(tickets), B, Ci, Co, HW, splits,
                      chunk, s);
  return (int)e;
}
