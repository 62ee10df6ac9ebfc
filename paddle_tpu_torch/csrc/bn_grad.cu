// Training-mode batch-norm backward for Hopper (sm_90a) over a
// channels-minor activation (B7).
//
// Built by paddle_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes: the entry point below is `extern "C"`, takes raw
// device pointers and a stream, launches on that stream without
// synchronising, allocates nothing, and returns the cudaError_t of its
// launches (0 on success).
//
// Replaces paddle_tpu/kernels/bn_grad.py `_kernel` (the pallas_call in
// `bn_grad`). Over x, dy viewed as [M, C] (M = N*H*W rows, channels
// minor), float32 or bfloat16, with scale [C] float32:
//   mean  = sum(x) / M          var = max(sum(x^2) / M - mean^2, 0)
//   inv   = rsqrt(var + eps)    xhat = (x - mean) inv
//   dbias = sum(dy)             dscale = (sum(dy x) - mean sum(dy)) inv
//   dx    = (scale inv) / M * (M dy - dbias - xhat dscale)
// dx is written in x's type; dscale and dbias are float32; the four sums
// are always taken in float32.
//
// Bound on the H100: bytes. The sums must be complete before the first
// dx, so x and dy are read twice and dx written once: five passes over
// M*C elements (1.03 GB at the ResNet-50 stem, [64,112,112,64] float32,
// ~307 us at 3.35 TB/s) against ~12 floating-point operations an element.
//
// Design. The TPU kernel is a sequential (2, tiles) grid that carries the
// four sums in scratch memory from one grid step to the next; blocks on a
// GPU run in no order, so this is three kernels on one stream instead:
//
// 1. bn_partial: threads run along C (a float4, or four bfloat16, each:
//    neighbouring threads on neighbouring addresses), and a block of
//    TX x TY threads owns TX column groups and walks rows
//    blockIdx.y*TY + ty, stepping by gridDim.y*TY, two rows in flight. Its
//    TY row lanes are added through shared memory in a fixed order and the
//    block writes one row of partial [row_blocks, 4, C].
//    C is 64 at the stem, where M is 802816, and 2048 at stage 4, where M
//    is 3136: TX is 16 for C <= 64 and 32 above, and the wrapper picks the
//    number of row blocks so that the grid holds about eight blocks an SM
//    at either end.
// 2. bn_finalize: one block per 32 channels adds the partial rows, 32
//    lanes each taking every 32nd row in order and the lanes then added
//    in order, and writes dscale, dbias and the per-channel coefficients
//    (mean, inv, dbias, dscale, scale inv / M) of dx.
// 3. bn_dx: the same thread layout as (1); each thread keeps its
//    channels' coefficients in registers and streams x, dy -> dx.
//
// No float atomics anywhere: every sum has one owner and a fixed order,
// so the result does not change from run to run. Any M is taken (the row
// loops mask their tail); channels that do not fill a vector (C % 4 != 0)
// or unaligned pointers take the scalar instantiation (VEC = 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFinalizeLanes = 32;

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]);

template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* p,
                                                   float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

template <>
__device__ __forceinline__ void load_vec<float, 1>(const float* p,
                                                   float (&v)[1]) {
  v[0] = *p;
}

template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 4>(
    const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __bfloat162float(a.x); v[1] = __bfloat162float(a.y);
  v[2] = __bfloat162float(b.x); v[3] = __bfloat162float(b.y);
}

template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 1>(
    const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(*p);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]);

template <>
__device__ __forceinline__ void store_vec<float, 4>(float* p,
                                                    const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <>
__device__ __forceinline__ void store_vec<float, 1>(float* p,
                                                    const float (&v)[1]) {
  *p = v[0];
}

template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 4>(
    __nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<uint32_t*>(&a);
  t.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 1>(
    __nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16(v[0]);
}

// ---------------------------------------------------------------------
// 1. per-block partial sums: partial[blockIdx.y][q][c], q = sum x,
//    sum x^2, sum dy, sum dy x
// ---------------------------------------------------------------------
template <typename T, int VEC, int TX>
__global__ void __launch_bounds__(kThreads)
bn_partial(const T* __restrict__ x, const T* __restrict__ dy,
           float* __restrict__ partial, int M, int C) {
  constexpr int TY = kThreads / TX;
  __shared__ float red[4 * VEC][TY][TX + 1];
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int cg = blockIdx.x * TX + tx;          // column group
  const int c0 = cg * VEC;
  const bool live = c0 < C;
  float acc[4][VEC];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[q][v] = 0.f;

  const int stride = gridDim.y * TY;
  if (live) {
    int r = blockIdx.y * TY + ty;
    // two rows in flight: four independent vector loads a trip
    for (; r + stride < M; r += 2 * stride) {
      float xa[VEC], da[VEC], xb[VEC], db[VEC];
      const size_t oa = (size_t)r * C + c0;
      const size_t ob = (size_t)(r + stride) * C + c0;
      load_vec<T, VEC>(x + oa, xa);
      load_vec<T, VEC>(dy + oa, da);
      load_vec<T, VEC>(x + ob, xb);
      load_vec<T, VEC>(dy + ob, db);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        acc[0][v] += xa[v];
        acc[1][v] += xa[v] * xa[v];
        acc[2][v] += da[v];
        acc[3][v] += da[v] * xa[v];
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        acc[0][v] += xb[v];
        acc[1][v] += xb[v] * xb[v];
        acc[2][v] += db[v];
        acc[3][v] += db[v] * xb[v];
      }
    }
    if (r < M) {
      float xa[VEC], da[VEC];
      const size_t oa = (size_t)r * C + c0;
      load_vec<T, VEC>(x + oa, xa);
      load_vec<T, VEC>(dy + oa, da);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        acc[0][v] += xa[v];
        acc[1][v] += xa[v] * xa[v];
        acc[2][v] += da[v];
        acc[3][v] += da[v] * xa[v];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int v = 0; v < VEC; ++v) red[q * VEC + v][ty][tx] = acc[q][v];
  __syncthreads();
  // the block's TY row lanes, added in lane order by 4*VEC*TX threads
  for (int i = threadIdx.x; i < 4 * VEC * TX; i += kThreads) {
    const int qv = i / TX, t = i % TX;
    const int c = (blockIdx.x * TX + t) * VEC + qv % VEC;
    if (c < C) {
      float s = 0.f;
#pragma unroll 4
      for (int l = 0; l < TY; ++l) s += red[qv][l][t];
      partial[((size_t)blockIdx.y * 4 + qv / VEC) * C + c] = s;
    }
  }
}

// ---------------------------------------------------------------------
// 2. add the partial rows in a fixed order; per-channel results
//    coef[5][C] = mean, inv, dbias, dscale, scale * inv / M
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(32 * kFinalizeLanes)
bn_finalize(const float* __restrict__ partial, const float* __restrict__ scale,
            float* __restrict__ dscale, float* __restrict__ dbias,
            float* __restrict__ coef, int M, int C, int row_blocks,
            float eps) {
  __shared__ float red[4][kFinalizeLanes][33];
  const int tx = threadIdx.x % 32;
  const int lane = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + tx;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (c < C) {
    for (int b = lane; b < row_blocks; b += kFinalizeLanes) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[q] += partial[((size_t)b * 4 + q) * C + c];
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) red[q][lane][tx] = acc[q];
  __syncthreads();
  if (lane == 0 && c < C) {
    float s[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float t = 0.f;
      for (int l = 0; l < kFinalizeLanes; ++l) t += red[q][l][tx];
      s[q] = t;
    }
    const float n = (float)M;
    const float mean = s[0] / n;
    const float var = fmaxf(s[1] / n - mean * mean, 0.f);
    const float inv = rsqrtf(var + eps);
    const float db = s[2];
    const float ds = (s[3] - mean * s[2]) * inv;
    dbias[c] = db;
    dscale[c] = ds;
    coef[c] = mean;
    coef[C + c] = inv;
    coef[2 * C + c] = db;
    coef[3 * C + c] = ds;
    coef[4 * C + c] = scale[c] * inv / n;
  }
}

// ---------------------------------------------------------------------
// 3. dx = k (M dy - dbias - xhat dscale), k = scale inv / M
// ---------------------------------------------------------------------
template <typename T, int VEC, int TX>
__global__ void __launch_bounds__(kThreads)
bn_dx(const T* __restrict__ x, const T* __restrict__ dy,
      const float* __restrict__ coef, T* __restrict__ dx, int M, int C) {
  constexpr int TY = kThreads / TX;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int c0 = (blockIdx.x * TX + tx) * VEC;
  if (c0 >= C) return;
  float mean[VEC], inv[VEC], db[VEC], ds[VEC], k[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    mean[v] = coef[c0 + v];
    inv[v] = coef[C + c0 + v];
    db[v] = coef[2 * C + c0 + v];
    ds[v] = coef[3 * C + c0 + v];
    k[v] = coef[4 * C + c0 + v];
  }
  const float n = (float)M;
  const int stride = gridDim.y * TY;
  int r = blockIdx.y * TY + ty;
  for (; r + stride < M; r += 2 * stride) {
    float xa[VEC], da[VEC], xb[VEC], dbv[VEC], oa[VEC], ob[VEC];
    const size_t pa = (size_t)r * C + c0;
    const size_t pb = (size_t)(r + stride) * C + c0;
    load_vec<T, VEC>(x + pa, xa);
    load_vec<T, VEC>(dy + pa, da);
    load_vec<T, VEC>(x + pb, xb);
    load_vec<T, VEC>(dy + pb, dbv);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      oa[v] = k[v] * (n * da[v] - db[v] - (xa[v] - mean[v]) * inv[v] * ds[v]);
      ob[v] = k[v] * (n * dbv[v] - db[v] - (xb[v] - mean[v]) * inv[v] * ds[v]);
    }
    store_vec<T, VEC>(dx + pa, oa);
    store_vec<T, VEC>(dx + pb, ob);
  }
  if (r < M) {
    float xa[VEC], da[VEC], oa[VEC];
    const size_t pa = (size_t)r * C + c0;
    load_vec<T, VEC>(x + pa, xa);
    load_vec<T, VEC>(dy + pa, da);
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      oa[v] = k[v] * (n * da[v] - db[v] - (xa[v] - mean[v]) * inv[v] * ds[v]);
    store_vec<T, VEC>(dx + pa, oa);
  }
}

template <typename T, int VEC, int TX>
cudaError_t launch(const void* x, const void* dy, const float* scale,
                   void* dx, float* dscale, float* dbias, float* partial,
                   float* coef, int M, int C, float eps, int row_blocks,
                   cudaStream_t stream) {
  const int groups = (C + VEC - 1) / VEC;
  const dim3 grid((groups + TX - 1) / TX, row_blocks);
  bn_partial<T, VEC, TX><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), partial, M, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bn_finalize<<<(C + 31) / 32, 32 * kFinalizeLanes, 0, stream>>>(
      partial, scale, dscale, dbias, coef, M, C, row_blocks, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bn_dx<T, VEC, TX><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), coef,
      static_cast<T*>(dx), M, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dy, const float* scale,
                     void* dx, float* dscale, float* dbias, float* partial,
                     float* coef, int M, int C, float eps, int vec,
                     int row_blocks, cudaStream_t stream) {
  if (vec == 4) {
    if (C <= 64)
      return launch<T, 4, 16>(x, dy, scale, dx, dscale, dbias, partial, coef,
                              M, C, eps, row_blocks, stream);
    return launch<T, 4, 32>(x, dy, scale, dx, dscale, dbias, partial, coef, M,
                            C, eps, row_blocks, stream);
  }
  return launch<T, 1, 32>(x, dy, scale, dx, dscale, dbias, partial, coef, M,
                          C, eps, row_blocks, stream);
}

}  // namespace

// x, dy, dx: [M, C] contiguous, float32 (is_bf16 = 0) or bfloat16 (1).
// scale, dscale, dbias: [C] float32. partial: [row_blocks, 4, C] and
// coef: [5, C] float32 scratch. vec is 4 (C % 4 == 0 and x, dy, dx
// aligned to four elements) or 1. row_blocks in [1, 65535].
extern "C" int bn_grad(const void* x, const void* dy, const void* scale,
                       void* dx, void* dscale, void* dbias, void* partial,
                       void* coef, int M, int C, float eps, int is_bf16,
                       int vec, int row_blocks, void* stream) {
  if (M <= 0 || C <= 0 || row_blocks < 1 || row_blocks > 65535 ||
      (vec != 1 && vec != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (is_bf16)
    e = dispatch<__nv_bfloat16>(
        x, dy, static_cast<const float*>(scale), dx,
        static_cast<float*>(dscale), static_cast<float*>(dbias),
        static_cast<float*>(partial), static_cast<float*>(coef), M, C, eps,
        vec, row_blocks, s);
  else
    e = dispatch<float>(
        x, dy, static_cast<const float*>(scale), dx,
        static_cast<float*>(dscale), static_cast<float*>(dbias),
        static_cast<float*>(partial), static_cast<float*>(coef), M, C, eps,
        vec, row_blocks, s);
  return (int)e;
}
