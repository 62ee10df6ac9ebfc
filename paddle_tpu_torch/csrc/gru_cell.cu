// Whole-sequence GRU for Hopper (sm_90a): the forward kernel and the
// reverse-time backward kernel behind the `gru` op.
//
// Built by paddle_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes: every entry point below is `extern "C"`, takes
// raw device pointers and a stream, launches on that stream without
// synchronising, allocates nothing, and returns the cudaError_t of the
// launch (0 on success).
//
// Layout is the JAX package's public one (the reference gru_op's),
// batch-major: xg [B, T, 3H] of pre-projected gate inputs (bias added),
// columns [u | r | c~] in blocks of H; W [H, 3H] = [w_ur | w_c]; h0
// [B, H]; mask [B, T] (1 = valid step, 0 = a finished row, which carries
// h through unchanged and gets no gate gradient). Everything is float32
// and contiguous.
//
// ---------------------------------------------------------------------
// gru_fwd  (B5)
//   Replaces paddle_tpu/kernels/gru_cell.py `_fwd_kernel` (the
//   pallas_call in `_fwd_pallas`): per step
//     u, r = sigmoid(xg_ur + h_{t-1} w_ur)
//     c    = tanh(xg_c + (r * h_{t-1}) w_c)
//     h_t  = u h_{t-1} + (1 - u) c        (a masked row keeps h_{t-1})
//   and writes hs [B, T, H] and the stash [B, T, 3H] of u, r, c that
//   gru_bwd reads.
//   Bound on the H100 at the seq2seq training path's shape (B=64, T=30,
//   H=512): 2*64*30*512*1536 = 3.02 GFLOP of recurrence, ~45 us at 67
//   TFLOP/s (fp32 FMA, TF32 off); it moves ~31 MB (xg 11.8 read, stash
//   11.8 and hs 3.9 written, W 3.1), ~9 us at 3.35 TB/s. Bound by
//   operations, and in practice by the serial chain of T steps, each of
//   two dependent products.
//   Design (persistent RNN, as csrc/lstm_cell.cu): the TPU kernel keeps
//   all of W in VMEM over a sequential grid over T. Here one cooperative
//   grid of ceil(H/4) blocks, all resident, walks T itself: block j owns
//   hidden units [4j, 4j+4) and keeps their 12 columns of W (H x 12
//   floats, 24 KB at H=512) in shared memory for the whole sequence.
//   The candidate product needs r of every unit of a row, so each step
//   has two phases and two grid barriers (cooperative_groups
//   this_grid().sync()):
//   A. copy h_{t-1} (unit-major [H, B rounded up to 64] in a global
//      buffer that stays in L2) into shared memory in tiles of 64 batch
//      rows, form the [64, 8] preactivations of the block's u and r
//      columns (4 x 4 register tiles over 8 slices of K = H, fp32 FMA,
//      the slices added through shared memory), then u and r of each
//      (row, unit); publish r h_{t-1} unit-major through L2.
//   B. copy r h_{t-1} of every unit the same way, form the [64, 4]
//      candidate preactivations (16 K-slices), then c and h_t; write
//      hs, the stash, and h_t unit-major for the next step's phase A.
//   2T + 1 barriers per call.
//
// gru_bwd  (B6)
//   Replaces paddle_tpu/kernels/gru_cell.py `_bwd_kernel` (the
//   pallas_call in `_bwd_pallas`): walks t downwards from the stash,
//   hs, h0, mask and dhs to dxg [B, T, 3H] = [da_u | da_r | da_c] (zero
//   on masked steps) and dh0 [B, H]:
//     dh     = dhs_t + dh carry
//     da_c   = m dh (1 - u)(1 - c^2)
//     drh    = da_c w_c^T
//     da_u   = m dh (h_{t-1} - c) u (1 - u)
//     da_r   = m drh h_{t-1} r (1 - r)
//     dh_{t-1} = (dh u + drh r) m + (1 - m) dh + [da_u | da_r] w_ur^T
//   dW is two GEMMs outside the kernel, as in the JAX package.
//   Bound at the path's shape: the same 3.02 GFLOP (the two products
//   per step), ~45 us; it moves ~35 MB, ~10 us. Bound by operations.
//   Design: block j owns units [4j, 4j+4) and keeps their ROWS of W
//   (3H x 4 floats, 24 KB at H=512), transposed k-major, in shared
//   memory. drh needs all of a row's da_c, and dh_{t-1} all of its
//   da_ur, so each step has two phases and two barriers:
//   A. (with the dh_{t-1} product of the step above, whose result this
//      same thread owns) form dh, da_c of each (row, unit) of the
//      block; write da_c to dxg and unit-major to a scratch in L2.
//   B. copy da_c of every unit into shared memory in 64-row tiles, form
//      drh [64, 4] of the block's units, then da_u, da_r and the masked
//      part of dh_{t-1}; write da_u, da_r to dxg and unit-major to
//      scratch.
//   After the last step, one more product forms dh0. 2T barriers.
//
// Reads of data that other blocks wrote in this launch go through L2
// (__ldcg), never a stale L1 line. Both entry points check that the
// grid can be resident at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// and return cudaErrorCooperativeLaunchTooLarge otherwise: H <= 528 on
// an H100 (132 SMs, one block of ~170 KB of shared memory each).
// ---------------------------------------------------------------------

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kU = 4;            // hidden units owned by one block
constexpr int kBT = 64;          // batch rows per tile
constexpr int kThreads = 256;    // = kBT * kU: one per (row, unit)
constexpr int kLoads = 8;        // 16-byte loads in flight per thread
constexpr int kRed = 4096;       // floats of the K-slice partials

static_assert(kThreads == kBT * kU, "one thread per (row, unit)");

__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
}

// acc[i][j] = sum over k = k0, k0 + dk, ... < K of a[k*lda + i] * b[k*ldb + j]
// (a 4x4 register tile of a product whose operands are stored k-major
// in shared memory; a and b 16-byte aligned)
__device__ __forceinline__ void mma4x4(float (&acc)[4][4], const float* a,
                                       int lda, const float* b, int ldb,
                                       int k0, int K, int dk) {
#pragma unroll 4
  for (int k = k0; k < K; k += dk) {
    const float4 av = *reinterpret_cast<const float4*>(a + (size_t)k * lda);
    const float4 bv = *reinterpret_cast<const float4*>(b + (size_t)k * ldb);
    const float ai[4] = {av.x, av.y, av.z, av.w};
    const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
  }
}

// Copy rows [b0, b0 + 64) of a unit-major global buffer src [K][Bp]
// (written by other blocks in this launch: read through L2) into
// dst [K][64] in shared memory. Bp is a multiple of 64.
__device__ __forceinline__ void stage(float* dst, const float* src, int b0,
                                      int K, int Bp) {
  constexpr int kRow4 = kBT / 4;
  const int n4 = K * kRow4;
  const float4* s = reinterpret_cast<const float4*>(src + b0);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int base = 0; base < n4; base += kThreads * kLoads) {
    float4 v[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int q = base + j * kThreads + threadIdx.x;
      if (q < n4) v[j] = __ldcg(s + (size_t)(q / kRow4) * (Bp / 4) + q % kRow4);
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int q = base + j * kThreads + threadIdx.x;
      if (q < n4) d[q] = v[j];
    }
  }
}

// The [64, NC] product of a staged tile a [K][64] and b [K][NC] (both
// k-major in shared memory), accumulated into acc: 4x4 register tiles
// over kK = 256 / (16 * NC / 4) K-slices. Call finish<NC>() after the
// last accumulation to sum the slices.
template <int NC>
struct TileProduct {
  static constexpr int kTiles = (kBT / 4) * (NC / 4);
  static constexpr int kK = kThreads / kTiles;
  static_assert(kK * kBT * NC == kRed, "partials fill the reduction buffer");
  int rq, cq, ks;
  float acc[4][4];

  __device__ __forceinline__ TileProduct() {
    const int q = threadIdx.x % kTiles;
    ks = threadIdx.x / kTiles;
    rq = q / (NC / 4);
    cq = q % (NC / 4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void add(const float* a, const float* b, int K) {
    mma4x4(acc, a + 4 * rq, kBT, b + 4 * cq, NC, ks, K, kK);
  }

  // write the partials to red [kK][64][NC]; after a __syncthreads,
  // sum(red, row, col) is the product's element
  __device__ __forceinline__ void store(float* red) const {
    float* r = red + ((size_t)ks * kBT + 4 * rq) * NC + 4 * cq;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(r + i * NC) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }

  static __device__ __forceinline__ float sum(const float* red, int row,
                                              int col) {
    float s = 0.f;
#pragma unroll
    for (int f = 0; f < kK; ++f) s += red[((size_t)f * kBT + row) * NC + col];
    return s;
  }
};

__global__ void __launch_bounds__(kThreads)
gru_fwd_kernel(const float* __restrict__ xg, const float* __restrict__ w,
               const float* __restrict__ h0, const float* __restrict__ mask,
               float* __restrict__ hs, float* __restrict__ stash,
               float* __restrict__ scratch, int B, int T, int H) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* wur = smem;                         // [H][8]: u cols, then r cols
  float* wc = wur + (size_t)H * 8;           // [H][4]
  float* tile = wc + (size_t)H * 4;          // [H][kBT]
  float* red = tile + (size_t)H * kBT;       // [kRed]
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * kU;
  const size_t G3 = 3 * (size_t)H;
  const int Bp = (B + kBT - 1) / kBT * kBT;
  // scratch [2][H][Bp]: h_{t-1}, then r h_{t-1}, unit-major; rows past B
  // stay zero
  float* hbuf = scratch;
  float* rhbuf = scratch + (size_t)H * Bp;

  for (int idx = tid; idx < H * 8; idx += kThreads) {
    const int k = idx / 8, c = idx % 8;
    const int u = u0 + c % kU;
    wur[idx] = u < H ? w[(size_t)k * G3 + (size_t)(c / kU) * H + u] : 0.f;
  }
  for (int idx = tid; idx < H * 4; idx += kThreads) {
    const int k = idx / 4, u = u0 + idx % 4;
    wc[idx] = u < H ? w[(size_t)k * G3 + 2 * (size_t)H + u] : 0.f;
  }
  for (int idx = tid; idx < B * kU; idx += kThreads) {
    const int b = idx / kU, u = u0 + idx % kU;
    if (u < H) hbuf[(size_t)u * Bp + b] = h0[(size_t)b * H + u];
  }

  // cell work: one thread per (row of the tile, unit)
  const int cb = tid / kU, cu = tid % kU;
  const int unit = u0 + cu;
  const bool unit_ok = unit < H;

  grid.sync();  // hbuf holds h0 of every unit

  for (int t = 0; t < T; ++t) {
    // ---- phase A: u, r of the block's units; publish r h_{t-1} ----
    for (int b0 = 0; b0 < B; b0 += kBT) {
      const int b = b0 + cb;
      const bool live = b < B && unit_ok;
      const size_t bt = (size_t)(live ? b : 0) * T + t;
      float xu = 0.f, xr = 0.f, h_prev = 0.f;
      if (live) {
        xu = xg[bt * G3 + unit];
        xr = xg[bt * G3 + H + unit];
        h_prev = t ? hs[(bt - 1) * H + unit] : h0[(size_t)b * H + unit];
      }
      stage(tile, hbuf, b0, H, Bp);
      __syncthreads();
      TileProduct<8> p;
      p.add(tile, wur, H);
      p.store(red);
      __syncthreads();
      if (live) {
        const float u = sigm(xu + TileProduct<8>::sum(red, cb, cu));
        const float r = sigm(xr + TileProduct<8>::sum(red, cb, kU + cu));
        stash[bt * G3 + unit] = u;
        stash[bt * G3 + H + unit] = r;
        rhbuf[(size_t)unit * Bp + b] = r * h_prev;
      }
      __syncthreads();  // the tile's shared memory is consumed
    }
    grid.sync();  // r h_{t-1} of every unit is in rhbuf

    // ---- phase B: c and h_t of the block's units ----
    for (int b0 = 0; b0 < B; b0 += kBT) {
      const int b = b0 + cb;
      const bool live = b < B && unit_ok;
      const size_t bt = (size_t)(live ? b : 0) * T + t;
      float xc = 0.f, h_prev = 0.f, u = 0.f, m = 0.f;
      if (live) {
        xc = xg[bt * G3 + 2 * (size_t)H + unit];
        h_prev = t ? hs[(bt - 1) * H + unit] : h0[(size_t)b * H + unit];
        u = stash[bt * G3 + unit];  // this thread's own write in phase A
        m = mask[bt];
      }
      stage(tile, rhbuf, b0, H, Bp);
      __syncthreads();
      TileProduct<4> p;
      p.add(tile, wc, H);
      p.store(red);
      __syncthreads();
      if (live) {
        const float c = tanhf(xc + TileProduct<4>::sum(red, cb, cu));
        float h_t = u * h_prev + (1.f - u) * c;
        h_t = m * h_t + (1.f - m) * h_prev;
        hs[bt * H + unit] = h_t;
        stash[bt * G3 + 2 * (size_t)H + unit] = c;
        hbuf[(size_t)unit * Bp + b] = h_t;
      }
      __syncthreads();
    }
    grid.sync();  // h_t of every unit is in hbuf
  }
}

__global__ void __launch_bounds__(kThreads)
gru_bwd_kernel(const float* __restrict__ stash, const float* __restrict__ hs,
               const float* __restrict__ w, const float* __restrict__ h0,
               const float* __restrict__ mask, const float* __restrict__ dhs,
               float* __restrict__ dxg, float* __restrict__ dh0,
               float* __restrict__ scratch, int B, int T, int H) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* wuT = smem;                         // [H][4]: W[unit][k], u part
  float* wrT = wuT + (size_t)H * 4;          // [H][4]: r part
  float* wcT = wrT + (size_t)H * 4;          // [H][4]: c part
  float* tile = wcT + (size_t)H * 4;         // [H][kBT]
  float* red = tile + (size_t)H * kBT;       // [kRed]
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * kU;
  const size_t G3 = 3 * (size_t)H;
  const int Bp = (B + kBT - 1) / kBT * kBT;
  // scratch: da_c, da_u, da_r unit-major [3][H][Bp] (rows past B stay
  // zero), then dh and the masked part of dh_{t-1}, [2][B][H]
  float* dacT = scratch;
  float* dauT = dacT + (size_t)H * Bp;
  float* darT = dauT + (size_t)H * Bp;
  float* dhb = darT + (size_t)H * Bp;
  float* dhm = dhb + (size_t)B * H;

  for (int idx = tid; idx < H * 4; idx += kThreads) {
    const int k = idx / 4, u = u0 + idx % 4;
    const bool ok = u < H;
    const float* row = w + (size_t)u * G3;
    wuT[idx] = ok ? row[k] : 0.f;
    wrT[idx] = ok ? row[H + k] : 0.f;
    wcT[idx] = ok ? row[2 * (size_t)H + k] : 0.f;
  }

  const int cb = tid / kU, cu = tid % kU;
  const int unit = u0 + cu;
  const bool unit_ok = unit < H;

  // dh_{t} of (b, unit) from step t + 1's da_ur: the carry product, then
  // the masked part phase B of step t + 1 left in dhm. The caller stages
  // da_u and da_r of rows [b0, b0 + 64); every thread takes part.
  auto carry = [&](int b0, bool live, int b) -> float {
    TileProduct<4> p;
    stage(tile, dauT, b0, H, Bp);
    __syncthreads();
    p.add(tile, wuT, H);
    __syncthreads();
    stage(tile, darT, b0, H, Bp);
    __syncthreads();
    p.add(tile, wrT, H);
    p.store(red);
    __syncthreads();
    const float d = live ? dhm[(size_t)b * H + unit] +
                               TileProduct<4>::sum(red, cb, cu)
                         : 0.f;
    __syncthreads();  // red and the tile are consumed
    return d;
  };

  for (int t = T - 1; t >= 0; --t) {
    // ---- phase A: dh_{t} (the carry from step t + 1), da_c ----
    for (int b0 = 0; b0 < B; b0 += kBT) {
      const int b = b0 + cb;
      const bool live = b < B && unit_ok;
      const float dh_c = t < T - 1 ? carry(b0, live, b) : 0.f;
      if (live) {
        const size_t bt = (size_t)b * T + t;
        const float u = stash[bt * G3 + unit];
        const float c = stash[bt * G3 + 2 * (size_t)H + unit];
        const float m = mask[bt];
        const float dh = dhs[bt * H + unit] + dh_c;
        const float da_c = m * dh * (1.f - u) * (1.f - c * c);
        dxg[bt * G3 + 2 * (size_t)H + unit] = da_c;
        dacT[(size_t)unit * Bp + b] = da_c;
        dhb[(size_t)b * H + unit] = dh;
      }
    }
    grid.sync();  // da_c of every unit of step t is in dacT

    // ---- phase B: drh, da_u, da_r, the masked part of dh_{t-1} ----
    for (int b0 = 0; b0 < B; b0 += kBT) {
      const int b = b0 + cb;
      const bool live = b < B && unit_ok;
      stage(tile, dacT, b0, H, Bp);
      __syncthreads();
      TileProduct<4> p;
      p.add(tile, wcT, H);
      p.store(red);
      __syncthreads();
      if (live) {
        const size_t bt = (size_t)b * T + t;
        const float drh = TileProduct<4>::sum(red, cb, cu);
        const float u = stash[bt * G3 + unit];
        const float r = stash[bt * G3 + H + unit];
        const float c = stash[bt * G3 + 2 * (size_t)H + unit];
        const float h_prev =
            t ? hs[(bt - 1) * H + unit] : h0[(size_t)b * H + unit];
        const float m = mask[bt];
        const float dh = dhb[(size_t)b * H + unit];
        const float da_u = m * dh * (h_prev - c) * u * (1.f - u);
        const float da_r = m * drh * h_prev * r * (1.f - r);
        dxg[bt * G3 + unit] = da_u;
        dxg[bt * G3 + H + unit] = da_r;
        dauT[(size_t)unit * Bp + b] = da_u;
        darT[(size_t)unit * Bp + b] = da_r;
        dhm[(size_t)b * H + unit] = (dh * u + drh * r) * m + (1.f - m) * dh;
      }
      __syncthreads();  // the tile's shared memory is consumed
    }
    grid.sync();  // da_u, da_r of every unit of step t are in scratch
  }

  // dh0: the carry out of step 0
  for (int b0 = 0; b0 < B; b0 += kBT) {
    const int b = b0 + cb;
    const bool live = b < B && unit_ok;
    const float d = carry(b0, live, b);
    if (live) dh0[(size_t)b * H + unit] = d;
  }
}

size_t smem_bytes(int H) {
  return ((size_t)H * 12 + (size_t)H * kBT + kRed) * sizeof(float);
}

// Set the kernel's shared memory and check that `blocks` of it can be
// resident at once, as a cooperative launch needs.
cudaError_t prepare(const void* kernel, int blocks, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                  dev)) != cudaSuccess)
    return e;
  if (!coop) return cudaErrorNotSupported;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return e;
  if (per_sm * sms < blocks) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// xg [B,T,3H], w [H,3H], h0 [B,H], mask [B,T]; outputs hs [B,T,H] and
// stash [B,T,3H]; scratch is [2,H,Bp], Bp = B rounded up to a multiple
// of 64, zero-filled.
cudaError_t gru_fwd(const float* xg, const float* w, const float* h0,
                    const float* mask, float* hs, float* stash,
                    float* scratch, int B, int T, int H,
                    cudaStream_t stream) {
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  const int blocks = (H + kU - 1) / kU;
  const size_t smem = smem_bytes(H);
  cudaError_t e = prepare((const void*)gru_fwd_kernel, blocks, smem);
  if (e != cudaSuccess) return e;
  void* args[] = {&xg, &w, &h0, &mask, &hs, &stash, &scratch, &B, &T, &H};
  e = cudaLaunchCooperativeKernel((const void*)gru_fwd_kernel, blocks,
                                  kThreads, args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// stash [B,T,3H], hs [B,T,H], w [H,3H], h0 [B,H], mask [B,T], dhs
// [B,T,H]; outputs dxg [B,T,3H] and dh0 [B,H]; scratch is 3*H*Bp + 2*B*H
// floats, zero-filled.
cudaError_t gru_bwd(const float* stash, const float* hs, const float* w,
                    const float* h0, const float* mask, const float* dhs,
                    float* dxg, float* dh0, float* scratch, int B, int T,
                    int H, cudaStream_t stream) {
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  const int blocks = (H + kU - 1) / kU;
  const size_t smem = smem_bytes(H);
  cudaError_t e = prepare((const void*)gru_bwd_kernel, blocks, smem);
  if (e != cudaSuccess) return e;
  void* args[] = {&stash, &hs, &w, &h0, &mask, &dhs,
                  &dxg, &dh0, &scratch, &B, &T, &H};
  e = cudaLaunchCooperativeKernel((const void*)gru_bwd_kernel, blocks,
                                  kThreads, args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"
