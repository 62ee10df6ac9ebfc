// Whole-sequence LSTM for Hopper (sm_90a): the forward kernel and the
// reverse-time backward kernel behind the `lstm` op.
//
// Built by paddle_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes: every entry point below is `extern "C"`, takes
// raw device pointers and a stream, launches on that stream without
// synchronising, allocates nothing, and returns the cudaError_t of the
// launch (0 on success).
//
// Layout is the JAX package's public one, batch-major: xg [B, T, 4H] of
// pre-projected gate inputs (bias added), gate order (i, c~, f, o) in
// blocks of H; W [H, 4H]; h0, c0 [B, H]; mask [B, T] (1 = valid step,
// 0 = a finished row, which carries h and c through unchanged and gets
// no gate gradient); peep [3, H] (w_ic, w_fc, w_oc; zeros for none).
// Everything is float32 and contiguous; the cell state is float32.
//
// ---------------------------------------------------------------------
// lstm_fwd  (B3)
//   Replaces paddle_tpu/kernels/lstm_cell.py `_fwd_kernel` (the
//   pallas_call in `_fwd_pallas`): g_t = xg_t + h_{t-1} W, the gates, the
//   peepholes, the mask carry; writes hs, cs [B, T, H] and the stash
//   [B, T, 4H] of gate activations (i, c~, f, o) that lstm_bwd reads.
//   Bound on the H100 at the training path's shape (B=64, T=80, H=512):
//   2*64*80*512*2048 = 10.7 GFLOP of recurrence, ~160 us at 67 TFLOP/s
//   (fp32 FMA, TF32 off); it moves ~109 MB (xg 41.9 read, stash 41.9,
//   hs 10.5, cs 10.5 written), ~33 us at 3.35 TB/s. Bound by operations,
//   and in practice by the serial chain of T dependent steps.
//   Design (persistent RNN): the TPU kernel keeps all of W (4 MB at
//   H=512) in VMEM over a sequential grid over T. One SM holds 227 KB,
//   so here one cooperative grid of ceil(H/4) blocks, all resident, walks
//   T itself: block j owns hidden units [4j, 4j+4) and keeps their 16
//   gate columns of W (H x 16 floats, 32 KB at H=512) in shared memory
//   for the whole sequence. Each step it copies h_{t-1} (unit-major
//   [H, B rounded up to 64] in a double-buffered global buffer that
//   stays in L2, 16-byte loads, 8 in flight per thread) into shared
//   memory in tiles of 64 batch rows and forms its [64, 16] gate
//   preactivations: each thread a 4 x 4 register tile over a quarter of
//   the K = H sum (fp32 FMA, two 16-byte shared loads per 16 FMAs), the
//   quarters added through shared memory. Then each thread updates c
//   and h of one (row, unit), writes its slices of hs, cs, the stash and
//   h_t, and the blocks meet at a grid barrier
//   (cooperative_groups::this_grid().sync()): T + 1 barriers per call.
//
// lstm_bwd  (B4)
//   Replaces paddle_tpu/kernels/lstm_cell.py `_bwd_kernel` (the
//   pallas_call in `_bwd_pallas`): walks t downwards from the stash, cs
//   and c0 to dxg [B, T, 4H], dh0, dc0 [B, H] and dpeep [3, H]. dW is
//   one GEMM outside the kernel, as in the JAX package.
//   Bound at the path's shape: the same 10.7 GFLOP (the dh recurrence
//   dgates_t W^T), ~160 us; it moves ~120 MB, ~36 us. Bound by
//   operations.
//   Design: two phases per step, two grid barriers. Phase A: block j
//   owns units [4j, 4j+4) of every row; each thread forms the gate
//   gradients of one (row, unit) from the stash, c_t, c_{t-1} and its dh
//   and dc carries, writes them to dxg, and accumulates dpeep in
//   registers (summed over the block's rows at the end: no atomics).
//   Phase B: dh_{t-1} = dgates_t W^T + (1 - m) dh, tiled in 2-D: block j
//   owns 16 units x 16 rows, keeps those units' rows of W transposed in
//   shared memory for the whole sequence (4H x 16 floats, 128 KB at
//   H=512), streams its 16 rows of dgates_t through shared memory in
//   512-column tiles, and forms the tile with 4 x 4 register tiles over
//   16 K-slices. A block reads 16 rows of dgates per step instead of all
//   B: a quarter of the L2 traffic of owning all rows of 4 units (16 vs
//   64 MB per step at the path's shape), for a second barrier.
//
// Reads of data that other blocks wrote in this launch (h_{t-1}, the
// gate gradients) go through L2 (__ldcg), never a stale L1 line.
// Both entry points check that the grid can be resident at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and return
// cudaErrorCooperativeLaunchTooLarge otherwise.
// ---------------------------------------------------------------------

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kU = 4;            // hidden units owned by one block
constexpr int kG = 4 * kU;       // their gate columns
constexpr int kBT = 64;          // batch rows per tile
constexpr int kThreads = 256;    // = kBT * kU = (kBT / 4) * kG
constexpr int kUB = 16;          // bwd phase B: units per tile
constexpr int kRB = 16;          // bwd phase B: rows per tile
constexpr int kKC = 512;         // bwd phase B: gate columns per staged tile
constexpr int kKB = kThreads / ((kRB / 4) * (kUB / 4));  // its K-slices
constexpr int kLoads = 8;        // 16-byte loads in flight per thread
constexpr int kKF = kThreads / ((kBT / 4) * (kG / 4));  // fwd K-slices

static_assert(kThreads == kBT * kU, "one thread per (row, unit)");
static_assert(kThreads == (kBT / 4) * kG, "one thread per 4 rows x 1 col");
static_assert(kRB == 16 && kKC * kRB % (4 * kThreads) == 0 &&
                  kThreads / 32 * 2 * (kKC * kRB / 4 / kThreads) == kKC / 4,
              "bwd staging: a warp covers 16 rows x 2 float4 per load");
static_assert(kRB * kUB <= kThreads, "one thread per output of a tile");

__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[i][j] = sum over k = k0, k0 + dk, ... < K of a[k*lda + i] * b[k*ldb + j]
// (a 4x4 register tile of a product whose operands are stored k-major
// in shared memory; a and b 16-byte aligned)
__device__ __forceinline__ void mma4x4(float (&acc)[4][4], const float* a,
                                       int lda, const float* b, int ldb,
                                       int k0, int K, int dk) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
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

__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(const float* __restrict__ xg, const float* __restrict__ w,
                const float* __restrict__ peep,
                const float* __restrict__ h0, const float* __restrict__ c0,
                const float* __restrict__ mask, float* __restrict__ hs,
                float* __restrict__ cs, float* __restrict__ stash,
                float* __restrict__ hbuf, int B, int T, int H) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ws = smem;                          // [H][kG]
  float* hsT = ws + (size_t)H * kG;          // [H][kBT]
  float* red = hsT + (size_t)H * kBT;        // [kKF][kBT][kG] partials
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * kU;
  const size_t G4 = 4 * (size_t)H;

  for (int idx = tid; idx < H * kG; idx += kThreads) {
    const int k = idx / kG, c = idx % kG;
    const int u = u0 + c % kU;
    ws[idx] = u < H ? w[(size_t)k * G4 + (size_t)(c / kU) * H + u] : 0.f;
  }
  // hbuf is [2][H][Bp], Bp = B rounded up to whole tiles; the rows past
  // B stay zero
  const int Bp = (B + kBT - 1) / kBT * kBT;
  for (int idx = tid; idx < B * kU; idx += kThreads) {
    const int b = idx / kU, u = u0 + idx % kU;
    if (u < H) hbuf[(size_t)u * Bp + b] = h0[(size_t)b * H + u];
  }

  // cell phase: one thread per (row of the tile, unit)
  const int cb = tid / kU, cu = tid % kU;
  const int unit = u0 + cu;
  const bool unit_ok = unit < H;
  const float p0 = unit_ok ? peep[unit] : 0.f;
  const float p1 = unit_ok ? peep[H + unit] : 0.f;
  const float p2 = unit_ok ? peep[2 * H + unit] : 0.f;
  // product phase: one thread per (4 rows x 4 gate columns, K-slice);
  // a warp shares its slice, so its 16-byte loads hit distinct banks
  const int kq = tid % (kThreads / kKF), fks = tid / (kThreads / kKF);
  const int rq = kq / (kG / 4), cq = kq % (kG / 4);

  grid.sync();  // hbuf[0] holds h0 of every unit

  for (int t = 0; t < T; ++t) {
    const float* hcur = hbuf + (size_t)(t & 1) * H * Bp;
    float* hnxt = hbuf + (size_t)((t + 1) & 1) * H * Bp;
    for (int b0 = 0; b0 < B; b0 += kBT) {
      const int nb = min(kBT, B - b0);
      // this thread's cell inputs, loaded ahead of the product
      const int b = b0 + cb;
      const bool live = cb < nb && unit_ok;
      const size_t bt = (size_t)(live ? b : 0) * T + t;
      float x4[4] = {0.f, 0.f, 0.f, 0.f};
      float c_prev = 0.f, h_prev = 0.f, m = 0.f;
      if (live) {
        const float* x = xg + bt * G4;
#pragma unroll
        for (int q = 0; q < 4; ++q) x4[q] = x[(size_t)q * H + unit];
        c_prev = t ? cs[(bt - 1) * H + unit] : c0[(size_t)b * H + unit];
        h_prev = t ? hs[(bt - 1) * H + unit] : h0[(size_t)b * H + unit];
        m = mask[bt];
      }
      // h_{t-1} of the tile's rows, every unit: rows of kBT floats
      {
        constexpr int kRow4 = kBT / 4;
        const int n4 = H * kRow4;
        const float4* src = reinterpret_cast<const float4*>(hcur + b0);
        float4* dst = reinterpret_cast<float4*>(hsT);
        for (int base = 0; base < n4; base += kThreads * kLoads) {
          float4 v[kLoads];
#pragma unroll
          for (int j = 0; j < kLoads; ++j) {
            const int q = base + j * kThreads + tid;
            if (q < n4)
              v[j] = __ldcg(src + (size_t)(q / kRow4) * (Bp / 4) + q % kRow4);
          }
#pragma unroll
          for (int j = 0; j < kLoads; ++j) {
            const int q = base + j * kThreads + tid;
            if (q < n4) dst[q] = v[j];
          }
        }
      }
      __syncthreads();

      {
        float acc[4][4];
        mma4x4(acc, hsT + 4 * rq, kBT, ws + 4 * cq, kG, fks, H, kKF);
        float* r = red + ((size_t)fks * kBT + 4 * rq) * kG + 4 * cq;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(r + i * kG) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
      __syncthreads();

      if (live) {
        float gsum[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float a = x4[q];
#pragma unroll
          for (int f = 0; f < kKF; ++f)
            a += red[((size_t)f * kBT + cb) * kG + q * kU + cu];
          gsum[q] = a;
        }
        float gi = gsum[0];
        const float gcand = gsum[1];
        float gf = gsum[2];
        float go = gsum[3];
        gi += c_prev * p0;
        gf += c_prev * p1;
        const float i_t = sigm(gi), f_t = sigm(gf), g_t = tanhf(gcand);
        float c_t = f_t * c_prev + i_t * g_t;
        go += c_t * p2;
        const float o_t = sigm(go);
        float h_t = o_t * tanhf(c_t);
        h_t = m * h_t + (1.f - m) * h_prev;
        c_t = m * c_t + (1.f - m) * c_prev;
        hs[bt * H + unit] = h_t;
        cs[bt * H + unit] = c_t;
        float* st = stash + bt * G4;
        st[unit] = i_t;
        st[H + unit] = g_t;
        st[2 * H + unit] = f_t;
        st[3 * H + unit] = o_t;
        hnxt[(size_t)unit * Bp + b] = h_t;
      }
      __syncthreads();  // the tile's shared memory is consumed
    }
    grid.sync();  // h_t of every unit is in hnxt
  }
}

__global__ void __launch_bounds__(kThreads)
lstm_bwd_kernel(const float* __restrict__ stash, const float* __restrict__ cs,
                const float* __restrict__ w, const float* __restrict__ peep,
                const float* __restrict__ c0, const float* __restrict__ mask,
                const float* __restrict__ dhs, const float* __restrict__ dcs,
                float* __restrict__ dxg, float* __restrict__ dh0,
                float* __restrict__ dc0, float* __restrict__ dpeep,
                float* __restrict__ scratch, int B, int T, int H) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int G4 = 4 * H;
  float* wt = smem;                          // [4H][kUB]: W[unit][col]
  float* dgT = wt + (size_t)G4 * kUB;        // [kKC][kRB]: a column tile
  float* red = dgT + kKC * kRB;              // [kKB][kRB][kUB] partials
  // scratch [3][B][H]: dh carry (dh_t from step t+1's phase B), (1-m) dh
  // of step t, dc carry
  float* dhb = scratch;
  float* dhm = scratch + (size_t)B * H;
  float* dcb = scratch + 2 * (size_t)B * H;
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  // phase A: block j owns units [4j, 4j + 4), every row; one thread per
  // (row of a 64-row tile, unit)
  const int cb = tid / kU, cu = tid % kU;
  const int unit = blockIdx.x * kU + cu;
  const bool unit_ok = unit < H;
  const float p0 = unit_ok ? peep[unit] : 0.f;
  const float p1 = unit_ok ? peep[H + unit] : 0.f;
  const float p2 = unit_ok ? peep[2 * H + unit] : 0.f;
  float dp0 = 0.f, dp1 = 0.f, dp2 = 0.f;

  // phase B: block j owns a (kRB rows, kUB units) tile of dh_{t-1}:
  // unit group j % NU, row group j / NU (blocks past NU * NR idle)
  const int NU = (H + kUB - 1) / kUB;
  const int NR = max(1, (int)gridDim.x / NU);
  const int ug = blockIdx.x % NU, rg = blockIdx.x / NU;
  const bool b_active = rg < NR;
  // one thread per (4 rows x 4 units, K-slice); a warp's two K-slices
  // are adjacent columns, 16 floats apart: distinct banks
  const int bq = tid % 16, bks = tid / 16;
  const int brq = bq / 4, buq = bq % 4;

  for (int idx = tid; idx < G4 * kUB; idx += kThreads) {
    const int col = idx / kUB, u = ug * kUB + idx % kUB;
    wt[idx] = (b_active && u < H) ? w[(size_t)u * G4 + col] : 0.f;
  }
  if (unit_ok) {
    for (int b = cb; b < B; b += kBT) {
      dhb[(size_t)b * H + unit] = 0.f;
      dcb[(size_t)b * H + unit] = 0.f;
    }
  }

  for (int t = T - 1; t >= 0; --t) {
    // ---- phase A: gate gradients of the block's units ----
    if (unit_ok) {
      for (int b = cb; b < B; b += kBT) {
        const size_t bt = (size_t)b * T + t;
        const size_t bu = (size_t)b * H + unit;
        const float m = mask[bt];
        const float* st = stash + bt * G4;
        const float i_t = st[unit], g_t = st[H + unit];
        const float f_t = st[2 * H + unit], o_t = st[3 * H + unit];
        const float c_t = cs[bt * H + unit];
        const float c_prev = t ? cs[(bt - 1) * H + unit] : c0[bu];
        // dhb of this (row, unit) was zeroed by this thread or written by
        // phase B of step t + 1, before the barrier that ended it
        const float dh = dhs[bt * H + unit] + __ldcg(dhb + bu);
        const float dc_in = dcs[bt * H + unit] + dcb[bu];
        const float tanh_c = tanhf(c_t);
        float dgo = dh * tanh_c * o_t * (1.f - o_t);
        const float dct = dh * o_t * (1.f - tanh_c * tanh_c) + dc_in +
                          dgo * p2;
        float dgi = dct * g_t * i_t * (1.f - i_t);
        float dgc = dct * i_t * (1.f - g_t * g_t);
        float dgf = dct * c_prev * f_t * (1.f - f_t);
        const float dc_prev = dct * f_t + dgi * p0 + dgf * p1;
        dgi *= m;
        dgc *= m;
        dgf *= m;
        dgo *= m;
        dcb[bu] = m * dc_prev + (1.f - m) * dc_in;
        dhm[bu] = (1.f - m) * dh;  // phase B adds dgates W^T
        float* out = dxg + bt * G4;
        out[unit] = dgi;
        out[H + unit] = dgc;
        out[2 * H + unit] = dgf;
        out[3 * H + unit] = dgo;
        dp0 += dgi * c_prev;
        dp1 += dgf * c_prev;
        dp2 += dgo * c_t;
      }
    }
    grid.sync();  // every unit's gate gradients of step t are in dxg

    // ---- phase B: dh_{t-1}[rows, units] = dgates_t W[units, :]^T
    //      + (1 - m) dh, for this block's tile ----
    if (b_active) {
      for (int b0 = rg * kRB; b0 < B; b0 += NR * kRB) {
        const int nr = min(kRB, B - b0);
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int col0 = 0; col0 < G4; col0 += kKC) {
          const int nc = min(kKC, G4 - col0);
          __syncthreads();  // the previous column tile is consumed
          // a warp loads 2 float4 of each of the kRB rows and stores
          // them transposed; the upper half-warp rotates the component
          // order so the two halves hit distinct banks
          float4 v[kKC * kRB / 4 / kThreads];
#pragma unroll
          for (int it = 0; it < kKC * kRB / 4 / kThreads; ++it) {
            const int col = 4 * (2 * (it * (kThreads / 32) + warp) +
                                 lane / kRB);
            const int r = lane % kRB;
            v[it] = (r < nr && col < nc)
                        ? __ldcg(reinterpret_cast<const float4*>(
                              dxg + ((size_t)(b0 + r) * T + t) * G4 + col0 +
                              col))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int it = 0; it < kKC * kRB / 4 / kThreads; ++it) {
            const int col = 4 * (2 * (it * (kThreads / 32) + warp) +
                                 lane / kRB);
            const int r = lane % kRB;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int q = (j + lane / kRB) & 3;
              dgT[(col + q) * kRB + r] = comp(v[it], q);
            }
          }
          __syncthreads();
          float part[4][4];
          mma4x4(part, dgT + 4 * brq, kRB, wt + (size_t)col0 * kUB + 4 * buq,
                 kUB, bks, nc, kKB);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
        }
        float* r = red + ((size_t)bks * kRB + 4 * brq) * kUB + 4 * buq;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(r + i * kUB) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        __syncthreads();
        {
          const int rr = tid / kUB, uu = tid % kUB;
          const int u = ug * kUB + uu;
          if (rr < nr && u < H) {
            float sum = 0.f;
#pragma unroll
            for (int q = 0; q < kKB; ++q)
              sum += red[((size_t)q * kRB + rr) * kUB + uu];
            const size_t bu = (size_t)(b0 + rr) * H + u;
            dhb[bu] = sum + __ldcg(dhm + bu);
          }
        }
      }
    }
    grid.sync();  // dh_{t-1} of every (row, unit) is in dhb
  }

  if (unit_ok) {
    for (int b = cb; b < B; b += kBT) {
      dh0[(size_t)b * H + unit] = __ldcg(dhb + (size_t)b * H + unit);
      dc0[(size_t)b * H + unit] = dcb[(size_t)b * H + unit];
    }
  }
  // dpeep: sum the per-(row, unit) partials over the block's rows
  const float part[3] = {dp0, dp1, dp2};
  for (int q = 0; q < 3; ++q) {
    __syncthreads();
    red[tid] = part[q];
    __syncthreads();
    if (tid < kU && blockIdx.x * kU + tid < H) {
      float sum = 0.f;
      for (int r = 0; r < kThreads / kU; ++r) sum += red[r * kU + tid];
      dpeep[(size_t)q * H + blockIdx.x * kU + tid] = sum;
    }
  }
}

size_t fwd_smem(int H) {
  return ((size_t)H * kG + (size_t)H * kBT + (size_t)kKF * kBT * kG) *
         sizeof(float);
}

size_t bwd_smem(int H) {
  return (4 * (size_t)H * kUB + (size_t)kKC * kRB +
          (size_t)kKB * kRB * kUB) * sizeof(float);
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

// xg [B,T,4H], w [H,4H], peep [3,H], h0/c0 [B,H], mask [B,T]; outputs
// hs/cs [B,T,H] and stash [B,T,4H]; hbuf is [2,H,Bp] scratch, Bp = B
// rounded up to a multiple of 64, zero-filled.
cudaError_t lstm_fwd(const float* xg, const float* w, const float* peep,
                     const float* h0, const float* c0, const float* mask,
                     float* hs, float* cs, float* stash, float* hbuf, int B,
                     int T, int H, cudaStream_t stream) {
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  const int blocks = (H + kU - 1) / kU;
  const size_t smem = fwd_smem(H);
  cudaError_t e = prepare((const void*)lstm_fwd_kernel, blocks, smem);
  if (e != cudaSuccess) return e;
  void* args[] = {&xg, &w, &peep, &h0, &c0, &mask, &hs,
                  &cs, &stash, &hbuf, &B, &T, &H};
  e = cudaLaunchCooperativeKernel((const void*)lstm_fwd_kernel, blocks,
                                  kThreads, args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// stash [B,T,4H], cs [B,T,H], w [H,4H], peep [3,H], c0 [B,H], mask
// [B,T], dhs/dcs [B,T,H]; outputs dxg [B,T,4H], dh0/dc0 [B,H], dpeep
// [3,H]; scratch is [3,B,H].
cudaError_t lstm_bwd(const float* stash, const float* cs, const float* w,
                     const float* peep, const float* c0, const float* mask,
                     const float* dhs, const float* dcs, float* dxg,
                     float* dh0, float* dc0, float* dpeep, float* scratch,
                     int B, int T, int H, cudaStream_t stream) {
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  const int blocks = (H + kU - 1) / kU;
  const size_t smem = bwd_smem(H);
  cudaError_t e = prepare((const void*)lstm_bwd_kernel, blocks, smem);
  if (e != cudaSuccess) return e;
  void* args[] = {&stash, &cs, &w, &peep, &c0, &mask, &dhs, &dcs,
                  &dxg, &dh0, &dc0, &dpeep, &scratch, &B, &T, &H};
  e = cudaLaunchCooperativeKernel((const void*)lstm_bwd_kernel, blocks,
                                  kThreads, args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"
