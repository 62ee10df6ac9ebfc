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
//   H=512): 2*64*30*512*1536 = 3.02 GFLOP of recurrence, 18.3 us as
//   3xTF32 on the tensor cores (3 x 3.02 GFLOP at 495 TFLOP/s); it moves
//   ~31 MB (xg 11.8 read, stash 11.8 and hs 3.9 written, W 3.1), ~9 us at
//   3.35 TB/s. In practice bound by the chain of T steps, each of two
//   dependent products: c needs r of every unit of its row.
//   Design: lstm_cell.cu's B3 (rnn_step.cuh), with two rounds a step.
//   Blocks run the cells of 32 rows x 8 units; a row group of 32 rows
//   takes ceil(H/8) blocks (128 at the path's shape: 2 row groups x 64),
//   all resident (a cooperative launch), as many row groups at once as
//   fit. Each block keeps its units' 16 columns of w_ur and 8 of w_c in
//   shared memory for the whole sequence, split once into 3xTF32 big
//   and small fragments (96 KB at H=512). A step of a row group:
//   1. h_{t-1} of the row group, from the exchange tile in A-fragment
//      order, times w_ur: [32, H] x [H, 16] as 3xTF32 mma.sync.m16n8k8,
//      each 32-deep stage in fresh accumulators added by FADD; u and r of
//      each owned (row, unit);
//   2. r h_{t-1} into the second exchange tile, then a release;
//   3. r h_{t-1} of every unit of the row group times w_c: [32, H] x
//      [H, 8]; c and h_t;
//   4. h_t into the first exchange tile, a release, and only then hs and
//      the stash.
//   Each consuming lane fetches its own fragments with 16-byte cp.async;
//   a warp waits (acquire) on the counter of each 128-unit chunk it is
//   about to copy, so it starts while later chunks are still written. Two
//   exchange tiles suffice, one each, with no double buffering: a block
//   writes either tile only after it has read all of the other one,
//   which its producers published after they had read the tile being
//   written. h_{t-1} of the owned (row, unit)s stays in registers for
//   the first two row groups a block runs. No float atomics: two runs
//   give the same bits; a wait that lasts 10 s traps.
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
// gru_bwd's reads of data that other blocks wrote in this launch go
// through L2 (__ldcg), never a stale L1 line. It checks that its grid
// can be resident at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// and returns cudaErrorCooperativeLaunchTooLarge otherwise: H <= 528 on
// an H100 (132 SMs, one block of ~170 KB of shared memory each). gru_fwd
// takes H <= 864 (its W slice in shared memory) and ceil(H/8) <= the
// SMs; past either it returns cudaErrorCooperativeLaunchTooLarge.
// ---------------------------------------------------------------------

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "rnn_step.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kU = 4;            // hidden units owned by one block
constexpr int kBT = 64;          // batch rows per tile
constexpr int kThreads = 256;    // = kBT * kU: one per (row, unit)
constexpr int kLoads = 8;        // 16-byte loads in flight per thread
constexpr int kRed = 4096;       // floats of the K-slice partials

static_assert(kThreads == kBT * kU, "one thread per (row, unit)");

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

// =====================================================================
// gru_fwd (B5)
// =====================================================================

namespace rs = rnn_step;

constexpr int kUrNT = 2;   // round 1: the n8 tiles of u and r of 8 units
constexpr int kCNT = 1;    // round 2: the candidate's n8 tile
// the most shared memory a block may ask for on an H100 (227 KB)
constexpr size_t kMaxSmem = 232448;

struct FwdArgs {
  const float* xg;
  const float* w;
  const float* h0;
  const float* mask;
  float* hs;
  float* stash;
  float* hx;         // [RG][2][nks][32][4]: h_{t-1}, zero-filled
  float* rx;         // [RG][2][nks][32][4]: r h_{t-1}, zero-filled
  unsigned* flags;   // [2][RG][nch]: h's counters, then r h's; zeroed
  int B, T, H, nch, RG, RGB, UGp;
};

// the cell's inputs of (row b, unit) at step t (zeros off the edge)
struct CellIn {
  float xu, xr, xc, m;
};
__device__ __forceinline__ CellIn load_cell(const FwdArgs& a, int t, int b,
                                            int unit) {
  CellIn v = {};
  if (b < a.B && unit < a.H) {
    const size_t bt = (size_t)b * a.T + t;
    const float* x = a.xg + bt * 3 * a.H;
    v.xu = x[unit];
    v.xr = x[a.H + unit];
    v.xc = x[2 * (size_t)a.H + unit];
    v.m = a.mask[bt];
  }
  return v;
}

__global__ void __launch_bounds__(rs::kThreads, 1)
gru_fwd_kernel(FwdArgs a) {
  extern __shared__ float4 smem4[];
  const int H = a.H, B = a.B, T = a.T, nch = a.nch;
  const int nks = (H + 7) / 8;
  const size_t G3 = 3 * (size_t)H;
  const size_t tile = (size_t)2 * nks * 128;   // floats of a row group
  float4* wur = smem4;                          // w_ur fragments
  float4* wc = wur + (size_t)nks * kUrNT * 32;  // w_c fragments
  // per warp: its two chunk slots, which then take its partial sums
  float4* slots = wc + (size_t)nks * kCNT * 32;
  float* part = reinterpret_cast<float*>(slots);
  unsigned* hflag = a.flags;
  unsigned* rflag = a.flags + (size_t)a.RG * nch;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ug = blockIdx.x % a.UGp, rgb = blockIdx.x / a.UGp;
  const int u0 = ug * rs::kUnits;
  const int my_chunk = u0 / rs::kKC;

  // column n of w_ur is gate n / 8 (u, then r) of unit u0 + n % 8, so
  // n8 tile 0 is u and tile 1 is r; column n of w_c is unit u0 + n
  rs::stage_w<kUrNT>(wur, nks, [&](int k, int n) {
    const int u = u0 + n % rs::kUnits;
    return (k < H && u < H)
               ? a.w[(size_t)k * G3 + (size_t)(n / rs::kUnits) * H + u]
               : 0.f;
  });
  rs::stage_w<kCNT>(wc, nks, [&](int k, int n) {
    const int u = u0 + n;
    return (k < H && u < H) ? a.w[(size_t)k * G3 + 2 * (size_t)H + u] : 0.f;
  });
  const int r = tid / rs::kUnits, uu = tid % rs::kUnits;   // the cell
  const int unit = u0 + uu;
  const bool unit_ok = unit < H;
  // h0 of this block's units in the row groups it runs, published
  for (int rg = rgb; rg < a.RG; rg += a.RGB) {
    const int b = rg * rs::kRows + r;
    if (unit_ok && b < B)
      a.hx[rg * tile + rs::frag_idx(r, unit, nks)] = a.h0[(size_t)b * H + unit];
  }
  __syncthreads();
  if (tid == 0)
    for (int rg = rgb; rg < a.RG; rg += a.RGB)
      rs::publish(&hflag[rg * nch + my_chunk]);

  // the blocks that publish chunk c: one for each 8 of its units
  auto producers = [&](int c) {
    return (unsigned)((min(rs::kKC, H - c * rs::kKC) + rs::kUnits - 1) /
                      rs::kUnits);
  };
  float hreg[rs::kRegTiles] = {};
  const int grp = warp / 4, kw = warp % 4;   // chunk parity, slice
  CellIn cur = load_cell(a, 0, rgb * rs::kRows + r, unit);

  for (int t = 0; t < T; ++t) {
    int rl = 0;
    for (int rg = rgb; rg < a.RG; rg += a.RGB, ++rl) {
      const int b = rg * rs::kRows + r;
      const bool live = unit_ok && b < B;
      const size_t bt = (size_t)(live ? b : 0) * T + t;
      const CellIn in = cur;
      {
        // the next round's cell inputs, loaded while this round runs
        int rg2 = rg + a.RGB, t2 = t;
        if (rg2 >= a.RG) rg2 = rgb, ++t2;
        if (t2 < T) cur = load_cell(a, t2, rg2 * rs::kRows + r, unit);
      }
      float h_prev = 0.f;
      if (live) {
        if (t == 0) {
          h_prev = a.h0[(size_t)b * H + unit];
        } else if (rl < rs::kRegTiles) {
#pragma unroll
          for (int i = 0; i < rs::kRegTiles; ++i)
            if (rl == i) h_prev = hreg[i];
        } else {
          h_prev = a.hs[(bt - 1) * H + unit];
        }
      }
      float* hx = a.hx + rg * tile;
      float* rx = a.rx + rg * tile;
      float4* my_slots = slots + warp * 2 * rs::kSlot;

      // ---- round 1: u, r from h_{t-1} w_ur; a chunk of h_{t-1} is
      //      ready when the blocks of its 128 units have published it ----
      float acc1[2][kUrNT][4] = {};
      rs::warp_product<kUrNT>(
          hx, nks, H, nch, grp, kw, wur, my_slots,
          lane,
          [&](int c) {
            rs::wait_count(&hflag[rg * nch + c], producers(c) * (t + 1));
          },
          acc1);
      rs::store_partial<kUrNT>(part + warp * rs::kPart, lane, acc1);
      __syncthreads();
      float u = 0.f, rr = 0.f;
      if (live) {
        const int row = r * rs::part_ld<kUrNT>();
        u = rs::sigm(in.xu + rs::sum_partials(part, rs::kPart, row + uu));
        rr = rs::sigm(in.xr + rs::sum_partials(part, rs::kPart,
                                               row + rs::kUnits + uu));
        rx[rs::frag_idx(r, unit, nks)] = rr * h_prev;
      }
      __syncthreads();   // partials read, r h_{t-1} in the exchange
      if (tid == 0) rs::publish(&rflag[rg * nch + my_chunk]);

      // ---- round 2: c from (r h_{t-1}) w_c, then h_t ----
      float acc2[2][kCNT][4] = {};
      rs::warp_product<kCNT>(
          rx, nks, H, nch, grp, kw, wc, my_slots,
          lane,
          [&](int c) {
            rs::wait_count(&rflag[rg * nch + c], producers(c) * (t + 1));
          },
          acc2);
      rs::store_partial<kCNT>(part + warp * rs::kPart, lane, acc2);
      __syncthreads();
      float c = 0.f, h_t = 0.f;
      if (live) {
        c = tanhf(in.xc + rs::sum_partials(part, rs::kPart,
                                           r * rs::part_ld<kCNT>() + uu));
        h_t = u * h_prev + (1.f - u) * c;
        h_t = in.m * h_t + (1.f - in.m) * h_prev;
        if (t + 1 < T) hx[rs::frag_idx(r, unit, nks)] = h_t;
      }
      __syncthreads();   // partials read, h_t in the exchange
      if (tid == 0 && t + 1 < T) rs::publish(&hflag[rg * nch + my_chunk]);
      // the outputs after the release, which waits for no more than the
      // exchange
      if (live) {
        a.hs[bt * H + unit] = h_t;
        float* st = a.stash + bt * G3;
        st[unit] = u;
        st[H + unit] = rr;
        st[2 * (size_t)H + unit] = c;
#pragma unroll
        for (int i = 0; i < rs::kRegTiles; ++i)
          if (rl == i) hreg[i] = h_t;
      }
    }
  }
}

size_t fwd_smem(int H) {
  const size_t nks = (H + 7) / 8;
  return nks * (kUrNT + kCNT) * 512 +
         (size_t)rs::kWarps * 2 * rs::kSlot * 16;
}

// B5's launch plan on a card of `sms` SMs, one block an SM: out[0]
// blocks, out[1] row groups in flight at once, out[2] row groups a block
// runs a step, out[3] shared bytes a block. A row group takes ceil(H/8)
// blocks; as many row groups run at once as the SMs hold.
cudaError_t fwd_plan(int B, int H, int sms, int* out) {
  const size_t smem = fwd_smem(H);
  const int per = (H + rs::kUnits - 1) / rs::kUnits;
  const int RG = (B + rs::kRows - 1) / rs::kRows;
  if (smem > kMaxSmem || per > sms) return cudaErrorCooperativeLaunchTooLarge;
  const int rows = min(RG, sms / per);
  out[0] = per * rows;
  out[1] = rows;
  out[2] = (RG + rows - 1) / rows;
  out[3] = (int)smem;
  return cudaSuccess;
}

// =====================================================================
// gru_bwd (B6)
// =====================================================================

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

// B5's launch plan at (B, H) on a card of `sms` SMs: out[0] blocks,
// out[1] row groups of 32 rows in flight, out[2] row groups a block runs
// a step, out[3] shared bytes a block (kernels.gru_cell.launch_plan
// mirrors it).
cudaError_t gru_plan(int B, int H, int sms, int* out) {
  return fwd_plan(B, H, sms, out);
}

// xg [B,T,3H], w [H,3H], h0 [B,H], mask [B,T]; outputs hs [B,T,H] and
// stash [B,T,3H]; hx and rx [RG,2,nks,32,4] and flags [2,RG,nch] are
// zero-filled scratch (RG = ceil(B/32), nks = ceil(H/8), nch =
// ceil(H/128)).
cudaError_t gru_fwd(const float* xg, const float* w, const float* h0,
                    const float* mask, float* hs, float* stash, float* hx,
                    float* rx, unsigned* flags, int B, int T, int H,
                    cudaStream_t stream) {
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  int dev = 0, sms = 0, coop = 0, per_sm = 0, p[4];
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                  dev)) != cudaSuccess)
    return e;
  if (!coop) return cudaErrorNotSupported;
  if ((e = fwd_plan(B, H, sms, p)) != cudaSuccess) return e;
  if ((e = cudaFuncSetAttribute(gru_fwd_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                p[3])) != cudaSuccess)
    return e;
  // the plan counts one block an SM: that one must fit
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, gru_fwd_kernel, rs::kThreads, p[3])) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  FwdArgs a;
  a.xg = xg;
  a.w = w;
  a.h0 = h0;
  a.mask = mask;
  a.hs = hs;
  a.stash = stash;
  a.hx = hx;
  a.rx = rx;
  a.flags = flags;
  a.B = B;
  a.T = T;
  a.H = H;
  a.nch = (H + rs::kKC - 1) / rs::kKC;
  a.RG = (B + rs::kRows - 1) / rs::kRows;
  a.RGB = p[1];
  a.UGp = p[0] / p[1];
  return rs::launch(gru_fwd_kernel, a, 1, p[0], p[3], stream);
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
