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
// h through unchanged and gets no gate gradient). Everything is
// contiguous. Two instantiations of each kernel, by the element type E
// of xg, W, hs, the stash, dhs and dxg: float (gru_fwd, gru_bwd) and
// bfloat16 (gru_fwd_bf16, gru_bwd_bf16, the bf16 AMP path); h0, mask and
// dh0 are float32 in both, and so are the carried h, the gates and every
// sum: the JAX kernels' dtypes. The bf16 kernels round h_{t-1}, r
// h_{t-1} (B5), da_c and da_ur (B6) to bf16 where the exchange carries
// them, as the JAX kernels round each product's input, and the outputs
// as they store them; B6 reads h_{t-1} from the stored hs, as the JAX
// kernel does. In bf16 the recurrence's 3.02 GFLOP take 3.1 us at 989
// TFLOP/s and the bytes ~16 us: the chain of steps bounds them.
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
//     dh     = dhs_t + (dhm_{t+1} + da_ur_{t+1} w_ur^T)
//     da_c   = m dh (1 - u)(1 - c^2)
//     drh    = da_c w_c^T
//     da_u   = m dh (h_{t-1} - c) u (1 - u)
//     da_r   = m drh h_{t-1} r (1 - r)
//     dhm_t  = (dh u + drh r) m + (1 - m) dh
//   and dh0 = dhm_0 + da_ur_0 w_ur^T. dW is two GEMMs outside the
//   kernel, as in the JAX package.
//   Bound at the path's shape: the same 3.02 GFLOP as gru_fwd (the two
//   products a step), 18.3 us as 3xTF32; it moves ~35 MB, ~10 us. In
//   practice bound by the chain of T steps, each of two dependent
//   products: the carry needs da_ur of every unit of its row, drh da_c
//   of every unit.
//   Design: gru_fwd's rounds in reverse, with lstm_bwd's cluster pair
//   for the product of K = 2H. A cluster of two blocks shares 16 units
//   of a 32-row group; each block runs the cells of its own 8 (a row
//   group takes 2 ceil(H/16) blocks: 128 at the path's shape, 2 row
//   groups x 32 pairs x 2). Each block keeps, split once into 3xTF32
//   fragments in shared memory, w_ur^T over its half of K for the
//   pair's 16 units (block `hf` takes w_u^T or w_r^T: 64 KB at H=512)
//   and w_c^T over K = H for its own 8 units (32 KB). A step of a row
//   group:
//   A. the carry: da_ur(t+1) of the row group, half hf, times the
//      half's w^T: [32, H] x [H, 16] as 3xTF32 mma.sync.m16n8k8, each
//      32-deep stage in fresh accumulators added by FADD; the block
//      keeps its own 8 units' sums and stores the partner's 8 in the
//      partner's shared memory, then arrives on its mbarrier; the carry
//      is half 0's sum + half 1's, in that order in both blocks (none
//      at t = T-1). Then dh and da_c of each owned (row, unit); da_c
//      into the da_c exchange tile, a release, and then dxg's da_c;
//   B. drh: da_c(t) of every unit of the row group times w_c^T:
//      [32, H] x [H, 8]; da_u, da_r and dhm_t; da_u and da_r into the
//      da_ur exchange tile, a release, and only then dxg's.
//   After step 0 one more round A on da_ur(0) forms dh0.
//   Each consuming lane fetches its own fragments with 16-byte
//   cp.async; a warp waits (acquire) on the counter of each 128-unit
//   chunk it is about to copy. The counters, per (row group, chunk) of
//   each tile, only grow. Each tile is single-buffered. A block writes
//   da_c only after its round A has waited for every chunk of da_ur,
//   whose producers published it after their round B had read all of
//   da_c; and it writes da_ur only after its round B has waited for
//   every chunk of da_c, whose producers published it after their own
//   round A had read da_ur and had taken their partner's sums, which
//   the partner sent after its own round A. (A block past H, the second
//   of the last pair when 16 does not divide H, runs no cell and no
//   round B and publishes nothing: its partner's release covers it.)
//   dhm of the owned (row, unit)s stays in registers for the first two
//   row groups a block runs, in `carry` past them. No float atomics:
//   two runs give the same bits; a wait that lasts 10 s traps.
//
// Both entry points check that their grid can be resident at once and
// return cudaErrorCooperativeLaunchTooLarge otherwise (gru_plan): on an
// H100, gru_fwd takes H <= 864 (its W slice in shared memory) and
// ceil(H/8) <= the SMs, gru_bwd H <= 856 and 2 ceil(H/16) <= the SMs.
// ---------------------------------------------------------------------

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rnn_step.cuh"

namespace {

// =====================================================================
// gru_fwd (B5)
// =====================================================================

namespace rs = rnn_step;

constexpr int kUrNT = 2;   // round 1: the n8 tiles of u and r of 8 units
constexpr int kCNT = 1;    // round 2: the candidate's n8 tile
// the most shared memory a block may ask for on an H100 (227 KB)
constexpr size_t kMaxSmem = 232448;

template <typename E>
struct FwdArgs {
  const E* xg;
  const E* w;
  const float* h0;
  const float* mask;
  E* hs;
  E* stash;
  E* hx;             // [RG][2][nks][32][16 bytes]: h_{t-1}, zero-filled
  E* rx;             // [RG][2][nks][32][16 bytes]: r h_{t-1}, zero-filled
  float* hcar;       // [B][H]: h carries past rs::kRegTiles
  unsigned* flags;   // [2][RG][nch]: h's counters, then r h's; zeroed
  int B, T, H, nch, RG, RGB, UGp;
};

// the cell's inputs of (row b, unit) at step t (zeros off the edge)
struct CellIn {
  float xu, xr, xc, m;
};
template <typename E>
__device__ __forceinline__ CellIn load_cell(const FwdArgs<E>& a, int t,
                                            int b, int unit) {
  CellIn v = {};
  if (b < a.B && unit < a.H) {
    const size_t bt = (size_t)b * a.T + t;
    const E* x = a.xg + bt * 3 * a.H;
    v.xu = rs::ld(x + unit);
    v.xr = rs::ld(x + a.H + unit);
    v.xc = rs::ld(x + 2 * (size_t)a.H + unit);
    v.m = a.mask[bt];
  }
  return v;
}

template <typename E>
__global__ void __launch_bounds__(rs::kThreads, 1)
gru_fwd_kernel(FwdArgs<E> a) {
  using WF = typename rs::Elem<E>::WFrag;
  extern __shared__ float4 smem4[];
  const int H = a.H, B = a.B, T = a.T, nch = a.nch;
  const int nks = (H + rs::Elem<E>::kK - 1) / rs::Elem<E>::kK;
  const size_t G3 = 3 * (size_t)H;
  // elements of a row group's tile
  const size_t tile = (size_t)2 * nks * rs::kFragElems<E>;
  WF* wur = reinterpret_cast<WF*>(smem4);       // w_ur fragments
  WF* wc = wur + (size_t)nks * kUrNT * 32;      // w_c fragments
  // per warp: its two chunk slots, which then take its partial sums
  float4* slots = reinterpret_cast<float4*>(wc + (size_t)nks * kCNT * 32);
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
               ? rs::ld(a.w + (size_t)k * G3 + (size_t)(n / rs::kUnits) * H + u)
               : 0.f;
  });
  rs::stage_w<kCNT>(wc, nks, [&](int k, int n) {
    const int u = u0 + n;
    return (k < H && u < H) ? rs::ld(a.w + (size_t)k * G3 + 2 * (size_t)H + u)
                            : 0.f;
  });
  const int r = tid / rs::kUnits, uu = tid % rs::kUnits;   // the cell
  const int unit = u0 + uu;
  const bool unit_ok = unit < H;
  // h0 of this block's units in the row groups it runs, published
  for (int rg = rgb; rg < a.RG; rg += a.RGB) {
    const int b = rg * rs::kRows + r;
    if (unit_ok && b < B)
      rs::st(a.hx + rg * tile + rs::frag_idx<E>(r, unit, nks),
             a.h0[(size_t)b * H + unit]);
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
      const size_t bu = (size_t)(live ? b : 0) * H + unit;
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
          h_prev = a.h0[bu];
        } else if (rl < rs::kRegTiles) {
#pragma unroll
          for (int i = 0; i < rs::kRegTiles; ++i)
            if (rl == i) h_prev = hreg[i];
        } else {
          h_prev = a.hcar[bu];
        }
      }
      E* hx = a.hx + rg * tile;
      E* rx = a.rx + rg * tile;
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
        rs::st(rx + rs::frag_idx<E>(r, unit, nks), rr * h_prev);
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
        if (t + 1 < T) rs::st(hx + rs::frag_idx<E>(r, unit, nks), h_t);
      }
      __syncthreads();   // partials read, h_t in the exchange
      if (tid == 0 && t + 1 < T) rs::publish(&hflag[rg * nch + my_chunk]);
      // the outputs after the release, which waits for no more than the
      // exchange
      if (live) {
        rs::st(a.hs + bt * H + unit, h_t);
        E* sp = a.stash + bt * G3;
        rs::st(sp + unit, u);
        rs::st(sp + H + unit, rr);
        rs::st(sp + 2 * (size_t)H + unit, c);
        if (rl < rs::kRegTiles) {
#pragma unroll
          for (int i = 0; i < rs::kRegTiles; ++i)
            if (rl == i) hreg[i] = h_t;
        } else {
          a.hcar[bu] = h_t;
        }
      }
    }
  }
}

template <typename E>
size_t fwd_smem(int H) {
  const int nks = (H + rs::Elem<E>::kK - 1) / rs::Elem<E>::kK;
  return rs::w_bytes<E, kUrNT + kCNT>(nks) +
         (size_t)rs::kWarps * 2 * rs::kSlot * 16;
}

// B5's launch plan on a card of `sms` SMs, one block an SM: out[0]
// blocks, out[1] row groups in flight at once, out[2] row groups a block
// runs a step, out[3] shared bytes a block. A row group takes ceil(H/8)
// blocks; as many row groups run at once as the SMs hold.
template <typename E>
cudaError_t fwd_plan(int B, int H, int sms, int* out) {
  const size_t smem = fwd_smem<E>(H);
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

constexpr int kPairNT = 2;   // round A: the n8 tiles of a pair's 16 units

template <typename E>
struct BwdArgs {
  const E* stash;
  const E* hs;
  const E* w;
  const float* h0;
  const float* mask;
  const E* dhs;
  E* dxg;
  float* dh0;
  float* carry;      // [B][H]: dhm past rs::kRegTiles
  E* urx;            // [RG][2 halves][2][nks][32][16 bytes]: da_u | da_r
  E* cx;             // [RG][2][nks][32][16 bytes]: da_c; both zero-filled
  unsigned* flags;   // [2][RG][nch]: da_c's counters, then da_ur's; zeroed
  int B, T, H, nch, RG, RGB, UGp;
};

// the cell's inputs of (row b, unit) at step t (zeros off the edge)
struct BwdIn {
  float u, r, c, hp, m, dhs;
};
template <typename E>
__device__ __forceinline__ BwdIn load_bwd(const BwdArgs<E>& a, int t, int b,
                                          int unit) {
  BwdIn v = {};
  if (b < a.B && unit < a.H) {
    const int H = a.H;
    const size_t bt = (size_t)b * a.T + t;
    const E* sp = a.stash + bt * 3 * H;
    v.u = rs::ld(sp + unit);
    v.r = rs::ld(sp + H + unit);
    v.c = rs::ld(sp + 2 * (size_t)H + unit);
    v.hp = t ? rs::ld(a.hs + (bt - 1) * H + unit) : a.h0[(size_t)b * H + unit];
    v.m = a.mask[bt];
    v.dhs = rs::ld(a.dhs + bt * H + unit);
  }
  return v;
}

template <typename E>
__global__ void __launch_bounds__(rs::kThreads, 1)
gru_bwd_kernel(BwdArgs<E> a) {
  using WF = typename rs::Elem<E>::WFrag;
  extern __shared__ float4 smem4[];
  const int H = a.H, B = a.B, T = a.T, nch = a.nch;
  const int nks = (H + rs::Elem<E>::kK - 1) / rs::Elem<E>::kK;
  const size_t G3 = 3 * (size_t)H;
  // elements of a K = H tile
  const size_t tile = (size_t)2 * nks * rs::kFragElems<E>;
  WF* wur = reinterpret_cast<WF*>(smem4);       // w_ur^T fragments, half hf
  WF* wc = wur + (size_t)nks * kPairNT * 32;    // w_c^T fragments
  // per warp: its two chunk slots, which then take its partial sums
  float4* slots = reinterpret_cast<float4*>(wc + (size_t)nks * kCNT * 32);
  float* part = reinterpret_cast<float*>(slots);
  // the partner's sums for this block's cells, two rounds' buffers
  float* xpart = reinterpret_cast<float*>(slots + rs::kWarps * 2 * rs::kSlot);
  uint64_t* xbar = reinterpret_cast<uint64_t*>(xpart + 2 * rs::kThreads);
  unsigned* cflag = a.flags;
  unsigned* urflag = a.flags + (size_t)a.RG * nch;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the pair (a cluster of two) shares units [16 p, 16 p + 16): block
  // `hf` runs the cells of [16 p + 8 hf, + 8) and forms round A over
  // half hf of K = 2H (da_u, or da_r) for all 16
  const int hf = (int)rs::cluster_rank();
  const int pair = blockIdx.x % a.UGp / 2, rgb = blockIdx.x / a.UGp;
  const int p16 = 2 * rs::kUnits * pair;
  const int u0 = p16 + rs::kUnits * hf;
  const bool has_units = u0 < H;
  const int my_chunk = u0 / rs::kKC;

  // w_ur^T over half hf: column n is unit p16 + n, row k is gate column
  // hf H + k; w_c^T: column n is unit u0 + n, row k gate column 2H + k
  rs::stage_w<kPairNT>(wur, nks, [&](int k, int n) {
    const int u = p16 + n;
    return (k < H && u < H) ? rs::ld(a.w + (size_t)u * G3 + (size_t)hf * H + k)
                            : 0.f;
  });
  rs::stage_w<kCNT>(wc, nks, [&](int k, int n) {
    const int u = u0 + n;
    return (k < H && u < H) ? rs::ld(a.w + (size_t)u * G3 + 2 * (size_t)H + k)
                            : 0.f;
  });
  if (tid == 0) rs::mbar_init(xbar, 1);
  __syncthreads();
  rs::cluster_sync();   // the partner's mbarrier exists before any arrival

  const int r = tid / rs::kUnits, uu = tid % rs::kUnits;   // the cell
  const int unit = u0 + uu;
  const bool unit_ok = unit < H;
  // the blocks that publish chunk c: one for each 8 of its units
  auto producers = [&](int c) {
    return (unsigned)((min(rs::kKC, H - c * rs::kKC) + rs::kUnits - 1) /
                      rs::kUnits);
  };
  const int grp = warp / 4, kw = warp % 4;   // chunk parity, slice
  float4* my_slots = slots + warp * 2 * rs::kSlot;
  unsigned n = 0;   // rounds A with a product: the mbarrier's phases

  // Round A's product for row group rg once da_ur is published `target`
  // times: the carry of this thread's (row, unit), half 0's sum first.
  // Every thread of the block takes part.
  auto carry_of = [&](int rg, unsigned target) -> float {
    float acc[2][kPairNT][4] = {};
    rs::warp_product<kPairNT>(
        a.urx + ((size_t)rg * 2 + hf) * tile, nks, H, nch, grp, kw, wur,
        my_slots, lane,
        [&](int c) {
          rs::wait_count(&urflag[rg * nch + c], producers(c) * target);
        },
        acc);
    rs::store_partial<kPairNT>(part + warp * rs::kPart, lane, acc);
    __syncthreads();
    const int row = r * rs::part_ld<kPairNT>();
    const float mine = rs::sum_partials(part, rs::kPart,
                                        row + rs::kUnits * hf + uu);
    const float other = rs::sum_partials(part, rs::kPart,
                                         row + rs::kUnits * (1 - hf) + uu);
    rs::st_remote(xpart + (n & 1) * rs::kThreads + tid, 1 - hf, other);
    __syncthreads();   // partials read, the partner's sums stored
    if (tid == 0) rs::mbar_arrive_remote(xbar, 1 - hf);
    rs::mbar_wait_cluster(xbar, n & 1);
    const float got = xpart[(n & 1) * rs::kThreads + tid];
    ++n;
    return hf == 0 ? mine + got : got + mine;
  };

  float dhmreg[rs::kRegTiles] = {};
  BwdIn cur = load_bwd(a, T - 1, rgb * rs::kRows + r, unit);
  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    int rl = 0;
    for (int rg = rgb; rg < a.RG; rg += a.RGB, ++rl) {
      const int b = rg * rs::kRows + r;
      const bool live = unit_ok && b < B;
      const size_t bt = (size_t)(live ? b : 0) * T + t;
      const size_t bu = (size_t)(live ? b : 0) * H + unit;
      const BwdIn in = cur;
      {
        // the next round's cell inputs, loaded while this round runs
        int rg2 = rg + a.RGB, s2 = s;
        if (rg2 >= a.RG) rg2 = rgb, ++s2;
        if (s2 < T) cur = load_bwd(a, T - 1 - s2, rg2 * rs::kRows + r, unit);
      }
      E* cx = a.cx + rg * tile;
      E* urx = a.urx + rg * 2 * tile;

      // ---- round A: dh from the carry of step t + 1, then da_c ----
      const float car = s ? carry_of(rg, (unsigned)s) : 0.f;
      float dh = 0.f, da_c = 0.f;
      if (live) {
        float dhm = 0.f;
        if (s) {
          if (rl < rs::kRegTiles) {
#pragma unroll
            for (int i = 0; i < rs::kRegTiles; ++i)
              if (rl == i) dhm = dhmreg[i];
          } else {
            dhm = a.carry[bu];
          }
        }
        dh = in.dhs + (dhm + car);
        da_c = in.m * dh * (1.f - in.u) * (1.f - in.c * in.c);
        rs::st(cx + rs::frag_idx<E>(r, unit, nks), da_c);
      }
      __syncthreads();   // da_c in the exchange
      if (tid == 0 && has_units) rs::publish(&cflag[rg * nch + my_chunk]);
      if (live) rs::st(a.dxg + bt * G3 + 2 * (size_t)H + unit, da_c);

      // ---- round B: drh from da_c of every unit, then da_u, da_r ----
      if (has_units) {
        float acc[2][kCNT][4] = {};
        rs::warp_product<kCNT>(
            cx, nks, H, nch, grp, kw, wc, my_slots, lane,
            [&](int c) {
              rs::wait_count(&cflag[rg * nch + c], producers(c) * (s + 1));
            },
            acc);
        rs::store_partial<kCNT>(part + warp * rs::kPart, lane, acc);
        __syncthreads();
        float da_u = 0.f, da_r = 0.f;
        if (live) {
          const float drh = rs::sum_partials(
              part, rs::kPart, r * rs::part_ld<kCNT>() + uu);
          da_u = in.m * dh * (in.hp - in.c) * in.u * (1.f - in.u);
          da_r = in.m * drh * in.hp * in.r * (1.f - in.r);
          const float dhm = (dh * in.u + drh * in.r) * in.m + (1.f - in.m) * dh;
          if (rl < rs::kRegTiles) {
#pragma unroll
            for (int i = 0; i < rs::kRegTiles; ++i)
              if (rl == i) dhmreg[i] = dhm;
          } else {
            a.carry[bu] = dhm;
          }
          rs::st(urx + rs::frag_idx<E>(r, unit, nks), da_u);
          rs::st(urx + tile + rs::frag_idx<E>(r, unit, nks), da_r);
        }
        __syncthreads();   // partials read, da_ur in the exchange
        if (tid == 0) rs::publish(&urflag[rg * nch + my_chunk]);
        // the outputs after the release, which waits for no more than
        // the exchange
        if (live) {
          rs::st(a.dxg + bt * G3 + unit, da_u);
          rs::st(a.dxg + bt * G3 + H + unit, da_r);
        }
      }
    }
  }

  // dh0: one more round A, on da_ur(0)
  int rl = 0;
  for (int rg = rgb; rg < a.RG; rg += a.RGB, ++rl) {
    const float car = carry_of(rg, (unsigned)T);
    const int b = rg * rs::kRows + r;
    if (unit_ok && b < B) {
      const size_t bu = (size_t)b * H + unit;
      float dhm = 0.f;
      if (rl < rs::kRegTiles) {
#pragma unroll
        for (int i = 0; i < rs::kRegTiles; ++i)
          if (rl == i) dhm = dhmreg[i];
      } else {
        dhm = a.carry[bu];
      }
      a.dh0[bu] = dhm + car;
    }
  }
  rs::cluster_sync();   // no block leaves while its partner may address it
}

template <typename E>
size_t bwd_smem(int H) {
  const int nks = (H + rs::Elem<E>::kK - 1) / rs::Elem<E>::kK;
  return rs::w_bytes<E, kPairNT + kCNT>(nks) +
         (size_t)rs::kWarps * 2 * rs::kSlot * 16 + 2 * rs::kThreads * 4 +
         sizeof(uint64_t);
}

// B6's launch plan on a card of `sms` SMs, one block an SM: out[0]
// blocks, out[1] row groups in flight at once, out[2] row groups a block
// runs a step, out[3] shared bytes a block. A row group takes two
// blocks, a cluster, for each 16 units; as many row groups run at once
// as the SMs and the card's resident clusters hold.
template <typename E>
cudaError_t bwd_plan(int B, int H, int sms, int* out) {
  const size_t smem = bwd_smem<E>(H);
  const int per = 2 * ((H + 2 * rs::kUnits - 1) / (2 * rs::kUnits));
  const int RG = (B + rs::kRows - 1) / rs::kRows;
  if (smem > kMaxSmem || per > sms) return cudaErrorCooperativeLaunchTooLarge;
  cudaError_t e = cudaFuncSetAttribute(
      gru_bwd_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(per);
  cfg.blockDim = dim3(rs::kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if ((e = cudaOccupancyMaxActiveClusters(&clusters, gru_bwd_kernel<E>,
                                          &cfg)) != cudaSuccess)
    return e;
  const int rows = min(RG, min(sms, 2 * clusters) / per);
  if (!rows) return cudaErrorCooperativeLaunchTooLarge;
  out[0] = per * rows;
  out[1] = rows;
  out[2] = (RG + rows - 1) / rows;
  out[3] = (int)smem;
  return cudaSuccess;
}

// the card's SM count, or an error where it takes no cooperative launch
cudaError_t card_sms(int* sms) {
  int dev = 0, coop = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                  dev)) != cudaSuccess)
    return e;
  return coop ? cudaSuccess : cudaErrorNotSupported;
}

template <typename E>
cudaError_t fwd(const void* xg, const void* w, const float* h0,
                const float* mask, void* hs, void* stash, void* hx, void* rx,
                float* hcar, unsigned* flags, int B, int T, int H,
                cudaStream_t stream) {
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  int sms = 0, per_sm = 0, p[4];
  cudaError_t e;
  if ((e = card_sms(&sms)) != cudaSuccess) return e;
  if ((e = fwd_plan<E>(B, H, sms, p)) != cudaSuccess) return e;
  if ((e = cudaFuncSetAttribute(gru_fwd_kernel<E>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                p[3])) != cudaSuccess)
    return e;
  // the plan counts one block an SM: that one must fit
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, gru_fwd_kernel<E>, rs::kThreads, p[3])) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  FwdArgs<E> a;
  a.xg = static_cast<const E*>(xg);
  a.w = static_cast<const E*>(w);
  a.h0 = h0;
  a.mask = mask;
  a.hs = static_cast<E*>(hs);
  a.stash = static_cast<E*>(stash);
  a.hx = static_cast<E*>(hx);
  a.rx = static_cast<E*>(rx);
  a.hcar = hcar;
  a.flags = flags;
  a.B = B;
  a.T = T;
  a.H = H;
  a.nch = (H + rs::kKC - 1) / rs::kKC;
  a.RG = (B + rs::kRows - 1) / rs::kRows;
  a.RGB = p[1];
  a.UGp = p[0] / p[1];
  return rs::launch(gru_fwd_kernel<E>, a, 1, p[0], p[3], stream);
}

template <typename E>
cudaError_t bwd(const void* stash, const void* hs, const void* w,
                const float* h0, const float* mask, const void* dhs,
                void* dxg, float* dh0, float* carry, void* urx, void* cx,
                unsigned* flags, int B, int T, int H, cudaStream_t stream) {
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  int sms = 0, p[4];
  cudaError_t e;
  if ((e = card_sms(&sms)) != cudaSuccess) return e;
  if ((e = bwd_plan<E>(B, H, sms, p)) != cudaSuccess) return e;
  BwdArgs<E> a;
  a.stash = static_cast<const E*>(stash);
  a.hs = static_cast<const E*>(hs);
  a.w = static_cast<const E*>(w);
  a.h0 = h0;
  a.mask = mask;
  a.dhs = static_cast<const E*>(dhs);
  a.dxg = static_cast<E*>(dxg);
  a.dh0 = dh0;
  a.carry = carry;
  a.urx = static_cast<E*>(urx);
  a.cx = static_cast<E*>(cx);
  a.flags = flags;
  a.B = B;
  a.T = T;
  a.H = H;
  a.nch = (H + rs::kKC - 1) / rs::kKC;
  a.RG = (B + rs::kRows - 1) / rs::kRows;
  a.RGB = p[1];
  a.UGp = p[0] / p[1];
  return rs::launch(gru_bwd_kernel<E>, a, 2, p[0], p[3], stream);
}

}  // namespace

extern "C" {

// The launch plan of gru_fwd (kind 0) or gru_bwd (kind 1), of the float
// (bf16 = 0) or bfloat16 (bf16 = 1) kernels, at (B, H) on a card of `sms`
// SMs: out[0] cluster size, out[1] blocks, out[2] row groups of 32 rows
// in flight, out[3] row groups a block runs a step, out[4] shared bytes a
// block (kernels.gru_cell.launch_plan mirrors it).
cudaError_t gru_plan(int kind, int bf16, int B, int H, int sms, int* out) {
  out[0] = kind == 0 ? 1 : 2;
  if (bf16)
    return kind == 0 ? fwd_plan<rs::bf16>(B, H, sms, out + 1)
                     : bwd_plan<rs::bf16>(B, H, sms, out + 1);
  return kind == 0 ? fwd_plan<float>(B, H, sms, out + 1)
                   : bwd_plan<float>(B, H, sms, out + 1);
}

// xg [B,T,3H], w [H,3H], h0 [B,H], mask [B,T]; outputs hs [B,T,H] and
// stash [B,T,3H]; hcar [B,H] is scratch; hx and rx [RG,2,nks,32,16
// bytes] and flags [2,RG,nch] are zero-filled scratch (RG = ceil(B/32),
// nks = ceil(H/8) for float and ceil(H/16) for bfloat16, nch =
// ceil(H/128)). xg, w, hs, stash, hx and rx are float in gru_fwd and
// bfloat16 in gru_fwd_bf16; the rest float32 in both.
cudaError_t gru_fwd(const void* xg, const void* w, const float* h0,
                    const float* mask, void* hs, void* stash, void* hx,
                    void* rx, float* hcar, unsigned* flags, int B, int T,
                    int H, cudaStream_t stream) {
  return fwd<float>(xg, w, h0, mask, hs, stash, hx, rx, hcar, flags, B, T,
                    H, stream);
}
cudaError_t gru_fwd_bf16(const void* xg, const void* w, const float* h0,
                         const float* mask, void* hs, void* stash, void* hx,
                         void* rx, float* hcar, unsigned* flags, int B, int T,
                         int H, cudaStream_t stream) {
  return fwd<rs::bf16>(xg, w, h0, mask, hs, stash, hx, rx, hcar, flags, B,
                       T, H, stream);
}

// stash [B,T,3H], hs [B,T,H], w [H,3H], h0 [B,H], mask [B,T], dhs
// [B,T,H]; outputs dxg [B,T,3H] and dh0 [B,H]; carry [B,H] is scratch;
// urx [RG,2,2,nks,32,16 bytes], cx [RG,2,nks,32,16 bytes] and flags
// [2,RG,nch] are zero-filled scratch (RG = ceil(B/32), nks as gru_fwd's,
// nch = ceil(H/128)). stash, hs, w, dhs, dxg, urx and cx are float in
// gru_bwd and bfloat16 in gru_bwd_bf16; the rest float32 in both.
cudaError_t gru_bwd(const void* stash, const void* hs, const void* w,
                    const float* h0, const float* mask, const void* dhs,
                    void* dxg, float* dh0, float* carry, void* urx, void* cx,
                    unsigned* flags, int B, int T, int H,
                    cudaStream_t stream) {
  return bwd<float>(stash, hs, w, h0, mask, dhs, dxg, dh0, carry, urx, cx,
                    flags, B, T, H, stream);
}
cudaError_t gru_bwd_bf16(const void* stash, const void* hs, const void* w,
                         const float* h0, const float* mask, const void* dhs,
                         void* dxg, float* dh0, float* carry, void* urx,
                         void* cx, unsigned* flags, int B, int T, int H,
                         cudaStream_t stream) {
  return bwd<rs::bf16>(stash, hs, w, h0, mask, dhs, dxg, dh0, carry, urx,
                       cx, flags, B, T, H, stream);
}

}  // extern "C"
