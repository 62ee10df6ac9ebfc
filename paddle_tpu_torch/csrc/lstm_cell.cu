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
// Everything is contiguous. Two instantiations of each kernel, by the
// element type E of xg, W, hs, the stash, dhs, dcs and dxg: float
// (lstm_fwd, lstm_bwd) and bfloat16 (lstm_fwd_bf16, lstm_bwd_bf16, the
// bf16 AMP path). h0, c0, mask, peep, cs, dh0, dc0 and dpeep are float32
// in both, and so are the carried h and c, the gates and every sum: the
// JAX kernels' dtypes. The bf16 kernels round h_{t-1} (B3) and dgates_t
// (B4) to bf16 where the exchange carries them, as the JAX kernels round
// the product's input (astype(w.dtype)), and the outputs as they store
// them.
//
// ---------------------------------------------------------------------
// lstm_fwd (B3) replaces paddle_tpu/kernels/lstm_cell.py `_fwd_kernel`
// (the pallas_call in `_fwd_pallas`): g_t = xg_t + h_{t-1} W, the gates,
// the peepholes, the mask carry; it writes hs, cs [B, T, H] and the stash
// [B, T, 4H] of gate activations (i, c~, f, o) that lstm_bwd reads.
// lstm_bwd (B4) replaces `_bwd_kernel` (the pallas_call in
// `_bwd_pallas`): it walks t downwards from the stash, cs and c0 to dxg
// [B, T, 4H], dh0, dc0 [B, H] and dpeep [3, H]; dW is one GEMM outside
// the kernel, as in the JAX package.
//
// What bounds them. At the training path's shape (B 64, T 80, H 512)
// each does 2*64*80*512*2048 = 10.7 GFLOP of recurrence: 65 us as
// 3xTF32 on the tensor cores (3 x 10.7 GFLOP at 495 TFLOP/s), against
// ~33-36 us for their ~110-120 MB. In practice they are bound by the
// chain of T dependent steps: each step needs the whole of the previous
// step's h (B3) or gate gradients (B4) from every block of the grid, so
// a step costs the latency of one exchange through L2 plus one product
// and one cell update, whatever the card's rates.
//
// The design, in both kernels:
// * Persistent grid. The TPU kernel keeps all of W (4 MB at H 512) in
//   VMEM over a sequential grid over T. One SM holds 227 KB, so one grid
//   of blocks, all resident at once (a cooperative launch), walks T
//   itself; each block keeps its slice of W in shared memory for the
//   whole sequence, split once into the 3xTF32 big and small parts and
//   laid out in mma fragment order (16-byte loads, no bank conflicts).
// * Small row groups. A block runs the cells of 32 batch rows x 8 units
//   (one thread each), so it needs the exchange tile of 32 rows only:
//   64 KB a step at H 512 in B3, a 128 KB half in B4, where PR 5's
//   kernels read 128 KB (B3: 64 rows) and 128 KB (B4) per block.
// * Tensor cores. The recurrent product runs as mma.sync.m16n8k8 TF32 in
//   3xTF32 (tf32x3.cuh), or in bf16 as one pass of mma.sync.m16n8k16
//   with float32 accumulation. The tensor core's accumulation truncates,
//   so every 32-deep stage goes into fresh accumulators (big*big apart
//   from the two small cross products), whose sum is then added by an
//   FADD (as the fused 1x1 backward found, conv1x1_bwd.cu); the plain
//   versions follow the same stages and order. In bf16 at the path's
//   shape the recurrence's 10.7 GFLOP take 10.9 us at 989 TFLOP/s and
//   the bytes (~70 MB) ~21 us: the chain of steps bounds it all the
//   more.
// * The exchange in fragment order. A producer writes h_t (B3) or
//   dgates_t (B4) straight into the A-fragment order of the product
//   (frag_idx), so each lane of a consuming warp fetches its own
//   fragments of a k8 step as one 16-byte cp.async (LDGSTS, L2 only),
//   into its own slots of shared memory: no other lane reads them, so
//   no barrier guards the copies. K comes in chunks of 128; warp w takes
//   chunks w / 4, w / 4 + 2, ... and the 32-deep slice w % 4 of each,
//   for both m16 tiles of the row group, through a ring of two chunk
//   slots a warp: the copies of the next chunk fly while the warp
//   multiplies this one.
// * A one-phase step barrier. Instead of cooperative_groups' grid sync,
//   a block that has written its part of an exchange tile publishes it
//   with a release (fence, then an atomic add on a counter in device
//   memory), and each consuming warp waits with acquire loads until the
//   counter of what it is about to copy has reached its target. The
//   counters only grow (targets are multiples of the step), so nothing
//   is reset. Exchange tiles alternate between two buffers by the
//   parity of the step. B3 counts per (row group, chunk of 128 units):
//   a warp starts copying a chunk as soon as its 16 producers have
//   published it, while later chunks are still being written.
// * Carries in registers: B3's c and h, B4's dh and dc of each owned
//   (row, unit) stay in registers for the first two row groups a block
//   runs (in float32 device memory past them: B > 128 at H 512).
//
// lstm_bwd's one barrier a step. Its blocks own the same (row, unit)
// pairs in both phases. Phase A: each thread forms the gate gradients of
// its pair from the stash, c_t, c_{t-1} and its dh and dc carries, and
// writes dxg and the exchange tile of dgates_t. Phase B: dh_{t-1} of its
// pairs = dgates_t[rows, 4H] W[units, 4H]^T + (1 - m) dh. A thread-block
// cluster of two shares 16 units: block `hf` of the pair forms the
// product over half hf of K = 4H for all 16, so that it holds W^T for
// 16 units x 2H in shared memory (128 KB split) and reads half the row
// group's dgates_t; it keeps the sums of its own 8 units and stores the
// other 8 in its partner's shared memory (distributed shared memory),
// then arrives on the partner's mbarrier. dh_{t-1} = (half 0's sum +
// half 1's sum) + (1 - m) dh, in that order in both blocks. dpeep's
// per-block sums go to `dpart` [row groups in flight, 3, H]; the wrapper
// adds them.
//
// No float atomics anywhere: every sum has a fixed order, so two runs
// give the same bits. A wait that does not end within 10 s traps. Both
// entry points return cudaErrorCooperativeLaunchTooLarge when not even
// one row group's blocks can be resident at once.
//
// The blocking, the exchange, the product, the counters, the pair's
// exchange and the launch are shared with gru_cell.cu's kernels (B5, B6)
// through rnn_step.cuh.
// ---------------------------------------------------------------------

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rnn_step.cuh"
#include "tf32x3.cuh"

namespace {

using namespace rnn_step;

constexpr int kFwdNT = 4;                // fwd: n8 tiles (gates) of W
constexpr int kBwdNT = 2;                // bwd: n8 tiles (units of a pair)

// =====================================================================
// lstm_fwd (B3)
// =====================================================================

template <typename E>
struct FwdArgs {
  const E* xg;
  const E* w;
  const float* peep;
  const float* h0;
  const float* c0;
  const float* mask;
  E* hs;
  float* cs;
  E* stash;
  E* hx;             // [2][RG][2][nks][32][16 bytes], zero-filled
  float* hcar;       // [B][H]: h carries past kRegTiles
  unsigned* flags;   // [RG][nch], zero-filled
  int B, T, H, nch, RG, RGB, UGp;
};

// the cell's inputs of (row b, unit) at step t (zeros off the edge)
struct CellIn {
  float x[4], m;
};
template <typename E>
__device__ __forceinline__ CellIn load_cell(const FwdArgs<E>& a, int t,
                                            int b, int unit) {
  CellIn v = {};
  if (b < a.B && unit < a.H) {
    const size_t bt = (size_t)b * a.T + t;
    const E* x = a.xg + bt * 4 * a.H;
#pragma unroll
    for (int q = 0; q < 4; ++q) v.x[q] = ld(x + (size_t)q * a.H + unit);
    v.m = a.mask[bt];
  }
  return v;
}

template <typename E>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_fwd_kernel(FwdArgs<E> a) {
  using WF = typename Elem<E>::WFrag;
  extern __shared__ float4 smem4[];
  const int H = a.H, B = a.B, T_ = a.T, nch = a.nch;
  const int nks = (H + Elem<E>::kK - 1) / Elem<E>::kK;
  const size_t G4 = 4 * (size_t)H;
  // elements of a row group's tile
  const size_t tile = (size_t)2 * nks * kFragElems<E>;
  WF* wf = reinterpret_cast<WF*>(smem4);        // W fragments
  // per warp: its two chunk slots, which then take its [32 x 32]
  // partial sums
  float4* slots = reinterpret_cast<float4*>(wf + (size_t)nks * kFwdNT * 32);
  float* part = reinterpret_cast<float*>(slots);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ug = blockIdx.x % a.UGp, rgb = blockIdx.x / a.UGp;
  const int u0 = ug * kUnits;
  const int my_chunk = u0 < H ? u0 / kKC : -1;

  // W's 32 columns of this block: column n is gate n / 8 of unit u0 +
  // n % 8, so n8 tile q is gate q
  stage_w<kFwdNT>(wf, nks, [&](int k, int n) {
    const int u = u0 + n % kUnits;
    return (k < H && u < H)
               ? ld(a.w + (size_t)k * G4 + (size_t)(n / kUnits) * H + u)
               : 0.f;
  });
  const int r = tid / kUnits, uu = tid % kUnits;   // the cell: row, unit
  const int unit = u0 + uu;
  const bool unit_ok = unit < H;
  // h0 of this block's units in the row groups it runs, published
  for (int rg = rgb; rg < a.RG; rg += a.RGB) {
    const int b = rg * kRows + r;
    if (unit_ok && b < B)
      st(a.hx + rg * tile + frag_idx<E>(r, unit, nks),
         a.h0[(size_t)b * H + unit]);
  }
  __syncthreads();
  if (tid == 0 && my_chunk >= 0)
    for (int rg = rgb; rg < a.RG; rg += a.RGB)
      publish(&a.flags[rg * nch + my_chunk]);

  const float p0 = unit_ok ? a.peep[unit] : 0.f;
  const float p1 = unit_ok ? a.peep[H + unit] : 0.f;
  const float p2 = unit_ok ? a.peep[2 * H + unit] : 0.f;
  float creg[kRegTiles] = {}, hreg[kRegTiles] = {};
  const int grp = warp / 4, kw = warp % 4;   // chunk parity, slice
  CellIn cur = load_cell(a, 0, rgb * kRows + r, unit);

  for (int t = 0; t < T_; ++t) {
    int rl = 0;
    for (int rg = rgb; rg < a.RG; rg += a.RGB, ++rl) {
      const int b = rg * kRows + r;
      const bool live = unit_ok && b < B;
      const size_t bt = (size_t)(live ? b : 0) * T_ + t;
      const size_t bu = (size_t)(live ? b : 0) * H + unit;
      const CellIn in = cur;
      {
        // the next round's cell inputs, loaded while this round runs
        int rg2 = rg + a.RGB, t2 = t;
        if (rg2 >= a.RG) rg2 = rgb, ++t2;
        if (t2 < T_) cur = load_cell(a, t2, rg2 * kRows + r, unit);
      }
      float c_prev = 0.f, h_prev = 0.f;
      if (live) {
        if (t == 0) {
          c_prev = a.c0[bu];
          h_prev = a.h0[bu];
        } else if (rl < kRegTiles) {
#pragma unroll
          for (int i = 0; i < kRegTiles; ++i)
            if (rl == i) c_prev = creg[i], h_prev = hreg[i];
        } else {
          c_prev = a.cs[(bt - 1) * H + unit];
          h_prev = a.hcar[bu];
        }
      }

      // h_{t-1} W for the row group: a chunk of h_{t-1} is ready when
      // the blocks of its 128 units have published it this step
      float acc[2][kFwdNT][4] = {};
      warp_product<kFwdNT>(
          a.hx + ((size_t)(t & 1) * a.RG + rg) * tile, nks, H, nch, grp, kw,
          wf, slots + warp * 2 * kSlot, lane,
          [&](int c) {
            const int units = min(kKC, H - c * kKC);
            wait_count(&a.flags[rg * nch + c],
                       (unsigned)((units + kUnits - 1) / kUnits * (t + 1)));
          },
          acc);
      store_partial<kFwdNT>(part + warp * kPart, lane, acc);
      __syncthreads();

      float h_t = 0.f, c_t = 0.f, act[4] = {0.f, 0.f, 0.f, 0.f};
      if (live) {
        float gsum[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          gsum[q] = in.x[q] + sum_partials(part, kPart,
                                           r * part_ld<kFwdNT>() + 8 * q + uu);
        const float m = in.m;
        const float gi = gsum[0] + c_prev * p0;
        const float gf = gsum[2] + c_prev * p1;
        act[0] = sigm(gi);
        act[1] = tanhf(gsum[1]);
        act[2] = sigm(gf);
        c_t = act[2] * c_prev + act[0] * act[1];
        act[3] = sigm(gsum[3] + c_t * p2);
        h_t = act[3] * tanhf(c_t);
        h_t = m * h_t + (1.f - m) * h_prev;
        c_t = m * c_t + (1.f - m) * c_prev;
        if (t + 1 < T_)
          st(a.hx + ((size_t)((t + 1) & 1) * a.RG + rg) * tile +
                 frag_idx<E>(r, unit, nks),
             h_t);
      }
      __syncthreads();   // partials read, h_t in the exchange
      if (tid == 0 && my_chunk >= 0 && t + 1 < T_)
        publish(&a.flags[rg * nch + my_chunk]);
      // the outputs after the release, which waits for no more than the
      // exchange
      if (live) {
        st(a.hs + bt * H + unit, h_t);
        a.cs[bt * H + unit] = c_t;
        E* sp = a.stash + bt * G4;
#pragma unroll
        for (int q = 0; q < 4; ++q) st(sp + (size_t)q * H + unit, act[q]);
        if (rl < kRegTiles) {
#pragma unroll
          for (int i = 0; i < kRegTiles; ++i)
            if (rl == i) creg[i] = c_t, hreg[i] = h_t;
        } else {
          a.hcar[bu] = h_t;
        }
      }
    }
  }
}

// =====================================================================
// lstm_bwd (B4)
// =====================================================================

template <typename E>
struct BwdArgs {
  const E* stash;
  const float* cs;
  const E* w;
  const float* peep;
  const float* c0;
  const float* mask;
  const E* dhs;
  const E* dcs;
  E* dxg;
  float* dh0;
  float* dc0;
  float* dpart;        // [RGB][3][H]
  float* carry;        // [2][B][H]: dh, dc carries past kRegTiles
  E* dgx;              // [2][RG][2 halves][2][nks][32][16 bytes], zeroed
  unsigned* counters;  // [RG], zero-filled
  int B, T, H, nch, RG, RGB, UGp;
};

// phase A's inputs of the pair (row b, unit) at step t (zeros off the
// edge)
struct AIn {
  float m, i, g, f, o, c, cp, dh, dc;
};
template <typename E>
__device__ __forceinline__ AIn load_a(const BwdArgs<E>& a, int t, int b,
                                      int unit) {
  AIn v = {};
  if (b < a.B && unit < a.H) {
    const int H = a.H;
    const size_t bt = (size_t)b * a.T + t;
    const E* sp = a.stash + bt * 4 * H;
    v.m = a.mask[bt];
    v.i = ld(sp + unit);
    v.g = ld(sp + H + unit);
    v.f = ld(sp + 2 * H + unit);
    v.o = ld(sp + 3 * H + unit);
    v.c = a.cs[bt * H + unit];
    v.cp = t ? a.cs[(bt - 1) * H + unit] : a.c0[(size_t)b * H + unit];
    v.dh = ld(a.dhs + bt * H + unit);
    v.dc = ld(a.dcs + bt * H + unit);
  }
  return v;
}

template <typename E>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_bwd_kernel(BwdArgs<E> a) {
  using WF = typename Elem<E>::WFrag;
  extern __shared__ float4 smem4[];
  const int H = a.H, B = a.B, T_ = a.T, nch = a.nch;
  const int G4 = 4 * H, H2 = 2 * H;
  const int nks = (H2 + Elem<E>::kK - 1) / Elem<E>::kK;
  // elements of a half tile
  const size_t half = (size_t)2 * nks * kFragElems<E>;
  WF* wf = reinterpret_cast<WF*>(smem4);        // W^T fragments
  // and the partials
  float4* slots = reinterpret_cast<float4*>(wf + (size_t)nks * kBwdNT * 32);
  float* part = reinterpret_cast<float*>(slots);
  float* xpart = reinterpret_cast<float*>(slots + kWarps * 2 * kSlot);
  uint64_t* xbar = reinterpret_cast<uint64_t*>(xpart + 2 * kThreads);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the pair (a cluster of two) shares 16 units: block `hf` runs the
  // cells of units [16 p + 8 hf, + 8) and forms the product over half hf
  // of K = 4H (gate columns [2H hf, 2H hf + 2H)) for all 16
  const int hf = (int)cluster_rank();
  const int pair = blockIdx.x % a.UGp / 2, rgb = blockIdx.x / a.UGp;
  const int u0 = 16 * pair + kUnits * hf;
  // where dgates_t of (row r, gate column col) goes in buffer `par`
  auto xidx = [&](int par, int rg, int col, int r) {
    const int hh = col / H2;
    return (((size_t)par * a.RG + rg) * 2 + hh) * half +
           frag_idx<E>(r, col - hh * H2, nks);
  };

  // W[16 p .. 16 p + 16, 2H hf .. 2H hf + 2H]^T: n8 tile nt holds units
  // 16 p + 8 nt ..
  stage_w<kBwdNT>(wf, nks, [&](int k, int n) {
    const int u = 16 * pair + n;
    return (u < H && k < H2) ? ld(a.w + (size_t)u * G4 + (size_t)hf * H2 + k)
                             : 0.f;
  });
  if (tid == 0) mbar_init(xbar, 1);
  __syncthreads();
  cluster_sync();   // the partner's mbarrier exists before any arrival

  const int r = tid / kUnits, uu = tid % kUnits;   // the pair: row, unit
  const int unit = u0 + uu;
  const bool unit_ok = unit < H;
  const float p0 = unit_ok ? a.peep[unit] : 0.f;
  const float p1 = unit_ok ? a.peep[H + unit] : 0.f;
  const float p2 = unit_ok ? a.peep[2 * H + unit] : 0.f;
  float dp0 = 0.f, dp1 = 0.f, dp2 = 0.f;
  float dhreg[kRegTiles] = {}, dcreg[kRegTiles] = {};
  const int grp = warp / 4, kw = warp % 4;   // chunk parity, slice
  float* dhc = a.carry;
  float* dcc = a.carry + (size_t)B * H;

  AIn cur = load_a(a, T_ - 1, rgb * kRows + r, unit);
  int n = 0;   // rounds
  for (int s = 0; s < T_; ++s) {
    const int t = T_ - 1 - s;
    int rl = 0;
    for (int rg = rgb; rg < a.RG; rg += a.RGB, ++rl, ++n) {
      // ---- phase A: the gate gradients of this thread's pair ----
      const int b = rg * kRows + r;
      const bool live = unit_ok && b < B;
      const size_t bt = (size_t)(live ? b : 0) * T_ + t;
      const size_t bu = (size_t)(live ? b : 0) * H + unit;
      const AIn in = cur;
      {
        // the next round's inputs, loaded while this round runs
        int rg2 = rg + a.RGB, s2 = s;
        if (rg2 >= a.RG) rg2 = rgb, ++s2;
        if (s2 < T_) cur = load_a(a, T_ - 1 - s2, rg2 * kRows + r, unit);
      }
      float m = 0.f, dh = 0.f, dg[4] = {0.f, 0.f, 0.f, 0.f};
      if (live) {
        m = in.m;
        float dh_c = 0.f, dc_c = 0.f;
        if (s) {
          if (rl < kRegTiles) {
#pragma unroll
            for (int i = 0; i < kRegTiles; ++i)
              if (rl == i) dh_c = dhreg[i], dc_c = dcreg[i];
          } else {
            dh_c = dhc[bu];
            dc_c = dcc[bu];
          }
        }
        dh = in.dh + dh_c;
        const float dc_in = in.dc + dc_c;
        const float tanh_c = tanhf(in.c);
        float dgo = dh * tanh_c * in.o * (1.f - in.o);
        const float dct =
            dh * in.o * (1.f - tanh_c * tanh_c) + dc_in + dgo * p2;
        float dgi = dct * in.g * in.i * (1.f - in.i);
        float dgc = dct * in.i * (1.f - in.g * in.g);
        float dgf = dct * in.cp * in.f * (1.f - in.f);
        const float dc_prev = dct * in.f + dgi * p0 + dgf * p1;
        dgi *= m;
        dgc *= m;
        dgf *= m;
        dgo *= m;
        const float dc_new = m * dc_prev + (1.f - m) * dc_in;
        if (rl < kRegTiles) {
#pragma unroll
          for (int i = 0; i < kRegTiles; ++i)
            if (rl == i) dcreg[i] = dc_new;
        } else {
          dcc[bu] = dc_new;
        }
        if (t == 0) a.dc0[bu] = dc_new;
        dg[0] = dgi;
        dg[1] = dgc;
        dg[2] = dgf;
        dg[3] = dgo;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          st(a.dgx + xidx(s & 1, rg, q * H + unit, r), dg[q]);
        dp0 += dgi * in.cp;
        dp1 += dgf * in.cp;
        dp2 += dgo * in.c;
      }
      __syncthreads();   // this block's columns of dgates_t are written
      if (tid == 0) publish(&a.counters[rg]);
      if (live) {
        // dxg after the release, which waits for no more than the
        // exchange
        E* out = a.dxg + bt * G4;
#pragma unroll
        for (int q = 0; q < 4; ++q) st(out + (size_t)q * H + unit, dg[q]);
      }

      // ---- phase B: this half of K for the pair's 16 units, once every
      //      block of the row group has published ----
      float acc[2][kBwdNT][4] = {};
      warp_product<kBwdNT>(
          a.dgx + ((((size_t)(s & 1) * a.RG + rg) * 2 + hf) * half), nks,
          H2, nch, grp, kw, wf, slots + warp * 2 * kSlot, lane,
          [&](int c) {
            if (c < 2)
              wait_count(&a.counters[rg], (unsigned)(a.UGp * (s + 1)));
          },
          acc);
      store_partial<kBwdNT>(part + warp * kPart, lane, acc);
      __syncthreads();
      // this half's sums for row r: of this block's unit, kept, and of
      // the partner's, stored in its shared memory
      const float mine = sum_partials(
          part, kPart, r * part_ld<kBwdNT>() + kUnits * hf + uu);
      const float other = sum_partials(
          part, kPart, r * part_ld<kBwdNT>() + kUnits * (1 - hf) + uu);
      st_remote(xpart + (n & 1) * kThreads + tid, 1 - hf, other);
      __syncthreads();
      if (tid == 0) mbar_arrive_remote(xbar, 1 - hf);
      mbar_wait_cluster(xbar, n & 1);
      if (live) {
        const float got = xpart[(n & 1) * kThreads + tid];
        // half 0's sum first, then half 1's
        const float dh_new =
            (hf == 0 ? mine + got : got + mine) + (1.f - m) * dh;
        if (rl < kRegTiles) {
#pragma unroll
          for (int i = 0; i < kRegTiles; ++i)
            if (rl == i) dhreg[i] = dh_new;
        } else {
          dhc[bu] = dh_new;
        }
        if (t == 0) a.dh0[bu] = dh_new;
      }
      // the next round's phase A ends in a __syncthreads before any warp
      // writes `part` again
    }
  }

  // dpeep: this block's rows, summed in row order, for each unit
  const float dp[3] = {dp0, dp1, dp2};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    __syncthreads();
    part[tid] = dp[q];
    __syncthreads();
    if (tid < kUnits && u0 + tid < H) {
      float sum = 0.f;
      for (int rr = 0; rr < kRows; ++rr) sum += part[rr * kUnits + tid];
      a.dpart[((size_t)rgb * 3 + q) * H + u0 + tid] = sum;
    }
  }
  cluster_sync();   // no block leaves while its partner may address it
}

template <typename E>
size_t fwd_smem(int H) {
  const int nks = (H + Elem<E>::kK - 1) / Elem<E>::kK;
  return w_bytes<E, kFwdNT>(nks) + (size_t)kWarps * 2 * kSlot * 16;
}

template <typename E>
size_t bwd_smem(int H) {
  const int nks = (2 * H + Elem<E>::kK - 1) / Elem<E>::kK;
  return w_bytes<E, kBwdNT>(nks) + (size_t)kWarps * 2 * kSlot * 16 +
         2 * kThreads * 4 + sizeof(uint64_t);
}

// The launch plan: out[0] cluster size, out[1] blocks, out[2] row groups
// in flight at once, out[3] row groups a block runs a step. A row group
// takes ceil(H/8) blocks (B3) or two blocks, a cluster, for each 16
// units (B4); as many row groups as can be resident run at once.
template <typename E>
cudaError_t plan(int kind, int B, int H, int* out, size_t* smem_out) {
  const void* kernel = kind == 0 ? (const void*)lstm_fwd_kernel<E>
                                 : (const void*)lstm_bwd_kernel<E>;
  const size_t smem = kind == 0 ? fwd_smem<E>(H) : bwd_smem<E>(H);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, coop = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                  dev)) != cudaSuccess)
    return e;
  if (!coop) return cudaErrorNotSupported;
  const int RG = (B + kRows - 1) / kRows;
  const int cs = kind == 0 ? 1 : 2;
  const int per = kind == 0 ? (H + kUnits - 1) / kUnits : 2 * ((H + 15) / 16);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(per);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if ((e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg)) !=
      cudaSuccess)
    return e;
  const int rows = min(RG, clusters * cs / per);
  if (!rows) return cudaErrorCooperativeLaunchTooLarge;
  out[0] = cs;
  out[1] = per * rows;
  out[2] = rows;
  out[3] = (RG + rows - 1) / rows;
  *smem_out = smem;
  return cudaSuccess;
}

template <typename E>
cudaError_t fwd(const void* xg, const void* w, const float* peep,
                const float* h0, const float* c0, const float* mask,
                void* hs, float* cs, void* stash, void* hx, float* hcar,
                unsigned* flags, int B, int T_, int H, cudaStream_t stream) {
  if (B == 0 || T_ == 0 || H == 0) return cudaSuccess;
  int p[4];
  size_t smem;
  cudaError_t e = plan<E>(0, B, H, p, &smem);
  if (e != cudaSuccess) return e;
  FwdArgs<E> a;
  a.xg = static_cast<const E*>(xg);
  a.w = static_cast<const E*>(w);
  a.peep = peep;
  a.h0 = h0;
  a.c0 = c0;
  a.mask = mask;
  a.hs = static_cast<E*>(hs);
  a.cs = cs;
  a.stash = static_cast<E*>(stash);
  a.hx = static_cast<E*>(hx);
  a.hcar = hcar;
  a.flags = flags;
  a.B = B;
  a.T = T_;
  a.H = H;
  a.nch = (H + kKC - 1) / kKC;
  a.RG = (B + kRows - 1) / kRows;
  a.RGB = p[2];
  a.UGp = p[1] / p[2];
  return launch(lstm_fwd_kernel<E>, a, p[0], p[1], smem, stream);
}

template <typename E>
cudaError_t bwd(const void* stash, const float* cs, const void* w,
                const float* peep, const float* c0, const float* mask,
                const void* dhs, const void* dcs, void* dxg, float* dh0,
                float* dc0, float* dpart, float* carry, void* dgx,
                unsigned* counters, int B, int T_, int H,
                cudaStream_t stream) {
  if (B == 0 || T_ == 0 || H == 0) return cudaSuccess;
  int p[4];
  size_t smem;
  cudaError_t e = plan<E>(1, B, H, p, &smem);
  if (e != cudaSuccess) return e;
  BwdArgs<E> a;
  a.stash = static_cast<const E*>(stash);
  a.cs = cs;
  a.w = static_cast<const E*>(w);
  a.peep = peep;
  a.c0 = c0;
  a.mask = mask;
  a.dhs = static_cast<const E*>(dhs);
  a.dcs = static_cast<const E*>(dcs);
  a.dxg = static_cast<E*>(dxg);
  a.dh0 = dh0;
  a.dc0 = dc0;
  a.dpart = dpart;
  a.carry = carry;
  a.dgx = static_cast<E*>(dgx);
  a.counters = counters;
  a.B = B;
  a.T = T_;
  a.H = H;
  a.nch = (2 * H + kKC - 1) / kKC;
  a.RG = (B + kRows - 1) / kRows;
  a.RGB = p[2];
  a.UGp = p[1] / p[2];
  return launch(lstm_bwd_kernel<E>, a, p[0], p[1], smem, stream);
}

}  // namespace

extern "C" {

// The launch plan of lstm_fwd (kind 0) or lstm_bwd (kind 1), of the
// float (bf16 = 0) or bfloat16 (bf16 = 1) kernels, at (B, H) on the
// current device: out[0] cluster size, out[1] blocks, out[2] row groups
// of 32 rows in flight, out[3] row groups a block runs a step.
cudaError_t lstm_plan(int kind, int bf16, int B, int H, int* out) {
  size_t smem;
  return bf16 ? plan<rnn_step::bf16>(kind, B, H, out, &smem)
              : plan<float>(kind, B, H, out, &smem);
}

// xg [B,T,4H], w [H,4H], peep [3,H], h0/c0 [B,H], mask [B,T]; outputs
// hs/cs [B,T,H] and stash [B,T,4H]; hcar [B,H] is scratch; hx
// [2,RG,2,nks,32,16 bytes] and flags [RG,nch] are zero-filled scratch
// (RG = ceil(B/32), nks = ceil(H/8) for float and ceil(H/16) for
// bfloat16, nch = ceil(H/128)). xg, w, hs, stash and hx are float in
// lstm_fwd and bfloat16 in lstm_fwd_bf16; the rest float32 in both.
cudaError_t lstm_fwd(const void* xg, const void* w, const float* peep,
                     const float* h0, const float* c0, const float* mask,
                     void* hs, float* cs, void* stash, void* hx, float* hcar,
                     unsigned* flags, int B, int T, int H,
                     cudaStream_t stream) {
  return fwd<float>(xg, w, peep, h0, c0, mask, hs, cs, stash, hx, hcar,
                    flags, B, T, H, stream);
}
cudaError_t lstm_fwd_bf16(const void* xg, const void* w, const float* peep,
                          const float* h0, const float* c0,
                          const float* mask, void* hs, float* cs, void* stash,
                          void* hx, float* hcar, unsigned* flags, int B,
                          int T, int H, cudaStream_t stream) {
  return fwd<rnn_step::bf16>(xg, w, peep, h0, c0, mask, hs, cs, stash, hx,
                             hcar, flags, B, T, H, stream);
}

// stash [B,T,4H], cs [B,T,H], w [H,4H], peep [3,H], c0 [B,H], mask
// [B,T], dhs/dcs [B,T,H]; outputs dxg [B,T,4H], dh0/dc0 [B,H] and dpart
// [RG,3,H] (zero-filled; dpeep = its sum over the first axis); carry
// [2,B,H] is scratch; dgx [2,RG,2,2,nks,32,16 bytes] and counters [RG]
// are zero-filled scratch (RG = ceil(B/32), nks = ceil(2H/8) for float
// and ceil(2H/16) for bfloat16). stash, w, dhs, dcs, dxg and dgx are
// float in lstm_bwd and bfloat16 in lstm_bwd_bf16; the rest float32.
cudaError_t lstm_bwd(const void* stash, const float* cs, const void* w,
                     const float* peep, const float* c0, const float* mask,
                     const void* dhs, const void* dcs, void* dxg, float* dh0,
                     float* dc0, float* dpart, float* carry, void* dgx,
                     unsigned* counters, int B, int T, int H,
                     cudaStream_t stream) {
  return bwd<float>(stash, cs, w, peep, c0, mask, dhs, dcs, dxg, dh0, dc0,
                    dpart, carry, dgx, counters, B, T, H, stream);
}
cudaError_t lstm_bwd_bf16(const void* stash, const float* cs, const void* w,
                          const float* peep, const float* c0,
                          const float* mask, const void* dhs, const void* dcs,
                          void* dxg, float* dh0, float* dc0, float* dpart,
                          float* carry, void* dgx, unsigned* counters, int B,
                          int T, int H, cudaStream_t stream) {
  return bwd<rnn_step::bf16>(stash, cs, w, peep, c0, mask, dhs, dcs, dxg,
                             dh0, dc0, dpart, carry, dgx, counters, B, T, H,
                             stream);
}

}  // extern "C"
