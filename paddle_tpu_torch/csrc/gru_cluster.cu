// The bfloat16 GRU for Hopper (sm_90a) as one thread-block cluster per
// row group: the forward (B5) and the reverse-time backward (B6) that the
// bf16 AMP path launches wherever the plan takes the shape
// (kernels/gru_cell.py `cluster_plan`; gru_cell.cu's kernels take the
// other shapes and the float32 inputs).
//
// Built by paddle_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes: every entry point below is `extern "C"`, takes
// raw device pointers and a stream, launches on that stream without
// synchronising, allocates nothing, and returns the cudaError_t of the
// launch (0 on success).
//
// Layout and dtypes are gru_cell.cu's: xg [B, T, 3H], columns [u | r |
// c~] in blocks of H, W [H, 3H] = [w_ur | w_c], hs, the stash of u, r, c,
// dhs and dxg in bfloat16; h0, mask [B, T] and dh0 in float32, and so are
// the carried h and dh, the gates and every sum. h_{t-1} and r h_{t-1}
// (B5; r h_{t-1} formed from the float32 carried h) and da_c, da_ur (B6)
// are rounded to bf16 just before their products, as the JAX kernels
// round them (astype(w.dtype)); B6 reads h_{t-1} from the stored hs and h0
// in float32 at t = 0.
//
// ---------------------------------------------------------------------
// gru_fwd_cluster (B5) replaces paddle_tpu/kernels/gru_cell.py
// `_fwd_kernel` (the pallas_call in `_fwd_pallas`); gru_bwd_cluster (B6)
// replaces `_bwd_kernel` (the pallas_call in `_bwd_pallas`). dW is two
// GEMMs outside the kernel, as in the JAX package.
//
// What bounds them. At the seq2seq training path's shape (B 64, T 30, H
// 512) the recurrence is 3.02 GFLOP, 3.1 us at 989 TFLOP/s, and its bytes
// (15-18 MB) 4.6-5.3 us: the chain of 30 dependent steps bounds them, and
// each step holds two dependent exchanges across the row group. B5's c
// needs r h_{t-1} of every unit of the row, so a step all-gathers h_{t-1}
// and then r h_{t-1}; B6's da_r needs drh = da_c W_c^T summed over every
// unit, and the carry da_ur W_ur^T in turn, so a step reduce-scatters
// twice. gru_cell.cu's bf16 kernels pay 5.6 us (B5) and 6.3 us (B6) a
// step, each exchange through device memory with a fence, an atomic
// counter and polling of L2; these pay 2.9 and 3.2 us, of which the two
// exchanges and their waits alone (no product, no cell) take 1.8 and 2.3
// us, and ~14 us a call of launch, staging W and drain (on an H100 80GB
// HBM3 at 700 W: lstm_breakdown.py --gru-bf16 times both designs and the
// parts of this one). So the two exchanges' latency bounds these kernels,
// at ~4x the bytes bound.
//
// The design, in both kernels (lstm_cluster.cu's, with two exchanges):
// * One cluster of nb = ceil(H / 32) blocks (16 at H 512, non-portable)
//   per row group of R = 16 batch rows, 256 threads (two warpgroups) a
//   block. Block r owns units [32 r, 32 r + 32) and keeps its columns of
//   W (u, r and c of its units: 96 KB at H 512) in REGISTERS for the
//   whole sequence as the A operand of wgmma, staged once by 16-byte
//   cp.async in the swizzle and loaded by ldmatrix. Row groups are
//   independent: no cooperative launch.
// * B5's products are transposed (M the gate columns, N the 16 rows, K
//   the 512 units of h): u and r of the block's units are one m64 tile of
//   W_ur^T (row 16 w + g + 8 q is gate q of unit 8 w + g, so a thread
//   holds u and r of its unit), c half of one (rows 16 w + 8 .. 15 zero).
//   The two warpgroups split K: warpgroup wg takes K rows [256 wg, 256 wg
//   + 256) of both products, 16 dependent m64n16k16 steps instead of 32,
//   and the halves' sums meet through shared memory, warpgroup 0's first
//   (each warpgroup then runs the cells of 8 of the 16 rows, two a
//   thread; a swap waits for the partner warp only). The step: wait for h_{t-1}; u, r; r h_{t-1} of the block's
//   units (float32, then rounded) all-gathered; wait for it; c and h_t;
//   h_t all-gathered. Each all-gather is one 1 KB bulk copy to each peer
//   (the block's [16 x 32] bf16 slice is one sub-tile of the 64-byte
//   swizzle, the products' B).
// * B6's products run over M = 512 units (8 m64 tiles, 4 a warpgroup),
//   N the 16 rows and K the block's own columns: drh's partial W_c[:,
//   own 32]·da_c^T (K 32) and the carry's W_ur[:, own 64]·da_ur^T (K
//   64, u's columns first). Each is reduce-scattered: every block's [32
//   units x 16] float32 piece of another block's units goes by st.async
//   straight from the accumulators, the owner adding the nb pieces in rank
//   order (rnn_cluster.cuh; its own piece, stored by two of its warps,
//   completes the same mbarrier by their arrivals, so no barrier of the
//   block waits for it; the pieces' loads issued together). da_u does not wait for drh, so the carry's
//   da_u half runs beside drh's product and only its da_r half (K 32)
//   stays on the chain after drh has arrived. The step: the carry's
//   pieces of step s - 1; dh, da_c, da_u (phase A, one thread a unit and
//   two rows, in the layout the pieces arrive in); drh's product and the
//   carry's da_u half; drh reduce-scattered; wait for it; da_r, the
//   carry's da_r half; the carry reduce-scattered.
// * Inputs by TMA through a ring of 8 steps (B5: xg's [16 x 3 x 32] gate
//   block and the mask; B6: the stash's gate block, h_{t-1} (hs, or h0 in
//   float32), dhs_t and the mask), outputs by TMA stores from shared
//   memory (B5: the stash and hs; B6: dxg). The threads of the chain
//   issue no load or store to device memory in the loop (B6 stores dh0
//   after it).
// * The products run over 512 units whatever H is (zeros past it): a
//   product bounded at run time makes ptxas serialise the wgmma
//   instructions. The cell's nonlinearities on the special function unit
//   (rnn_cluster.cuh: within a few ulp of float32).
//
// One buffer of each exchange is enough, though a step has two and a
// block reuses each at the next step. In B5 a block sends h_t into its
// peers' h buffer only after it has received r h_{t-1} ... r h_t from
// every peer, which each peer sent after its own product had read h_{t-1}
// from that buffer (and after the wait that completed the buffer's
// mbarrier phase, so no phase receives two steps' bytes); it sends r h_t
// only after it has received h_{t-1}, which each peer sent after its
// product of c had read r h_{t-1}. The same holds for a block's own slice,
// which its peers copy out of its shared memory: it is rewritten only
// after every peer has sent what it could send only once the copy had
// landed. B6 alike: a block sends drh's pieces of step s + 1 only after it
// has received the carry's pieces of step s from every peer, each sent
// after that peer had summed drh's pieces of step s, and it sends the
// carry's pieces of step s + 1 only after drh's of step s + 1 have come
// from every peer, each sent after that peer had summed the carry's of
// step s. No float atomics: every sum has a fixed order, so two runs give
// the same bits. A wait that does not end within 10 s traps.
// ---------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "rnn_cluster.cuh"
#include "rnn_step.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hopper::desc;
using hopper::fence_regs;
using hopper::smem_u32;
namespace rc = rnn_cluster;
using rc::bf;
using rc::kHead;
using rc::kRows;
using rc::sw128;
using rc::sw64;

constexpr int kThreads = 256;   // two warpgroups, in both kernels
constexpr int kFwdStages = 8;   // B5's ring of inputs, steps ahead
constexpr int kBwdStages = 8;   // B6's

// The products run over the largest cluster's units whatever H is.
constexpr int kKp = rc::kMaxCluster * rc::kUnits;   // 512
constexpr int kKsWg = kKp / 16 / 2;   // B5: k16 steps of a warpgroup's K half
constexpr int kMTiles = kKp / 64;     // B6: m64 tiles of units
constexpr int kTilesWg = kMTiles / 2;   // ... a warpgroup

// Boxes of R rows x 32 units (TMA, dense in shared memory): a gate block
// [R][3][32] bf16, a [R][32] float32 or bf16 plane, R float32 mask
// values (in a 128-byte slot); a block's [R x 32] bf16 slice of an
// all-gather or of a product's B, one sub-tile of the 64-byte swizzle.
constexpr int kGates = kRows * 3 * rc::kUnits * 2;
constexpr int kPlaneF = kRows * rc::kUnits * 4;
constexpr int kPlaneH = kRows * rc::kUnits * 2;
constexpr int kMask = 128;
constexpr int kSlice = kRows * 64;
static_assert(kRows * 4 <= kMask, "the mask's slot");
static_assert(kSlice == kPlaneH, "a slice is one bf16 plane");

// B5's shared memory: W_ur^T's slice (K rows of 128 bytes: u and r of
// 32 units) and W_c^T's (K rows of 64 bytes) staged for the registers,
// the h and r h buffers of kMaxCluster slices each, kFwdOutSlots slots of
// the outputs on their way out (the stash's gate block, hs), the
// warpgroups' swaps of sums (u, r: a float4 a thread; c: a float2), and
// the ring of inputs (xg's gate block and the mask).
constexpr int kFwdOutSlots = 3;
constexpr int kFwdWur = kKp * 128;
constexpr int kFwdWc = kKp * 64;
constexpr int kFwdX = rc::kMaxCluster * kSlice;
constexpr int kFwdOut = kGates + kPlaneH;
constexpr int kFwdSwap = kThreads * (16 + 8);
constexpr int kFwdStage = kGates + kMask;
constexpr size_t kFwdSmem = (size_t)kHead + kFwdWur + kFwdWc + 2 * kFwdX +
                            kFwdOutSlots * kFwdOut + kFwdSwap +
                            kFwdStages * kFwdStage;
// B6's: the products' B (da_c, da_u, da_r: one slice each), kBwdOutSlots
// slots of dxg's gate block on their way out, the two receive buffers of
// nb float32 pieces of 32 x R (drh's, the carry's; before the first step
// the same bytes, and more, stage W's rows for the registers: kMTiles m64
// tiles of W_c's 32 columns (64-byte rows) and of W_ur's 64 (128-byte
// rows)), and the ring of inputs (the stash's gate block, h_{t-1} in
// room for float32, dhs_t and the mask). The gathers read kMaxCluster
// pieces' places of either buffer, which lie in those bytes (the first
// nb are summed).
constexpr int kBwdOutSlots = 3;
constexpr int kBwdDa = 3 * kSlice;
constexpr int kBwdWc = kMTiles * 64 * 64;
constexpr int kBwdWur = kMTiles * 64 * 128;
constexpr int kPiece = rc::kUnits * kRows * 4;
constexpr int kBwdStage = kGates + kPlaneF + kPlaneH + kMask;
size_t bwd_smem(int nb) {
  const size_t x = 2 * (size_t)nb * kPiece, w = kBwdWc + kBwdWur;
  return (size_t)kHead + kBwdDa + kBwdOutSlots * kGates + (x > w ? x : w) +
         kBwdStages * kBwdStage;
}

// =====================================================================
// gru_fwd_cluster (B5)
// =====================================================================

struct FwdArgs {
  // TMA: xg and the stash as [B][T][3][H] bf16, hs [B][T][H] bf16, in
  // boxes of 32 units x R rows; the mask as [T][B] float32 in boxes of R
  // rows
  CUtensorMap tm_xg, tm_mask, tm_hs, tm_stash;
  const bf16* w;
  const float* h0;
  int B, T, H, nb;
};

// Thread (warpgroup wg, warp w, lane 4 g + t) holds, of both products,
// K half wg's sums for unit j = 8 w + g and rows 8 i + 2 t + e; after
// each swap it runs the cells of rows n = 8 wg + 2 t + e (cell e).
__global__ void __launch_bounds__(kThreads, 1)
    gru_fwd_cluster_kernel(const __grid_constant__ FwdArgs a) {
  constexpr int NC = 2;   // cells a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* hbar = reinterpret_cast<uint64_t*>(smem_raw);   // h_{t-1}
  uint64_t* rbar = hbar + 1;                                // r h_{t-1}
  uint64_t* xfull = hbar + 2;                     // [kFwdStages]: inputs
  const int nb = a.nb, H = a.H, T_ = a.T;
  unsigned char* wur = rc::tiles(smem_raw);
  unsigned char* wc = wur + kFwdWur;
  unsigned char* hb = wc + kFwdWc;
  unsigned char* rb = hb + kFwdX;
  unsigned char* outs = rb + kFwdX;
  float4* xur = reinterpret_cast<float4*>(outs + kFwdOutSlots * kFwdOut);
  float2* xc = reinterpret_cast<float2*>(xur + kThreads);
  unsigned char* ring = reinterpret_cast<unsigned char*>(xc + kThreads);
  const unsigned xbytes = (nb - 1) * kSlice;   // the peers' slices
  const unsigned rank = rc::cluster_rank();
  const int rg = blockIdx.x / nb, r0 = rg * kRows;
  const int u0 = rc::kUnits * (int)rank;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wl = warp % 4, g = lane / 4, t4 = lane % 4;
  const size_t G3 = 3 * (size_t)H;

  // step t's inputs into ring slot t % kFwdStages, by thread 0
  auto load = [&](int t) {
    const int sl = t % kFwdStages;
    unsigned char* st = ring + sl * kFwdStage;
    hopper::mbar_expect_tx(&xfull[sl], kGates + kRows * 4);
    hopper::tma_load_4d(st, &a.tm_xg, &xfull[sl], u0, 0, t, r0);
    hopper::tma_load_2d(st + kGates, &a.tm_mask, &xfull[sl], r0, t);
  };
  if (tid == 0) {
    hopper::mbar_init(hbar, 1);
    hopper::mbar_init(rbar, 1);
    for (int i = 0; i < kFwdStages; ++i) hopper::mbar_init(&xfull[i], 1);
    hopper::mbar_fence_init();
    for (int t = 0; t < kFwdStages && t < T_; ++t) load(t);
  }
  // W's columns of the block, staged MN-major (zeros past H): K row k of
  // W_ur^T, 16-byte chunk c = 2 w + q: gate q (u, r) of units u0 + 8 w ..
  // + 7; K row k of W_c^T, chunk w: the candidate's of the same units
  for (int idx = tid; idx < kKp * 12; idx += kThreads) {
    const int k = idx / 12, c = idx % 12;
    const bool ur = c < 8;
    const int q = ur ? c % 2 : 2, j0 = 8 * (ur ? c / 2 : c - 8);
    const bool ok = k < H && u0 + j0 < H;
    const bf16* src =
        ok ? a.w + (size_t)k * G3 + (size_t)q * H + u0 + j0 : a.w;
    rnn_step::cp16(ur ? wur + sw128(k, 16 * c) : wc + sw64(k, 16 * (c - 8)),
                   src, ok);
  }
  rnn_step::cp_commit();
  // the slices past the cluster's blocks stay zero in both buffers
  for (int i = nb * kSlice / 16 + tid; i < kFwdX / 16; i += kThreads) {
    reinterpret_cast<uint4*>(hb)[i] = make_uint4(0, 0, 0, 0);
    reinterpret_cast<uint4*>(rb)[i] = make_uint4(0, 0, 0, 0);
  }

  const int j = 8 * wl + g;   // this thread's unit of the block
  const bool unit_ok = u0 + j < H;
  unsigned char* own_h = hb + rank * kSlice;   // this block's slices
  unsigned char* own_r = rb + rank * kSlice;
  float hreg[NC];   // the carried h of the thread's cells, float32
  bool live[NC];
#pragma unroll
  for (int e = 0; e < NC; ++e) {
    const int n = 8 * wg + 2 * t4 + e, b = r0 + n;
    live[e] = unit_ok && b < a.B;
    hreg[e] = live[e] ? a.h0[(size_t)b * H + u0 + j] : 0.f;
    *reinterpret_cast<bf16*>(own_h + sw64(n, 2 * j)) =
        __float2bfloat16_rn(hreg[e]);
  }
  rnn_step::cp_wait<0>();
  __syncthreads();   // W is staged
  // warpgroup wg's K half of both products into registers, the A
  // operand: k16 step kk as the warp's 16 x 16 fragment (matrices: rows
  // 16 w (+ 8), K 16 kk (+ 8)); W_c^T's rows 16 w + 8 .. 15 are zero, so
  // only its registers 0 and 2 are loaded
  unsigned wur_f[kKsWg][4], wc_f[kKsWg][2];
  {
    const int mi = lane / 8, k_in = lane % 8;
#pragma unroll
    for (int kk = 0; kk < kKsWg; ++kk) {
      const int k0 = 16 * (kKsWg * wg + kk);
      rc::ldsm_x4_trans(wur_f[kk], wur + sw128(k0 + 8 * (mi >> 1) + k_in,
                                               16 * (2 * wl + (mi & 1))));
      rc::ldsm_x2_trans(wc_f[kk],
                        wc + sw64(k0 + 8 * (mi & 1) + k_in, 16 * wl));
    }
  }
  hopper::fence_proxy_async();
  // every block's mbarriers exist, h0's slice is in place
  rc::cluster_sync();
  if (tid == 0) rc::expect(hbar, xbytes);
  if (warp == 1) rc::all_gather(own_h, kSlice, hbar, rank, nb, lane);

  const unsigned zero = 0u;
  const unsigned ha = smem_u32(hb), ra = smem_u32(rb);
  for (int t = 0; t < T_; ++t) {
    const unsigned ph = t & 1;
    // ---- u, r: this warpgroup's K half of h_{t-1} W_ur ----
    rc::wait(hbar, ph);
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKsWg; ++kk) {
      const int ks = kKsWg * wg + kk;   // two k16 steps a block's slice
      hopper::wgmma_rs_n16<0>(
          acc, wur_f[kk], desc(ha + (ks / 2) * kSlice + (ks % 2) * 32, 512, 2),
          1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_regs(acc);
    // acc[4 i + 2 q + e]: gate q of unit j, row 8 i + 2 t + e; the other
    // warpgroup's rows go to it, its sums for this one's come back
    xur[tid] = wg == 0 ? make_float4(acc[4], acc[5], acc[6], acc[7])
                       : make_float4(acc[0], acc[1], acc[2], acc[3]);
    const int sl = t % kFwdStages;
    const unsigned char* in = ring + sl * kFwdStage;
    hopper::mbar_wait(&xfull[sl], (t / kFwdStages) & 1);
    rc::pair_sync(1 + wl);   // the sums swapped with warp wl of the other
    const float4 pv = xur[tid ^ 128];
    float gu[NC], gr[NC];
#pragma unroll
    for (int e = 0; e < NC; ++e) {
      const int n = 8 * wg + 2 * t4 + e, x0 = n * 3 * rc::kUnits + j;
      // the K halves in order, warpgroup 0's first; by selects: no
      // register array is indexed at run time
      const float mu = wg == 0 ? acc[e] : acc[4 + e];
      const float mr = wg == 0 ? acc[2 + e] : acc[6 + e];
      const float ou = e == 0 ? pv.x : pv.y;
      const float orr = e == 0 ? pv.z : pv.w;
      gu[e] = rc::sigm_fast(bf(in, x0) + (wg == 0 ? mu + ou : ou + mu));
      gr[e] = rc::sigm_fast(bf(in, x0 + rc::kUnits) +
                            (wg == 0 ? mr + orr : orr + mr));
      // r h_{t-1} from the float32 carry, rounded for the product
      *reinterpret_cast<bf16*>(own_r + sw64(n, 2 * j)) =
          __float2bfloat16_rn(gr[e] * hreg[e]);
    }
    hopper::fence_proxy_async();
    __syncthreads();   // r h_{t-1}'s slice written
    if (tid == 0) rc::expect(rbar, xbytes);
    if (warp == 1) rc::all_gather(own_r, kSlice, rbar, rank, nb, lane);

    // ---- c: this warpgroup's K half of (r h_{t-1}) W_c ----
    rc::wait(rbar, ph);
    float acc2[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc2[i] = 0.f;
    fence_regs(acc2);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKsWg; ++kk) {
      const int ks = kKsWg * wg + kk;
      const unsigned af[4] = {wc_f[kk][0], zero, wc_f[kk][1], zero};
      hopper::wgmma_rs_n16<0>(
          acc2, af, desc(ra + (ks / 2) * kSlice + (ks % 2) * 32, 512, 2), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_regs(acc2);
    // acc2[4 i + e]: the candidate's sum of unit j, row 8 i + 2 t + e
    // (acc2[4 i + 2 + e]: the zero rows)
    xc[tid] = wg == 0 ? make_float2(acc2[4], acc2[5])
                      : make_float2(acc2[0], acc2[1]);
    rc::pair_sync(1 + wl);   // the sums swapped
    const float2 pc = xc[tid ^ 128];
    unsigned char* out = outs + (t % kFwdOutSlots) * kFwdOut;
    bf16* o_st = reinterpret_cast<bf16*>(out);
    bf16* o_hs = reinterpret_cast<bf16*>(out + kGates);
#pragma unroll
    for (int e = 0; e < NC; ++e) {
      const int n = 8 * wg + 2 * t4 + e, x0 = n * 3 * rc::kUnits + j;
      const float mc = wg == 0 ? acc2[e] : acc2[4 + e];
      const float oc = e == 0 ? pc.x : pc.y;
      const float c =
          rc::tanh_fast(bf(in, x0 + 2 * rc::kUnits) +
                        (wg == 0 ? mc + oc : oc + mc));
      const float m = reinterpret_cast<const float*>(in + kGates)[n];
      const float h_prev = hreg[e];
      float h_t = gu[e] * h_prev + (1.f - gu[e]) * c;
      h_t = m * h_t + (1.f - m) * h_prev;
      hreg[e] = live[e] ? h_t : 0.f;
      const bf16 hv = __float2bfloat16_rn(hreg[e]);
      if (t + 1 < T_) *reinterpret_cast<bf16*>(own_h + sw64(n, 2 * j)) = hv;
      // the outputs into their slot, in the boxes' layout
      o_hs[n * rc::kUnits + j] = hv;
      o_st[n * 3 * rc::kUnits + j] = __float2bfloat16_rn(gu[e]);
      o_st[(n * 3 + 1) * rc::kUnits + j] = __float2bfloat16_rn(gr[e]);
      o_st[(n * 3 + 2) * rc::kUnits + j] = __float2bfloat16_rn(c);
    }
    hopper::fence_proxy_async();
    __syncthreads();   // h_t's slice and the outputs written, slot sl read
    // This block's arrival first (no thread passes it before the output
    // slot it writes next, that of step t + 1 - kFwdOutSlots, is read
    // out: thread 0 waited for it at step t - 1), the slice to the peers
    // from another warp, then the outputs by TMA and the next inputs.
    if (t + 1 < T_) {
      if (tid == 0) rc::expect(hbar, xbytes);
      if (warp == 1) rc::all_gather(own_h, kSlice, hbar, rank, nb, lane);
    }
    if (tid == 0) {
      hopper::tma_store_4d(&a.tm_stash, o_st, u0, 0, t, r0);
      hopper::tma_store_3d(&a.tm_hs, o_hs, u0, t, r0);
      hopper::bulk_commit();
      hopper::bulk_wait_read<kFwdOutSlots - 2>();
      if (t + kFwdStages < T_) load(t + kFwdStages);
    }
  }
  if (tid == 0) hopper::bulk_wait<0>();
  rc::cluster_sync();   // no block leaves while a peer may still copy
}

// =====================================================================
// gru_bwd_cluster (B6)
// =====================================================================

struct BwdArgs {
  // TMA: the stash and dxg as [B][T][3][H] bf16, hs and dhs [B][T][H]
  // bf16, h0 [B][H] float32, in boxes of 32 units x R rows; the mask as
  // [T][B] float32 in boxes of R rows
  CUtensorMap tm_stash, tm_hs, tm_h0, tm_dhs, tm_mask, tm_dxg;
  const bf16* w;
  float* dh0;
  int B, T, H, nb;
};

// Thread tid runs the gate gradients of unit ju = tid % 64 / 2 for half
// hf = tid % 2 of the quad of rows tid / 64 (rc::piece_row), the layout
// its sums arrive in: two (row, unit) pairs a thread, and a warp's 8-byte
// loads of a piece 256 contiguous bytes (the two halves of 16 units'
// quads; two wavefronts, where lanes of one half and 32 units would take
// four). In the products, warpgroup wg takes the m64 tiles 4 wg .. 4 wg +
// 3 of units.
__global__ void __launch_bounds__(kThreads, 1)
    gru_bwd_cluster_kernel(const __grid_constant__ BwdArgs a) {
  constexpr int NR = kRows / 2;   // accumulator registers of an m64nR tile
  static_assert(rc::kUnits * kRows / 2 == kThreads, "half a quad a thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* dbar = reinterpret_cast<uint64_t*>(smem_raw);   // drh's pieces
  uint64_t* cbar = dbar + 1;                         // the carry's pieces
  uint64_t* xfull = dbar + 2;                     // [kBwdStages]: inputs
  const int nb = a.nb, H = a.H, T_ = a.T;
  unsigned char* dac = rc::tiles(smem_raw);   // the products' B
  unsigned char* dau = dac + kSlice;
  unsigned char* dar = dau + kSlice;
  unsigned char* odx = dac + kBwdDa;   // dxg's gate blocks
  float* rdrh = reinterpret_cast<float*>(odx + kBwdOutSlots * kGates);
  const int rfloats = nb * kPiece / 4;
  float* rcar = rdrh + rfloats;
  unsigned char* wcs = reinterpret_cast<unsigned char*>(rdrh);   // staged
  unsigned char* wurs = wcs + kBwdWc;
  unsigned char* ring =
      wcs + (2 * rfloats * 4 > kBwdWc + kBwdWur ? 2 * rfloats * 4
                                                : kBwdWc + kBwdWur);
  const unsigned xbytes = (unsigned)((nb - 1) * kPiece);   // the peers'
  const unsigned rank = rc::cluster_rank();
  const int rg = blockIdx.x / nb, r0 = rg * kRows;
  const int u0 = rc::kUnits * (int)rank;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wl = warp % 4;
  const int mt0 = wg * kTilesWg;
  const size_t G3 = 3 * (size_t)H;

  // step s's inputs (t = T - 1 - s) into ring slot s % kBwdStages, by
  // thread 0: the stash's gate block, h_{t-1} (hs, or h0 in float32 at t
  // = 0), dhs_t, the mask
  auto load = [&](int s) {
    const int t = T_ - 1 - s, sl = s % kBwdStages;
    unsigned char* st = ring + sl * kBwdStage;
    hopper::mbar_expect_tx(&xfull[sl], kGates + (t ? kPlaneH : kPlaneF) +
                                           kPlaneH + kRows * 4);
    hopper::tma_load_4d(st, &a.tm_stash, &xfull[sl], u0, 0, t, r0);
    if (t)
      hopper::tma_load_3d(st + kGates, &a.tm_hs, &xfull[sl], u0, t - 1, r0);
    else
      hopper::tma_load_2d(st + kGates, &a.tm_h0, &xfull[sl], u0, r0);
    hopper::tma_load_3d(st + kGates + kPlaneF, &a.tm_dhs, &xfull[sl], u0, t,
                        r0);
    hopper::tma_load_2d(st + kGates + kPlaneF + kPlaneH, &a.tm_mask,
                        &xfull[sl], r0, t);
  };
  if (tid == 0) {
    // each completes by thread 0's arrival, the peers' bytes and the
    // arrivals of the threads that store this block's own piece
    hopper::mbar_init(dbar, 1 + rc::kOwnArrivals);
    hopper::mbar_init(cbar, 1 + rc::kOwnArrivals);
    for (int i = 0; i < kBwdStages; ++i) hopper::mbar_init(&xfull[i], 1);
    hopper::mbar_fence_init();
    for (int s = 0; s < kBwdStages && s < T_; ++s) load(s);
  }
  // W's rows, staged K-major (zeros past H): m64 tile mt of units, row m;
  // chunks 0 .. 3 W_c's columns of units u0 + 8 c .. + 7 (64-byte rows),
  // chunks 4 .. 11 W_ur's: chunk 4 + 4 q + c gate q (u, r) of units u0 +
  // 8 c .. + 7 (128-byte rows)
  for (int idx = tid; idx < kMTiles * 64 * 12; idx += kThreads) {
    const int c = idx % 12, m = idx / 12 % 64, mt = idx / 12 / 64;
    const int uu = 64 * mt + m;
    const bool cand = c < 4;
    const int q = cand ? 2 : (c - 4) / 4, j0 = 8 * (cand ? c : (c - 4) % 4);
    const bool ok = uu < H && u0 + j0 < H;
    const bf16* src =
        ok ? a.w + (size_t)uu * G3 + (size_t)q * H + u0 + j0 : a.w;
    rnn_step::cp16(cand ? wcs + mt * 4096 + sw64(m, 16 * c)
                        : wurs + mt * 8192 + sw128(m, 16 * (c - 4)),
                   src, ok);
  }
  rnn_step::cp_commit();
  rnn_step::cp_wait<0>();
  __syncthreads();   // W's rows are staged
  // ... then into registers, the products' A: warpgroup wg's m64 tiles,
  // k16 step kk as the warp's 16 x 16 fragment (matrices: units 16 w (+
  // 8), columns 16 kk (+ 8)); the carry's k16 steps 0, 1 are u's columns,
  // 2, 3 r's
  unsigned wc_f[kTilesWg][2][4], wur_f[kTilesWg][4][4];
  {
    const int mi = lane / 8, m = 16 * wl + 8 * (mi & 1) + lane % 8;
#pragma unroll
    for (int i = 0; i < kTilesWg; ++i) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        rc::ldsm_x4(wc_f[i][kk], wcs + (mt0 + i) * 4096 +
                                     sw64(m, 2 * (16 * kk + 8 * (mi >> 1))));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        rc::ldsm_x4(wur_f[i][kk],
                    wurs + (mt0 + i) * 8192 +
                        sw128(m, 2 * (16 * kk + 8 * (mi >> 1))));
    }
  }

  const int ju = tid % 64 / 2, quad = tid / 64, hf = tid % 2;
  const int u = u0 + ju;
  const bool unit_ok = u < H;
  int rows[2];
  bool live[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    rows[e] = rc::piece_row(quad, 2 * hf + e);
    live[e] = unit_ok && r0 + rows[e] < a.B;
  }
  float keep[2] = {}, dhv[2] = {};   // (dh u + drh r) m + (1 - m) dh; dh
  // every block's mbarriers exist, and no block has W's rows staged where
  // its peers' pieces are about to land
  rc::cluster_sync();
  if (tid == 0) {
    rc::expect(dbar, xbytes);
    rc::expect(cbar, xbytes);
  }
  const unsigned dca = smem_u32(dac), dua = smem_u32(dau),
                 dra = smem_u32(dar);

  for (int s = 0; s < T_; ++s) {
    const int t = T_ - 1 - s, sl = s % kBwdStages;
    const unsigned char* in = ring + sl * kBwdStage;
    const unsigned char* in_hp = in + kGates;
    const unsigned char* in_dh = in_hp + kPlaneF;
    const float* in_m = reinterpret_cast<const float*>(in_dh + kPlaneH);
    bf16* o_dx = reinterpret_cast<bf16*>(odx + (s % kBwdOutSlots) * kGates);
    // ---- phase A: dh, da_c and da_u of this thread's two pairs ----
    // dh_t's carry: the local part, then the nb pieces of step s - 1 in
    // rank order
    float carry[2] = {0.f, 0.f};
    if (s) {
      // then the next phase's arrival: thread 0 has read out dxg's slot
      // of step s + 1 - kBwdOutSlots at step s - 1, and no thread writes
      // it before this phase completes
      rc::wait(cbar, (s - 1) & 1);
      if (tid == 0) rc::expect(cbar, xbytes);
      const float2 sum =
          rc::gather_sum<kRows, rc::kMaxCluster>(rcar, nb, ju, quad, hf);
      carry[0] = keep[0] + sum.x;
      carry[1] = keep[1] + sum.y;
    }
    hopper::mbar_wait(&xfull[sl], (s / kBwdStages) & 1);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = rows[e], x0 = n * 3 * rc::kUnits + ju;
      const float gu = bf(in, x0), gc = bf(in, x0 + 2 * rc::kUnits);
      const float hp =
          t ? bf(in_hp, n * rc::kUnits + ju)
            : reinterpret_cast<const float*>(in_hp)[n * rc::kUnits + ju];
      const float m = in_m[n];
      const float dh = bf(in_dh, n * rc::kUnits + ju) + carry[e];
      const float da_c = m * dh * (1.f - gu) * (1.f - gc * gc);
      const float da_u = m * dh * (hp - gc) * gu * (1.f - gu);
      dhv[e] = dh;
      const bf16 vc = __float2bfloat16_rn(live[e] ? da_c : 0.f);
      const bf16 vu = __float2bfloat16_rn(live[e] ? da_u : 0.f);
      *reinterpret_cast<bf16*>(dac + sw64(n, 2 * ju)) = vc;
      *reinterpret_cast<bf16*>(dau + sw64(n, 2 * ju)) = vu;
      o_dx[(n * 3 + 2) * rc::kUnits + ju] = vc;
      o_dx[n * 3 * rc::kUnits + ju] = vu;
    }
    hopper::fence_proxy_async();
    __syncthreads();   // da_c and da_u are in their tiles

    // ---- drh's partials over this block's units, and the carry's da_u
    //      half, then drh's pieces to the blocks that own them ----
    float acc2[kTilesWg][NR];   // the carry's partials
#pragma unroll
    for (int i = 0; i < kTilesWg; ++i) {
#pragma unroll
      for (int r = 0; r < NR; ++r) acc2[i][r] = 0.f;
      fence_regs(acc2[i]);
    }
    // drh in two rounds of two tiles, which keeps fewer sums live, with
    // the carry's da_u half committed after the first: each round's
    // pieces leave while the next products run
    float acc[2][NR];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int r = 0; r < NR; ++r) acc[i][r] = 0.f;
        fence_regs(acc[i]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t db = desc(dca + kk * 32, 512, 2);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          hopper::wgmma_rs_n16<0>(acc[i], wc_f[2 * half + i][kk], db, 1);
      }
      hopper::wgmma_commit();
      if (half == 0) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint64_t db = desc(dua + kk * 32, 512, 2);
#pragma unroll
          for (int i = 0; i < kTilesWg; ++i)
            hopper::wgmma_rs_n16<0>(acc2[i], wur_f[i][kk], db, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();   // this round's, not the da_u half
      } else {
        hopper::wgmma_wait<0>();
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        fence_regs(acc[i]);
        rc::scatter_tile<kRows, true>(acc[i], 64 * (mt0 + 2 * half + i),
                                      rc::kUnits * nb, rdrh, dbar, rank, wl,
                                      lane);
      }
    }
#pragma unroll
    for (int i = 0; i < kTilesWg; ++i) fence_regs(acc2[i]);

    // ---- da_r once drh has come from every block ----
    rc::wait(dbar, s & 1);
    if (tid == 0 && s + 1 < T_) rc::expect(dbar, xbytes);
    {
      const float2 d =
          rc::gather_sum<kRows, rc::kMaxCluster>(rdrh, nb, ju, quad, hf);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = rows[e], x0 = n * 3 * rc::kUnits + ju;
        const float gu = bf(in, x0), gr = bf(in, x0 + rc::kUnits);
        const float hp =
            t ? bf(in_hp, n * rc::kUnits + ju)
              : reinterpret_cast<const float*>(in_hp)[n * rc::kUnits + ju];
        const float m = in_m[n];
        const float drh = e == 0 ? d.x : d.y;
        const float da_r = m * drh * hp * gr * (1.f - gr);
        const float dh = dhv[e];
        keep[e] = live[e] ? (dh * gu + drh * gr) * m + (1.f - m) * dh : 0.f;
        const bf16 vr = __float2bfloat16_rn(live[e] ? da_r : 0.f);
        *reinterpret_cast<bf16*>(dar + sw64(n, 2 * ju)) = vr;
        o_dx[(n * 3 + 1) * rc::kUnits + ju] = vr;
      }
    }
    hopper::fence_proxy_async();
    __syncthreads();   // da_r is in its tile, dxg's block whole, slot sl read
    // dxg leaves by TMA, and the next inputs come: these threads issue no
    // store to device memory in the loop
    if (tid == 0) {
      hopper::tma_store_4d(&a.tm_dxg, o_dx, u0, 0, t, r0);
      hopper::bulk_commit();
      hopper::bulk_wait_read<1>();   // dxg's slot of step s - 1 is free
      if (s + kBwdStages < T_) load(s + kBwdStages);
    }

    // ---- the carry's da_r half, then its pieces to their owners, two
    //      tiles leaving while the other two's products run ----
    hopper::wgmma_fence();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t db = desc(dra + kk * 32, 512, 2);
#pragma unroll
        for (int i = 2 * half; i < 2 * half + 2; ++i)
          hopper::wgmma_rs_n16<0>(acc2[i], wur_f[i][2 + kk], db, 1);
      }
      hopper::wgmma_commit();
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (half == 0)
        hopper::wgmma_wait<1>();
      else
        hopper::wgmma_wait<0>();
#pragma unroll
      for (int i = 2 * half; i < 2 * half + 2; ++i) {
        fence_regs(acc2[i]);
        rc::scatter_tile<kRows, true>(acc2[i], 64 * (mt0 + i),
                                      rc::kUnits * nb, rcar, cbar, rank, wl,
                                      lane);
      }
    }
  }

  // dh0: the local part and the last step's pieces
  if (T_ > 0) {
    rc::wait(cbar, (T_ - 1) & 1);
    const float2 sum =
        rc::gather_sum<kRows, rc::kMaxCluster>(rcar, nb, ju, quad, hf);
    const float v[2] = {sum.x, sum.y};
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (live[e]) a.dh0[(size_t)(r0 + rows[e]) * H + u] = keep[e] + v[e];
  }
  if (tid == 0) hopper::bulk_wait<0>();
  rc::cluster_sync();   // no block leaves while a peer may still store
}

constexpr CUtensorMapDataType kBf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;

// The plan: out[0] whether the cluster kernels take (B, H) (H a multiple
// of 8, at most 32 x 16 units, the shared memory within the card's),
// out[1] blocks a cluster, out[2] rows a cluster, out[3] units a block,
// out[4] clusters (row groups), out[5] clusters the card holds at once
// (the rest queue behind them).
cudaError_t plan(int kind, int B, int H, int* out, size_t* smem) {
  const int nb = (H + rc::kUnits - 1) / rc::kUnits;
  *smem = kind == 0 ? kFwdSmem : bwd_smem(nb);
  size_t optin = 0;
  const cudaError_t e = rc::smem_optin(&optin);
  if (e != cudaSuccess) return e;
  const bool take = H > 0 && H % 8 == 0 && nb <= rc::kMaxCluster &&
                    *smem <= optin;
  out[0] = take;
  out[1] = nb;
  out[2] = kRows;
  out[3] = rc::kUnits;
  out[4] = (B + kRows - 1) / kRows;
  out[5] = 0;
  if (!take) return cudaSuccess;
  const void* kernel = kind == 0 ? (const void*)gru_fwd_cluster_kernel
                                 : (const void*)gru_bwd_cluster_kernel;
  return rc::prepare(kernel, nb, kThreads, *smem, &out[5]);
}

}  // namespace

extern "C" {

// The plan of gru_fwd_cluster (kind 0) or gru_bwd_cluster (kind 1) at
// (B, H) on the current device, in out[0..5] (see `plan`).
cudaError_t gru_cluster_plan(int kind, int B, int H, int* out) {
  size_t smem;
  return plan(kind, B, H, out, &smem);
}

// xg [B,T,3H] and w [H,3H] bfloat16, h0 [B,H] float32, mask_t [T,bp]
// float32 (the mask transposed, bp = B rounded up to 4, the rows past B
// zero); outputs hs [B,T,H] and the stash [B,T,3H] bfloat16; xg, w, hs,
// the stash and mask_t 16-byte aligned. cudaErrorInvalidValue where the
// plan does not take (B, H).
cudaError_t gru_fwd_cluster(const void* xg, const void* w, const float* h0,
                            const float* mask_t, void* hs, void* stash,
                            int B, int T, int H, cudaStream_t stream) {
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  int p[6];
  size_t smem;
  cudaError_t e = plan(0, B, H, p, &smem);
  if (e != cudaSuccess) return e;
  if (!p[0]) return cudaErrorInvalidValue;
  FwdArgs a;
  if (!rc::unit_map(&a.tm_xg, xg, 3, 2, kBf, B, T, H) ||
      !rc::mask_map(&a.tm_mask, mask_t, B, T, (B + 3) / 4 * 4) ||
      !rc::unit_map(&a.tm_hs, hs, 0, 2, kBf, B, T, H) ||
      !rc::unit_map(&a.tm_stash, stash, 3, 2, kBf, B, T, H))
    return cudaErrorInvalidValue;
  a.w = static_cast<const bf16*>(w);
  a.h0 = h0;
  a.B = B;
  a.T = T;
  a.H = H;
  a.nb = p[1];
  return rc::launch(gru_fwd_cluster_kernel, a, a.nb, p[4], kThreads, smem,
                    stream);
}

// stash [B,T,3H], hs and dhs [B,T,H], w [H,3H] bfloat16; h0 [B,H]
// float32, mask_t as for gru_fwd_cluster; outputs dxg [B,T,3H] bfloat16
// and dh0 [B,H] float32 (zero-filled: rows and units past the kernel's
// stay zero); every address but dh0's 16-byte aligned.
cudaError_t gru_bwd_cluster(const void* stash, const void* hs, const void* w,
                            const float* h0, const float* mask_t,
                            const void* dhs, void* dxg, float* dh0, int B,
                            int T, int H, cudaStream_t stream) {
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  int p[6];
  size_t smem;
  cudaError_t e = plan(1, B, H, p, &smem);
  if (e != cudaSuccess) return e;
  if (!p[0]) return cudaErrorInvalidValue;
  BwdArgs a;
  if (!rc::unit_map(&a.tm_stash, stash, 3, 2, kBf, B, T, H) ||
      !rc::unit_map(&a.tm_hs, hs, 0, 2, kBf, B, T, H) ||
      !rc::unit_map(&a.tm_h0, h0, 0, 4, kF32, B, 0, H) ||
      !rc::unit_map(&a.tm_dhs, dhs, 0, 2, kBf, B, T, H) ||
      !rc::mask_map(&a.tm_mask, mask_t, B, T, (B + 3) / 4 * 4) ||
      !rc::unit_map(&a.tm_dxg, dxg, 3, 2, kBf, B, T, H))
    return cudaErrorInvalidValue;
  a.w = static_cast<const bf16*>(w);
  a.dh0 = dh0;
  a.B = B;
  a.T = T;
  a.H = H;
  a.nb = p[1];
  return rc::launch(gru_bwd_cluster_kernel, a, a.nb, p[4], kThreads, smem,
                    stream);
}

}  // extern "C"
