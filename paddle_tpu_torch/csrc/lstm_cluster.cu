// The bfloat16 LSTM for Hopper (sm_90a) as one thread-block cluster per
// row group: the forward (B3) and the reverse-time backward (B4) that the
// bf16 AMP path launches wherever W fits the cluster's shared memory
// (kernels/lstm_cell.py `cluster_plan`; lstm_cell.cu's kernels take the
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
// Layout and dtypes are lstm_cell.cu's: xg [B, T, 4H], gate order (i, c~,
// f, o) in blocks of H, W [H, 4H], hs, the stash, dhs, dcs and dxg in
// bfloat16; h0, c0, mask [B, T], peep [3, H], cs, dh0, dc0 and dpeep in
// float32, and so are the carried h and c, the gates and every sum. h_{t-1}
// (B3) and dgates_t (B4) are rounded to bf16 just before their product, as
// the JAX kernels round them (astype(w.dtype)).
//
// ---------------------------------------------------------------------
// lstm_fwd_cluster (B3) replaces paddle_tpu/kernels/lstm_cell.py
// `_fwd_kernel` (the pallas_call in `_fwd_pallas`); lstm_bwd_cluster (B4)
// replaces `_bwd_kernel` (the pallas_call in `_bwd_pallas`). dW is one
// GEMM outside the kernel, as in the JAX package.
//
// What bounds them. At the training path's shape (B 64, T 80, H 512) the
// recurrence is 10.7 GFLOP, 10.9 us at 989 TFLOP/s, and its bytes (60-65
// MB) 18-20 us: the chain of 80 dependent steps bounds it, as each step
// needs the whole of h_{t-1} (B3) or of dgates_t W^T (B4) of its row
// group from every block that owns a slice. lstm_cell.cu's bf16 kernels
// pay 3.9 us (B3) and 6.1 us (B4) a step (lstm_breakdown.py --lstm-bf16):
// a store to device memory, a fence and an atomic counter, polling, and
// the row group's tile back out of L2 into every block. These pay 2.3 us
// and 2.1 us, of which the exchange and its waits alone (no product, no
// cell) take 1.5 us (B3) and 1.2 us (B4).
//
// The design, in both kernels:
// * One cluster of nb = ceil(H / 32) blocks (16 at H 512, non-portable)
//   per row group of R = 16 batch rows, 256 threads (two warpgroups) a
//   block. Block r owns units [32 r, 32 r + 32), so 128 gate columns, and
//   keeps its slice of W (128 KB at H 512: the cluster's 16 SMs hold all
//   2 MB) in REGISTERS for the whole sequence, as the A operand of wgmma:
//   staged once by 16-byte cp.async into shared memory in the 128-byte
//   swizzle, then loaded by ldmatrix, 128 registers a thread. Reading W
//   from shared memory at every step bounded the product at the shared
//   memory's 128 bytes a cycle (0.7 us a step). Row groups are
//   independent, so clusters need not be resident together (no
//   cooperative launch, no grid-wide wait).
// * The product on wgmma with A in registers, transposed so that the 16
//   rows fill N and the columns fill M: B3 forms gates^T = W_slice^T
//   h_{t-1}^T (M 128: warpgroup wg takes tile wg, N 16, K 512, h K-major
//   in the 64-byte swizzle); B4 forms its float32 share of dh^T = W[:,
//   its columns] dgates_t^T (M 512 as 8 m64 tiles, 4 a warpgroup, in two
//   rounds of two to keep the live sums down; N 16, K 128). K and M run
//   over 512 units whatever H is (zeros past it): a product bounded at
//   run time makes ptxas serialise the wgmma instructions.
// * The step's exchange through distributed shared memory, completing
//   the receiver's mbarrier by bytes (rnn_cluster.cuh): B3 all-gathers
//   h_t, each block writing its [16 x 32] bf16 slice (1 KB, one sub-tile
//   of the 64-byte swizzle, so contiguous) into its own buffer and a warp
//   sending it by one bulk copy to each peer; B4 reduce-scatters, each
//   block's [32 units x 16] float32 piece of every other block's units
//   going by st.async straight from the accumulators (16 bytes a store:
//   staging the pieces for bulk copies costs more, a fence.proxy.async
//   and a pass through shared memory), the owner adding the nb pieces in
//   rank order. dgates never leave the block. No counters in device
//   memory, no polling of L2.
// * Inputs by TMA through a ring of 8 steps (B3: xg's [16 x 4 x 32] gate
//   block and the mask; B4: the stash's gate block, c_{t-1}, dh_t, dc_t
//   and the mask), outputs by TMA stores from shared memory (B3: the
//   stash, cs, hs; B4: dxg). A load one step ahead in registers left the
//   HBM latency on the chain: the outputs' bytes (36 MB a forward at the
//   path's shape) evict xg from L2. The threads of the chain issue no
//   load or store to device memory in the loop.
// * B3's M rows are permuted so that a thread's accumulator holds two
//   gates of its unit for its rows (chunk 2 w + h of tile mt is gate
//   2 mt + h of units 8 w .. 8 w + 7): warpgroup 0 holds (i, c~),
//   warpgroup 1 (f, o); they swap half their sums through shared memory
//   and each runs the cells of 8 of the 16 rows in float32, the c and h
//   carries in registers. B4's phase A runs one thread a unit and two
//   rows, in the layout its pieces arrive in.
// * The cell's nonlinearities on the special function unit (__expf and a
//   fast reciprocal: within a few ulp of float32).
//
// Two buffers of each exchange, by step parity, are enough (see
// rnn_cluster.cuh). No float atomics: every sum has a fixed order, so two
// runs give the same bits. A wait that does not end within 10 s traps.
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
using rc::tiles;

constexpr int kFwdThreads = 256;   // B3: two warpgroups
constexpr int kBwdThreads = 256;   // B4: two warpgroups
constexpr int kFwdStages = 8;      // B3's ring of inputs, steps ahead
constexpr int kBwdStages = 8;      // B4's

// The products run over the largest cluster's units whatever H is (K of
// B3 and M of B4 are 512, zero past H): no product depends on a runtime
// bound, which would make ptxas serialise the wgmma instructions.
constexpr int kKp = rc::kMaxCluster * rc::kUnits;
constexpr int kMTiles = kKp / 64;       // B4's m64 tiles of units
constexpr int kTilesWg = kMTiles / 2;   // ... a warpgroup

// Boxes of R rows x 32 units (TMA, dense in shared memory): a gate block
// [R][4][32] bf16, a [R][32] float32 or bf16 plane, R float32 mask values
// (in a 128-byte slot).
constexpr int kGates = kRows * 4 * rc::kUnits * 2;
constexpr int kPlaneF = kRows * rc::kUnits * 4;
constexpr int kPlaneH = kRows * rc::kUnits * 2;
constexpr int kMask = 128;
static_assert(kRows * 4 <= kMask, "the mask's slot");

// B3's shared memory: W^T's slice staged for the registers (two m64
// tiles of kKp K rows of 128 bytes), two h buffers of kMaxCluster
// sub-tiles of R rows x 64 bytes, kFwdOutSlots slots of the outputs on
// their way out (the stash's gate block, cs, hs), the warpgroups' swap of
// sums, and the ring of inputs (xg's gate block and the mask).
constexpr int kFwdOutSlots = 3;
constexpr int kFwdW = 2 * kKp * 128;
constexpr int kFwdH = rc::kMaxCluster * kRows * 64;
constexpr int kFwdOut = kGates + kPlaneF + kPlaneH;
constexpr int kFwdStage = kGates + kMask;
constexpr size_t kFwdSmem = (size_t)kHead + kFwdW + 2 * kFwdH +
                            kFwdOutSlots * kFwdOut + kFwdThreads * 16 +
                            kFwdStages * kFwdStage;
// B4's: dgates_t (two sub-tiles of R rows x 128 bytes, the product's B),
// dxg's gate block on its way out, two buffers of the nb float32 pieces
// of 32 x R it receives (before the first step the same bytes, and more,
// stage W's rows for the registers: kMTiles m64 tiles of two 64-column
// sub-tiles of 64 rows x 128 bytes), and the ring of inputs (the stash's
// gate block, c_{t-1}, dh_t, dc_t and the mask).
constexpr int kBwdDg = 2 * kRows * 128;
constexpr int kPiece = rc::kUnits * kRows * 4;
constexpr int kBwdW = kMTiles * 2 * 64 * 128;
constexpr int kBwdStage = kGates + kPlaneF + 2 * kPlaneH + kMask;
size_t bwd_smem(int nb) {
  const size_t x = 2 * (size_t)nb * kPiece;
  return (size_t)kHead + kBwdDg + kGates + (x > kBwdW ? x : kBwdW) +
         kBwdStages * kBwdStage;
}

// =====================================================================
// lstm_fwd_cluster (B3)
// =====================================================================

struct FwdArgs {
  // TMA: xg and the stash as [B][T][4][H] bf16, hs [B][T][H] bf16, cs
  // [B][T][H] float32, in boxes of 32 units x R rows; the mask as [T][B]
  // float32 in boxes of R rows
  CUtensorMap tm_xg, tm_mask, tm_hs, tm_cs, tm_stash;
  const bf16* w;
  const float* peep;
  const float* h0;
  const float* c0;
  int B, T, H, nb;
};

// Warpgroup wg forms m64 tile wg of gates^T: thread (warp w, lane 4 g + t)
// holds gates 2 wg, 2 wg + 1 of unit j = 8 w + g for rows 8 i + 2 t + e.
// The warpgroups swap half their sums through shared memory and each runs
// the cells of its rows n = 8 wg + 2 t + e (cell e), two a thread.
__global__ void __launch_bounds__(kFwdThreads, 1)
    lstm_fwd_cluster_kernel(const __grid_constant__ FwdArgs a) {
  constexpr int NC = 2;           // cells a thread
  constexpr int NR = kRows / 2;   // accumulator registers of an m64nR tile
  constexpr int KS = kKp / 16;    // k16 steps
  constexpr unsigned kSlice = kRows * 64;   // one block's slice of h_t
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);   // [2]: h
  uint64_t* xfull = full + 2;                     // [kFwdStages]: inputs
  const int nb = a.nb, H = a.H, T_ = a.T;
  unsigned char* wt = tiles(smem_raw);
  unsigned char* hb = wt + kFwdW;
  unsigned char* outs = hb + 2 * kFwdH;
  float4* xch = reinterpret_cast<float4*>(outs + kFwdOutSlots * kFwdOut);
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(xch + kFwdThreads);
  const unsigned xbytes = (nb - 1) * kSlice;   // the peers' slices
  const unsigned rank = rc::cluster_rank();
  const int rg = blockIdx.x / nb, r0 = rg * kRows;
  const int u0 = rc::kUnits * (int)rank;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wl = warp % 4, g = lane / 4, t4 = lane % 4;
  const size_t G4 = 4 * (size_t)H;

  // step t's inputs into ring slot t % kFwdStages, by thread 0
  auto load = [&](int t) {
    const int sl = t % kFwdStages;
    unsigned char* st = ring + sl * kFwdStage;
    hopper::mbar_expect_tx(&xfull[sl], kGates + kRows * 4);
    hopper::tma_load_4d(st, &a.tm_xg, &xfull[sl], u0, 0, t, r0);
    hopper::tma_load_2d(st + kGates, &a.tm_mask, &xfull[sl], r0, t);
  };
  if (tid == 0) {
    hopper::mbar_init(&full[0], 1);
    hopper::mbar_init(&full[1], 1);
    for (int i = 0; i < kFwdStages; ++i) hopper::mbar_init(&xfull[i], 1);
    hopper::mbar_fence_init();
    for (int t = 0; t < kFwdStages && t < T_; ++t) load(t);
  }
  // W^T's slice, staged MN-major: tile mt, K row k, 16-byte chunk c =
  // 2 w + hh holds gate 2 mt + hh of units u0 + 8 w .. + 7 (zeros past H)
  for (int idx = tid; idx < 2 * kKp * 8; idx += kFwdThreads) {
    const int c = idx % 8, k = idx / 8 % kKp, mt = idx / 8 / kKp;
    const int q = 2 * mt + c % 2, j0 = 8 * (c / 2);
    const bool ok = k < H && u0 + j0 < H;
    const bf16* src = ok ? a.w + (size_t)k * G4 + (size_t)q * H + u0 + j0
                         : a.w;
    rnn_step::cp16(wt + (size_t)mt * kKp * 128 + sw128(k, 16 * c), src, ok);
  }
  rnn_step::cp_commit();
  // the sub-tiles of h past the cluster's blocks stay zero
  for (int i = nb * kSlice / 16 + tid; i < kFwdH / 16; i += kFwdThreads) {
    reinterpret_cast<uint4*>(hb)[i] = make_uint4(0, 0, 0, 0);
    reinterpret_cast<uint4*>(hb + kFwdH)[i] = make_uint4(0, 0, 0, 0);
  }

  const int j = 8 * wl + g;   // this thread's unit of the block
  const int u = u0 + j;
  const bool unit_ok = u < H;
  const float p0 = unit_ok ? a.peep[u] : 0.f;
  const float p1 = unit_ok ? a.peep[H + u] : 0.f;
  const float p2 = unit_ok ? a.peep[2 * H + u] : 0.f;
  float hreg[NC], creg[NC];
  bool live[NC];
  unsigned char* own = hb + rank * kSlice;   // this block's slice, buffer 0
#pragma unroll
  for (int e = 0; e < NC; ++e) {
    const int n = 8 * wg + 2 * t4 + e, b = r0 + n;
    live[e] = unit_ok && b < a.B;
    hreg[e] = live[e] ? a.h0[(size_t)b * H + u] : 0.f;
    creg[e] = live[e] ? a.c0[(size_t)b * H + u] : 0.f;
    *reinterpret_cast<bf16*>(own + sw64(n, 2 * j)) =
        __float2bfloat16_rn(hreg[e]);
  }
  rnn_step::cp_wait<0>();
  __syncthreads();   // W^T is staged
  // this warpgroup's tile of W^T into registers, the product's A: k16
  // step kk as the warp's 16 x 16 fragment (matrices: rows 16 w (+ 8),
  // K 16 kk (+ 8))
  unsigned wf[KS][4];
  {
    const int mi = lane / 8, k_in = lane % 8;
    const unsigned char* tile = wt + (size_t)wg * kKp * 128;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int k = 16 * kk + 8 * (mi >> 1) + k_in;
      rc::ldsm_x4_trans(wf[kk], tile + sw128(k, 16 * (2 * wl + (mi & 1))));
    }
  }
  hopper::fence_proxy_async();
  // every block's mbarriers exist, h0's slice is in place
  rc::cluster_sync();
  if (tid == 0) rc::expect(&full[0], xbytes);
  if (warp == 1) rc::all_gather(own, kSlice, &full[0], rank, nb, lane);

  for (int t = 0; t < T_; ++t) {
    const int par = t & 1;
    // h_{t-1} of the row group, from every block
    rc::wait(&full[par], (t >> 1) & 1);
    __syncwarp();
    float acc[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[i] = 0.f;
    fence_regs(acc);
    hopper::wgmma_fence();
    {
      const unsigned ha = smem_u32(hb + par * kFwdH);
      // k16 steps: two in each block's 32-unit sub-tile of h
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        hopper::wgmma_rs_n16<0>(
            acc, wf[kk],
            desc(ha + (kk / 2) * kSlice + (kk % 2) * 32, 512, 2), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_regs(acc);

    // acc[4 i + 2 hh + e] is gate 2 wg + hh of row 8 i + 2 t + e: the
    // other warpgroup's rows go to it, its sums for this one's come back
    xch[tid] = wg == 0 ? make_float4(acc[4], acc[5], acc[6], acc[7])
                       : make_float4(acc[0], acc[1], acc[2], acc[3]);
    const int sl = t % kFwdStages;
    const unsigned char* in = ring + sl * kFwdStage;
    hopper::mbar_wait(&xfull[sl], (t / kFwdStages) & 1);
    __syncthreads();   // the sums swapped
    const float4 pv = xch[tid ^ 128];
    unsigned char* hnext = hb + (par ^ 1) * kFwdH + rank * kSlice;
    unsigned char* out = outs + (t % kFwdOutSlots) * kFwdOut;
    bf16* o_st = reinterpret_cast<bf16*>(out);
    float* o_cs = reinterpret_cast<float*>(out + kGates);
    bf16* o_hs = reinterpret_cast<bf16*>(out + kGates + kPlaneF);
#pragma unroll
    for (int e = 0; e < NC; ++e) {
      const int n = 8 * wg + 2 * t4 + e;
      // this warpgroup's two gates of the cell and the other's (gates (i,
      // c~) are warpgroup 0's, (f, o) warpgroup 1's), by selects: no
      // register array is indexed at run time
      const float mine0 = wg == 0 ? acc[e] : acc[4 + e];
      const float mine1 = wg == 0 ? acc[2 + e] : acc[6 + e];
      const float oth0 = e == 0 ? pv.x : pv.y;
      const float oth1 = e == 0 ? pv.z : pv.w;
      const int x0 = n * 4 * rc::kUnits + j;
      const float gsum[4] = {
          bf(in, x0) + (wg == 0 ? mine0 : oth0),
          bf(in, x0 + rc::kUnits) + (wg == 0 ? mine1 : oth1),
          bf(in, x0 + 2 * rc::kUnits) + (wg == 0 ? oth0 : mine0),
          bf(in, x0 + 3 * rc::kUnits) + (wg == 0 ? oth1 : mine1)};
      const float m = reinterpret_cast<const float*>(in + kGates)[n];
      const float c_prev = creg[e], h_prev = hreg[e];
      const float gi = gsum[0] + c_prev * p0;
      const float gf = gsum[2] + c_prev * p1;
      float act[4];
      act[0] = rc::sigm_fast(gi);
      act[1] = rc::tanh_fast(gsum[1]);
      act[2] = rc::sigm_fast(gf);
      float c_t = act[2] * c_prev + act[0] * act[1];
      act[3] = rc::sigm_fast(gsum[3] + c_t * p2);
      float h_t = act[3] * rc::tanh_fast(c_t);
      h_t = m * h_t + (1.f - m) * h_prev;
      c_t = m * c_t + (1.f - m) * c_prev;
      hreg[e] = live[e] ? h_t : 0.f;
      creg[e] = live[e] ? c_t : 0.f;
      if (t + 1 < T_)
        *reinterpret_cast<bf16*>(hnext + sw64(n, 2 * j)) =
            __float2bfloat16_rn(hreg[e]);
      // the outputs into their slot, in the boxes' layout
      o_hs[n * rc::kUnits + j] = __float2bfloat16_rn(hreg[e]);
      o_cs[n * rc::kUnits + j] = creg[e];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        o_st[(n * 4 + q) * rc::kUnits + j] = __float2bfloat16_rn(act[q]);
    }
    hopper::fence_proxy_async();
    __syncthreads();   // h_t's slice and the outputs written, slot sl read
    // This block's arrival first (no thread passes it before the output
    // slot it writes next, that of step t + 1 - kFwdOutSlots, is read
    // out: thread 0 waited for it at step t - 1), the slice to the peers
    // from another warp, then the outputs by TMA and the next inputs.
    // These threads issue no store to device memory.
    if (t + 1 < T_) {
      if (tid == 0) rc::expect(&full[par ^ 1], xbytes);
      if (warp == 1)
        rc::all_gather(hnext, kSlice, &full[par ^ 1], rank, nb, lane);
    }
    if (tid == 0) {
      hopper::tma_store_4d(&a.tm_stash, o_st, u0, 0, t, r0);
      hopper::tma_store_3d(&a.tm_cs, o_cs, u0, t, r0);
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
// lstm_bwd_cluster (B4)
// =====================================================================

struct BwdArgs {
  // TMA: the stash and dxg as [B][T][4][H] bf16, cs [B][T][H] float32,
  // c0 [B][H] float32, dhs and dcs [B][T][H] bf16, in boxes of 32 units x
  // R rows; the mask as [T][B] float32 in boxes of R rows
  CUtensorMap tm_stash, tm_cs, tm_c0, tm_dhs, tm_dcs, tm_mask, tm_dxg;
  const bf16* w;
  const float* cs;
  const float* peep;
  float* dh0;
  float* dc0;
  float* dpart;   // [row groups][3][H]
  int B, T, H, nb;
};

// Phase A: thread tid takes unit ju = tid % 32 and half hf = tid / 32 % 2
// of the quad of rows tid / 64 (rc::piece_row), the layout its sums
// arrive in: two (row, unit) pairs a thread.
__global__ void __launch_bounds__(kBwdThreads, 1)
    lstm_bwd_cluster_kernel(const __grid_constant__ BwdArgs a) {
  constexpr int NR = kRows / 2;
  constexpr int kActive = rc::kUnits * kRows / 2;
  static_assert(kActive == kBwdThreads, "half a quad a thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* rbar = reinterpret_cast<uint64_t*>(smem_raw);   // [2]: pieces
  uint64_t* xfull = rbar + 2;                     // [kBwdStages]: inputs
  const int nb = a.nb, H = a.H, T_ = a.T;
  unsigned char* dg = tiles(smem_raw);
  bf16* o_dx = reinterpret_cast<bf16*>(dg + kBwdDg);   // dxg's gate block
  float* recv = reinterpret_cast<float*>(dg + kBwdDg + kGates);
  const int rfloats = nb * kPiece / 4;
  unsigned char* wa = reinterpret_cast<unsigned char*>(recv);   // W staged
  unsigned char* ring =
      wa + (2 * rfloats * 4 > kBwdW ? 2 * rfloats * 4 : kBwdW);
  const unsigned xbytes = (unsigned)((nb - 1) * kPiece);   // the peers'
  const unsigned rank = rc::cluster_rank();
  const int rg = blockIdx.x / nb, r0 = rg * kRows;
  const int u0 = rc::kUnits * (int)rank;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wl = warp % 4;
  const size_t G4 = 4 * (size_t)H;

  // step s's inputs (t = T - 1 - s) into ring slot s % kBwdStages, by
  // thread 0: the stash's gate block, c_{t-1} (c0 at t = 0), dh_t, dc_t,
  // the mask
  auto load = [&](int s) {
    const int t = T_ - 1 - s, sl = s % kBwdStages;
    unsigned char* st = ring + sl * kBwdStage;
    hopper::mbar_expect_tx(&xfull[sl],
                           kGates + kPlaneF + 2 * kPlaneH + kRows * 4);
    hopper::tma_load_4d(st, &a.tm_stash, &xfull[sl], u0, 0, t, r0);
    if (t)
      hopper::tma_load_3d(st + kGates, &a.tm_cs, &xfull[sl], u0, t - 1, r0);
    else
      hopper::tma_load_2d(st + kGates, &a.tm_c0, &xfull[sl], u0, r0);
    hopper::tma_load_3d(st + kGates + kPlaneF, &a.tm_dhs, &xfull[sl], u0, t,
                        r0);
    hopper::tma_load_3d(st + kGates + kPlaneF + kPlaneH, &a.tm_dcs,
                        &xfull[sl], u0, t, r0);
    hopper::tma_load_2d(st + kGates + kPlaneF + 2 * kPlaneH, &a.tm_mask,
                        &xfull[sl], r0, t);
  };
  if (tid == 0) {
    hopper::mbar_init(&rbar[0], 1);
    hopper::mbar_init(&rbar[1], 1);
    for (int i = 0; i < kBwdStages; ++i) hopper::mbar_init(&xfull[i], 1);
    hopper::mbar_fence_init();
    for (int s = 0; s < kBwdStages && s < T_; ++s) load(s);
  }
  // W's rows, staged K-major: m64 tile mt of units, sub-tile sb of the
  // block's 128 columns (column k = 32 q + j is gate q of unit u0 + j),
  // row m, 16-byte chunk c: columns 64 sb + 8 c .. + 7 (zeros past H)
  for (int idx = tid; idx < kMTiles * 2 * 64 * 8; idx += kBwdThreads) {
    const int c = idx % 8, m = idx / 8 % 64, sb = idx / 512 % 2,
              mt = idx / 1024;
    const int uu = 64 * mt + m, k = 64 * sb + 8 * c;
    const int q = k / 32, j0 = k % 32;
    const bool ok = uu < H && u0 + j0 < H;
    const bf16* src = ok ? a.w + (size_t)uu * G4 + (size_t)q * H + u0 + j0
                         : a.w;
    rnn_step::cp16(wa + (size_t)(mt * 2 + sb) * 8192 + sw128(m, 16 * c), src,
                   ok);
  }
  rnn_step::cp_commit();
  rnn_step::cp_wait<0>();
  __syncthreads();   // W's rows are staged
  // ... then into registers, the product's A: warpgroup wg's m64 tiles
  // 4 wg .. 4 wg + 3, k16 step kk as the warp's 16 x 16 fragment
  // (matrices: units 16 w (+ 8), columns 16 kk (+ 8))
  const int mt0 = wg * kTilesWg;
  unsigned wf[kTilesWg][8][4];
  {
    const int mi = lane / 8, m = 16 * wl + 8 * (mi & 1) + lane % 8;
#pragma unroll
    for (int i = 0; i < kTilesWg; ++i)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int k = 16 * kk + 8 * (mi >> 1);
        rc::ldsm_x4(wf[i][kk], wa + (size_t)((mt0 + i) * 2 + k / 64) * 8192 +
                                   sw128(m, (k % 64) * 2));
      }
  }

  const int ju = tid % 32, quad = tid / 64, hf = tid / 32 % 2;
  const int u = u0 + ju;
  const bool unit_ok = u < H;
  int rows[2];
  bool live[2];
  float c_t[2];   // c_t of the step: cs_{T-1} first, then each c_{t-1}
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    rows[e] = rc::piece_row(quad, 2 * hf + e);
    live[e] = unit_ok && r0 + rows[e] < a.B;
    c_t[e] = live[e] ? a.cs[((size_t)(r0 + rows[e]) * T_ + T_ - 1) * H + u]
                     : 0.f;
  }
  const float p0 = unit_ok ? a.peep[u] : 0.f;
  const float p1 = unit_ok ? a.peep[H + u] : 0.f;
  const float p2 = unit_ok ? a.peep[2 * H + u] : 0.f;
  float dp0 = 0.f, dp1 = 0.f, dp2 = 0.f;
  float dcc[2] = {}, keep[2] = {};   // the dc carry; (1 - m) dh
  // every block's mbarriers exist, and no block has W's rows staged where
  // its peers' pieces are about to land
  rc::cluster_sync();

  for (int s = 0; s < T_; ++s) {
    const int t = T_ - 1 - s;
    const int sl = s % kBwdStages;
    // ---- phase A: the gate gradients of this thread's two pairs ----
    // dh_t's carry: the nb pieces of step s - 1 in rank order, then
    // (1 - m) dh
    float dh_c[2] = {};
    if (s) {
      rc::wait(&rbar[(s - 1) & 1], ((s - 1) >> 1) & 1);
      const float2 sum = rc::gather_sum<kRows>(
          recv + ((s - 1) & 1) * rfloats, nb, ju, quad, hf);
      dh_c[0] = sum.x + keep[0];
      dh_c[1] = sum.y + keep[1];
    }
    {
      const unsigned char* in = ring + sl * kBwdStage;
      hopper::mbar_wait(&xfull[sl], (s / kBwdStages) & 1);
      const float* in_cp = reinterpret_cast<const float*>(in + kGates);
      const unsigned char* in_dh = in + kGates + kPlaneF;
      const unsigned char* in_dc = in_dh + kPlaneH;
      const float* in_m =
          reinterpret_cast<const float*>(in_dc + kPlaneH);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = rows[e], x0 = n * 4 * rc::kUnits + ju;
        const float gi_ = bf(in, x0), gc_ = bf(in, x0 + rc::kUnits);
        const float gf_ = bf(in, x0 + 2 * rc::kUnits);
        const float go_ = bf(in, x0 + 3 * rc::kUnits);
        const float cp = in_cp[n * rc::kUnits + ju], c = c_t[e];
        const float m = in_m[n];
        const float dh = bf(in_dh, n * rc::kUnits + ju) + dh_c[e];
        const float dc_in = bf(in_dc, n * rc::kUnits + ju) + dcc[e];
        const float tanh_c = rc::tanh_fast(c);
        float dgo = dh * tanh_c * go_ * (1.f - go_);
        const float dct = dh * go_ * (1.f - tanh_c * tanh_c) + dc_in + dgo * p2;
        float dgi = dct * gc_ * gi_ * (1.f - gi_);
        float dgc = dct * gi_ * (1.f - gc_ * gc_);
        float dgf = dct * cp * gf_ * (1.f - gf_);
        const float dc_prev = dct * gf_ + dgi * p0 + dgf * p1;
        dgi *= m;
        dgc *= m;
        dgf *= m;
        dgo *= m;
        dcc[e] = live[e] ? m * dc_prev + (1.f - m) * dc_in : 0.f;
        keep[e] = live[e] ? (1.f - m) * dh : 0.f;
        const float dgv[4] = {live[e] ? dgi : 0.f, live[e] ? dgc : 0.f,
                              live[e] ? dgf : 0.f, live[e] ? dgo : 0.f};
        // dgates_t, rounded, into the product's B tile (row n, column
        // 32 q + ju) and into dxg's gate block
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = 32 * q + ju;
          const bf16 v = __float2bfloat16_rn(dgv[q]);
          *reinterpret_cast<bf16*>(dg + (k / 64) * kRows * 128 +
                                   sw128(n, (k % 64) * 2)) = v;
          o_dx[(n * 4 + q) * rc::kUnits + ju] = v;
        }
        if (live[e]) {
          if (t == 0) a.dc0[(size_t)(r0 + n) * H + u] = dcc[e];
          dp0 += dgi * cp;
          dp1 += dgf * cp;
          dp2 += dgo * c;
        }
        c_t[e] = cp;
      }
    }
    hopper::fence_proxy_async();
    __syncthreads();   // dgates_t is in its tile, slot sl read
    // dxg leaves by TMA: these threads issue no store to device memory in
    // the loop but dc0's at its last step
    if (tid == 0) {
      hopper::tma_store_4d(&a.tm_dxg, o_dx, u0, 0, t, r0);
      hopper::bulk_commit();
      if (s + kBwdStages < T_) load(s + kBwdStages);
    }

    // ---- phase B: this block's share of dgates_t W^T for every unit,
    //      then each 32 units' piece to the block that owns them ----
    // in two rounds of two tiles, which keeps fewer sums live
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float acc[2][NR];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int r = 0; r < NR; ++r) acc[i][r] = 0.f;
        fence_regs(acc[i]);
      }
      hopper::wgmma_fence();
      {
        const unsigned ba = smem_u32(dg);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint64_t db = desc(
              ba + (kk / 4) * kRows * 128 + (kk % 4) * 32, 1024, 1);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            hopper::wgmma_rs_n16<0>(acc[i], wf[2 * half + i][kk], db, 1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        fence_regs(acc[i]);
        rc::scatter_tile<kRows>(acc[i], 64 * (mt0 + 2 * half + i),
                                rc::kUnits * nb, recv + (s & 1) * rfloats,
                                &rbar[s & 1], rank, wl, lane);
      }
    }
    __syncthreads();   // this block's own pieces stored, its tile read
    if (tid == 0) {
      hopper::bulk_wait_read<0>();   // dxg's gate block is free again
      rc::expect(&rbar[s & 1], xbytes);
    }
  }

  // dh0: the last step's pieces, then (1 - m) dh
  if (T_ > 0) {
    rc::wait(&rbar[(T_ - 1) & 1], ((T_ - 1) >> 1) & 1);
    const float2 sum = rc::gather_sum<kRows>(
        recv + ((T_ - 1) & 1) * rfloats, nb, ju, quad, hf);
    const float v[2] = {sum.x, sum.y};
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (live[e]) a.dh0[(size_t)(r0 + rows[e]) * H + u] = v[e] + keep[e];
  }
  // dpeep: this block's rows summed in the order of the threads' halves
  // of quads, for each unit
  __syncthreads();   // every wait has ended: recv is free
  const float dp[3] = {dp0, dp1, dp2};
  float* part = recv;
#pragma unroll
  for (int q = 0; q < 3; ++q) part[q * kActive + tid] = dp[q];
  __syncthreads();
  if (tid < rc::kUnits && u0 + tid < H) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float sum = 0.f;
      for (int qd = 0; qd < kActive / rc::kUnits; ++qd)
        sum += part[q * kActive + qd * rc::kUnits + tid];
      a.dpart[((size_t)rg * 3 + q) * H + u0 + tid] = sum;
    }
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
  const void* kernel = kind == 0 ? (const void*)lstm_fwd_cluster_kernel
                                 : (const void*)lstm_bwd_cluster_kernel;
  return rc::prepare(kernel, nb, kind == 0 ? kFwdThreads : kBwdThreads,
                     *smem, &out[5]);
}

}  // namespace

extern "C" {

// The plan of lstm_fwd_cluster (kind 0) or lstm_bwd_cluster (kind 1) at
// (B, H) on the current device, in out[0..5] (see `plan`).
cudaError_t lstm_cluster_plan(int kind, int B, int H, int* out) {
  size_t smem;
  return plan(kind, B, H, out, &smem);
}

// xg [B,T,4H] and w [H,4H] bfloat16, peep [3,H], h0/c0 [B,H] float32,
// mask_t [T,bp] float32 (the mask transposed, bp = B rounded up to 4, the
// rows past B zero); outputs hs [B,T,H] bfloat16, cs [B,T,H] float32 and
// the stash [B,T,4H] bfloat16; every address 16-byte aligned.
// cudaErrorInvalidValue where the plan does not take (B, H).
cudaError_t lstm_fwd_cluster(const void* xg, const void* w, const float* peep,
                             const float* h0, const float* c0,
                             const float* mask_t, void* hs, float* cs,
                             void* stash, int B, int T, int H,
                             cudaStream_t stream) {
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  int p[6];
  size_t smem;
  cudaError_t e = plan(0, B, H, p, &smem);
  if (e != cudaSuccess) return e;
  if (!p[0]) return cudaErrorInvalidValue;
  FwdArgs a;
  if (!rc::unit_map(&a.tm_xg, xg, 4, 2, kBf, B, T, H) ||
      !rc::mask_map(&a.tm_mask, mask_t, B, T, (B + 3) / 4 * 4) ||
      !rc::unit_map(&a.tm_hs, hs, 0, 2, kBf, B, T, H) ||
      !rc::unit_map(&a.tm_cs, cs, 0, 4, kF32, B, T, H) ||
      !rc::unit_map(&a.tm_stash, stash, 4, 2, kBf, B, T, H))
    return cudaErrorInvalidValue;
  a.w = static_cast<const bf16*>(w);
  a.peep = peep;
  a.h0 = h0;
  a.c0 = c0;
  a.B = B;
  a.T = T;
  a.H = H;
  a.nb = p[1];
  return rc::launch(lstm_fwd_cluster_kernel, a, a.nb, p[4], kFwdThreads,
                    smem, stream);
}

// stash [B,T,4H], w [H,4H], dhs/dcs [B,T,H] bfloat16; cs [B,T,H], peep
// [3,H], c0 [B,H] float32, mask_t as for lstm_fwd_cluster; outputs dxg
// [B,T,4H] bfloat16, dh0/dc0 [B,H] (zero-filled) and dpart [ceil(B /
// 16),3,H] float32 (dpeep = its sum over the first axis); every address
// 16-byte aligned.
cudaError_t lstm_bwd_cluster(const void* stash, const float* cs,
                             const void* w, const float* peep,
                             const float* c0, const float* mask_t,
                             const void* dhs, const void* dcs, void* dxg,
                             float* dh0, float* dc0, float* dpart, int B,
                             int T, int H, cudaStream_t stream) {
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  int p[6];
  size_t smem;
  cudaError_t e = plan(1, B, H, p, &smem);
  if (e != cudaSuccess) return e;
  if (!p[0]) return cudaErrorInvalidValue;
  BwdArgs a;
  if (!rc::unit_map(&a.tm_stash, stash, 4, 2, kBf, B, T, H) ||
      !rc::unit_map(&a.tm_cs, cs, 0, 4, kF32, B, T, H) ||
      !rc::unit_map(&a.tm_c0, c0, 0, 4, kF32, B, 0, H) ||
      !rc::unit_map(&a.tm_dhs, dhs, 0, 2, kBf, B, T, H) ||
      !rc::unit_map(&a.tm_dcs, dcs, 0, 2, kBf, B, T, H) ||
      !rc::mask_map(&a.tm_mask, mask_t, B, T, (B + 3) / 4 * 4) ||
      !rc::unit_map(&a.tm_dxg, dxg, 4, 2, kBf, B, T, H))
    return cudaErrorInvalidValue;
  a.w = static_cast<const bf16*>(w);
  a.cs = cs;
  a.peep = peep;
  a.dh0 = dh0;
  a.dc0 = dc0;
  a.dpart = dpart;
  a.B = B;
  a.T = T;
  a.H = H;
  a.nb = p[1];
  return rc::launch(lstm_bwd_cluster_kernel, a, a.nb, p[4], kBwdThreads,
                    smem, stream);
}

}  // extern "C"
