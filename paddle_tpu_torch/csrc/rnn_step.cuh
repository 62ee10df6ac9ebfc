// The pieces of a persistent recurrent kernel that the LSTM kernels
// (lstm_cell.cu, B3 and B4) and the GRU kernels (gru_cell.cu, B5 and
// B6) share: the blocking (32 batch rows x 8 units a block, 8 warps),
// the exchange tile in mma A-fragment order, W staged once as mma
// fragments in shared memory, one warp's share of a row group's product
// fed by cp.async through a ring of two chunk slots, the warps' partial
// sums, the release/acquire step counters with a wait that traps instead
// of hanging, the pair of blocks of a cluster of two (B4, B6: the
// partner's sums stored in its shared memory, an mbarrier arrival) and
// the cooperative launch in clusters.
//
// Each kernel is a template over its element type T, the dtype of its
// inputs, outputs and exchange (the cell state and every sum stay
// float32):
// * float: the product in 3xTF32 on mma.sync.m16n8k8 (W split once into
//   big and small TF32 parts, a float4 of fragments an n8 tile, k8 step
//   and lane);
// * bfloat16: the product in one pass on mma.sync.m16n8k16 with float32
//   accumulation (a bf16 value is exact, so there is nothing to split;
//   8 bytes of W fragments an n8 tile, k16 step and lane); the exchange
//   carries bf16 values, rounded by the producer, in m16n8k16's
//   A-fragment order: a lane's fragment of a k16 step is still 16 bytes,
//   so the one-cp.async-a-lane scheme holds and a step moves half the
//   bytes.
// Both sum each 32-deep stage (four k8 or two k16 steps) into fresh
// accumulators and add the stage sums in the same order, so one plain
// version (kernels/lstm_cell.py `_product`) serves both.
// Sources include it by its relative name; kernels/_build.py hashes it
// with every source, so an edit here rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace rnn_step {

using tf32x3::cp16;
using tf32x3::cp_commit;
using tf32x3::cp_wait;
using tf32x3::mma;
using tf32x3::smem_u32;
using tf32x3::split;

constexpr int kWarps = 8;                // warps of a block
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32;                // batch rows of a row group
constexpr int kUnits = 8;                // units whose cells a block runs
constexpr int kKC = 128;                 // K of an exchange chunk
constexpr int kSliceSteps = 4;           // k8 steps of a warp's 32-deep
                                         // slice of a chunk: one stage
                                         // (a slot's room)
constexpr int kRegTiles = 2;             // row groups whose carries stay
                                         // in registers
// one chunk slot of a warp: kSliceSteps k8 steps of both m16 tiles, a
// float4 a lane each
constexpr int kSlot = 2 * kSliceSteps * 32;
// floats between two warps' partial sums, which take the warp's slots
constexpr int kPart = 2 * kSlot * 4;
// a row of a warp's partial sums of NT n8 tiles: the padding puts the
// rows that a warp of cells reads on distinct banks
template <int NT>
__host__ __device__ constexpr int part_ld() {
  return NT == 1 ? 24 : 8 * NT + 8;
}

static_assert(kThreads == kRows * kUnits, "one thread per (row, unit)");
static_assert(kWarps == 2 * (kKC / 32), "warp = chunk parity x slice");
static_assert(kPart >= 32 * part_ld<4>(), "partials fit the slots");

// ---- the element type ----

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
// rounded to nearest even, as the JAX kernels' astype rounds
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kK = 8;     // depth of one mma step (m16n8k8)
  using WFrag = float4;            // an n8 tile's fragments, k step, lane
};
template <>
struct Elem<bf16> {
  static constexpr int kK = 16;    // m16n8k16
  using WFrag = uint2;
};
// k steps of a 32-deep stage, of a chunk; elements of a lane's 16 bytes
template <typename T>
constexpr int kStageSteps = 32 / Elem<T>::kK;
template <typename T>
constexpr int kChunkSteps = kKC / Elem<T>::kK;
template <typename T>
constexpr int kFragElems = 32 * 16 / (int)sizeof(T);   // a k step's tile
// shared bytes of W fragments: nks k steps of NT n8 tiles
template <typename T, int NT>
__host__ __device__ constexpr size_t w_bytes(int nks) {
  return (size_t)nks * NT * 32 * sizeof(typename Elem<T>::WFrag);
}

// two floats rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
// c += a b, one m16n8k16 bf16 product with float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- waits that cannot hang, release/acquire counters ----

// A wait that has not ended within kHangNs is a fault of the protocol
// (or a grid that is not resident): the kernel traps, and the launch
// fails, instead of hanging the card.
constexpr unsigned long long kHangNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
__device__ __forceinline__ void check_hang(unsigned long long& t0) {
  if (!t0)
    t0 = now_ns();
  else if (now_ns() - t0 > kHangNs)
    __trap();
}
// the block's writes before the caller's last barrier are published:
// counter += 1 with release semantics
__device__ __forceinline__ void publish(unsigned* counter) {
  __threadfence();
  atomicAdd(counter, 1u);
}
// wait (acquire) until *counter >= target
__device__ __forceinline__ void wait_count(const unsigned* counter,
                                           unsigned target) {
  unsigned v;
  unsigned long long t0 = 0;
  for (;;) {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(counter)
                 : "memory");
    if (v >= target) return;
    check_hang(t0);
  }
}

// ---- a cluster of two blocks: rank, barrier, mbarrier, remote stores ----

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}
// one arrival completes a phase; a fence makes the barrier visible to
// the cluster (the caller's cluster_sync follows, before any arrival)
__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(b)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrive, with release at cluster scope, on the mbarrier at b's offset
// in the cluster's block `rank`
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* b,
                                                   unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(b)), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          r)
      : "memory");
}
// wait, with acquire at cluster scope, for the phase of parity `parity`
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* b,
                                                  unsigned parity) {
  const unsigned a = smem_u32(b);
  unsigned ok = 0;
  unsigned long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(a), "r"(parity)
        : "memory");
    if (ok) return;
    check_hang(t0);
  }
}
// store v at p's offset in the cluster's block `rank`
__device__ __forceinline__ void st_remote(float* p, unsigned rank, float v) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(r), "f"(v)
               : "memory");
}

__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
}

// wait until at most n of this thread's cp.async groups are pending
__device__ __forceinline__ void cp_wait_upto(int n) {
  if (n <= 0)
    cp_wait<0>();
  else
    cp_wait<1>();
}

// ---- the exchange tile and the product ----

// Where (row r of a row group, k) lies in the row group's exchange tile
// of nks k steps, in A-fragment order (PTX ISA; g = lane / 4, t = lane %
// 4), so that lane l of the warp that multiplies m16 tile r / 16 at k
// step k / kK finds its fragment values in one 16-byte word:
// * m16n8k8 .tf32: A rows g, g + 8 and columns t, t + 4, four floats;
// * m16n8k16 .bf16: rows g, g + 8 and columns 2t, 2t + 1, 2t + 8,
//   2t + 9, eight bf16 in register order (a0 a1 | a2 a3 | a4 a5 | a6 a7
//   = (g, 2t..) (g + 8, 2t..) (g, 2t + 8..) (g + 8, 2t + 8..)).
template <typename T>
__device__ __forceinline__ size_t frag_idx(int r, int k, int nks);
template <>
__device__ __forceinline__ size_t frag_idx<float>(int r, int k, int nks) {
  const int row = r % 16, kk = k % 8;
  const int lane = (row % 8) * 4 + kk % 4, e = row / 8 + 2 * (kk / 4);
  return ((size_t)(r / 16) * nks + k / 8) * 128 + lane * 4 + e;
}
template <>
__device__ __forceinline__ size_t frag_idx<bf16>(int r, int k, int nks) {
  const int row = r % 16, kk = k % 16;
  const int lane = (row % 8) * 4 + (kk % 8) / 2;
  const int e = kk % 2 + 2 * (row / 8) + 4 * (kk / 8);
  return ((size_t)(r / 16) * nks + k / 16) * 256 + lane * 8 + e;
}

// W's fragments for NT n8 tiles over nks k8 steps, split: per k8 step
// and lane (g, t), b0 = wval(8 ks + t, 8 nt + g) and b1 = wval(8 ks + t +
// 4, 8 nt + g) of each n8 tile nt. For NT >= 2, NT / 2 float4 of big
// parts then NT / 2 of small parts, each (b0, b1) of n8 tile 2i then of
// tile 2i + 1; for NT = 1, one float4 (big b0, big b1, small b0, small
// b1). Either way NT float4 a k8 step and lane.
template <int NT, typename F>
__device__ __forceinline__ void stage_w(float4* wf, int nks, F wval) {
  if constexpr (NT == 1) {
    for (int idx = threadIdx.x; idx < nks * 32; idx += blockDim.x) {
      const int l = idx % 32, ks = idx / 32;
      const int k = 8 * ks + l % 4, n = l / 4;
      unsigned big[2], small[2];
      split(wval(k, n), big[0], small[0]);
      split(wval(k + 4, n), big[1], small[1]);
      wf[ks * 32 + l] =
          make_float4(__uint_as_float(big[0]), __uint_as_float(big[1]),
                      __uint_as_float(small[0]), __uint_as_float(small[1]));
    }
  } else {
    for (int idx = threadIdx.x; idx < nks * (NT / 2) * 32;
         idx += blockDim.x) {
      const int l = idx % 32, i = idx / 32 % (NT / 2),
                ks = idx / 32 / (NT / 2);
      const int k = 8 * ks + l % 4, n = 16 * i + l / 4;
      const float v[4] = {wval(k, n), wval(k + 4, n), wval(k, n + 8),
                          wval(k + 4, n + 8)};
      unsigned big[4], small[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(v[e], big[e], small[e]);
      wf[(ks * NT + i) * 32 + l] =
          make_float4(__uint_as_float(big[0]), __uint_as_float(big[1]),
                      __uint_as_float(big[2]), __uint_as_float(big[3]));
      wf[(ks * NT + NT / 2 + i) * 32 + l] =
          make_float4(__uint_as_float(small[0]), __uint_as_float(small[1]),
                      __uint_as_float(small[2]), __uint_as_float(small[3]));
    }
  }
}

// The same for bf16 W: per k16 step, n8 tile nt and lane (g, t), one
// uint2 of b0 b1 = wval(16 ks + 2t + {0, 1}, 8 nt + g) and b2 b3 =
// wval(16 ks + 2t + 8 + {0, 1}, 8 nt + g), at (ks NT + nt) 32 + lane.
// wval's values are bf16 already: the packing rounds nothing.
template <int NT, typename F>
__device__ __forceinline__ void stage_w(uint2* wf, int nks, F wval) {
  for (int idx = threadIdx.x; idx < nks * NT * 32; idx += blockDim.x) {
    const int l = idx % 32, nt = idx / 32 % NT, ks = idx / 32 / NT;
    const int k = 16 * ks + 2 * (l % 4), n = 8 * nt + l / 4;
    wf[idx] = make_uint2(pack_bf16(wval(k, n), wval(k + 1, n)),
                         pack_bf16(wval(k + 8, n), wval(k + 9, n)));
  }
}

// k steps of slice kw of chunk c, of a K of `K` rows (0 past the end)
template <typename T>
__device__ __forceinline__ int slice_steps(int c, int kw, int K) {
  constexpr int kK = Elem<T>::kK;
  const int left = K - (c * kKC + kw * 32);
  return left <= 0 ? 0 : min(kStageSteps<T>, (left + kK - 1) / kK);
}

// One stage: `steps` k8 steps of both m16 tiles (fragments in a slot:
// af[(m * kSliceSteps + j) * 32 + lane]) against NT n8 tiles of W
// (fragments from wk). big*big and the two small cross products go into
// fresh accumulators (no chain is longer than 8 products), whose sum is
// then added to acc: the stage sum.
template <int NT>
__device__ __forceinline__ void stage_mma(const float4* af, const float4* wk,
                                          int steps, int lane,
                                          float (&acc)[2][NT][4]) {
  float bbp[2][NT][4] = {}, crs[2][NT][4] = {};
#pragma unroll
  for (int j = 0; j < kSliceSteps; ++j) {
    if (j < steps) {
      unsigned ab[2][4], as[2][4], bb[NT][2], bs[NT][2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float4 v = af[(m * kSliceSteps + j) * 32 + lane];
        split(v.x, ab[m][0], as[m][0]);
        split(v.y, ab[m][1], as[m][1]);
        split(v.z, ab[m][2], as[m][2]);
        split(v.w, ab[m][3], as[m][3]);
      }
      if constexpr (NT == 1) {
        const float4 v = wk[j * 32 + lane];
        bb[0][0] = __float_as_uint(v.x);
        bb[0][1] = __float_as_uint(v.y);
        bs[0][0] = __float_as_uint(v.z);
        bs[0][1] = __float_as_uint(v.w);
      } else {
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) {
          const float4 vb = wk[(j * NT + i) * 32 + lane];
          const float4 vs = wk[(j * NT + NT / 2 + i) * 32 + lane];
          bb[2 * i][0] = __float_as_uint(vb.x);
          bb[2 * i][1] = __float_as_uint(vb.y);
          bb[2 * i + 1][0] = __float_as_uint(vb.z);
          bb[2 * i + 1][1] = __float_as_uint(vb.w);
          bs[2 * i][0] = __float_as_uint(vs.x);
          bs[2 * i][1] = __float_as_uint(vs.y);
          bs[2 * i + 1][0] = __float_as_uint(vs.z);
          bs[2 * i + 1][1] = __float_as_uint(vs.w);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma(crs[m][nt], as[m], bb[nt]);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma(crs[m][nt], ab[m], bs[nt]);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma(bbp[m][nt], ab[m], bb[nt]);
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][nt][e] += bbp[m][nt][e] + crs[m][nt][e];
}

// The same stage in bf16: `steps` k16 steps of both m16 tiles (a uint4
// of A fragments a lane: af[(m * 2 + j) * 32 + lane]) against NT n8
// tiles (wk[(j * NT + nt) * 32 + lane]), one pass, into fresh
// accumulators whose sum is then added to acc.
template <int NT>
__device__ __forceinline__ void stage_mma(const float4* af, const uint2* wk,
                                          int steps, int lane,
                                          float (&acc)[2][NT][4]) {
  float sp[2][NT][4] = {};
  const uint4* a4 = reinterpret_cast<const uint4*>(af);
#pragma unroll
  for (int j = 0; j < kStageSteps<bf16>; ++j) {
    if (j < steps) {
      unsigned a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint4 v = a4[(m * kStageSteps<bf16> + j) * 32 + lane];
        a[m][0] = v.x;
        a[m][1] = v.y;
        a[m][2] = v.z;
        a[m][3] = v.w;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint2 v = wk[(j * NT + nt) * 32 + lane];
        const unsigned b[2] = {v.x, v.y};
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_bf16(sp[m][nt], a[m], b);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][nt][e] += sp[m][nt][e];
}

// One warp's share of a row group's product: chunks grp, grp + 2, ... of
// the nch chunks of K (`K` rows), slice kw of each, both m16 tiles.
// `src` is the exchange tile (frag_idx order, nks k steps a m16 tile),
// `ready(c)` waits until chunk c is published, `slots` is the warp's
// ring of two chunk slots. The copies of a chunk fly while the warp
// multiplies the one before. Each lane copies and reads only its own
// fragments.
template <int NT, typename T, typename WF, typename Ready>
__device__ __forceinline__ void warp_product(const T* src, int nks, int K,
                                             int nch, int grp, int kw,
                                             const WF* wf, float4* slots,
                                             int lane, Ready ready,
                                             float (&acc)[2][NT][4]) {
  constexpr int SS = kStageSteps<T>, CS = kChunkSteps<T>;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  auto issue = [&](int c, float4* slot) {
    ready(c);
    const int steps = slice_steps<T>(c, kw, K);
    const int ks0 = c * CS + kw * SS;
#pragma unroll
    for (int m = 0; m < 2; ++m)
      for (int j = 0; j < steps; ++j)
        cp16(slot + (m * SS + j) * 32 + lane,
             src4 + ((size_t)m * nks + ks0 + j) * 32 + lane, true);
    cp_commit();
  };
  if (grp < nch) issue(grp, slots);
  if (grp + 2 < nch) issue(grp + 2, slots + kSlot);
  for (int c = grp, i = 0; c < nch; c += 2, ++i) {
    cp_wait_upto(c + 2 < nch ? 1 : 0);
    float4* slot = slots + (i & 1) * kSlot;
    const int steps = slice_steps<T>(c, kw, K);
    if (steps)
      stage_mma<NT>(slot, wf + (size_t)(c * CS + kw * SS) * NT * 32, steps,
                    lane, acc);
    if (c + 4 < nch) issue(c + 4, slot);
  }
}

// The warp's [32 x 8 NT] sums into its partial buffer pw (rows of
// part_ld<NT>() floats).
template <int NT>
__device__ __forceinline__ void store_partial(float* pw, int lane,
                                              const float (&acc)[2][NT][4]) {
  const int g = lane / 4, t4 = lane % 4;
  constexpr int ld = part_ld<NT>();
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* p = pw + (16 * m + g) * ld + 8 * nt + 2 * t4;
      *reinterpret_cast<float2*>(p) = make_float2(acc[m][nt][0], acc[m][nt][1]);
      *reinterpret_cast<float2*>(p + 8 * ld) =
          make_float2(acc[m][nt][2], acc[m][nt][3]);
    }
}

// (row, column) of the row group's product: the eight warps' sums added
// in warp order; `stride` floats between two warps' buffers
__device__ __forceinline__ float sum_partials(const float* part, int stride,
                                              int idx) {
  float v = part[idx];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v += part[(size_t)w * stride + idx];
  return v;
}

// A cooperative launch (every block resident at once, or the launch is
// refused) in clusters of cs blocks.
template <typename Args>
cudaError_t launch(void (*kernel)(Args), const Args& args, int cs,
                   int blocks, size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace rnn_step
