// The pieces of a recurrent kernel that runs one thread-block cluster per
// row group (lstm_cluster.cu's bfloat16 B3 and B4, gru_cluster.cu's B5
// and B6): the blocking (a block owns 32 units of a row group of 16
// rows), the swizzled tiles that wgmma reads, the cell's nonlinearities,
// ldmatrix for W's fragments in registers, the step's all-gather and
// reduce-scatter between the cluster's blocks through distributed shared
// memory, each completing the receiver's mbarrier by its bytes, the wait
// on it (acquire at cluster scope, a trap after 10 s instead of a hang),
// the TMA maps of the [B][T][(gates)][H] tensors in boxes of a block's
// units and rows, and the launch in clusters.
//
// The exchange needs no global counters and no cooperative launch: the
// rows of one row group depend on no other row group, so clusters may
// queue behind each other. lstm_cluster.cu keeps each exchange buffer in
// two, by the parity of the step, each with an mbarrier of one arrival
// (the receiver's own, expecting the peers' bytes) that completes once a
// step. Two buffers are enough: a block can send step s + 2 into buffer
// s & 1 only after it has received step s + 1 from every block, and each
// block sends step s + 1 only after it has read step s. gru_cluster.cu's
// two exchanges a step alternate, and one buffer each is enough (the
// argument is in its head).
// Sources include it by its relative name; kernels/_build.py hashes it
// with every source, so an edit here rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "rnn_step.cuh"

namespace rnn_cluster {

using hopper::smem_u32;
using rnn_step::cluster_rank;
using rnn_step::cluster_sync;

constexpr int kUnits = 32;        // units a block owns
constexpr int kMaxCluster = 16;   // blocks a cluster (non-portable > 8)
constexpr int kRows = 16;         // R: batch rows a cluster (a row group)
// dynamic shared memory ahead of the tiles: the mbarriers (at most 32),
// then the pad to a 1024-byte boundary (the swizzle's)
constexpr int kHead = 2048;

// byte offset of (row, byte) in a tile of 64- or 128-byte swizzled rows
__device__ __forceinline__ int sw64(int row, int byte) {
  return row * 64 + ((((byte >> 4) ^ (row >> 1)) & 3) << 4) + (byte & 15);
}
__device__ __forceinline__ int sw128(int row, int byte) {
  return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

// the 1024-aligned tiles after the mbarriers at the head
__device__ __forceinline__ unsigned char* tiles(unsigned char* raw) {
  const unsigned a = smem_u32(raw);
  return raw + (((a + 256 + 1023) & ~1023u) - a);
}

__device__ __forceinline__ float bf(const unsigned char* p, int i) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
}

// The cell's nonlinearities on the special function unit: __expf and a
// fast reciprocal, within a few ulp of float32 (the gates then round to
// bf16 where they are stored); tanh(x) = 2 sigmoid(2x) - 1. Their limits
// hold at +-inf (1 / inf = 0).
__device__ __forceinline__ float sigm_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}
__device__ __forceinline__ float tanh_fast(float x) {
  return __fdividef(2.f, 1.f + __expf(-2.f * x)) - 1.f;
}

// The four 8 x 8 bf16 matrices at the lanes' row addresses (lanes 8 i ..
// 8 i + 7: the rows of matrix i), as registers 0..3: from a K-major tile
// the A fragment of mma.m16n8k16 (and of wgmma with A in registers);
// transposed, the same from an MN-major tile.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The two 8 x 8 bf16 matrices at the addresses of lanes 0 .. 15 (lanes
// 8 i .. 8 i + 7: the rows of matrix i), transposed, as registers 0, 1:
// from an MN-major tile half of an A fragment (its rows 0 .. 7, K 0 .. 7
// and 8 .. 15; registers 0 and 2 of the fragment)
__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// A barrier of the two warps `id` - 1 and `id` + 3 (the same warp of
// each warpgroup: named barrier id, 64 threads), for a swap of sums
// between thread tid and thread tid ^ 128
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// p's offset in the shared memory of the cluster's block `rank`
__device__ __forceinline__ unsigned peer_addr(const void* p, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// The block's own arrival on its exchange barrier for a step, expecting
// the `bytes` that its peers send into the buffer (none: a plain arrival)
__device__ __forceinline__ void expect(uint64_t* bar, unsigned bytes) {
  if (bytes)
    hopper::mbar_expect_tx(bar, bytes);
  else
    hopper::mbar_arrive(bar);
}

// Wait, with acquire at cluster scope, for the phase of parity `parity`
// of this block's mbarrier b; the clock is read only every 1024 polls
__device__ __forceinline__ void wait(uint64_t* b, unsigned parity) {
  const unsigned a = smem_u32(b);
  unsigned long long t0 = 0;
  for (unsigned n = 1;; ++n) {
    unsigned ok;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(a), "r"(parity)
        : "memory");
    if (ok) return;
    if (n % 1024 == 0) rnn_step::check_hang(t0);
  }
}

// All-gather, one warp: `bytes` of this block's shared memory at src
// (written by ordinary stores, then fence.proxy.async and a barrier) to
// the same offset in every other block of the cluster, lane p sending to
// block p, each copy completing that block's mbarrier at bar's offset.
__device__ __forceinline__ void all_gather(const void* src, unsigned bytes,
                                           uint64_t* bar, unsigned rank,
                                           unsigned nb, unsigned lane) {
  if (lane < nb && lane != rank)
    asm volatile(
        "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
        "bytes [%0], [%1], %2, [%3];\n" ::"r"(peer_addr(src, lane)),
        "r"(smem_u32(src)), "r"(bytes), "r"(peer_addr(bar, lane))
        : "memory");
}

// Where a receiver keeps the float32 piece that block `src` sends it:
// [src][R / 4 quads][32 units][4], quad q of unit ju holding rows 16 (q /
// 4) + 2 (q % 4) + {0, 1, 8, 9}: the four values that one thread of the
// sender's wgmma accumulator holds for a unit (rows 8 i + 2 t + e of
// i = 2k, 2k + 1), so that each is one 16-byte store, and a receiving
// thread reads half a quad of its unit as one 8-byte load, the 32 units
// of a warp spread over 512 consecutive bytes. A piece is 32 R floats.
template <int R>
__device__ __forceinline__ int piece_idx(int src, int ju, int quad) {
  return (src * (R / 4) + quad) * 4 * kUnits + ju * 4;
}
// the row of element e of a unit's quad
__device__ __forceinline__ int piece_row(int quad, int e) {
  return 16 * (quad / 4) + 2 * (quad % 4) + (e & 1) + 8 * (e >> 1);
}

// Reduce-scatter, the sending side of one m64 tile of a float32 product
// over the cluster's units (M = units m0 .. m0 + 63, N = R rows, the
// warpgroup's accumulator d: thread (warp w, lane 4 g + t) holds units
// m0 + 16 w + g + 8 h, rows 8 i + 2 t + e at d[4 i + 2 h + e]): each 32
// units' piece into the `recv` of the block that owns them, at this
// block's slot, 16 bytes a store straight from the registers: by
// st.async, completing that block's mbarrier at bar's offset, or by an
// ordinary store where this block owns them itself, then (ARRIVE) an
// arrival of each of the storing threads on bar, whose count includes
// them (kOwnArrivals), in place of a barrier of the block. Units past
// the cluster's go nowhere.
constexpr int kOwnArrivals = 64;   // two warps store a block's own piece
template <int R, bool ARRIVE = false>
__device__ __forceinline__ void scatter_tile(const float (&d)[R / 2], int m0,
                                             int nunits, float* recv,
                                             uint64_t* bar, unsigned rank,
                                             int warp, int lane) {
  const int g = lane / 4, t = lane % 4;
  const int dst = (m0 + 16 * warp) / kUnits;
  if ((dst + 1) * kUnits > nunits) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ju = 16 * (warp % 2) + g + 8 * h;
#pragma unroll
    for (int k = 0; k < R / 16; ++k) {
      const float4 v = make_float4(d[8 * k + 2 * h], d[8 * k + 2 * h + 1],
                                   d[8 * k + 4 + 2 * h],
                                   d[8 * k + 4 + 2 * h + 1]);
      float* p = recv + piece_idx<R>((int)rank, ju, 4 * k + t);
      if ((unsigned)dst == rank)
        *reinterpret_cast<float4*>(p) = v;
      else
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
            "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(peer_addr(p, dst)),
            "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(peer_addr(bar, dst))
            : "memory");
    }
  }
  if (ARRIVE && (unsigned)dst == rank) hopper::mbar_arrive(bar);
}

// The receiving side: this block's sum, in rank order, of the nb pieces'
// values for unit ju at rows piece_row(quad, 2 hf) and piece_row(quad,
// 2 hf + 1) (half hf of the quad). NMAX > 0: the loads of all NMAX
// pieces' places issued together ahead of the sums, which take the
// first nb (the same sums in the same order), instead of one load after
// each sum; recv must lie in NMAX pieces' bytes of shared memory.
template <int R, int NMAX = 0>
__device__ __forceinline__ float2 gather_sum(const float* recv, int nb,
                                             int ju, int quad, int hf) {
  const float* p = recv + piece_idx<R>(0, ju, quad) + 2 * hf;
  float2 s = *reinterpret_cast<const float2*>(p);
  if constexpr (NMAX > 0) {
    float2 v[NMAX];
#pragma unroll
    for (int src = 1; src < NMAX; ++src)
      v[src] = *reinterpret_cast<const float2*>(p + (size_t)src * kUnits * R);
#pragma unroll
    for (int src = 1; src < NMAX; ++src) {
      s.x = src < nb ? s.x + v[src].x : s.x;
      s.y = src < nb ? s.y + v[src].y : s.y;
    }
  } else {
    for (int src = 1; src < nb; ++src) {
      const float2 v =
          *reinterpret_cast<const float2*>(p + (size_t)src * kUnits * R);
      s.x += v.x;
      s.y += v.y;
    }
  }
  return s;
}

// Set what a launch in clusters of nb blocks of `smem` bytes needs (the
// shared memory beyond 48 KB; clusters of more than 8, which are not
// portable) and report how many such clusters the card can hold at once.
inline cudaError_t prepare(const void* kernel, int nb, int threads,
                           size_t smem, int* clusters) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (nb > 8 &&
      (e = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess)
    return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// The map of a [B][T][H] tensor (gates > 0: [B][T][gates][H]) of
// `es`-byte elements in boxes of 32 units x R rows (x the gates), dense
// in shared memory (also [B][H]: T = 0, no gates).
inline bool unit_map(CUtensorMap* m, const void* base, int gates, int es,
                     CUtensorMapDataType type, int B, int T, int H) {
  const uint64_t h = H, row = (uint64_t)(gates ? gates : 1) * H * es;
  if (gates) {
    const uint64_t dims[4] = {h, (uint64_t)gates, (uint64_t)T, (uint64_t)B};
    const uint64_t strides[3] = {h * es, row, row * T};
    const uint32_t box[4] = {kUnits, (uint32_t)gates, 1, kRows};
    return hopper::make_map(m, base, 4, dims, strides, box, 0, type);
  }
  if (T == 0) {
    const uint64_t dims[2] = {h, (uint64_t)B};
    const uint64_t strides[1] = {row};
    const uint32_t box[2] = {kUnits, kRows};
    return hopper::make_map(m, base, 2, dims, strides, box, 0, type);
  }
  const uint64_t dims[3] = {h, (uint64_t)T, (uint64_t)B};
  const uint64_t strides[2] = {row, row * T};
  const uint32_t box[3] = {kUnits, 1, kRows};
  return hopper::make_map(m, base, 3, dims, strides, box, 0, type);
}
// the mask, [T][bp] float32 (bp a multiple of 4, rows past B zero), in
// boxes of R rows
inline bool mask_map(CUtensorMap* m, const float* mask_t, int B, int T,
                     int bp) {
  const uint64_t dims[2] = {(uint64_t)B, (uint64_t)T};
  const uint64_t strides[1] = {(uint64_t)bp * 4};
  const uint32_t box[2] = {kRows, 1};
  return hopper::make_map(m, mask_t, 2, dims, strides, box, 0,
                          CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// The shared memory a block may take on the current device (its opt-in
// limit)
inline cudaError_t smem_optin(size_t* bytes) {
  int dev = 0, optin = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return e;
  *bytes = (size_t)optin;
  return cudaSuccess;
}

// One cluster of nb blocks per row group; not cooperative: clusters that
// do not fit at once wait for a free place.
template <typename Args>
cudaError_t launch(void (*kernel)(Args), const Args& args, int nb,
                   int groups, int threads, size_t smem,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb * groups);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace rnn_cluster
