// Training-mode batch-norm backward for Hopper (sm_90a) over a
// channels-minor activation (B7): one persistent, cooperative launch.
//
// Built by paddle_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes: the entry point below is `extern "C"`, takes raw
// device pointers and a stream, launches on that stream without
// synchronising, allocates nothing, and returns the cudaError_t of its
// launch (0 on success).
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
// Bound on the H100: bytes. x and dy are read once and dx written once:
// three passes over M*C elements (616 MB at the ResNet-50 stem,
// [64,112,112,64] float32, 184 us at 3.35 TB/s) against ~12
// floating-point operations an element. The sums must be complete
// before the first dx, so whatever of x and dy is not kept on chip
// between the two is read twice.
//
// Design. The TPU kernel walks a sequential (2, tiles) grid and carries
// the four sums in scratch memory from one step to the next. Here one
// block runs on each SM (the grid is the SM count; asking for all 227 KB
// of shared memory a block may have keeps a second block off), all
// resident at once (a cooperative launch, refused otherwise), and the
// launch plan (kernels/bn_grad.py `plan`, which this file mirrors) cuts
// [M, C] into G channel groups of W columns and R row slabs, G * R <=
// grid; blocks past G * R hold no rows. Block b takes group b % G and
// slab b / G: the tiles of BR rows x W columns r, r + R, r + 2R, ... of
// the group, so that at any moment the blocks read neighbouring tiles
// (one sweep over the rows, kind to the DRAM's pages) and phase 2 sweeps
// back.
//
// 1. Phase 1 streams the block's tiles through S slots of shared memory
//    (x's tile, then dy's), tile t into slot t % S, and a slot is loaded
//    again (tile t + S) as soon as every thread has read it, so up to S
//    tiles are in flight. The last min(n, S) tiles of the slab are never
//    overwritten: they stay resident for phase 2. Loaders, by the plan:
//    TMA 2-D boxes completing an mbarrier per slot (rows 16-byte
//    multiples and aligned: every shape of the ResNet-50 path), 16-byte
//    loads through registers (the same rule where a box cannot hold the
//    group), element loads otherwise (C * elt not a multiple of 16).
//    Rows past M and columns past C read as zero.
// 2. Each thread owns one vector of VEC columns (16 bytes; 1 element for
//    the element loader) and every L-th row of each tile, and adds
//    sum x, sum x^2, sum dy, sum dy x in float32 registers in row order.
//    The block adds its L row lanes (a warp's by an xor tree of
//    shuffles, then the warps in order, where a power of two of threads
//    up to 16 holds a row; else in lane order) and writes one row of
//    partial [R, 4, G * Wp].
// 3. One grid barrier with no reset: each block adds one to a 64-bit
//    counter of this device (g_arrivals, which only grows) with a release
//    reduction and waits, with acquire loads, for it to reach (v / grid +
//    1) * grid, v the counter as the block read it at its start (a trap
//    after 10 s instead of a hang). Every launch adds exactly its grid,
//    which is always the SM count, and no block leaves before all of its
//    launch have arrived; so a launch's blocks, one on each SM, start only
//    once every earlier launch's arrivals are in, and find the counter in
//    their own launch's window. The counter lives in the library's device
//    memory: it survives across calls and CUDA-graph replays, and no
//    caller allocates it.
// 4. Every block adds its group's R partial rows in slab order (chunks of
//    slabs by thread, the chunks then in order): the blocks of a group
//    get the same bits, with no second barrier and no float atomics, and
//    the result does not change from run to run. Slab 0's block writes
//    dscale and dbias.
// 5. Phase 2 walks the tiles in reverse: the resident ones first, straight
//    from shared memory; each freed slot is loaded at once with the tile
//    S below it, so the re-read starts with the lines phase 1 pulled
//    last, which the L2 still holds (where a block reads tiles again,
//    its loads of a tile for the last time ask the L2 to evict them
//    first). dx leaves as 16-byte stores from registers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTma = 0, kVec = 1, kScalar = 2;
constexpr int kMaxSmem = 232448;

// arrivals at the grid barrier on this device since the library loaded
__device__ unsigned long long g_arrivals;

// The plan's numbers, as kernels/bn_grad.py's `plan` gives them.
struct Args {
  CUtensorMap tm_x, tm_dy;   // the TMA loader's maps (else unused)
  const void* x;
  const void* dy;
  const float* scale;
  void* dx;
  float* dscale;
  float* dbias;
  float* partial;   // [R, 4, G * Wp]
  int M, C;
  int W, Wp;        // columns a group, and W rounded up to 4
  int G, R;         // channel groups, row slabs
  int BR, T;        // rows a tile, tiles a group (ceil(M / BR))
  int S;            // slots of shared memory
  unsigned half;    // bytes of one tensor's tile in a slot (128-aligned)
  float eps;
};

// an element type by its bits (bfloat16 or float32), its vector of VEC
// elements moved as one word, and the conversions
template <bool BF, int LOADER>
struct Tr {
  static constexpr int EB = BF ? 2 : 4;
  static constexpr int VEC = LOADER == kScalar ? 1 : 16 / EB;
  using E = typename std::conditional<BF, uint16_t, uint32_t>::type;
  using Word = typename std::conditional<VEC == 1, E, uint4>::type;
  // the scratch of the block sums: max(VEC, 4) floats a thread
  static constexpr int RED = VEC > 4 ? VEC : 4;
};

__device__ __forceinline__ float bf_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}
// the bits of f rounded to bfloat16, to nearest even (as torch rounds)
__device__ __forceinline__ uint32_t to_bf(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

template <bool BF>
__device__ __forceinline__ void unpack(uint4 w, float (&v)[BF ? 8 : 4]) {
  if constexpr (BF) {
    v[0] = bf_lo(w.x); v[1] = bf_hi(w.x);
    v[2] = bf_lo(w.y); v[3] = bf_hi(w.y);
    v[4] = bf_lo(w.z); v[5] = bf_hi(w.z);
    v[6] = bf_lo(w.w); v[7] = bf_hi(w.w);
  } else {
    v[0] = __uint_as_float(w.x); v[1] = __uint_as_float(w.y);
    v[2] = __uint_as_float(w.z); v[3] = __uint_as_float(w.w);
  }
}
template <bool BF>
__device__ __forceinline__ void unpack(uint16_t w, float (&v)[1]) {
  v[0] = bf_lo(w);
}
template <bool BF>
__device__ __forceinline__ void unpack(uint32_t w, float (&v)[1]) {
  v[0] = __uint_as_float(w);
}

template <bool BF>
__device__ __forceinline__ uint4 pack(const float (&v)[BF ? 8 : 4]) {
  uint4 w;
  if constexpr (BF) {
    w.x = to_bf(v[0]) | (to_bf(v[1]) << 16);
    w.y = to_bf(v[2]) | (to_bf(v[3]) << 16);
    w.z = to_bf(v[4]) | (to_bf(v[5]) << 16);
    w.w = to_bf(v[6]) | (to_bf(v[7]) << 16);
  } else {
    w.x = __float_as_uint(v[0]); w.y = __float_as_uint(v[1]);
    w.z = __float_as_uint(v[2]); w.w = __float_as_uint(v[3]);
  }
  return w;
}
template <bool BF>
__device__ __forceinline__ typename Tr<BF, kScalar>::Word pack(
    const float (&v)[1]) {
  if constexpr (BF)
    return (uint16_t)to_bf(v[0]);
  else
    return __float_as_uint(v[0]);
}

// one arrival at the grid barrier, releasing the block's writes before
// the caller's __syncthreads (no value returned: nothing waits for it)
__device__ __forceinline__ void arrive() {
  asm volatile("red.release.gpu.global.add.u64 [%0], 1;\n" ::"l"(
                   &g_arrivals)
               : "memory");
}

// wait (acquire) until the counter reaches target; trap after kHangNs
__device__ __forceinline__ void wait_arrivals(unsigned long long target) {
  unsigned long long v, t0 = 0;
  for (unsigned n = 1;; ++n) {
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
                 : "=l"(v)
                 : "l"(&g_arrivals)
                 : "memory");
    if (v >= target) return;
    if (n % 256 == 0) {
      if (!t0)
        t0 = hopper::now_ns();
      else if (hopper::now_ns() - t0 > hopper::kHangNs)
        __trap();
    }
  }
}

// hopper::tma_load_2d with an L2 eviction policy (createpolicy)
__device__ __forceinline__ void tma_load_2d_hint(void* dst,
                                                 const CUtensorMap* m,
                                                 uint64_t* bar, int c0,
                                                 int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          hopper::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(hopper::smem_u32(bar)),
      "r"(c0), "r"(c1), "l"(policy)
      : "memory");
}

// the phase parity of slot (t % S)'s mbarrier for phase 2's re-read of
// tile t (t < n - S): phase 1 completed (n - 1 - s) / S + 1 phases of
// slot s, and phase 2 reloads it with its tiles in descending order
__device__ __forceinline__ unsigned reread_parity(int t, int n, int S) {
  const int s = t % S;
  return (unsigned)(((n - 1 - s) / S + 1 + (n - S - 1 - t) / S) & 1);
}

template <bool BF, int LOADER>
__global__ void __launch_bounds__(kThreads, 1)
bn_grad_kernel(const __grid_constant__ Args a) {
  using TR = Tr<BF, LOADER>;
  using Word = typename TR::Word;
  constexpr int VEC = TR::VEC;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int nblk = gridDim.x;
  const int g = blockIdx.x % a.G;
  const int r = blockIdx.x / a.G;

  // the end of this launch's window of the barrier's counter: read at
  // the start, when the counter holds every earlier launch's arrivals
  // (their blocks all arrive before any leaves) and none or some of this
  // one's
  unsigned long long target = 0;
  if (tid == 0) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
                 : "=l"(v)
                 : "l"(&g_arrivals)
                 : "memory");
    target = (v / nblk + 1) * nblk;
  }
  if (r >= a.R) {   // no rows: arrive, and leave once all have arrived
    if (tid == 0) {
      arrive();
      wait_arrivals(target);
    }
    return;
  }
  // this slab's tiles of the group: its k-th is r + k * R, so that the
  // blocks of a group sweep [M, C] together, tile beside tile
  const int n = r < a.T ? (a.T - 1 - r) / a.R + 1 : 0;
  auto tile = [&](int k) { return (long long)r + (long long)k * a.R; };
  const int S = a.S;
  const unsigned pair = 2 * a.half;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + (size_t)S * pair);
  float* red = reinterpret_cast<float*>(smem + (size_t)S * pair +
                                        ((8 * S + 15) / 16) * 16);
  float* sums = red + kThreads * TR::RED;   // [4][Wp]
  float* coef = sums + 4 * a.Wp;            // [5][Wp]

  const int tpr = a.W / VEC;                // threads a row
  const int lanes = kThreads / tpr;         // row lanes
  const int j = tid % tpr, l = tid / tpr;
  const int col = g * a.W + j * VEC;        // this thread's first column
  const bool mine = l < lanes && col < a.C;
  const int cols = a.W / VEC;               // words a tile row
  const typename TR::E* xg = static_cast<const typename TR::E*>(a.x);
  const typename TR::E* dyg = static_cast<const typename TR::E*>(a.dy);

  auto slot_x = [&](int s) {
    return reinterpret_cast<const Word*>(smem + (size_t)s * pair);
  };
  auto slot_dy = [&](int s) {
    return reinterpret_cast<const Word*>(smem + (size_t)s * pair + a.half);
  };
  // tile t (of this slab) into slot s: by TMA from thread 0, or by every
  // thread through registers. Where phase 2 reads tiles again, a tile
  // read from device memory for the last time (a resident one, or the
  // re-read itself) is marked first to leave the L2, so that the lines
  // phase 2 reads again stay longer.
  uint64_t evict_first = 0;
  if constexpr (LOADER == kTma)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(evict_first));
  auto load = [&](int t, int s, bool last) {
    const long long row0 = tile(t) * a.BR;
    if constexpr (LOADER == kTma) {
      unsigned char* sx = smem + (size_t)s * pair;
      hopper::mbar_expect_tx(&bar[s], 2u * a.BR * a.W * TR::EB);
      if (last) {
        tma_load_2d_hint(sx, &a.tm_x, &bar[s], g * a.W, (int)row0,
                         evict_first);
        tma_load_2d_hint(sx + a.half, &a.tm_dy, &bar[s], g * a.W,
                         (int)row0, evict_first);
      } else {
        hopper::tma_load_2d(sx, &a.tm_x, &bar[s], g * a.W, (int)row0);
        hopper::tma_load_2d(sx + a.half, &a.tm_dy, &bar[s], g * a.W,
                            (int)row0);
      }
    } else {
      Word* sx = reinterpret_cast<Word*>(smem + (size_t)s * pair);
      Word* sd = reinterpret_cast<Word*>(smem + (size_t)s * pair + a.half);
#pragma unroll 4
      for (int i = tid; i < a.BR * cols; i += kThreads) {
        const long long gr = row0 + i / cols;
        const int c = g * a.W + (i % cols) * VEC;
        Word wx{}, wd{};
        if (gr < a.M && c < a.C) {
          const size_t o = (size_t)gr * a.C + c;
          wx = *reinterpret_cast<const Word*>(xg + o);
          wd = *reinterpret_cast<const Word*>(dyg + o);
        }
        sx[i] = wx;
        sd[i] = wd;
      }
    }
  };

  if constexpr (LOADER == kTma) {
    if (tid == 0) {
      hopper::prefetch_map(&a.tm_x);
      hopper::prefetch_map(&a.tm_dy);
    }
    for (int s = tid; s < S; s += kThreads) hopper::mbar_init(&bar[s], 1);
    hopper::mbar_fence_init();
    __syncthreads();
    if (tid == 0)
      for (int t = 0; t < n && t < S; ++t) load(t, t, n > S && t >= n - S);
  }

  // ---- phase 1: the four sums ----
  float acc[4][VEC];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[q][v] = 0.f;

  for (int t = 0; t < n; ++t) {
    const int s = t % S;
    if constexpr (LOADER == kTma) {
      hopper::mbar_wait(&bar[s], (unsigned)((t / S) & 1));
    } else {
      load(t, s, false);
      __syncthreads();
    }
    if (mine) {
      const Word* sx = slot_x(s);
      const Word* sd = slot_dy(s);
      for (int row = l; row < a.BR; row += lanes) {
        float xv[VEC], dv[VEC];
        unpack<BF>(sx[row * cols + j], xv);
        unpack<BF>(sd[row * cols + j], dv);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          acc[0][v] += xv[v];
          acc[1][v] += xv[v] * xv[v];
          acc[2][v] += dv[v];
          acc[3][v] += dv[v] * xv[v];
        }
      }
    }
    if constexpr (LOADER == kTma) {
      __syncthreads();   // slot s read by all: load tile t + S into it
      if (tid == 0 && t + S < n) load(t + S, s, t + S >= n - S);
    }
  }

  // the block's row lanes -> partial[r][q][g * Wp + c]
  const size_t cp = (size_t)a.G * a.Wp;
  float* part = a.partial + (size_t)r * 4 * cp + (size_t)g * a.Wp;
  if (tpr <= 16 && (tpr & (tpr - 1)) == 0) {
    // a warp's lanes of one column vector by an xor tree, then the
    // warps in order, two of the sums a round
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        for (int off = tpr; off < 32; off *= 2)
          acc[q][v] += __shfl_xor_sync(0xffffffffu, acc[q][v], off);
    const int w = tid / 32, lane = tid % 32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (lane < tpr)
#pragma unroll
        for (int qq = 0; qq < 2; ++qq)
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            red[(w * 2 + qq) * a.W + lane * VEC + v] = acc[2 * h + qq][v];
      __syncthreads();
      for (int i = tid; i < 2 * a.Wp; i += kThreads) {
        const int qq = i / a.Wp, c = i % a.Wp;
        float sum = 0.f;
        if (c < a.W)
          for (int ww = 0; ww < kThreads / 32; ++ww)
            sum += red[(ww * 2 + qq) * a.W + c];
        part[(size_t)(2 * h + qq) * cp + c] = sum;
      }
      __syncthreads();
    }
  } else {
    // any other width: the row lanes in lane order, one sum a round
    for (int q = 0; q < 4; ++q) {
      if (l < lanes)
#pragma unroll
        for (int v = 0; v < VEC; ++v) red[tid * VEC + v] = acc[q][v];
      __syncthreads();
      for (int c = tid; c < a.Wp; c += kThreads) {
        float sum = 0.f;
        if (c < a.W)
          for (int ll = 0; ll < lanes; ++ll) sum += red[ll * a.W + c];
        part[(size_t)q * cp + c] = sum;
      }
      __syncthreads();
    }
  }

  // ---- the grid barrier ----
  if (tid == 0) {
    arrive();
    wait_arrivals(target);
  }
  __syncthreads();

  // ---- the group's sums: R partial rows in slab order ----
  const int ni = a.Wp;          // float4 items: 4 sums x Wp / 4 columns
  const int quads = a.Wp / 4;
  float4* red4 = reinterpret_cast<float4*>(red);
  float4* sums4 = reinterpret_cast<float4*>(sums);
  auto item_sum = [&](int item, int r0, int r1) {
    const int q = item / quads, k = item % quads;
    const float* p = a.partial + (size_t)q * cp + (size_t)g * a.Wp + 4 * k;
    float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int rr = r0; rr < r1; ++rr) {
      const float4 v =
          __ldcg(reinterpret_cast<const float4*>(p + (size_t)rr * 4 * cp));
      s4.x += v.x; s4.y += v.y; s4.z += v.z; s4.w += v.w;
    }
    return s4;
  };
  if (ni <= kThreads) {
    const int parts = kThreads / ni;
    const int chunk = (a.R + parts - 1) / parts;
    if (tid < parts * ni) {
      const int item = tid % ni, part = tid / ni;
      const int r0 = part * chunk < a.R ? part * chunk : a.R;
      const int r1 = r0 + chunk < a.R ? r0 + chunk : a.R;
      red4[part * ni + item] = item_sum(item, r0, r1);
    }
    __syncthreads();
    if (tid < ni) {
      float4 s4 = red4[tid];
      for (int part = 1; part < parts; ++part) {
        const float4 v = red4[part * ni + tid];
        s4.x += v.x; s4.y += v.y; s4.z += v.z; s4.w += v.w;
      }
      sums4[tid] = s4;
    }
  } else {
    for (int item = tid; item < ni; item += kThreads)
      sums4[item] = item_sum(item, 0, a.R);
  }
  __syncthreads();
  const float nf = (float)a.M;
  for (int c = tid; c < a.W; c += kThreads) {
    const int cc = g * a.W + c;
    if (cc >= a.C) continue;
    const float sx = sums[c], sxx = sums[a.Wp + c];
    const float sdy = sums[2 * a.Wp + c], sdyx = sums[3 * a.Wp + c];
    const float mean = sx / nf;
    const float var = fmaxf(sxx / nf - mean * mean, 0.f);
    const float inv = rsqrtf(var + a.eps);
    const float ds = (sdyx - mean * sdy) * inv;
    coef[c] = mean;
    coef[a.Wp + c] = inv;
    coef[2 * a.Wp + c] = sdy;
    coef[3 * a.Wp + c] = ds;
    coef[4 * a.Wp + c] = a.scale[cc] * inv / nf;
    if (r == 0) {
      a.dscale[cc] = ds;
      a.dbias[cc] = sdy;
    }
  }
  __syncthreads();

  // ---- phase 2: dx, the tiles in reverse ----
  float mean[VEC], inv[VEC], db[VEC], ds[VEC], k[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int c = j * VEC + v;
    mean[v] = mine ? coef[c] : 0.f;
    inv[v] = mine ? coef[a.Wp + c] : 0.f;
    db[v] = mine ? coef[2 * a.Wp + c] : 0.f;
    ds[v] = mine ? coef[3 * a.Wp + c] : 0.f;
    k[v] = mine ? coef[4 * a.Wp + c] : 0.f;
  }
  Word* dxg = static_cast<Word*>(a.dx);
  for (int t = n - 1; t >= 0; --t) {
    const int s = t % S;
    if (t < n - S) {   // not resident: read again
      if constexpr (LOADER == kTma) {
        hopper::mbar_wait(&bar[s], reread_parity(t, n, S));
      } else {
        load(t, s, true);
        __syncthreads();
      }
    }
    const long long row0 = tile(t) * a.BR;
    const int rows = (int)(a.M - row0 < a.BR ? a.M - row0 : a.BR);
    if (mine) {
      const Word* sx = slot_x(s);
      const Word* sd = slot_dy(s);
      for (int row = l; row < rows; row += lanes) {
        float xv[VEC], dv[VEC], o[VEC];
        unpack<BF>(sx[row * cols + j], xv);
        unpack<BF>(sd[row * cols + j], dv);
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          o[v] = k[v] * (nf * dv[v] - db[v] - (xv[v] - mean[v]) * inv[v] *
                                                   ds[v]);
        dxg[((size_t)(row0 + row) * a.C + col) / VEC] = pack<BF>(o);
      }
    }
    __syncthreads();   // slot s read by all
    if constexpr (LOADER == kTma)
      if (tid == 0 && t - S >= 0) load(t - S, s, true);
  }
}

// dynamic shared memory of a plan: the slots, their mbarriers, the block
// sums' scratch, the group's sums and coefficients
template <bool BF, int LOADER>
size_t smem_bytes(const Args& a) {
  return (size_t)a.S * 2 * a.half + ((8 * (size_t)a.S + 15) / 16) * 16 +
         (size_t)4 * kThreads * Tr<BF, LOADER>::RED + (size_t)36 * a.Wp;
}

template <bool BF, int LOADER>
cudaError_t launch(Args& a, int grid, cudaStream_t stream) {
  using TR = Tr<BF, LOADER>;
  if (a.W % TR::VEC || a.W / TR::VEC > kThreads ||
      (LOADER != kScalar && a.C % TR::VEC))
    return cudaErrorInvalidValue;
  if (LOADER == kTma) {
    if (a.W > 256 || a.BR > 256 ||
        a.half != (unsigned)(((size_t)a.BR * a.W * TR::EB + 127) / 128 * 128))
      return cudaErrorInvalidValue;
    const uint64_t dims[2] = {(uint64_t)a.C, (uint64_t)a.M};
    const uint64_t strides[1] = {(uint64_t)a.C * TR::EB};
    const uint32_t box[2] = {(uint32_t)a.W, (uint32_t)a.BR};
    const CUtensorMapDataType type = BF ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    if (!hopper::make_map(&a.tm_x, a.x, 2, dims, strides, box, 0, type) ||
        !hopper::make_map(&a.tm_dy, a.dy, 2, dims, strides, box, 0, type))
      return cudaErrorInvalidValue;
  }
  // all a block may have, whatever the plan uses: no second block fits
  // on an SM beside it (the grid barrier's windows rely on that)
  const size_t smem = kMaxSmem;
  if (smem_bytes<BF, LOADER>(a) > smem) return cudaErrorInvalidValue;
  auto kernel = bn_grad_kernel<BF, LOADER>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool BF>
cudaError_t dispatch(Args& a, int loader, int grid, cudaStream_t s) {
  if (loader == kTma) return launch<BF, kTma>(a, grid, s);
  if (loader == kVec) return launch<BF, kVec>(a, grid, s);
  return launch<BF, kScalar>(a, grid, s);
}

}  // namespace

// x, dy, dx: [M, C] contiguous, float32 (is_bf16 = 0) or bfloat16 (1).
// scale, dscale, dbias: [C] float32. partial: [slabs, 4, groups * Wp]
// float32 scratch, Wp = width rounded up to 4. loader: 0 TMA, 1 16-byte
// loads, 2 element loads. width, groups, slabs, tile_rows, slots: the
// plan (kernels/bn_grad.py `plan`); grid must be the device's SM count,
// the same for every launch on it (the barrier's windows).
extern "C" int bn_grad(const void* x, const void* dy, const void* scale,
                       void* dx, void* dscale, void* dbias, void* partial,
                       int M, int C, float eps, int is_bf16, int loader,
                       int width, int groups, int slabs, int tile_rows,
                       int slots, int grid, void* stream) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return (int)cudaErrorInvalidDevice;
  if (M <= 0 || C <= 0 || width <= 0 || groups <= 0 || slabs <= 0 ||
      tile_rows <= 0 || slots < 2 || grid != sms ||
      (long long)groups * slabs > grid ||
      (long long)groups * width < C || (long long)(groups - 1) * width >= C ||
      loader < kTma || loader > kScalar)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.x = x;
  a.dy = dy;
  a.scale = static_cast<const float*>(scale);
  a.dx = dx;
  a.dscale = static_cast<float*>(dscale);
  a.dbias = static_cast<float*>(dbias);
  a.partial = static_cast<float*>(partial);
  a.M = M;
  a.C = C;
  a.W = width;
  a.Wp = (width + 3) / 4 * 4;
  a.G = groups;
  a.R = slabs;
  a.BR = tile_rows;
  a.T = (int)(((long long)M + tile_rows - 1) / tile_rows);
  a.S = slots;
  const int eb = is_bf16 ? 2 : 4;
  a.half = (unsigned)(((size_t)tile_rows * width * eb + 127) / 128 * 128);
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<true>(a, loader, grid, s)
                       : dispatch<false>(a, loader, grid, s));
}
