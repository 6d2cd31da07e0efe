// Window side of the device query engines, for Hopper (sm_90a).
//
// box_hits
//   Replaces the Pallas kernel kernels/window_filter.py:box_hits_tiled of
//   the JAX package: the (n, nq) int32 mask lo <= qhi && hi >= qlo over all
//   d dimensions, for one level block of node bounds (f32, or bf16 rounded
//   outward) against the whole window batch.
//   Bound on the H100: memory bytes, n*d*2*(4 or 2) + nq*d*8 + n*nq*4; the
//   (n, nq) int32 output dominates.  The work is d compares per element,
//   far below the card's compute rate.  Design: a 2-D grid of (64-box,
//   32-window) tiles; the window tile's bounds sit in shared memory laid
//   out [dim][window] so a warp reads them without bank conflicts, a warp
//   shares one box (a broadcast load), and the 32 lanes of a warp write 32
//   neighbouring output words (one 128-byte transaction).  bf16 bounds are
//   widened in registers by a 16-bit shift, which is exact.  Ragged edges
//   are masked here, so no inverted-box padding is needed.
//
// pair_window_ids
//   Replaces kernels/window_filter.py:pair_window_ids: for each (window,
//   leaf) pair, the exact f32 re-check of the leaf box, slot validity
//   (slot < leaf count, pair_valid > 0) and point containment; writes the
//   slot's dataset row or -1 and the pair's count.
//   Bound on the H100: memory bytes, P*S*(4d + 4 + 4) (points and ids
//   read, ids-or-minus-one written).  Design: one block per pair on
//   gridDim.x (P may exceed 65535); the block loads its own indices (the
//   TPU kernel's scalar prefetch), one thread re-checks the leaf box, the
//   threads stride over the S slots, and the count is reduced with warp
//   shuffles and then shared memory.  A pair whose box re-check fails
//   reads no points at all.
//
// window_count_gathered
//   Replaces kernels/window_filter.py:window_count_gathered, the scan of
//   core/jax_index.py:_window_count_core: (nq,) int32 counts of each
//   window's own gathered candidate points (its straddling leaves) that
//   lie in the window, slots with valid <= 0 excluded.  The Pallas kernel
//   carries the sum across point tiles of a sequential grid; here a block
//   owns one window and loops over its slots.
//   Bound on the H100: memory bytes, nq*npp*4 (validity) + the valid
//   slots' points (4d bytes each) + nq*(8d + 4); the work is 2d compares
//   per slot.  Design: one block per window on gridDim.x, the window's
//   bounds in shared memory, threads striding over the slots, and the
//   integer count reduced with warp shuffles and then shared memory
//   (exact in any order).
//
// window_mask_gathered
//   Replaces kernels/window_filter.py:window_mask_gathered, the collection
//   scan of the first-generation window engine (core/queries_jax.py:
//   _pair_collect): the (nq, npp) int32 mask, 1 where slot j of row i is
//   valid (valid > 0) and its point lies in row i's window.
//   Bound on the H100: memory bytes, nq*npp*4 (validity) + the valid
//   slots' points (4d bytes each) + nq*npp*4 (mask) + nq*8d; the work is
//   2d compares per slot.  Design: one thread per (row, slot) over a flat
//   1-D grid with a 64-bit index (rows may exceed 65535); the row's bounds
//   come through L1 into registers, shared by the threads of a block, and
//   an invalid slot reads no point.
//
// window_count_tiles
//   Replaces kernels/window_filter.py:window_count_tiles, the brute-force
//   count behind ops.window_count: (nq,) int32 in-window counts over one
//   shared (np, d) point table, points with valid <= 0 excluded.  The
//   Pallas kernel carries each window tile's counts across the point
//   tiles of a sequential grid; here blocks run in any order and add
//   their counts with integer atomics, which are exact in any order.
//   Bound on the H100: operations, nq*np*2d compares (1024 windows over
//   10M points at d = 2 is 4.1e10), far above its bytes (np*(4d + 4) +
//   nq*(8d + 4)).  What limits a design is instruction issue, and first
//   the compare pipe: an FSETP tests one coordinate against one bound for
//   32 lanes and issues at half the warp rate, so 2d FSETPs per 32
//   point-window tests bound any float design.  Design: lanes own windows
//   and points stream past them, compared as integers.  Each thread holds
//   R windows in registers (R = 4 at d <= 4, 2 at d <= 8; d is a template
//   argument up to 8) as one (base, width) pair per dimension of
//   order-preserving int32 keys, so lo <= x <= hi is the single unsigned
//   compare (unsigned)(key(x) - base) <= width; an empty or NaN bound is a
//   pair no key can meet.  A block of 256 threads covers a tile of 256 R
//   windows (gridDim.y tiles larger batches) and walks its contiguous
//   range of points through shared memory in double-buffered stages
//   loaded with cp.async.  While a stage lands, each thread turns the
//   points it copied into keys, and an invalid point (or a slot past the
//   range) into NaN's key, which fails every test, as NaN fails the plain
//   version's >= and <=.  Then every lane reads the same point (a
//   broadcast vector LDS, no bank conflicts) and tests it against its R
//   windows: per window and dimension one subtraction and one chained
//   ISETP, then one predicated add (PTX, so that nvcc emits one
//   instruction), with no ballot, no popc and no cross-lane reduction.
//   The grid is persistent (the blocks that fit on the card at once,
//   shared among the window tiles), and each block adds its counts into
//   out (zeroed by the launch function) once, one atomicAdd per window.
//   d > 8 keeps f32 points, one window per thread, and reads the window's
//   bounds through L1: correct, not fast.
//
// Every index in the launch interface is int32; offsets into the arrays
// are formed in 64 bits.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 64;        // the wrappers reject wider points

constexpr int BH_QT = 32;        // windows per block: one warp's lanes
constexpr int BH_WARPS = 8;      // warps per block
constexpr int BH_NT = 64;        // boxes per block

constexpr int PAIR_THREADS = 128;

constexpr int WCG_THREADS = 256;

constexpr int WMG_THREADS = 256;

constexpr int WCT_THREADS = 256;         // threads per block
constexpr int WCT_STAGE_FLOATS = 4096;   // coordinates per stage buffer (16 KB)
constexpr int WCT_MAX_STAGE = 1024;      // points per stage
constexpr int WCT_UNROLL = 8;            // points per step of the test loop

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

template <typename B>
__global__ void __launch_bounds__(BH_QT * BH_WARPS)
box_hits_kernel(const B* __restrict__ lo, const B* __restrict__ hi,
                const float* __restrict__ qlo, const float* __restrict__ qhi,
                int32_t* __restrict__ out, int n, int nq, int d) {
  extern __shared__ float smem[];
  float* sqlo = smem;               // [d][BH_QT]
  float* sqhi = smem + d * BH_QT;   // [d][BH_QT]
  const int q0 = blockIdx.y * BH_QT;
  const int b0 = blockIdx.x * BH_NT;
  const int tid = threadIdx.y * BH_QT + threadIdx.x;
  for (int i = tid; i < d * BH_QT; i += BH_QT * BH_WARPS) {
    const int qq = i / d;           // row-major (nq, d) source: coalesced
    const int k = i - qq * d;
    const int q = q0 + qq;
    float vlo = 0.f, vhi = 0.f;
    if (q < nq) {
      vlo = qlo[static_cast<int64_t>(q) * d + k];
      vhi = qhi[static_cast<int64_t>(q) * d + k];
    }
    sqlo[k * BH_QT + qq] = vlo;
    sqhi[k * BH_QT + qq] = vhi;
  }
  __syncthreads();
  const int q = q0 + threadIdx.x;
  if (q >= nq) return;
  for (int r = threadIdx.y; r < BH_NT; r += BH_WARPS) {
    const int b = b0 + r;
    if (b >= n) break;
    const int64_t row = static_cast<int64_t>(b) * d;
    bool hit = true;
    for (int k = 0; k < d; ++k) {
      const float l = widen(lo[row + k]);
      const float h = widen(hi[row + k]);
      hit = hit & (l <= sqhi[k * BH_QT + threadIdx.x]) &
            (h >= sqlo[k * BH_QT + threadIdx.x]);
    }
    out[static_cast<int64_t>(b) * nq + q] = hit ? 1 : 0;
  }
}

__global__ void __launch_bounds__(PAIR_THREADS)
pair_window_ids_kernel(const float* __restrict__ qlo,
                       const float* __restrict__ qhi,
                       const float* __restrict__ leaf_lo,
                       const float* __restrict__ leaf_hi,
                       const float* __restrict__ leaf_pts,
                       const int32_t* __restrict__ leaf_ids,
                       const int32_t* __restrict__ leaf_counts,
                       const int32_t* __restrict__ q_idx,
                       const int32_t* __restrict__ leaf_idx,
                       const int32_t* __restrict__ pair_valid,
                       int32_t* __restrict__ out_ids,
                       int32_t* __restrict__ out_counts,
                       int nq, int n_leaves, int s, int d) {
  __shared__ float sql[MAX_D];
  __shared__ float sqh[MAX_D];
  __shared__ int s_live;            // slots to test: 0 when the pair is out
  __shared__ int warp_sums[PAIR_THREADS / 32];
  const int p = blockIdx.x;
  const int qi = q_idx[p];
  const int li = leaf_idx[p];
  // an index outside its table cannot come from the engine; such a pair is
  // treated as padding instead of being read out of bounds
  const bool in_range = qi >= 0 && qi < nq && li >= 0 && li < n_leaves;
  if (in_range) {
    for (int k = threadIdx.x; k < d; k += blockDim.x) {
      sql[k] = qlo[static_cast<int64_t>(qi) * d + k];
      sqh[k] = qhi[static_cast<int64_t>(qi) * d + k];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bool ok = in_range && pair_valid[p] > 0;
    if (ok) {                       // exact f32 re-check of the leaf box
      const int64_t row = static_cast<int64_t>(li) * d;
      for (int k = 0; k < d; ++k)
        ok = ok & (leaf_lo[row + k] <= sqh[k]) & (leaf_hi[row + k] >= sql[k]);
    }
    s_live = ok ? min(leaf_counts[li], s) : 0;
  }
  __syncthreads();
  const int live = s_live;
  int32_t* orow = out_ids + static_cast<int64_t>(p) * s;
  int local = 0;
  for (int j = threadIdx.x; j < s; j += blockDim.x) {
    int32_t id = -1;
    if (j < live) {
      const int64_t slot = static_cast<int64_t>(li) * s + j;
      const float* pt = leaf_pts + slot * d;
      bool in = true;
      for (int k = 0; k < d; ++k) {
        const float v = pt[k];
        in = in & (v >= sql[k]) & (v <= sqh[k]);
      }
      if (in) {
        id = leaf_ids[slot];
        ++local;
      }
    }
    orow[j] = id;
  }
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < PAIR_THREADS / 32; ++w) t += warp_sums[w];
    out_counts[p] = t;
  }
}

__global__ void __launch_bounds__(WCG_THREADS)
window_count_gathered_kernel(const float* __restrict__ lo,
                             const float* __restrict__ hi,
                             const float* __restrict__ points,
                             const int32_t* __restrict__ valid,
                             int32_t* __restrict__ out, int npp, int d) {
  __shared__ float sl[MAX_D];
  __shared__ float sh[MAX_D];
  __shared__ int warp_sums[WCG_THREADS / 32];
  const int q = blockIdx.x;
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    sl[k] = lo[static_cast<int64_t>(q) * d + k];
    sh[k] = hi[static_cast<int64_t>(q) * d + k];
  }
  __syncthreads();
  const int64_t row = static_cast<int64_t>(q) * npp;
  int local = 0;
  for (int j = threadIdx.x; j < npp; j += blockDim.x) {
    if (valid[row + j] > 0) {
      const float* pt = points + (row + j) * d;
      bool in = true;
      for (int k = 0; k < d; ++k) {
        const float v = pt[k];
        in = in & (v >= sl[k]) & (v <= sh[k]);
      }
      local += in ? 1 : 0;
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < WCG_THREADS / 32; ++w) t += warp_sums[w];
    out[q] = t;
  }
}

__global__ void __launch_bounds__(WMG_THREADS)
window_mask_gathered_kernel(const float* __restrict__ lo,
                            const float* __restrict__ hi,
                            const float* __restrict__ points,
                            const int32_t* __restrict__ valid,
                            int32_t* __restrict__ out, int64_t total, int npp,
                            int d) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * WMG_THREADS + threadIdx.x;
  if (i >= total) return;
  bool in = valid[i] > 0;
  if (in) {
    const int64_t row = (i / npp) * d;
    const float* pt = points + i * d;
    for (int k = 0; k < d; ++k) {
      const float v = pt[k];
      in = in & (v >= lo[row + k]) & (v <= hi[row + k]);
    }
  }
  out[i] = in ? 1 : 0;
}

// The windows one thread holds (R) and the stage's stride per point (DP,
// a power of two, so that one point is one broadcast vector load) at
// dimension D; D == 0 is any d > 8, one window per thread, stride d.
template <int D>
struct Wct {
  static constexpr int R = D == 0 ? 1 : (D <= 4 ? 4 : 2);
  static constexpr int DP = D <= 1 ? 1 : (D <= 2 ? 2 : (D <= 4 ? 4 : 8));
};

// Points per stage: WCT_STAGE_FLOATS coordinates at the stage's stride,
// at most WCT_MAX_STAGE, a multiple of WCT_UNROLL (64 at d = 64).
int wct_stage(int dp) {
  const int fit = WCT_STAGE_FLOATS / dp / WCT_UNROLL * WCT_UNROLL;
  return fit < WCT_MAX_STAGE ? fit : WCT_MAX_STAGE;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {   // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One point's keys of a stage into registers: one broadcast LDS of DP
// words (two at DP = 8); every lane of the warp reads the same address.
template <int DP>
__device__ __forceinline__ void load_point(const int* p, int (&x)[DP]) {
  if constexpr (DP == 1) {
    x[0] = p[0];
  } else if constexpr (DP == 2) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
#pragma unroll
    for (int h = 0; h < DP; h += 4) {
      const int4 v = *reinterpret_cast<const int4*>(p + h);
      x[h] = v.x; x[h + 1] = v.y; x[h + 2] = v.z; x[h + 3] = v.w;
    }
  }
}

// The order-preserving int32 key of a coordinate: a < b exactly when
// key(a) < key(b), for every pair of non-NaN floats (-0 keys as +0, as
// the two compare equal); NaN keys as INT_MAX, above +inf's key.
__device__ __forceinline__ int wct_key(float f) {
  if (f != f) return INT_MAX;
  const int b = __float_as_int(f == 0.f ? 0.f : f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// One dimension of a window as (base, width): the keys x with
// (unsigned)(x - base) <= width are exactly those of lo <= x <= hi, one
// compare instead of two.  An empty bound (lo > hi, or a NaN bound) is
// (INT_MIN, 0): only the key INT_MIN would match, and no float has it.
__device__ __forceinline__ void wct_bound(float lo, float hi, int& base,
                                          int& width) {
  const bool empty = !(lo <= hi);
  base = empty ? INT_MIN : wct_key(lo);
  // mod 2^32 (a whole-line bound spans more than INT_MAX), read as unsigned
  width = empty ? 0
                : static_cast<int>(static_cast<unsigned>(wct_key(hi)) -
                                   static_cast<unsigned>(base));
}

// count += (point key x in window (b, w) in every one of D dimensions): D
// subtractions, D chained unsigned setp and one predicated add.  Written
// in PTX because nvcc turns `if (in) ++count` into an add and a
// predicated move: two instructions where one will do.
template <int D>
__device__ __forceinline__ void count_in(const int* x, const int* b,
                                         const int* w, int& c);
#define WCT_FIRST "sub.u32 t, %1, %2;\n\tsetp.le.u32 p, t, %3;\n\t"
#define WCT_AND(a, b, c) "sub.u32 t, %" #a ", %" #b ";\n\t" \
                         "setp.le.and.u32 p, t, %" #c ", p;\n\t"
#define WCT_OPS(k) "r"(x[k]), "r"(b[k]), "r"(w[k])
#define WCT_COUNT_IN(D, CHAIN, ...)                                          \
  template <>                                                                \
  __device__ __forceinline__ void count_in<D>(const int* x, const int* b,    \
                                              const int* w, int& c) {        \
    asm("{\n\t.reg .pred p;\n\t.reg .u32 t;\n\t" CHAIN                       \
        "@p add.s32 %0, %0, 1;\n\t}"                                         \
        : "+r"(c) : __VA_ARGS__);                                            \
  }
WCT_COUNT_IN(1, WCT_FIRST, WCT_OPS(0))
WCT_COUNT_IN(2, WCT_FIRST WCT_AND(4, 5, 6), WCT_OPS(0), WCT_OPS(1))
WCT_COUNT_IN(3, WCT_FIRST WCT_AND(4, 5, 6) WCT_AND(7, 8, 9), WCT_OPS(0),
             WCT_OPS(1), WCT_OPS(2))
WCT_COUNT_IN(4, WCT_FIRST WCT_AND(4, 5, 6) WCT_AND(7, 8, 9)
             WCT_AND(10, 11, 12), WCT_OPS(0), WCT_OPS(1), WCT_OPS(2),
             WCT_OPS(3))
WCT_COUNT_IN(5, WCT_FIRST WCT_AND(4, 5, 6) WCT_AND(7, 8, 9)
             WCT_AND(10, 11, 12) WCT_AND(13, 14, 15), WCT_OPS(0), WCT_OPS(1),
             WCT_OPS(2), WCT_OPS(3), WCT_OPS(4))
WCT_COUNT_IN(6, WCT_FIRST WCT_AND(4, 5, 6) WCT_AND(7, 8, 9)
             WCT_AND(10, 11, 12) WCT_AND(13, 14, 15) WCT_AND(16, 17, 18),
             WCT_OPS(0), WCT_OPS(1), WCT_OPS(2), WCT_OPS(3), WCT_OPS(4),
             WCT_OPS(5))
WCT_COUNT_IN(7, WCT_FIRST WCT_AND(4, 5, 6) WCT_AND(7, 8, 9)
             WCT_AND(10, 11, 12) WCT_AND(13, 14, 15) WCT_AND(16, 17, 18)
             WCT_AND(19, 20, 21), WCT_OPS(0), WCT_OPS(1), WCT_OPS(2),
             WCT_OPS(3), WCT_OPS(4), WCT_OPS(5), WCT_OPS(6))
WCT_COUNT_IN(8, WCT_FIRST WCT_AND(4, 5, 6) WCT_AND(7, 8, 9)
             WCT_AND(10, 11, 12) WCT_AND(13, 14, 15) WCT_AND(16, 17, 18)
             WCT_AND(19, 20, 21) WCT_AND(22, 23, 24), WCT_OPS(0), WCT_OPS(1),
             WCT_OPS(2), WCT_OPS(3), WCT_OPS(4), WCT_OPS(5), WCT_OPS(6),
             WCT_OPS(7))
#undef WCT_COUNT_IN
#undef WCT_OPS
#undef WCT_AND
#undef WCT_FIRST

// D > 0: the dimension, each thread holding R windows' bounds in
// registers as (base, width) key pairs, the stages holding point keys;
// D == 0: any d, one window per thread, its f32 bounds read through L1
// for each point, the stages holding f32 points.  Block (x, y) counts the points of its
// contiguous range (np / gridDim.x of them) for window tile y.
template <int D>
__global__ void __launch_bounds__(WCT_THREADS)
window_count_tiles_kernel(const float* __restrict__ lo,
                          const float* __restrict__ hi,
                          const float* __restrict__ points,
                          const int32_t* __restrict__ valid,
                          int32_t* __restrict__ out, int nq, int np, int dd,
                          int stage) {
  constexpr int R = Wct<D>::R;
  constexpr int RD = D > 0 ? D : 1;
  const int d = D > 0 ? D : dd;
  const int dp = D > 0 ? Wct<D>::DP : dd;
  extern __shared__ __align__(16) float wct_smem[];
  int* vbuf = reinterpret_cast<int*>(wct_smem + 2 * stage * dp);  // [2][stage]
  const int tid = threadIdx.x;
  const int w0 = blockIdx.y * (R * WCT_THREADS);
  const float qnan = __int_as_float(0x7fc00000);

  // window w0 + r * WCT_THREADS + tid; a padding window (w >= nq) has NaN
  // bounds, contains nothing and is never flushed
  int wb[R][RD], ww[R][RD];
  int cnt[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int w = w0 + r * WCT_THREADS + tid;
    cnt[r] = 0;
#pragma unroll
    for (int k = 0; k < RD; ++k) {
      const bool live = D > 0 && w < nq;
      wct_bound(live ? lo[static_cast<int64_t>(w) * d + k] : qnan,
                live ? hi[static_cast<int64_t>(w) * d + k] : qnan, wb[r][k], ww[r][k]);
    }
  }
  const int wg = w0 + tid;                       // the D == 0 window
  const bool warp_live = w0 + (tid & ~31) < nq;  // the warp holds a window

  const int64_t begin = static_cast<int64_t>(np) * blockIdx.x / gridDim.x;
  const int64_t end = static_cast<int64_t>(np) * (blockIdx.x + 1) / gridDim.x;
  const int n_stages = static_cast<int>((end - begin + stage - 1) / stage);

  // thread tid copies (and later fixes) points tid, tid + WCT_THREADS, ...
  // of every stage
  auto issue = [&](int s) {
    const int64_t left = end - begin - static_cast<int64_t>(s) * stage;
    const int n_s = static_cast<int>(left < stage ? left : stage);
    const int64_t p0 = begin + static_cast<int64_t>(s) * stage;
    float* bp = wct_smem + (s & 1) * stage * dp;
    int* bv = vbuf + (s & 1) * stage;
    for (int p = tid; p < n_s; p += WCT_THREADS) {
      const float* src = points + (p0 + p) * d;
#pragma unroll
      for (int k = 0; k < RD; ++k) cp_async4(bp + p * dp + k, src + k);
      if (D == 0)
        for (int k = 1; k < d; ++k) cp_async4(bp + p * dp + k, src + k);
      if (valid != nullptr) cp_async4(bv + p, valid + p0 + p);
    }
    cp_async_commit();
  };

  if (n_stages > 0) issue(0);
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) issue(s + 1);
    else cp_async_commit();                     // an empty group: keep the count
    cp_async_wait_one();                        // this thread's copies of stage s
    const int64_t left = end - begin - static_cast<int64_t>(s) * stage;
    const int n_s = static_cast<int>(left < stage ? left : stage);
    const int n_round = (n_s + WCT_UNROLL - 1) / WCT_UNROLL * WCT_UNROLL;
    float* bp = wct_smem + (s & 1) * stage * dp;
    const int* bv = vbuf + (s & 1) * stage;
    // validity folded into the data: an invalid point, or a slot past the
    // range, becomes NaN (D > 0: NaN's key), which fails every test; D > 0
    // also turns every coordinate into its key
    for (int p = tid; p < n_round; p += WCT_THREADS) {
      const bool out = p >= n_s || (valid != nullptr && bv[p] <= 0);
      float* pt = bp + p * dp;
      if constexpr (D > 0) {
#pragma unroll
        for (int k = 0; k < D; ++k) pt[k] = __int_as_float(out ? INT_MAX : wct_key(pt[k]));
      } else if (out) {
        for (int k = 0; k < d; ++k) pt[k] = qnan;
      }
    }
    __syncthreads();
    if (warp_live) {
      if constexpr (D > 0) {
        constexpr int DP = Wct<D>::DP;
        for (int p = 0; p < n_round; p += WCT_UNROLL) {
#pragma unroll
          for (int u = 0; u < WCT_UNROLL; ++u) {
            int x[DP];
            load_point<DP>(reinterpret_cast<const int*>(bp) + (p + u) * DP, x);
#pragma unroll
            for (int r = 0; r < R; ++r) count_in<D>(x, wb[r], ww[r], cnt[r]);
          }
        }
      } else if (wg < nq) {
        const float* wlo = lo + static_cast<int64_t>(wg) * d;
        const float* whi = hi + static_cast<int64_t>(wg) * d;
        for (int p = 0; p < n_round; ++p) {
          const float* x = bp + p * dp;
          bool in = true;
          for (int k = 0; k < d && in; ++k)
            in = x[k] >= __ldg(wlo + k) && x[k] <= __ldg(whi + k);
          if (in) ++cnt[0];
        }
      }
    }
    __syncthreads();                            // stage s read: its buffer is free
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int w = w0 + r * WCT_THREADS + tid;
    if (w < nq && cnt[r]) atomicAdd(&out[w], cnt[r]);
  }
}

template <int D>
cudaError_t launch_count_tiles(const float* lo, const float* hi,
                               const float* pts, const int32_t* valid,
                               int32_t* out, int nq, int np, int d,
                               cudaStream_t st) {
  constexpr int R = Wct<D>::R;
  const int dp = D > 0 ? Wct<D>::DP : d;
  const int stage = wct_stage(dp);
  const size_t shm = 2 * static_cast<size_t>(stage) * (dp + 1) * sizeof(float);
  const int gy = (nq + R * WCT_THREADS - 1) / (R * WCT_THREADS);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, window_count_tiles_kernel<D>, WCT_THREADS, shm);
  if (rc != cudaSuccess) return rc;
  // a persistent grid: as many blocks as fit on the card at once, shared
  // among the window tiles, none with less than one stage of points
  const int64_t stages = (static_cast<int64_t>(np) + stage - 1) / stage;
  int64_t gx = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1) / gy;
  gx = gx < 1 ? 1 : gx;
  gx = gx < stages ? gx : stages;
  window_count_tiles_kernel<D><<<dim3(static_cast<unsigned>(gx), gy), WCT_THREADS,
                                 shm, st>>>(lo, hi, pts, valid, out, nq, np, d,
                                            stage);
  return cudaGetLastError();
}

}  // namespace

extern "C" int box_hits_launch(const void* lo, const void* hi,
                               const void* qlo, const void* qhi, void* out,
                               int bf16, int n, int nq, int d, void* stream) {
  if (n > 0 && nq > 0) {
    const dim3 block(BH_QT, BH_WARPS);
    const dim3 grid((n + BH_NT - 1) / BH_NT, (nq + BH_QT - 1) / BH_QT);
    const size_t shm = 2 * static_cast<size_t>(d) * BH_QT * sizeof(float);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* ql = static_cast<const float*>(qlo);
    const float* qh = static_cast<const float*>(qhi);
    int32_t* o = static_cast<int32_t*>(out);
    if (bf16) {
      box_hits_kernel<uint16_t><<<grid, block, shm, st>>>(
          static_cast<const uint16_t*>(lo), static_cast<const uint16_t*>(hi),
          ql, qh, o, n, nq, d);
    } else {
      box_hits_kernel<float><<<grid, block, shm, st>>>(
          static_cast<const float*>(lo), static_cast<const float*>(hi),
          ql, qh, o, n, nq, d);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pair_window_ids_launch(
    const void* qlo, const void* qhi, const void* leaf_lo, const void* leaf_hi,
    const void* leaf_pts, const void* leaf_ids, const void* leaf_counts,
    const void* q_idx, const void* leaf_idx, const void* pair_valid,
    void* out_ids, void* out_counts, int n_pairs, int nq, int n_leaves,
    int s, int d, void* stream) {
  if (n_pairs > 0) {
    pair_window_ids_kernel<<<n_pairs, PAIR_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(qlo), static_cast<const float*>(qhi),
        static_cast<const float*>(leaf_lo), static_cast<const float*>(leaf_hi),
        static_cast<const float*>(leaf_pts),
        static_cast<const int32_t*>(leaf_ids),
        static_cast<const int32_t*>(leaf_counts),
        static_cast<const int32_t*>(q_idx),
        static_cast<const int32_t*>(leaf_idx),
        static_cast<const int32_t*>(pair_valid),
        static_cast<int32_t*>(out_ids), static_cast<int32_t*>(out_counts), nq,
        n_leaves, s, d);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int window_count_gathered_launch(const void* lo, const void* hi,
                                            const void* points,
                                            const void* valid, void* out,
                                            int nq, int npp, int d,
                                            void* stream) {
  if (nq > 0) {
    window_count_gathered_kernel<<<nq, WCG_THREADS, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(lo), static_cast<const float*>(hi),
        static_cast<const float*>(points), static_cast<const int32_t*>(valid),
        static_cast<int32_t*>(out), npp, d);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int window_mask_gathered_launch(const void* lo, const void* hi,
                                           const void* points,
                                           const void* valid, void* out,
                                           int nq, int npp, int d,
                                           void* stream) {
  const int64_t total = static_cast<int64_t>(nq) * npp;
  if (total > 0) {
    const int64_t blocks = (total + WMG_THREADS - 1) / WMG_THREADS;
    window_mask_gathered_kernel<<<static_cast<unsigned>(blocks), WMG_THREADS, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(lo), static_cast<const float*>(hi),
        static_cast<const float*>(points), static_cast<const int32_t*>(valid),
        static_cast<int32_t*>(out), total, npp, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// valid may be null: every point counts.  Zeroes out, then launches.
extern "C" int window_count_tiles_launch(const void* lo, const void* hi,
                                         const void* points, const void* valid,
                                         void* out, int nq, int np, int d,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* o = static_cast<int32_t*>(out);
  if (nq > 0) {
    const cudaError_t rc = cudaMemsetAsync(o, 0, sizeof(int32_t) * nq, st);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  if (nq > 0 && np > 0) {
    const float* l = static_cast<const float*>(lo);
    const float* h = static_cast<const float*>(hi);
    const float* p = static_cast<const float*>(points);
    const int32_t* v = static_cast<const int32_t*>(valid);
    cudaError_t rc = cudaSuccess;
    switch (d) {
      case 1: rc = launch_count_tiles<1>(l, h, p, v, o, nq, np, d, st); break;
      case 2: rc = launch_count_tiles<2>(l, h, p, v, o, nq, np, d, st); break;
      case 3: rc = launch_count_tiles<3>(l, h, p, v, o, nq, np, d, st); break;
      case 4: rc = launch_count_tiles<4>(l, h, p, v, o, nq, np, d, st); break;
      case 5: rc = launch_count_tiles<5>(l, h, p, v, o, nq, np, d, st); break;
      case 6: rc = launch_count_tiles<6>(l, h, p, v, o, nq, np, d, st); break;
      case 7: rc = launch_count_tiles<7>(l, h, p, v, o, nq, np, d, st); break;
      case 8: rc = launch_count_tiles<8>(l, h, p, v, o, nq, np, d, st); break;
      default: rc = launch_count_tiles<0>(l, h, p, v, o, nq, np, d, st); break;
    }
    return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}
