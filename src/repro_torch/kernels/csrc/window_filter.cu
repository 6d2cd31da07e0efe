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
//   nq*(8d + 4)).  Design: a 2-D grid of (point chunk, window tile); the
//   tile's bounds sit in shared memory laid out [dim][window], so a warp
//   reads one window's bounds as a broadcast; each lane holds WCT_PPL
//   points in registers (the dimension is a template argument up to 8;
//   wider points are read through L1), the warp tests its 32 * WCT_PPL
//   points against one window at a time and counts them with
//   __popc(__ballot_sync(...)); lane l keeps the count of window l of each
//   32-window pass, adds it to the block's count in shared memory, and the
//   block adds its counts to out (zeroed by the launch function) with one
//   atomicAdd per window.
//
// Every index in the launch interface is int32; offsets into the arrays
// are formed in 64 bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 64;        // the wrappers reject wider points

constexpr int BH_QT = 32;        // windows per block: one warp's lanes
constexpr int BH_WARPS = 8;      // warps per block
constexpr int BH_NT = 64;        // boxes per block

constexpr int PAIR_THREADS = 128;

constexpr int WCG_THREADS = 256;

constexpr int WMG_THREADS = 256;

constexpr int WCT_WARPS = 8;             // warps per block
constexpr int WCT_PPL = 8;               // points per lane
constexpr int WCT_CHUNK = WCT_WARPS * 32 * WCT_PPL;  // points per block
constexpr int WCT_MAX_TILE = 1024;       // windows per block (gridDim.y)
constexpr int WCT_SMEM = 48 * 1024;      // dynamic shared memory without opt-in

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

// Windows per block of window_count_tiles at dimension d: as many as
// WCT_SMEM holds (bounds 8d bytes and a count 4 bytes each), a multiple
// of 32, at most WCT_MAX_TILE (64 at d = 64).
int wct_tile(int d) {
  const int fit = WCT_SMEM / (8 * d + 4) / 32 * 32;
  return fit < WCT_MAX_TILE ? fit : WCT_MAX_TILE;
}

// D > 0: the dimension, points held in registers; D == 0: any d, each
// coordinate read again (through L1) for each window.
template <int D>
__global__ void __launch_bounds__(WCT_WARPS * 32)
window_count_tiles_kernel(const float* __restrict__ lo,
                          const float* __restrict__ hi,
                          const float* __restrict__ points,
                          const int32_t* __restrict__ valid,
                          int32_t* __restrict__ out, int nq, int np, int dd,
                          int tile) {
  constexpr int RD = D > 0 ? D : 1;
  const int d = D > 0 ? D : dd;
  extern __shared__ float smem[];
  float* sl = smem;                          // [d][tile]
  float* sh = smem + d * tile;               // [d][tile]
  int* scnt = reinterpret_cast<int*>(smem + 2 * d * tile);  // [tile]
  const int w0 = blockIdx.y * tile;
  const int nw = min(tile, nq - w0);
  const int tid = threadIdx.x;
  for (int i = tid; i < d * nw; i += WCT_WARPS * 32) {
    const int w = i / d;                     // row-major (nq, d) source
    const int k = i - w * d;
    sl[k * tile + w] = lo[static_cast<int64_t>(w0 + w) * d + k];
    sh[k * tile + w] = hi[static_cast<int64_t>(w0 + w) * d + k];
  }
  for (int w = tid; w < nw; w += WCT_WARPS * 32) scnt[w] = 0;
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * WCT_CHUNK +
                       static_cast<int64_t>(warp) * 32 * WCT_PPL + lane;
  bool ok[WCT_PPL];
  float p[WCT_PPL][RD];
#pragma unroll
  for (int j = 0; j < WCT_PPL; ++j) {
    const int64_t i = base + 32 * j;
    ok[j] = i < np && (valid == nullptr || valid[i] > 0);
    if (D > 0) {
#pragma unroll
      for (int k = 0; k < RD; ++k) p[j][k] = ok[j] ? points[i * RD + k] : 0.f;
    }
  }
  for (int wb = 0; wb < nw; wb += 32) {
    const int nl = min(32, nw - wb);
    int mine = 0;                            // lane l: window wb + l
    for (int l = 0; l < nl; ++l) {
      const int w = wb + l;
      int c = 0;
#pragma unroll
      for (int j = 0; j < WCT_PPL; ++j) {
        bool in = ok[j];
        if (D > 0) {
#pragma unroll
          for (int k = 0; k < RD; ++k)
            in = in & (p[j][k] >= sl[k * tile + w]) & (p[j][k] <= sh[k * tile + w]);
        } else if (in) {
          const float* pt = points + (base + 32 * j) * d;
          for (int k = 0; k < d; ++k) {
            const float v = pt[k];
            in = in & (v >= sl[k * tile + w]) & (v <= sh[k * tile + w]);
          }
        }
        c += __popc(__ballot_sync(0xffffffffu, in));
      }
      mine = lane == l ? c : mine;
    }
    if (lane < nl && mine) atomicAdd(&scnt[wb + lane], mine);
  }
  __syncthreads();
  for (int w = tid; w < nw; w += WCT_WARPS * 32) {
    const int c = scnt[w];
    if (c) atomicAdd(&out[w0 + w], c);
  }
}

template <int D>
void launch_count_tiles(const float* lo, const float* hi, const float* pts,
                        const int32_t* valid, int32_t* out, int nq, int np,
                        int d, cudaStream_t st) {
  const int tile = wct_tile(d);
  const dim3 grid((np + WCT_CHUNK - 1) / WCT_CHUNK, (nq + tile - 1) / tile);
  const size_t shm = static_cast<size_t>(tile) * (8 * d + 4);
  window_count_tiles_kernel<D><<<grid, WCT_WARPS * 32, shm, st>>>(
      lo, hi, pts, valid, out, nq, np, d, tile);
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
    switch (d) {
      case 1: launch_count_tiles<1>(l, h, p, v, o, nq, np, d, st); break;
      case 2: launch_count_tiles<2>(l, h, p, v, o, nq, np, d, st); break;
      case 3: launch_count_tiles<3>(l, h, p, v, o, nq, np, d, st); break;
      case 4: launch_count_tiles<4>(l, h, p, v, o, nq, np, d, st); break;
      case 5: launch_count_tiles<5>(l, h, p, v, o, nq, np, d, st); break;
      case 6: launch_count_tiles<6>(l, h, p, v, o, nq, np, d, st); break;
      case 7: launch_count_tiles<7>(l, h, p, v, o, nq, np, d, st); break;
      case 8: launch_count_tiles<8>(l, h, p, v, o, nq, np, d, st); break;
      default: launch_count_tiles<0>(l, h, p, v, o, nq, np, d, st); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
