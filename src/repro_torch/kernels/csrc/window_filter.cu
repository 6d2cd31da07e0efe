// Window side of the device query engine, for Hopper (sm_90a).
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
