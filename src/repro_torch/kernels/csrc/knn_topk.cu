// k-NN side of the device query engine, for Hopper (sm_90a).
//
// leaf_mindist
//   Replaces the Pallas kernel kernels/knn_topk.py:leaf_mindist_tiled of
//   the JAX package (whose fused k-NN computes the same sum inline, in
//   core/queries_jax.py:_knn_core_fused): the (nq, L) f32 plane
//   sum_d (max(lo - q, 0) + max(q - hi, 0))^2 over leaf bounds held in f32
//   or in outward-rounded bf16.
//   Bound on the H100: memory bytes, L*d*2*(4 or 2) + nq*L*4; the output
//   plane dominates, and the work is about 6 flops per element and
//   dimension, far below the card's compute rate.  Design: a 2-D grid of
//   (128-leaf, 16-query) tiles; the query tile sits in shared memory, each
//   thread keeps one leaf's bounds for one dimension in registers and
//   accumulates four queries, and a warp writes 32 neighbouring output
//   words.  bf16 bounds are widened by a 16-bit shift (exact).
//
// pair_dist2
//   Replaces kernels/knn_topk.py:pair_dist2: for each (query, leaf) pair,
//   the squared distance from the query to every slot of the leaf; slots
//   at or past the leaf's count get f32 max.
//   Bound on the H100: memory bytes, P*S*(4d + 4) (points read, distances
//   written).  Design: one block per pair on gridDim.x (P = queries times
//   candidate leaves outgrows gridDim.y's 65535 as the budget escalates);
//   the block loads its own indices and query, and threads stride over
//   the S slots.
//
// Rounding: every sum runs per dimension in the plain version's order with
// __fsub_rn / __fmul_rn / __fadd_rn, so no multiply-add is contracted into
// an FMA and the results equal the plain PyTorch version bit for bit (the
// k-NN certificate d2k[:, -1] <= unscanned compares these values exactly).
//
// Every index in the launch interface is int32; offsets into the arrays
// are formed in 64 bits.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 64;        // the wrappers reject wider points

constexpr int LM_LT = 128;       // leaves per block (threadIdx.x)
constexpr int LM_QROWS = 4;      // threadIdx.y
constexpr int LM_QPT = 4;        // queries per thread
constexpr int LM_QT = LM_QROWS * LM_QPT;  // queries per block

constexpr int PAIR_THREADS = 128;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// max(x, 0) that passes NaN through, as torch.clamp_min does
__device__ __forceinline__ float relu(float x) {
  return x != x ? x : fmaxf(x, 0.f);
}

template <typename B>
__global__ void __launch_bounds__(LM_LT * LM_QROWS)
leaf_mindist_kernel(const float* __restrict__ q, const B* __restrict__ lo,
                    const B* __restrict__ hi, float* __restrict__ out,
                    int nq, int nl, int d) {
  extern __shared__ float sq[];     // [LM_QT][d], row-major like q
  const int q0 = blockIdx.y * LM_QT;
  const int tid = threadIdx.y * LM_LT + threadIdx.x;
  for (int i = tid; i < LM_QT * d; i += LM_LT * LM_QROWS) {
    const int qg = q0 + i / d;
    sq[i] = qg < nq ? q[static_cast<int64_t>(q0) * d + i] : 0.f;
  }
  __syncthreads();
  const int l = blockIdx.x * LM_LT + threadIdx.x;
  if (l >= nl) return;
  float acc[LM_QPT];
#pragma unroll
  for (int i = 0; i < LM_QPT; ++i) acc[i] = 0.f;
  const int64_t row = static_cast<int64_t>(l) * d;
  for (int k = 0; k < d; ++k) {
    const float bl = widen(lo[row + k]);
    const float bh = widen(hi[row + k]);
#pragma unroll
    for (int i = 0; i < LM_QPT; ++i) {
      const float qk = sq[(threadIdx.y + i * LM_QROWS) * d + k];
      const float g = __fadd_rn(relu(__fsub_rn(bl, qk)), relu(__fsub_rn(qk, bh)));
      acc[i] = __fadd_rn(acc[i], __fmul_rn(g, g));
    }
  }
#pragma unroll
  for (int i = 0; i < LM_QPT; ++i) {
    const int qg = q0 + threadIdx.y + i * LM_QROWS;
    if (qg < nq) out[static_cast<int64_t>(qg) * nl + l] = acc[i];
  }
}

__global__ void __launch_bounds__(PAIR_THREADS)
pair_dist2_kernel(const float* __restrict__ queries,
                  const float* __restrict__ leaf_pts,
                  const int32_t* __restrict__ leaf_counts,
                  const int32_t* __restrict__ q_idx,
                  const int32_t* __restrict__ leaf_idx,
                  float* __restrict__ out, int nq, int n_leaves, int s, int d) {
  __shared__ float sq[MAX_D];
  const int p = blockIdx.x;
  const int qi = q_idx[p];
  const int li = leaf_idx[p];
  // an index outside its table cannot come from the engine; such a pair
  // gets no live slots instead of being read out of bounds
  const bool in_range = qi >= 0 && qi < nq && li >= 0 && li < n_leaves;
  for (int k = threadIdx.x; k < d; k += blockDim.x)
    sq[k] = in_range ? queries[static_cast<int64_t>(qi) * d + k] : 0.f;
  __syncthreads();
  const int live = in_range ? min(leaf_counts[li], s) : 0;
  float* orow = out + static_cast<int64_t>(p) * s;
  for (int j = threadIdx.x; j < s; j += blockDim.x) {
    float acc = FLT_MAX;
    if (j < live) {
      const float* pt = leaf_pts + (static_cast<int64_t>(li) * s + j) * d;
      acc = 0.f;
      for (int k = 0; k < d; ++k) {
        const float diff = __fsub_rn(pt[k], sq[k]);
        acc = __fadd_rn(acc, __fmul_rn(diff, diff));
      }
    }
    orow[j] = acc;
  }
}

}  // namespace

extern "C" int leaf_mindist_launch(const void* queries, const void* lo,
                                   const void* hi, void* out, int bf16, int nq,
                                   int nl, int d, void* stream) {
  if (nq > 0 && nl > 0) {
    const dim3 block(LM_LT, LM_QROWS);
    const dim3 grid((nl + LM_LT - 1) / LM_LT, (nq + LM_QT - 1) / LM_QT);
    const size_t shm = static_cast<size_t>(LM_QT) * d * sizeof(float);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* qp = static_cast<const float*>(queries);
    float* o = static_cast<float*>(out);
    if (bf16) {
      leaf_mindist_kernel<uint16_t><<<grid, block, shm, st>>>(
          qp, static_cast<const uint16_t*>(lo), static_cast<const uint16_t*>(hi),
          o, nq, nl, d);
    } else {
      leaf_mindist_kernel<float><<<grid, block, shm, st>>>(
          qp, static_cast<const float*>(lo), static_cast<const float*>(hi), o,
          nq, nl, d);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pair_dist2_launch(const void* queries, const void* leaf_pts,
                                 const void* leaf_counts, const void* q_idx,
                                 const void* leaf_idx, void* out, int n_pairs,
                                 int nq, int n_leaves, int s, int d,
                                 void* stream) {
  if (n_pairs > 0) {
    pair_dist2_kernel<<<n_pairs, PAIR_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(queries),
        static_cast<const float*>(leaf_pts),
        static_cast<const int32_t*>(leaf_counts),
        static_cast<const int32_t*>(q_idx),
        static_cast<const int32_t*>(leaf_idx), static_cast<float*>(out), nq,
        n_leaves, s, d);
  }
  return static_cast<int>(cudaGetLastError());
}
