// Step-2 routing of the balanced grid index, for Hopper (sm_90a).
//
// partition_assign
//   Replaces the Pallas kernel kernels/partition_assign.py:partition_assign
//   of the JAX package (the twin of core/jax_index.py:route): each point
//   descends the heap-form split tables [level, group] with
//   g = 2 g + (coord > val), and its leaf id is written out.
//   The TPU kernel keeps the whole tables in VMEM and selects entries with
//   one-hot matmuls, a way round the TPU's slow gathers.  At levels = 15
//   the tables hold 15 x 32768 entries of 8 bytes (3.9 MB; the part a
//   descent can reach, 2^levels - 1 entries, is 256 KB), more than a
//   block's shared memory, so here they stay in global memory, where L2
//   (50 MB) holds them, and each thread makes plain gathers.
//   Bound on the H100: memory bytes, n*d*4 (points) + n*4 (leaf ids) + the
//   reachable table entries; the work is one compare per level and point.
//   Design: one thread per point, `levels` dependent loads of (dim, val)
//   and of one coordinate each.  Non-finite split values read as FLT_MAX
//   (the Pallas wrapper's sanitising) and split dimensions are clamped to
//   [0, d), as a JAX gather clamps its index.
//
// Every extent in the launch interface is int32; offsets are formed in 64
// bits.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int PA_THREADS = 256;

__global__ void __launch_bounds__(PA_THREADS)
partition_assign_kernel(const float* __restrict__ points,
                        const int32_t* __restrict__ split_dim,
                        const float* __restrict__ split_val,
                        int32_t* __restrict__ out, int n, int d, int levels,
                        int n_groups) {
  const int i = blockIdx.x * PA_THREADS + threadIdx.x;
  if (i >= n) return;
  const float* pt = points + static_cast<int64_t>(i) * d;
  int g = 0;
  for (int level = 0; level < levels; ++level) {
    const int64_t off = static_cast<int64_t>(level) * n_groups + g;
    const int dim = min(max(__ldg(split_dim + off), 0), d - 1);
    float val = __ldg(split_val + off);
    if (!(fabsf(val) <= FLT_MAX)) val = FLT_MAX;   // +-inf and NaN
    g = 2 * g + (pt[dim] > val ? 1 : 0);
  }
  out[i] = g;
}

}  // namespace

extern "C" int partition_assign_launch(const void* points,
                                       const void* split_dim,
                                       const void* split_val, void* out, int n,
                                       int d, int levels, int n_groups,
                                       void* stream) {
  if (n > 0) {
    partition_assign_kernel<<<(n + PA_THREADS - 1) / PA_THREADS, PA_THREADS,
                              0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(points),
        static_cast<const int32_t*>(split_dim),
        static_cast<const float*>(split_val), static_cast<int32_t*>(out), n, d,
        levels, n_groups);
  }
  return static_cast<int>(cudaGetLastError());
}
