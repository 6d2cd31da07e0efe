// Step-2 routing of the balanced grid index, for Hopper (sm_90a).
//
// partition_assign
//   Replaces the Pallas kernel kernels/partition_assign.py:partition_assign
//   of the JAX package (the twin of core/jax_index.py:route): each point
//   descends the heap-form split tables [level, group] with
//   g = 2 g + (coord > val), and its leaf id is written out.
//   The TPU kernel keeps the whole tables in VMEM and selects entries with
//   one-hot matmuls, a way round the TPU's slow gathers.  A descent can
//   reach only 2^levels - 1 entries of the tables: at levels = 15 that is
//   32,767, which fit a block's shared memory at 5 bytes each (the value
//   as f32, the dimension as one byte: 160 KB).
//   Bound on the H100: memory bytes, n*d*4 (points) + n*4 (leaf ids) + the
//   reachable table entries; the work is one compare per level and point.
//   What limits a design is the chain of dependent loads per level (entry,
//   then coordinate) and, once the tables sit in shared memory, the bank
//   conflicts of its random gathers at the deep levels (the upper levels
//   broadcast).  Non-finite split values read as FLT_MAX (the Pallas
//   wrapper's sanitising) and split dimensions are clamped to [0, d), as
//   a JAX gather clamps its index.  Two kernels, chosen by the launch
//   function on n:
//
//   partition_assign_smem_kernel (n >= the launcher's threshold)
//     One persistent block of 512 threads per SM.  At block start the
//     reachable heap of the first min(levels, 15) levels is copied into
//     shared memory, sanitised once: entry (2^l - 1) + g of level l, the
//     dimension as uint8 at byte e and the value as f32 at 32768 + 4 e, so
//     a descent follows e = 2 e + 1 + (coord > val).  Each thread carries
//     PA_PPT points at once (independent descents in flight), their
//     coordinates in registers (d is a template argument up to 8; the
//     level's coordinate is an unrolled select, not a second load; wider
//     points read it through L1).  Levels past 15 read the global tables.
//
//   partition_assign_kernel (small n)
//     One thread per point, `levels` dependent loads of (dim, val) through
//     L2 and one of the coordinate each.  Filling 160 KB of shared memory
//     costs more than this for the few dozen queries of an adaptive batch.
//
// Every extent in the launch interface is int32; offsets are formed in 64
// bits.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int PA_THREADS = 256;        // small-n kernel: threads per block
constexpr int PA_SM_THREADS = 512;     // shared-table kernel: threads per block
constexpr int PA_PPT = 4;              // points per thread in flight
constexpr int PA_SM_LEVELS = 15;       // levels whose tables sit in shared memory
constexpr int PA_DIM_BYTES = 1 << PA_SM_LEVELS;  // uint8 dims; the f32 values follow
constexpr int PA_FILL = 16;            // table entries in flight per thread in the fill

__device__ __forceinline__ float sanitise(float v) {
  return fabsf(v) <= FLT_MAX ? v : FLT_MAX;   // +-inf and NaN
}

__device__ __forceinline__ int clamp_dim(int dim, int d) {
  return min(max(dim, 0), d - 1);
}

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
    const int dim = clamp_dim(__ldg(split_dim + off), d);
    const float val = sanitise(__ldg(split_val + off));
    g = 2 * g + (pt[dim] > val ? 1 : 0);
  }
  out[i] = g;
}

// D > 0: the dimension, coordinates held in registers; D == 0: any d, the
// level's coordinate read through L1.  ls = min(levels, PA_SM_LEVELS).
template <int D>
__global__ void __launch_bounds__(PA_SM_THREADS, 1)
partition_assign_smem_kernel(const float* __restrict__ points,
                             const int32_t* __restrict__ split_dim,
                             const float* __restrict__ split_val,
                             int32_t* __restrict__ out, int n, int dd,
                             int levels, int n_groups, int ls) {
  constexpr int RD = D > 0 ? D : 1;
  const int d = D > 0 ? D : dd;
  extern __shared__ __align__(16) unsigned char pa_smem[];
  uint8_t* sdim = pa_smem;                                       // [2^ls - 1]
  float* sval = reinterpret_cast<float*>(pa_smem + PA_DIM_BYTES);  // [2^ls - 1]

  // the fill: PA_FILL loads of each table in flight per thread
  const int n_ent = (1 << ls) - 1;
  for (int e0 = threadIdx.x; e0 < n_ent; e0 += PA_FILL * PA_SM_THREADS) {
    float v[PA_FILL];
    int dm[PA_FILL];
#pragma unroll
    for (int b = 0; b < PA_FILL; ++b) {
      const int e = e0 + b * PA_SM_THREADS;
      v[b] = 0.f;
      dm[b] = 0;
      if (e < n_ent) {
        const int level = 31 - __clz(e + 1);
        const int64_t off = static_cast<int64_t>(level) * n_groups + (e + 1 - (1 << level));
        v[b] = __ldg(split_val + off);
        dm[b] = __ldg(split_dim + off);
      }
    }
#pragma unroll
    for (int b = 0; b < PA_FILL; ++b) {
      const int e = e0 + b * PA_SM_THREADS;
      if (e < n_ent) {
        sval[e] = sanitise(v[b]);
        sdim[e] = static_cast<uint8_t>(clamp_dim(dm[b], d));
      }
    }
  }
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(gridDim.x) * PA_SM_THREADS;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * PA_SM_THREADS + threadIdx.x;
       base < n; base += stride * PA_PPT) {
    float x[PA_PPT][RD];
    int e[PA_PPT];
#pragma unroll
    for (int j = 0; j < PA_PPT; ++j) {
      const int64_t i = base + j * stride;
      e[j] = 0;
#pragma unroll
      for (int k = 0; k < RD; ++k)
        x[j][k] = (D > 0 && i < n) ? __ldg(points + i * d + k) : 0.f;
    }
    for (int level = 0; level < ls; ++level) {
#pragma unroll
      for (int j = 0; j < PA_PPT; ++j) {
        const float val = sval[e[j]];
        float c;
        if constexpr (D == 1) {
          c = x[j][0];
        } else if constexpr (D > 1) {
          const int dim = sdim[e[j]];
          c = x[j][0];
#pragma unroll
          for (int k = 1; k < D; ++k) c = dim == k ? x[j][k] : c;
        } else {
          const int64_t i = base + j * stride;
          c = i < n ? __ldg(points + i * d + sdim[e[j]]) : 0.f;
        }
        e[j] = 2 * e[j] + 1 + (c > val ? 1 : 0);
      }
    }
    // the group at level ls, then the levels past the shared tables
    int g[PA_PPT];
#pragma unroll
    for (int j = 0; j < PA_PPT; ++j) g[j] = e[j] - n_ent;
    for (int level = ls; level < levels; ++level) {
#pragma unroll
      for (int j = 0; j < PA_PPT; ++j) {
        const int64_t i = base + j * stride;
        const int64_t off = static_cast<int64_t>(level) * n_groups + g[j];
        const int dim = clamp_dim(__ldg(split_dim + off), d);
        const float val = sanitise(__ldg(split_val + off));
        float c;
        if constexpr (D > 0) {
          c = x[j][0];
#pragma unroll
          for (int k = 1; k < D; ++k) c = dim == k ? x[j][k] : c;
        } else {
          c = i < n ? __ldg(points + i * d + dim) : 0.f;
        }
        g[j] = 2 * g[j] + (c > val ? 1 : 0);
      }
    }
#pragma unroll
    for (int j = 0; j < PA_PPT; ++j) {
      const int64_t i = base + j * stride;
      if (i < n) out[i] = g[j];
    }
  }
}

template <int D>
cudaError_t launch_smem(const float* pts, const int32_t* sdim,
                        const float* sval, int32_t* out, int n, int d,
                        int levels, int n_groups, cudaStream_t st) {
  const int ls = levels < PA_SM_LEVELS ? levels : PA_SM_LEVELS;
  const size_t shm = PA_DIM_BYTES + sizeof(float) * ((1u << ls) - 1);
  int dev = 0, sms = 0;
  cudaError_t rc = cudaFuncSetAttribute(partition_assign_smem_kernel<D>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(shm));
  if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  const int64_t need = (static_cast<int64_t>(n) + PA_SM_THREADS * PA_PPT - 1) /
                       (PA_SM_THREADS * PA_PPT);
  const int grid = static_cast<int>(need < sms ? need : sms);
  partition_assign_smem_kernel<D><<<grid, PA_SM_THREADS, shm, st>>>(
      pts, sdim, sval, out, n, d, levels, n_groups, ls);
  return cudaGetLastError();
}

}  // namespace

// n >= smem_min_n takes the shared-table kernel, smaller n the global one.
extern "C" int partition_assign_launch(const void* points,
                                       const void* split_dim,
                                       const void* split_val, void* out, int n,
                                       int d, int levels, int n_groups,
                                       int smem_min_n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(points);
  const int32_t* sd = static_cast<const int32_t*>(split_dim);
  const float* sv = static_cast<const float*>(split_val);
  int32_t* o = static_cast<int32_t*>(out);
  if (n < smem_min_n) {
    partition_assign_kernel<<<(n + PA_THREADS - 1) / PA_THREADS, PA_THREADS, 0,
                              st>>>(p, sd, sv, o, n, d, levels, n_groups);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t rc = cudaSuccess;
  switch (d) {
    case 1: rc = launch_smem<1>(p, sd, sv, o, n, d, levels, n_groups, st); break;
    case 2: rc = launch_smem<2>(p, sd, sv, o, n, d, levels, n_groups, st); break;
    case 3: rc = launch_smem<3>(p, sd, sv, o, n, d, levels, n_groups, st); break;
    case 4: rc = launch_smem<4>(p, sd, sv, o, n, d, levels, n_groups, st); break;
    case 5: rc = launch_smem<5>(p, sd, sv, o, n, d, levels, n_groups, st); break;
    case 6: rc = launch_smem<6>(p, sd, sv, o, n, d, levels, n_groups, st); break;
    case 7: rc = launch_smem<7>(p, sd, sv, o, n, d, levels, n_groups, st); break;
    case 8: rc = launch_smem<8>(p, sd, sv, o, n, d, levels, n_groups, st); break;
    default: rc = launch_smem<0>(p, sd, sv, o, n, d, levels, n_groups, st); break;
  }
  return static_cast<int>(rc);
}
