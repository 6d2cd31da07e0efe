// Window side of the device query engines, for Hopper (sm_90a).
//
// box_hits
//   Replaces the Pallas kernel kernels/window_filter.py:box_hits_tiled of
//   the JAX package: the (n, nq) int32 mask lo <= qhi && hi >= qlo over all
//   d dimensions, for one level block of node bounds (f32, or bf16 rounded
//   outward) against the whole window batch.
//   Bound on the H100: memory bytes, n*d*2*(4 or 2) + nq*d*8 + n*nq*4; the
//   (n, nq) int32 output dominates (120 MB for 29,423 leaves x 1024
//   windows, more than the 50 MB L2).  The work is 2d compares per word,
//   far below the card's compute rate, so the kernel is a store stream and
//   its design keeps the stores coming.  Each thread owns R = 4 windows
//   and holds their bounds in registers for its whole life (d = 2 and
//   d = 5, the widths of the port's cells, are template arguments).  A
//   block's 256 threads cover a tile of up to 1024 windows (gridDim.y
//   tiles larger batches; a narrower batch puts several box lanes in one
//   block) and walk a contiguous run of boxes: the run is staged into
//   shared memory with one coalesced load per stage (bf16 widened there by
//   a 16-bit shift, which is exact), and then each box is read with
//   broadcast vector loads, tested against the four windows and written,
//   with no barrier inside the loop.  The grid
//   holds the blocks that fit on the card at once (at least BH_MIN_RUN
//   boxes each), so each thread issues tens of stores; a launch of a few
//   boxes against one tile of windows (the root level) splits the tile
//   into 8 of 128, so that one block's window loads do not hold it up.
//   Where nq % 4 == 0 a thread's windows are neighbours, loaded with
//   16-byte loads and written with one 16-byte store (a warp: 512
//   contiguous bytes of a row); a ragged nq would misalign every row after
//   the first, so there the windows of a thread lie WG apart and each is a
//   4-byte store, coalesced across the warp.
//   Stores are streaming (st.global.cs): the mask is read once, by the
//   next operation.  Comparisons are the plain version's float compares
//   (NaN fails, -0 equals +0).  Any other d reads the windows' bounds
//   through L1 for each box: correct, not fast.
//
// pair_window_ids
//   Replaces kernels/window_filter.py:pair_window_ids: for each (window,
//   leaf) pair, the exact f32 re-check of the leaf box, slot validity
//   (slot < leaf count, pair_valid > 0) and point containment; writes the
//   slot's dataset row or -1 and the pair's count.
//   Bound on the H100: memory bytes, P*S*4 written, the live leaves'
//   points and the inside slots' ids read.  A block per pair spent its
//   life on three dependent round trips and two barriers before its first
//   point; the design takes that chain out.  Each warp owns one pair (8
//   pairs per block on gridDim.x, so P may pass 65535).  Every lane reads
//   the pair's indices (one broadcast word each), then, in one round,
//   the window's bounds (registers at d = 2 and 5), the leaf's count and,
//   in lanes k < d, one dimension of the leaf box, whose re-check is
//   combined with __all_sync.  The scan takes 4 chunks of 32 slots per
//   step: all their points are loaded first (scalar loads: leaf li's
//   block starts at li * S * d floats, so its alignment depends on li),
//   then the ids of the slots inside, then the 4 stores; the count is
//   __popc(__ballot_sync) summed per chunk.  No __syncthreads, no
//   shared-memory reduction.  A padding pair, an index
//   outside its table or a failed re-check reads no point and writes its
//   row of -1 and a count of 0.
//
// window_count_gathered
//   Replaces kernels/window_filter.py:window_count_gathered, the scan of
//   core/jax_index.py:_window_count_core: (nq,) int32 counts of each
//   window's own gathered candidate points (its straddling leaves) that
//   lie in the window, slots with valid <= 0 excluded.  The Pallas kernel
//   carries the sum across point tiles of a sequential grid; here blocks
//   share a window's slots and add their counts.
//   Bound on the H100: memory bytes, nq*npp*4 (validity) + the valid
//   slots' points (4d bytes each) + nq*(8d + 4); the work is 2d compares
//   per slot.  Few slots are valid (about 6 % in the grid index's
//   window_count at d = 2), so the validity words are most of the bytes,
//   and the point loads stay predicated on them: reading every slot's
//   point would add 2d times those bytes.  A thread that loads one word,
//   branches and then loads a point keeps one load in flight, 8 KB per SM
//   where the card needs about 20 KB.  Design: each thread takes 16 slots
//   per step, issues all their validity loads first (four 16-byte loads
//   where npp % 4 == 0 and valid is 16-byte aligned, so every row is;
//   else 16 scalar loads, with the generic-d code), then the points of the
//   valid ones (registers at d = 2 and 5, the widths of the port's cells;
//   scalar loads, as a slot's point starts at a multiple of 4d bytes),
//   then compares.  Both choices were timed (H100 80GB HBM3 at 700 W, cold
//   L2, 1024 x 39,168 slots at d = 2): 16 scalar validity loads are 17 %
//   slower than four 16-byte ones, the generic-d code 9 % slower than
//   registers.  The count is reduced with warp shuffles and shared memory.
//   Block (x, y) counts window x over the y-th share of its slots: each
//   window spreads over several blocks, so that the grid fills the card
//   about WCG_WAVES times (windows hold very different numbers of valid
//   slots, and small shares keep the SMs evenly loaded to the end), none
//   with less than one step of its threads; the shares are added with
//   integer atomics into out, zeroed first (exact in any order).  A window
//   of one share writes its count.
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

constexpr unsigned FULL_MASK = 0xffffffffu;

constexpr int BH_THREADS = 256;        // threads per block
constexpr int BH_R = 4;                // windows per thread
constexpr int BH_STAGE_FLOATS = 4096;  // staged box bounds per block (16 KB)
constexpr int BH_MIN_RUN = 8;          // boxes per box lane and block, at least

constexpr int PAIR_WARPS = 8;          // pairs per block: one per warp
constexpr int PAIR_UNROLL = 4;         // 32-slot chunks per step of the scan

constexpr int WCG_THREADS = 256;
constexpr int WCG_SLOTS = 16;          // slots per thread and step of the scan
constexpr int WCG_WAVES = 8;           // grid of a launch: about this many full cards

constexpr int WMG_THREADS = 256;

constexpr int WCT_THREADS = 256;         // threads per block
constexpr int WCT_STAGE_FLOATS = 4096;   // coordinates per stage buffer (16 KB)
constexpr int WCT_MAX_STAGE = 1024;      // points per stage
constexpr int WCT_UNROLL = 8;            // points per step of the test loop

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// The stride of one staged box, lo then hi (2d floats), rounded up to a
// multiple of 4 so that a box is read with 16-byte loads.
__host__ __device__ constexpr int bh_stride(int d) { return (2 * d + 3) / 4 * 4; }

// D > 0: the dimension, the thread's R windows' bounds in registers;
// D == 0: any d, the windows' bounds read through L1 for each box.  VEC:
// a thread's windows are neighbours, loaded with 16-byte loads and written
// with one 16-byte store (nq % 4 == 0; out, qlo and qhi 16-byte aligned);
// else they lie WG = 2^wg_log2 apart and each is loaded and written on its
// own.  Thread t holds window group t % WG of the block's tile (gridDim.y)
// and box lane t / WG; block x walks boxes [n x / gridDim.x,
// n (x + 1) / gridDim.x).
template <int D, typename B, bool VEC>
__global__ void __launch_bounds__(BH_THREADS)
box_hits_kernel(const B* __restrict__ lo, const B* __restrict__ hi,
                const float* __restrict__ qlo, const float* __restrict__ qhi,
                int32_t* __restrict__ out, int n, int nq, int dd, int wg_log2) {
  constexpr int RD = D > 0 ? D : 1;
  constexpr int BP = bh_stride(RD);
  const int d = D > 0 ? D : dd;
  const int bp = D > 0 ? BP : bh_stride(dd);
  const int stage = BH_STAGE_FLOATS / bp;           // boxes per stage
  __shared__ __align__(16) float sbox[BH_STAGE_FLOATS];
  const int g = threadIdx.x & ((1 << wg_log2) - 1);
  const int lane_b = threadIdx.x >> wg_log2;
  const int n_lanes = BH_THREADS >> wg_log2;
  const int tile0 = blockIdx.y * (BH_R << wg_log2);
  const float qnan = __int_as_float(0x7fc00000);

  int w[BH_R];
  float wl[BH_R][RD], wh[BH_R][RD];                 // D > 0 only
#pragma unroll
  for (int c = 0; c < BH_R; ++c)
    w[c] = VEC ? tile0 + BH_R * g + c : tile0 + g + (c << wg_log2);
  if constexpr (VEC && D > 0) {
    // the 4 neighbouring windows' bounds are 4D floats from a 16-byte
    // boundary: D vector loads per side instead of 4D scalar ones
    const bool live = w[0] < nq;                    // all four or none
    const int64_t row = static_cast<int64_t>(w[0]) * D;
    const float4* pl = reinterpret_cast<const float4*>(qlo + row);
    const float4* ph = reinterpret_cast<const float4*>(qhi + row);
    const float4 none = make_float4(qnan, qnan, qnan, qnan);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float4 a = live ? __ldg(pl + i) : none;
      const float4 b = live ? __ldg(ph + i) : none;
      const float la[4] = {a.x, a.y, a.z, a.w}, hb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        wl[(4 * i + e) / D][(4 * i + e) % D] = la[e];
        wh[(4 * i + e) / D][(4 * i + e) % D] = hb[e];
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < BH_R; ++c) {
#pragma unroll
      for (int k = 0; k < RD; ++k) {
        const bool live = D > 0 && w[c] < nq;       // a dead window is never stored
        wl[c][k] = live ? __ldg(qlo + static_cast<int64_t>(w[c]) * d + k) : qnan;
        wh[c][k] = live ? __ldg(qhi + static_cast<int64_t>(w[c]) * d + k) : qnan;
      }
    }
  }
  bool any_live = false;
#pragma unroll
  for (int c = 0; c < BH_R; ++c) any_live |= w[c] < nq;

  const int64_t begin = static_cast<int64_t>(n) * blockIdx.x / gridDim.x;
  const int64_t end = static_cast<int64_t>(n) * (blockIdx.x + 1) / gridDim.x;
  for (int64_t s0 = begin; s0 < end; s0 += stage) {
    const int n_s = static_cast<int>(end - s0 < stage ? end - s0 : stage);
    // one coalesced pass over the stage's lo rows and hi rows, widened
    const B* ls = lo + s0 * d;
    const B* hs = hi + s0 * d;
    for (int f = threadIdx.x; f < n_s * d; f += BH_THREADS) {
      const int b = f / d;
      const int k = f - b * d;
      sbox[b * bp + k] = widen(ls[f]);
      sbox[b * bp + d + k] = widen(hs[f]);
    }
    __syncthreads();
    if (any_live) {
#pragma unroll 4
      for (int b = lane_b; b < n_s; b += n_lanes) {
        const float* bx = sbox + b * bp;
        bool hit[BH_R];
        if constexpr (D > 0) {
          float v[BP];                               // lo[0..D), hi[D..2D)
#pragma unroll
          for (int i = 0; i < BP; i += 4) {
            const float4 q = *reinterpret_cast<const float4*>(bx + i);
            v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
          }
#pragma unroll
          for (int c = 0; c < BH_R; ++c) {
            bool h = true;
#pragma unroll
            for (int k = 0; k < D; ++k)
              h = h & (v[k] <= wh[c][k]) & (v[D + k] >= wl[c][k]);
            hit[c] = h;
          }
        } else {
#pragma unroll
          for (int c = 0; c < BH_R; ++c) {
            const int64_t row = static_cast<int64_t>(w[c] < nq ? w[c] : nq - 1) * d;
            bool h = true;
            for (int k = 0; k < d; ++k)
              h = h & (bx[k] <= __ldg(qhi + row + k)) & (bx[d + k] >= __ldg(qlo + row + k));
            hit[c] = h;
          }
        }
        int32_t* orow = out + (s0 + b) * nq;
        if constexpr (VEC) {
          if (w[0] < nq)
            __stcs(reinterpret_cast<int4*>(orow + w[0]),
                   make_int4(hit[0], hit[1], hit[2], hit[3]));
        } else {
#pragma unroll
          for (int c = 0; c < BH_R; ++c)
            if (w[c] < nq) __stcs(orow + w[c], static_cast<int>(hit[c]));
        }
      }
    }
    __syncthreads();                                 // the stage is read: refill it
  }
}

// D > 0: the dimension, the window's bounds in registers; D == 0: any d,
// the window's bounds in the warp's slice of shared memory.  Warp w of
// block x scans pair x * PAIR_WARPS + w.
template <int D>
__global__ void __launch_bounds__(PAIR_WARPS * 32)
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
                       int n_pairs, int nq, int n_leaves, int s, int dd) {
  constexpr int RD = D > 0 ? D : 1;
  const int d = D > 0 ? D : dd;
  __shared__ float swin[D > 0 ? 1 : PAIR_WARPS][2][D > 0 ? 1 : MAX_D];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * PAIR_WARPS + warp;
  if (p >= n_pairs) return;                         // the whole warp leaves
  const int qi = __ldg(q_idx + p);
  const int li = __ldg(leaf_idx + p);
  // an index outside its table cannot come from the engine; such a pair is
  // treated as padding instead of being read out of bounds
  const bool live_pair = __ldg(pair_valid + p) > 0 && qi >= 0 && qi < nq &&
                         li >= 0 && li < n_leaves;
  float wl[RD], wh[RD];
  int cnt = 0;
  bool box = true;
#pragma unroll
  for (int k = 0; k < RD; ++k) wl[k] = wh[k] = 0.f;
  if (live_pair) {                                   // warp-uniform
    const float* ql = qlo + static_cast<int64_t>(qi) * d;
    const float* qh = qhi + static_cast<int64_t>(qi) * d;
    if constexpr (D > 0) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        wl[k] = __ldg(ql + k);
        wh[k] = __ldg(qh + k);
      }
    }
    cnt = __ldg(leaf_counts + li);
    // exact f32 re-check of the leaf box: lane k tests dimension k
    const int64_t row = static_cast<int64_t>(li) * d;
    for (int k = lane; k < d; k += 32) {
      const float a = __ldg(ql + k);
      const float b = __ldg(qh + k);
      box = box & (__ldg(leaf_lo + row + k) <= b) & (__ldg(leaf_hi + row + k) >= a);
      if constexpr (D == 0) {
        swin[warp][0][k] = a;
        swin[warp][1][k] = b;
      }
    }
  }
  const bool ok = __all_sync(FULL_MASK, box) && live_pair;
  if constexpr (D == 0) __syncwarp();
  const int live = ok ? (cnt < s ? cnt : s) : 0;    // slots to test

  int32_t* orow = out_ids + p * s;
  const int64_t slot0 = static_cast<int64_t>(ok ? li : 0) * s;
  const float* pts = leaf_pts + slot0 * d;
  const int32_t* ids = leaf_ids + slot0;
  int total = 0;
  for (int c0 = 0; c0 < s; c0 += 32 * PAIR_UNROLL) {   // warp-uniform trips
    bool in[PAIR_UNROLL];
    if constexpr (D > 0) {
      float x[PAIR_UNROLL][D];
#pragma unroll
      for (int u = 0; u < PAIR_UNROLL; ++u) {        // every point first
        const int j = c0 + 32 * u + lane;
        in[u] = j < live;
#pragma unroll
        for (int k = 0; k < D; ++k) x[u][k] = 0.f;
        if (in[u]) {
          const float* pt = pts + static_cast<int64_t>(j) * D;
#pragma unroll
          for (int k = 0; k < D; ++k) x[u][k] = __ldg(pt + k);
        }
      }
#pragma unroll
      for (int u = 0; u < PAIR_UNROLL; ++u) {
        bool h = in[u];
#pragma unroll
        for (int k = 0; k < D; ++k) h = h & (x[u][k] >= wl[k]) & (x[u][k] <= wh[k]);
        in[u] = h;
      }
    } else {
#pragma unroll
      for (int u = 0; u < PAIR_UNROLL; ++u) {
        const int j = c0 + 32 * u + lane;
        bool h = j < live;
        if (h) {
          const float* pt = pts + static_cast<int64_t>(j) * d;
          for (int k = 0; k < d; ++k) {
            const float v = __ldg(pt + k);
            h = h & (v >= swin[warp][0][k]) & (v <= swin[warp][1][k]);
          }
        }
        in[u] = h;
      }
    }
    int32_t id[PAIR_UNROLL];
#pragma unroll
    for (int u = 0; u < PAIR_UNROLL; ++u)            // then the inside slots' ids
      id[u] = in[u] ? __ldg(ids + c0 + 32 * u + lane) : -1;
#pragma unroll
    for (int u = 0; u < PAIR_UNROLL; ++u) {
      const int j = c0 + 32 * u + lane;
      if (j < s) orow[j] = id[u];
      total += __popc(__ballot_sync(FULL_MASK, in[u]));
    }
  }
  if (lane == 0) out_counts[p] = total;
}

// D > 0: the dimension, the window's bounds in registers; D == 0: any d,
// the bounds in shared memory.  W: slots per validity load (4: one 16-byte
// load; 1: a scalar one).  Block (x, y) counts window x over the y-th of
// gridDim.y shares of its npp / W slot groups.
template <int D, int W>
__global__ void __launch_bounds__(WCG_THREADS)
window_count_gathered_kernel(const float* __restrict__ lo,
                             const float* __restrict__ hi,
                             const float* __restrict__ points,
                             const int32_t* __restrict__ valid,
                             int32_t* __restrict__ out, int npp, int dd) {
  constexpr int RD = D > 0 ? D : 1;
  constexpr int U = WCG_SLOTS / W;                  // validity loads per step
  const int d = D > 0 ? D : dd;
  __shared__ float sl[D > 0 ? 1 : MAX_D];
  __shared__ float sh[D > 0 ? 1 : MAX_D];
  __shared__ int warp_sums[WCG_THREADS / 32];
  const int q = blockIdx.x;
  float wl[RD], wh[RD];
  if constexpr (D > 0) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      wl[k] = __ldg(lo + static_cast<int64_t>(q) * D + k);
      wh[k] = __ldg(hi + static_cast<int64_t>(q) * D + k);
    }
  } else {
    for (int k = threadIdx.x; k < d; k += WCG_THREADS) {
      sl[k] = lo[static_cast<int64_t>(q) * d + k];
      sh[k] = hi[static_cast<int64_t>(q) * d + k];
    }
    __syncthreads();
  }
  const int64_t row = static_cast<int64_t>(q) * npp;
  const int32_t* vrow = valid + row;
  const float* prow = points + row * d;
  const int64_t groups = npp / W;
  const int64_t g_end = groups * (blockIdx.y + 1) / gridDim.y;
  int local = 0;
  for (int64_t g0 = groups * blockIdx.y / gridDim.y + threadIdx.x; g0 < g_end;
       g0 += static_cast<int64_t>(WCG_THREADS) * U) {
    int v[U][W];
#pragma unroll
    for (int u = 0; u < U; ++u) {                   // every validity word first
      const int64_t g = g0 + static_cast<int64_t>(u) * WCG_THREADS;
      if (g < g_end) {
        if constexpr (W == 4) {
          const int4 t = __ldg(reinterpret_cast<const int4*>(vrow) + g);
          v[u][0] = t.x; v[u][1] = t.y; v[u][2] = t.z; v[u][3] = t.w;
        } else {
          v[u][0] = __ldg(vrow + g);
        }
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) v[u][w] = 0;
      }
    }
    if constexpr (D > 0) {
      float x[U][W][D];
#pragma unroll
      for (int u = 0; u < U; ++u) {                 // then the valid slots' points
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float* pt =
              prow + ((g0 + static_cast<int64_t>(u) * WCG_THREADS) * W + w) * D;
#pragma unroll
          for (int k = 0; k < D; ++k) x[u][w][k] = v[u][w] > 0 ? __ldg(pt + k) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          bool in = v[u][w] > 0;
#pragma unroll
          for (int k = 0; k < D; ++k)
            in = in & (x[u][w][k] >= wl[k]) & (x[u][w][k] <= wh[k]);
          local += in ? 1 : 0;
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          if (v[u][w] > 0) {
            const float* pt =
                prow + ((g0 + static_cast<int64_t>(u) * WCG_THREADS) * W + w) * d;
            bool in = true;
            for (int k = 0; k < d; ++k) {
              const float xk = __ldg(pt + k);
              in = in & (xk >= sl[k]) & (xk <= sh[k]);
            }
            local += in ? 1 : 0;
          }
        }
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(FULL_MASK, local, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
#pragma unroll
    for (int w = 0; w < WCG_THREADS / 32; ++w) t += warp_sums[w];
    if (gridDim.y == 1) out[q] = t;
    else if (t) atomicAdd(out + q, t);
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

template <int D, typename B, bool VEC>
cudaError_t launch_box_hits(const B* lo, const B* hi, const float* qlo,
                            const float* qhi, int32_t* out, int n, int nq,
                            int d, int wg_log2, cudaStream_t st) {
  static int per_sm = 0;              // resident blocks per SM, found once
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess && per_sm == 0)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, box_hits_kernel<D, B, VEC>, BH_THREADS, 0);
  if (rc != cudaSuccess) return rc;
  const int64_t tile = BH_R << wg_log2;
  const int64_t gy = (nq + tile - 1) / tile;
  // the blocks that fit on the card at once, shared among the window
  // tiles, each with at least BH_MIN_RUN boxes per box lane
  const int64_t run = static_cast<int64_t>(BH_MIN_RUN) * (BH_THREADS >> wg_log2);
  int64_t gx = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1) / gy;
  gx = gx < (n + run - 1) / run ? gx : (n + run - 1) / run;
  gx = gx < 1 ? 1 : gx;
  box_hits_kernel<D, B, VEC><<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
                               BH_THREADS, 0, st>>>(lo, hi, qlo, qhi, out, n, nq, d,
                                                    wg_log2);
  return cudaGetLastError();
}

template <typename B>
cudaError_t box_hits_dispatch(const B* lo, const B* hi, const float* qlo,
                              const float* qhi, int32_t* out, int n, int nq,
                              int d, int wg_log2, bool vec, cudaStream_t st) {
#define BH_CASE(DD)                                                            \
  return vec ? launch_box_hits<DD, B, true>(lo, hi, qlo, qhi, out, n, nq, d,   \
                                            wg_log2, st)                       \
             : launch_box_hits<DD, B, false>(lo, hi, qlo, qhi, out, n, nq, d,  \
                                             wg_log2, st)
  switch (d) {                      // the widths of the port's cells
    case 2: BH_CASE(2);
    case 5: BH_CASE(5);
    default: BH_CASE(0);
  }
#undef BH_CASE
}

template <int D>
void launch_pair_window_ids(const float* qlo, const float* qhi,
                            const float* leaf_lo, const float* leaf_hi,
                            const float* leaf_pts, const int32_t* leaf_ids,
                            const int32_t* leaf_counts, const int32_t* q_idx,
                            const int32_t* leaf_idx, const int32_t* pair_valid,
                            int32_t* out_ids, int32_t* out_counts, int n_pairs,
                            int nq, int n_leaves, int s, int d,
                            cudaStream_t st) {
  const int64_t blocks = (static_cast<int64_t>(n_pairs) + PAIR_WARPS - 1) / PAIR_WARPS;
  pair_window_ids_kernel<D><<<static_cast<unsigned>(blocks), PAIR_WARPS * 32, 0,
                              st>>>(qlo, qhi, leaf_lo, leaf_hi, leaf_pts, leaf_ids,
                                    leaf_counts, q_idx, leaf_idx, pair_valid,
                                    out_ids, out_counts, n_pairs, nq, n_leaves, s, d);
}

}  // namespace

extern "C" int box_hits_launch(const void* lo, const void* hi,
                               const void* qlo, const void* qhi, void* out,
                               int bf16, int n, int nq, int d, void* stream) {
  if (n > 0 && nq > 0) {
    // window groups per tile: the power of two whose 4 windows each cover
    // nq, at most one per thread of the block
    int wg_log2 = 0;
    while ((BH_R << wg_log2) < nq && (1 << wg_log2) < BH_THREADS) ++wg_log2;
    // a grid of one block (a few boxes, the root level, and one tile of
    // windows) spreads its windows over tiles of 128 instead, one block
    // each, so that 8 SMs share the window loads that would hold up one
    if (n <= BH_MIN_RUN && nq <= BH_R * BH_THREADS && wg_log2 > 5) wg_log2 = 5;
    const bool vec = nq % BH_R == 0 && (reinterpret_cast<uintptr_t>(out) |
                                         reinterpret_cast<uintptr_t>(qlo) |
                                         reinterpret_cast<uintptr_t>(qhi)) % 16 == 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* ql = static_cast<const float*>(qlo);
    const float* qh = static_cast<const float*>(qhi);
    int32_t* o = static_cast<int32_t*>(out);
    const cudaError_t rc =
        bf16 ? box_hits_dispatch(static_cast<const uint16_t*>(lo),
                                 static_cast<const uint16_t*>(hi), ql, qh, o, n, nq, d,
                                 wg_log2, vec, st)
             : box_hits_dispatch(static_cast<const float*>(lo),
                                 static_cast<const float*>(hi), ql, qh, o, n, nq, d,
                                 wg_log2, vec, st);
    return static_cast<int>(rc);
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
#define PWI(DD)                                                                \
  launch_pair_window_ids<DD>(                                                  \
      static_cast<const float*>(qlo), static_cast<const float*>(qhi),          \
      static_cast<const float*>(leaf_lo), static_cast<const float*>(leaf_hi),  \
      static_cast<const float*>(leaf_pts),                                     \
      static_cast<const int32_t*>(leaf_ids),                                   \
      static_cast<const int32_t*>(leaf_counts),                                \
      static_cast<const int32_t*>(q_idx),                                      \
      static_cast<const int32_t*>(leaf_idx),                                   \
      static_cast<const int32_t*>(pair_valid), static_cast<int32_t*>(out_ids), \
      static_cast<int32_t*>(out_counts), n_pairs, nq, n_leaves, s, d,          \
      static_cast<cudaStream_t>(stream))
    switch (d) {                    // the widths of the port's cells
      case 2: PWI(2); break;
      case 5: PWI(5); break;
      default: PWI(0); break;
    }
#undef PWI
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int window_count_gathered_launch(const void* lo, const void* hi,
                                            const void* points,
                                            const void* valid, void* out,
                                            int nq, int npp, int d,
                                            void* stream) {
  if (nq > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int32_t* o = static_cast<int32_t*>(out);
    // every row of valid starts 16-byte aligned: one load per 4 slots
    const bool vec = npp % 4 == 0 && reinterpret_cast<uintptr_t>(valid) % 16 == 0;
    const int w = vec ? 4 : 1;
    int dev = 0, sms = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    // blocks per window: about WCG_WAVES full cards of 2048-thread SMs,
    // none with less than one step of its threads
    const int64_t resident = static_cast<int64_t>(sms) * (2048 / WCG_THREADS);
    const int64_t per_step = WCG_THREADS * (WCG_SLOTS / w);   // slot groups
    const int64_t steps = (npp / w + per_step - 1) / per_step;
    int64_t splits = (WCG_WAVES * resident + nq - 1) / nq;
    splits = splits < steps ? splits : steps;
    splits = splits < 65535 ? splits : 65535;
    splits = splits < 1 ? 1 : splits;
    if (splits > 1) {
      rc = cudaMemsetAsync(o, 0, sizeof(int32_t) * nq, st);
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
    const dim3 grid(static_cast<unsigned>(nq), static_cast<unsigned>(splits));
#define WCG(DD, WW)                                                            \
  window_count_gathered_kernel<DD, WW><<<grid, WCG_THREADS, 0, st>>>(          \
      static_cast<const float*>(lo), static_cast<const float*>(hi),            \
      static_cast<const float*>(points), static_cast<const int32_t*>(valid),   \
      o, npp, d)
    if (!vec) WCG(0, 1);            // ragged npp: no path of the port
    else switch (d) {               // the widths of the port's cells
      case 2: WCG(2, 4); break;
      case 5: WCG(5, 4); break;
      default: WCG(0, 4); break;
    }
#undef WCG
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
