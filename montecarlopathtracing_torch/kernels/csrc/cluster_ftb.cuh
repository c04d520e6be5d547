// Nearest hit over front-to-back candidate units with an early exit: the
// device code of cluster_intersect_hbm.cu (unit = one supergroup block of
// the swizzled table).  The chunked kernel (cluster_intersect_ftb.cu) walks
// its rows the same way with a body of its own.
//
// Replaces the body of montecarlopathtracing_tpu/kernels/cluster.py::
// _intersect_hbm_kernel.
//
// A row is one ray subtile.  Its candidate units arrive sorted by
// their entry key (the subtile's least slab-entry distance, quantised down),
// `qkeys` aligned with `order`.  They are walked in that order, and the walk
// stops before a unit if
//     qkeys[j] > max over the subtile's rays of min(best t, cap)
// where cap is the ray's exit distance from the enclosing box (ray column 6,
// 9 with Moller-Trumbore), 1e30 for none.
// The units come sorted, so every unit not tested has an entry beyond every
// ray's bound: it can neither win nor tie.  The best is the order-independent
// lexicographic (t, triangle id) minimum of cluster_tri.cuh, so the result
// equals a scan of all candidates in any order.  A best t that is out of
// date only makes the bound larger: the walk then tests more and returns the
// same result.
//
// Bound on an H100: as cluster_intersect.cu, f32 instruction throughput
// (about 34 fused operations per (ray, triangle) pair, twice that unfused)
// against 64 table bytes per triangle and subtile.  What keeps a kernel far
// below that here: a 4-byte shared-memory load per table word and test; per
// 128-column piece two barriers around a copy through registers with
// nothing in flight, plus a third barrier per unit for the exit bound; and
// one block per row, so that a launch ends on its longest row (330
// supergroups of 512 columns in one call of the 400k-triangle frame) while
// the other SMs drain.
//
// The design:
//   * a unit is cut into pieces of at most 128 columns (a supergroup of any
//     size fits) that stream through the cp.async ring of cluster_tri.cuh and
//     are tested on a register tile of 4 rays per thread; one barrier per
//     piece;
//   * a row's pieces, numbered front to back, are dealt out to the n_split
//     blocks of the row in turn (block y takes pieces y, y + n_split, ...),
//     so all of them advance front to back together: with four pieces to a
//     supergroup and n_split = 16, each block takes one 128-column quarter of
//     every fourth candidate.  The blocks share the rays' best hits through one
//     64-bit word per ray in device memory (hit_word in cluster_tri.cuh):
//     when a block finishes its share of a unit it atomicMins its bests into
//     the words, and what the atomics return is the other blocks' progress,
//     from which it takes its bound.  The words end as the row's result; the
//     caller presets them to the miss and unpacks them.  With n_split = 1
//     there are no words: the block keeps its bests and writes (t, id);
//   * the copy runs ahead: while a piece is tested the block's next piece is
//     in flight, fetched on the guess that the walk goes on (a wrong guess
//     costs one unused 8 KB copy);
//   * the exit bound costs no barrier of its own: each warp reduces min(best
//     t, cap) over its rays (shuffles over the lanes of a ray group, then a
//     max over the warp) into a slot of its own, and every thread reads the
//     slots after the barrier that the next piece needs anyway.  The slots
//     alternate with the piece's parity, so a warp that runs ahead never
//     overwrites a slot still being read.  Every thread reads the same slots
//     and takes the same branch;
//   * the blocks take their rows from the key kernel's row list
//     (cluster_rows.cuh), longest candidate lists first, so the launch does
//     not end on one long row while SMs drain, and a row without candidates
//     gets no block that does anything.

#pragma once

#include "cluster_rows.cuh"
#include "cluster_tri.cuh"

namespace mcpt {

// rays     (n_subtiles * tile, ray_stride) f32 rows, the cap in column 6
//          (9 with MT)
// counts   (n_subtiles,) i32, order / qkeys (that, n_units)
// heads, wrows  the row list of cluster_rows.cuh over these counts: blocks
//          (b, *) take the list's entry b, and those past its end leave: the
//          caller presets `packed`, or out_t / out_tri, to the miss for the
//          rows not listed
// tconst   (n_units, 16, unit_cols) f32; unit_cols is a power of two, cut
//          into 1 << pshift pieces
// packed   (n_subtiles * tile,) u64 preset to kMissWord, with a grid of
//          (rows, n_split); or null with a grid of (rows, 1), and then out_t /
//          out_tri (n_subtiles * tile,) are written.  The triangle id is
//          unit * unit_cols + column
// tested   null, or one counter that receives the number of (subtile, unit)
//          pairs whose first piece was tested
template <bool MT>
__global__ void __launch_bounds__(kMaxThreads, MCPT_MIN_BLOCKS)
cluster_ftb_kernel(
    const float* __restrict__ rays, int ray_stride, int tile,
    const int* __restrict__ counts,
    const int* __restrict__ order, const float* __restrict__ qkeys,
    const int* __restrict__ heads, const int* __restrict__ wrows,
    int n_units, const float* __restrict__ tconst, int unit_cols, int pshift,
    int split,
    unsigned long long* __restrict__ packed, float* __restrict__ out_t,
    int* __restrict__ out_tri, unsigned long long* __restrict__ tested) {
  extern __shared__ float4 s_ring[];            // [kStages][4 * pcols]
  __shared__ int s_bound[2][kMaxThreads / 32];  // [piece parity][warp]

  const int listed = list_row(heads, wrows, gridDim.x, blockIdx.x);
  if (listed < 0) return;  // past the list: the preset misses stand
  const size_t row = listed;
  const int n_split = gridDim.y;
  const int npu = 1 << pshift;
  const int total = counts[row] * npu;  // the row's pieces
  // This block's pieces: blockIdx.y, blockIdx.y + n_split, ...
  const int n_mine = (total - (int)blockIdx.y + n_split - 1) / n_split;
  if (n_mine <= 0) return;  // fewer pieces than blocks: nothing for this one

  const size_t ray0 = row * tile;
  const int* cand = order + row * n_units;
  const float* qk = qkeys + row * n_units;
  const float* table = tconst;
  const int pcols = min(unit_cols, kPieceCols);

  auto stage = [&](int i) {
    const int q = blockIdx.y + i * n_split;
    stage_cols(s_ring + (i % kStages) * 4 * pcols, 0,
               table + (size_t)cand[q >> pshift] * 16 * unit_cols +
                   (q & (npu - 1)) * kPieceCols,
               unit_cols, pcols);
    __pipeline_commit();
  };
  stage(0);

  const int part = threadIdx.x % split;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  Ray r[kRaysPerThread];
  float cap[kRaysPerThread];
  float bt[kRaysPerThread];
  int bi[kRaysPerThread];
  int first;
  load_ray_tile<MT>(rays + ray0 * ray_stride, ray_stride, tile, split, r,
                    first);
#pragma unroll
  for (int i = 0; i < kRaysPerThread; ++i) {
    const size_t in_sub = min(first + i, tile - 1);
    cap[i] = rays[(ray0 + in_sub) * ray_stride + (MT ? 9 : 6)];
    bt[i] = kBig;
    bi[i] = INT_MAX;
  }

  int done = 0;  // units whose first piece this block tested
  for (int i = 0; i < n_mine; ++i) {
    const int q = blockIdx.y + i * n_split;
    const int j = q >> pshift;
    const int p = q & (npu - 1);
    if (i + 1 < n_mine)
      stage(i + 1);  // a guess that the walk goes on
    else
      __pipeline_commit();  // an empty group keeps the wait below uniform
    __pipeline_wait_prior(1);  // this thread's share of the piece has landed
    __syncthreads();  // everyone's has; the piece before is no longer read;
                      // the bound slots written after it are complete
    if (i > 0 && j != (q - n_split) >> pshift) {  // a new unit: may we stop?
      const int* slots = s_bound[(i - 1) & 1];
      int b = slots[0];
      for (int w = 1; w < n_warps; ++w) b = max(b, slots[w]);
      if (qk[j] > __int_as_float(ordered_bits(b))) break;  // block-wide
    }
    if (p == 0) ++done;
    const int base = cand[j] * unit_cols + p * kPieceCols;
    test_piece<MT>(r, s_ring + (i % kStages) * 4 * pcols, pcols, part, split,
                   bt, bi, [&](int c) { return base + c; });
    if (i + 1 < n_mine && j != (q + n_split) >> pshift) {
      // This block's share of unit j is done: the bound for its next unit,
      // max over this warp's rays of min(best t of the ray, cap).
      int m = INT_MIN;
#pragma unroll
      for (int k = 0; k < kRaysPerThread; ++k) {
        float rt = bt[k];
        if (packed == nullptr) {
          for (int off = split >> 1; off > 0; off >>= 1)
            rt = fminf(rt, __shfl_xor_sync(0xffffffffu, rt, off));
        } else {
          // Publish the group's best for the ray; what the atomic returns
          // tells how far the row's other blocks have come.
          int ri = bi[k];
          lex_reduce(rt, ri, split);
          if (part == 0) {
            const unsigned long long mine = hit_word(rt, ri);
            const unsigned long long old = atomicMin(
                packed + ray0 + min(first + k, tile - 1), mine);
            rt = __uint_as_float((unsigned)(min(old, mine) >> 32));
          }
        }
        if (part == 0)
          m = max(m, ordered_bits(__float_as_int(fminf(rt, cap[k]))));
      }
      m = __reduce_max_sync(0xffffffffu, m);
      if ((threadIdx.x & 31) == 0) s_bound[i & 1][warp] = m;
    }
  }
  __pipeline_wait_prior(0);  // a guessed copy may still be in flight
  if (tested != nullptr && threadIdx.x == 0)
    atomicAdd(tested, (unsigned long long)done);

#pragma unroll
  for (int i = 0; i < kRaysPerThread; ++i) {
    lex_reduce(bt[i], bi[i], split);
    if (part != 0 || first + i >= tile) continue;
    const size_t g = ray0 + first + i;
    if (packed == nullptr) {
      out_t[g] = bt[i];
      out_tri[g] = bt[i] < kBig ? bi[i] : -1;
    } else if (bt[i] < kBig) {
      atomicMin(packed + g, hit_word(bt[i], bi[i]));
    }
  }
}

// Launch (rows, n_split) blocks on `stream`, one row per subtile; returns
// the CUDA error of the launch.
inline int launch_cluster_ftb(const float* rays, int ray_stride,
                              int n_subtiles, int tile, const int* counts,
                              const int* order, const float* qkeys,
                              const int* heads, const int* wrows,
                              int n_units, const float* tconst,
                              int unit_cols, int mt,
                              int n_split, unsigned long long* packed,
                              float* out_t, int* out_tri,
                              unsigned long long* tested, void* stream) {
  if (n_subtiles <= 0) return (int)cudaGetLastError();
  if (n_split < 1 || (packed == nullptr) != (n_split == 1) ||
      heads == nullptr || wrows == nullptr)
    return (int)cudaErrorInvalidValue;
  const int pcols = unit_cols < kPieceCols ? unit_cols : kPieceCols;
  const BlockShape shape = block_shape(tile, pcols);
  const size_t smem = ring_bytes(pcols);
  int pshift = 0;
  while ((kPieceCols << pshift) < unit_cols) ++pshift;
  const dim3 grid((unsigned)n_subtiles, n_split);
  cudaStream_t s = (cudaStream_t)stream;
  if (mt) {
    cluster_ftb_kernel<true><<<grid, shape.threads, smem, s>>>(
        rays, ray_stride, tile, counts, order, qkeys,
        heads, wrows, n_units, tconst, unit_cols, pshift, shape.split,
        packed, out_t, out_tri, tested);
  } else {
    cluster_ftb_kernel<false><<<grid, shape.threads, smem, s>>>(
        rays, ray_stride, tile, counts, order, qkeys,
        heads, wrows, n_units, tconst, unit_cols, pshift, shape.split,
        packed, out_t, out_tri, tested);
  }
  return (int)cudaGetLastError();
}

}  // namespace mcpt
