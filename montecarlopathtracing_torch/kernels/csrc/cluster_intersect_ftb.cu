// Nearest hit over each (chunk, ray subtile)'s front-to-back candidate
// clusters, with the early exit, the K chunks met in one 64-bit word per ray.
//
// Replaces the TPU kernel montecarlopathtracing_tpu/kernels/cluster.py::
// _intersect_kernel with ftb=True: its pallas_call over a (K chunks,
// n_steps) grid in cluster_intersect_chunked together with the merge of the
// K results that follows it, and the one in _cluster_intersect_padded when
// front-to-back keys are given (K = 1, offset 0).
//
// Table layout: tconst (K * C, 16, W), chunk k's clusters at rows
// [k * C, (k + 1) * C); a candidate unit is one cluster (W <= 128: one
// 128-column piece; a wider cluster is several).  All K chunks run in one
// launch, over one copy of the rays: chunk_cap (K, R) carries what the TPU
// version kept in K copies of the ray rows (the cap column, and the origin
// moved to 1e9 for a ray that misses the chunk's AABB), or is null (K = 1,
// the cap is the ray's cap column).  Each row (chunk, subtile) ends with an
// atomicMin of its rays' bests into packed (R,): hit_word(t, offsets[k] +
// cluster * W + column) of cluster_tri.cuh.  The least word is the
// lexicographic (t, global id) minimum over the chunks, the TPU package's
// merge (chunks ascend in id), with no (K, R) arrays and no merge kernels
// after the launch; the caller presets the words to the miss and unpacks
// them.  The TPU kernel checks its exit every 4 panels of `group` clusters;
// this one checks before every cluster, against the row's own bests and the
// chunk's cap.  `heads` and `wrows`, the key kernel's row list of
// cluster_rows.cuh, name the rows that have candidates, longest lists first:
// block b takes the list's entry b, so no row is sorted and a block past the
// list's end has nothing to do.
//
// Bound on an H100: f32 instruction issue, about 34 fused operations per
// (ray, triangle) test, 85 instructions once a*b+c may not contract and the
// division is IEEE (what keeps the result bit for bit the plain version's).
// The body is the supergroup kernel's (cluster_ftb.cuh, whose comment gives
// the design: 4 rays per thread in registers against a cp.async ring of
// column-major 128-column pieces, one barrier per piece, the exit bound
// folded into that barrier) for one block per row, kept apart so that
// either can change without moving the other's register allocation.
// Measured on the 97 chunked calls of the 400k-triangle frame and not
// taken (PERF.md): an exact reject of the pairs whose plane distance cannot
// win (51% of pairs, but a whole warp step in 12% of steps only; queueing
// the undecided pairs for their edge tests 32 at a time was bound by
// shared-memory traffic, 0.96 against 0.60 ms a launch), and a grid of a few
// waves of resident blocks looping over the list instead of the 12,829
// blocks a call that find no row (the loop cost the test loop 8 of 343
// instructions and more time than the empty blocks).  A -DMCPT_COUNT_STATS
// build counts both.

#include "cluster_rows.cuh"
#include "cluster_tri.cuh"

namespace mcpt {
namespace {

#ifdef MCPT_COUNT_STATS
// A measurement build only: `tested` is then an array of kCounters that also
// receives [1] blocks that found no row on the list, [2] (ray, triangle)
// pairs tested, [3] of them the pairs whose plane distance alone decides
// that they cannot change the ray's best (!(t > 0 && t < 1e30 && t <= the
// testing thread's best t); NaN and inf fail, a tie still counts), [4] warp
// steps (one test instruction stream over 32 lanes), [5] of them the steps
// in which that holds for every lane's pair.
constexpr int kCounters = 6;

template <bool MT, class TriOf>
__device__ __forceinline__ void count_piece(
    const Ray (&r)[kRaysPerThread], const float4* slot, int ncols, int part,
    int split, int first, int tile, float (&bt)[kRaysPerThread],
    int (&bi)[kRaysPerThread], TriOf tri_of, unsigned (&cnt)[kCounters]) {
  for (int c = part; c < ncols; c += split) {
    const Col k = load_col(slot, c);
#pragma unroll
    for (int i = 0; i < kRaysPerThread; ++i) {
      float t;
      const bool hit = tri_test<MT>(r[i], k, t);
      const bool valid = first + i < tile;
      const bool rej = !(t > 0.0f && t < kBig && t <= bt[i]);
      cnt[2] += valid;
      cnt[3] += valid && rej;
      const unsigned act = __activemask();
      const bool all = __all_sync(act, rej || !valid);
      if ((int)(threadIdx.x & 31) == __ffs(act) - 1) {
        cnt[4] += 1;
        cnt[5] += all;
      }
      if (hit) lex_min(bt[i], bi[i], t, tri_of(c));
    }
  }
}
#endif

// rays     (n_subtiles * tile, ray_stride) f32 rows, shared by all chunks
// chunk_cap (n_chunks, n_subtiles * tile) f32 or null (see above)
// offsets  (n_chunks,) i32, the first global triangle id of each chunk, or
//          null for 0
// counts   (n_chunks * n_subtiles,) i32, order / qkeys (that, n_units)
// tconst   (n_chunks * n_units, 16, unit_cols) f32; unit_cols is a power of
//          two, cut into 1 << pshift pieces
// packed   (n_subtiles * tile,) u64 preset to kMissWord
// tested   null, or one counter that receives the number of (subtile, unit)
//          pairs whose first piece was tested (kCounters of them in a
//          -DMCPT_COUNT_STATS build)
template <bool MT>
__global__ void __launch_bounds__(kMaxThreads, MCPT_MIN_BLOCKS)
cluster_ftb_chunked_kernel(
    const float* __restrict__ rays, int ray_stride, int n_subtiles, int tile,
    const float* __restrict__ chunk_cap, const int* __restrict__ offsets,
    const int* __restrict__ counts, const int* __restrict__ order,
    const float* __restrict__ qkeys, const int* __restrict__ heads,
    const int* __restrict__ wrows, int n_units,
    const float* __restrict__ tconst, int unit_cols, int pshift, int split,
    unsigned long long* __restrict__ packed,
    unsigned long long* __restrict__ tested) {
  extern __shared__ float4 s_ring[];            // [kStages][4 * pcols]
  __shared__ int s_bound[2][kMaxThreads / 32];  // [unit parity][warp]

  const int listed = list_row(heads, wrows, gridDim.x, blockIdx.x);
#ifdef MCPT_COUNT_STATS
  unsigned cnt[kCounters] = {};
  if (listed < 0 && tested != nullptr && threadIdx.x == 0)
    atomicAdd(tested + 1, 1ull);
#endif
  if (listed < 0) return;  // past the list: the preset misses stand
  const size_t row = listed;
  const int npu = 1 << pshift;
  const int total = counts[row] * npu;  // the row's pieces

  const int chunk = (int)(row / n_subtiles);
  const int sub = (int)(row - (size_t)chunk * n_subtiles);
  const size_t ray0 = (size_t)chunk * n_subtiles * tile + (size_t)sub * tile;
  const int* cand = order + row * n_units;
  const float* qk = qkeys + row * n_units;
  const float* table = tconst + (size_t)chunk * n_units * 16 * unit_cols;
  const int pcols = min(unit_cols, kPieceCols);

  auto stage = [&](int i) {
    stage_cols(s_ring + (i % kStages) * 4 * pcols, 0,
               table + (size_t)cand[i >> pshift] * 16 * unit_cols +
                   (i & (npu - 1)) * kPieceCols,
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
  load_ray_tile<MT>(rays + (size_t)sub * tile * ray_stride, ray_stride, tile,
                    split, r, first);
#pragma unroll
  for (int i = 0; i < kRaysPerThread; ++i) {
    const size_t in_sub = min(first + i, tile - 1);
    if (chunk_cap != nullptr) {
      cap[i] = chunk_cap[ray0 + in_sub];
      if (cap[i] < 0.0f) park_ray<MT>(r[i]);
    } else {
      cap[i] = rays[((size_t)sub * tile + in_sub) * ray_stride + (MT ? 9 : 6)];
    }
    bt[i] = kBig;
    bi[i] = INT_MAX;
  }

  int done = 0;  // units whose first piece this block tested
  for (int i = 0; i < total; ++i) {
    const int j = i >> pshift;
    const int p = i & (npu - 1);
    if (i + 1 < total)
      stage(i + 1);  // a guess that the walk goes on
    else
      __pipeline_commit();  // an empty group keeps the wait below uniform
    __pipeline_wait_prior(1);  // this thread's share of the piece has landed
    __syncthreads();  // everyone's has; the piece before is no longer read;
                      // the bound slots written after it are complete
    if (p == 0 && i > 0) {  // a new unit: may we stop?
      const int* slots = s_bound[(j - 1) & 1];
      int b = slots[0];
      for (int w = 1; w < n_warps; ++w) b = max(b, slots[w]);
      if (qk[j] > __int_as_float(ordered_bits(b))) break;  // block-wide
    }
    if (p == 0) ++done;
    const int base = cand[j] * unit_cols + p * kPieceCols;
#ifdef MCPT_COUNT_STATS
    count_piece<MT>(r, s_ring + (i % kStages) * 4 * pcols, pcols, part, split,
                    first, tile, bt, bi, [&](int c) { return base + c; }, cnt);
#else
    test_piece<MT>(r, s_ring + (i % kStages) * 4 * pcols, pcols, part, split,
                   bt, bi, [&](int c) { return base + c; });
#endif
    if (p == npu - 1 && i + 1 < total) {
      // This block is done with unit j: the bound for its next unit, max
      // over this warp's rays of min(best t of the ray, cap).
      int m = INT_MIN;
#pragma unroll
      for (int k = 0; k < kRaysPerThread; ++k) {
        float rt = bt[k];
        for (int off = split >> 1; off > 0; off >>= 1)
          rt = fminf(rt, __shfl_xor_sync(0xffffffffu, rt, off));
        if (part == 0)
          m = max(m, ordered_bits(__float_as_int(fminf(rt, cap[k]))));
      }
      m = __reduce_max_sync(0xffffffffu, m);
      if ((threadIdx.x & 31) == 0) s_bound[j & 1][warp] = m;
    }
  }
  __pipeline_wait_prior(0);  // a guessed copy may still be in flight
  if (tested != nullptr && threadIdx.x == 0)
    atomicAdd(tested, (unsigned long long)done);
#ifdef MCPT_COUNT_STATS
  if (tested != nullptr) {
#pragma unroll
    for (int k = 2; k < kCounters; ++k) {
      const unsigned s = __reduce_add_sync(0xffffffffu, cnt[k]);
      if ((threadIdx.x & 31) == 0) atomicAdd(tested + k, (unsigned long long)s);
    }
  }
#endif

  // The chunks meet in the words, one per ray; the id made global.
  const int id0 = offsets != nullptr ? offsets[chunk] : 0;
#pragma unroll
  for (int i = 0; i < kRaysPerThread; ++i) {
    lex_reduce(bt[i], bi[i], split);
    if (part == 0 && first + i < tile && bt[i] < kBig)
      atomicMin(packed + (size_t)sub * tile + first + i,
                hit_word(bt[i], id0 + bi[i]));
  }
}

}  // namespace
}  // namespace mcpt

extern "C" int mcpt_cluster_intersect_ftb(
    const float* rays, int ray_stride, int n_subtiles, int tile, int n_chunks,
    const float* chunk_cap, const int* offsets, const int* counts,
    const int* order, const float* qkeys, const int* heads, const int* wrows,
    int n_clusters, const float* tconst, int width, int mt,
    unsigned long long* packed, unsigned long long* tested, void* stream) {
  if (n_subtiles <= 0 || n_chunks <= 0) return (int)cudaGetLastError();
  if (packed == nullptr || heads == nullptr || wrows == nullptr)
    return (int)cudaErrorInvalidValue;
  const int pcols = width < mcpt::kPieceCols ? width : mcpt::kPieceCols;
  const mcpt::BlockShape shape = mcpt::block_shape(tile, pcols);
  const size_t smem = mcpt::ring_bytes(pcols);
  int pshift = 0;
  while ((mcpt::kPieceCols << pshift) < width) ++pshift;
  const unsigned grid = (unsigned)n_subtiles * (unsigned)n_chunks;
  cudaStream_t s = (cudaStream_t)stream;
  if (mt) {
    mcpt::cluster_ftb_chunked_kernel<true><<<grid, shape.threads, smem, s>>>(
        rays, ray_stride, n_subtiles, tile, chunk_cap, offsets, counts, order,
        qkeys, heads, wrows, n_clusters, tconst, width, pshift, shape.split,
        packed, tested);
  } else {
    mcpt::cluster_ftb_chunked_kernel<false><<<grid, shape.threads, smem, s>>>(
        rays, ray_stride, n_subtiles, tile, chunk_cap, offsets, counts, order,
        qkeys, heads, wrows, n_clusters, tconst, width, pshift, shape.split,
        packed, tested);
  }
  return (int)cudaGetLastError();
}
