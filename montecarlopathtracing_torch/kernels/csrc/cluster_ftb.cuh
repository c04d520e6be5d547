// Nearest hit over front-to-back candidate units with an early exit: the
// device code shared by cluster_intersect_ftb.cu (unit = one cluster of a
// chunk's table) and cluster_intersect_hbm.cu (unit = one supergroup block
// of the swizzled table).  On this card every table lies in device memory,
// so the two differ only in the table layout and in what a unit is.
//
// One block per (ray subtile, chunk).  The subtile's candidate units arrive
// sorted by their entry key (the subtile's least slab-entry distance,
// quantised down), `qkeys` aligned with `order`.  The block walks them in
// that order; before each unit it stops if
//     qkeys[j] > max over the subtile's rays of min(best t, cap)
// where cap is the ray's exit distance from the enclosing box (a chunk's
// AABB), 1e30 for none, and -1 for a ray that does not touch the chunk.
// The units come sorted, so every unit not tested has an entry beyond every
// ray's bound: it can neither win nor tie.  The best is the order-independent
// lexicographic (t, triangle id) minimum of cluster_tri.cuh, so the result
// equals a scan of all candidates in any order.
//
// The decision is block-wide: every thread reads the same bound from shared
// memory after a barrier and takes the same branch, so the staging barriers
// stay matched.
//
// Bound: as cluster_intersect.cu, about 34 f32 operations per (ray,
// triangle) pair against 64 table bytes per triangle and subtile: by f32
// operations at tile 64.  What this design does: rays in registers, a unit
// staged in shared memory in pieces of at most 128 columns (so a supergroup
// of any size fits), the columns of a piece split over the threads of a ray,
// one shuffle reduction and one barrier per unit for the bound.  The table
// fetch is a plain load (no cp.async / TMA pipeline yet).

#pragma once

#include "cluster_tri.cuh"

namespace mcpt {

constexpr int kPieceCols = 128;  // table columns staged per pass (max)

// Order-preserving map between float and int (and back: an involution).
__device__ __forceinline__ int ordered_bits(int b) {
  return b ^ ((b >> 31) & 0x7fffffff);
}

// rays     (n_subtiles * tile, ray_stride) f32 rows, shared by all chunks
// chunk_cap (n_chunks, n_subtiles * tile) f32 or null.  Given: the cap of
//          each (chunk, ray), and a ray whose cap is < 0 is parked for that
//          chunk (origin moved to 1e9).  Null: the cap is ray column 6 (9
//          with MT) and no ray is moved.
// counts   (n_chunks * n_subtiles,) i32, order / qkeys (that, n_units)
// tconst   (n_chunks * n_units, 16, unit_cols) f32
// out_t / out_tri (n_chunks, n_subtiles * tile); tri = unit * unit_cols +
//          column, local to the chunk
// tested   null, or one counter that receives the number of (subtile, unit)
//          pairs tested
template <bool MT>
__global__ void cluster_ftb_kernel(
    const float* __restrict__ rays, int ray_stride, int tile,
    const float* __restrict__ chunk_cap, const int* __restrict__ counts,
    const int* __restrict__ order, const float* __restrict__ qkeys,
    int n_units, const float* __restrict__ tconst, int unit_cols, int piece,
    int split, float* __restrict__ out_t, int* __restrict__ out_tri,
    unsigned long long* __restrict__ tested) {
  extern __shared__ float s_tab[];  // [16][piece]
  __shared__ int s_bound[32];       // one slot per warp

  const int sub = blockIdx.x;
  const int chunk = blockIdx.y;
  const size_t n_rays = (size_t)gridDim.x * tile;
  const size_t row = (size_t)chunk * gridDim.x + sub;
  const int tid = threadIdx.x;
  const int ray = tid / split;
  const int part = tid - ray * split;
  const size_t g = (size_t)sub * tile + ray;
  const float* rp = rays + g * ray_stride;
  Ray r = load_ray<MT>(rp);
  float cap;
  if (chunk_cap != nullptr) {
    cap = chunk_cap[chunk * n_rays + g];
    if (cap < 0.0f) park_ray<MT>(r);
  } else {
    cap = rp[MT ? 9 : 6];
  }

  const int n = counts[row];
  const int* cand = order + row * n_units;
  const float* qk = qkeys + row * n_units;
  const float* table = tconst + (size_t)chunk * n_units * 16 * unit_cols;
  const unsigned mask = warp_mask();
  const int n_warps = (blockDim.x + 31) >> 5;

  float bt = kBig;
  int bi = INT_MAX;
  float bound = kBig;
  int j = 0;
  for (; j < n; ++j) {
    if (qk[j] > bound) break;  // the same for every thread of the block
    const int unit = cand[j];
    const float* blk = table + (size_t)unit * 16 * unit_cols;
    for (int p0 = 0; p0 < unit_cols; p0 += piece) {
      __syncthreads();  // the previous piece is no longer read
      for (int idx = tid; idx < 16 * piece; idx += blockDim.x) {
        const int trow = idx / piece;
        const int col = idx - trow * piece;
        s_tab[idx] = blk[(size_t)trow * unit_cols + p0 + col];
      }
      __syncthreads();
      for (int c = part; c < piece; c += split) {
        float t;
        if (tri_test<MT>(r, s_tab, piece, c, t))
          lex_min(bt, bi, t, unit * unit_cols + p0 + c);
      }
    }
    // max over the subtile's rays of min(best t of the ray, cap).
    float rb = bt;
    for (int off = split >> 1; off > 0; off >>= 1)
      rb = fminf(rb, __shfl_xor_sync(mask, rb, off));
    const int wb = __reduce_max_sync(
        mask, ordered_bits(__float_as_int(fminf(rb, cap))));
    // s_bound was last read before this unit's staging barriers.
    if ((tid & 31) == 0) s_bound[tid >> 5] = wb;
    __syncthreads();
    int b = s_bound[0];
    for (int w = 1; w < n_warps; ++w) b = max(b, s_bound[w]);
    bound = __int_as_float(ordered_bits(b));
  }
  if (tested != nullptr && tid == 0)
    atomicAdd(tested, (unsigned long long)j);

  lex_reduce(bt, bi, split, mask);
  if (part == 0) {
    out_t[chunk * n_rays + g] = bt;
    out_tri[chunk * n_rays + g] = bt < kBig ? bi : -1;
  }
}

// Launch over (n_subtiles, n_chunks) blocks on `stream`; returns the CUDA
// error of the launch.
inline int launch_cluster_ftb(const float* rays, int ray_stride,
                              int n_subtiles, int tile, int n_chunks,
                              const float* chunk_cap, const int* counts,
                              const int* order, const float* qkeys,
                              int n_units, const float* tconst, int unit_cols,
                              int mt, float* out_t, int* out_tri,
                              unsigned long long* tested, void* stream) {
  if (n_subtiles <= 0 || n_chunks <= 0) return (int)cudaGetLastError();
  const int split = ray_split(tile);
  const int threads = tile * split;
  const int piece = unit_cols < kPieceCols ? unit_cols : kPieceCols;
  const size_t smem = sizeof(float) * 16 * (size_t)piece;
  const dim3 grid(n_subtiles, n_chunks);
  cudaStream_t s = (cudaStream_t)stream;
  if (mt) {
    cluster_ftb_kernel<true><<<grid, threads, smem, s>>>(
        rays, ray_stride, tile, chunk_cap, counts, order, qkeys, n_units,
        tconst, unit_cols, piece, split, out_t, out_tri, tested);
  } else {
    cluster_ftb_kernel<false><<<grid, threads, smem, s>>>(
        rays, ray_stride, tile, chunk_cap, counts, order, qkeys, n_units,
        tconst, unit_cols, piece, split, out_t, out_tri, tested);
  }
  return (int)cudaGetLastError();
}

}  // namespace mcpt
