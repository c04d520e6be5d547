// Nearest hit over each (chunk, ray subtile)'s front-to-back candidate
// clusters, with the early exit.
//
// Replaces the TPU kernel montecarlopathtracing_tpu/kernels/cluster.py::
// _intersect_kernel with ftb=True: its pallas_call over a (K chunks,
// n_steps) grid in cluster_intersect_chunked, and the one in
// _cluster_intersect_padded when front-to-back keys are given (K = 1).
//
// Table layout: tconst (K * C, 16, W), chunk k's clusters at rows
// [k * C, (k + 1) * C); a candidate unit is one cluster, and the triangle id
// written is cluster * W + column, local to the chunk.  All K chunks run in
// one launch, over one copy of the rays: chunk_cap (K, R) carries what the
// TPU version kept in K copies of the ray rows (the cap column, and the
// origin moved to 1e9 for a ray that misses the chunk's AABB).  The TPU
// kernel checks its exit every 4 panels of `group` clusters; this one checks
// before every cluster.  `heads` and `wrows`, the key kernel's row list of
// cluster_rows.cuh, name the rows that have candidates, longest lists first:
// block b takes the list's entry b, so no row is sorted and a block past the
// list's end has nothing to do (at W = 128 a chunked call of the
// 400k-triangle frame has 14,336 rows and 1.2 candidates per row).
// n_split > 1 deals a row's clusters out to that many blocks, which meet in
// `packed` (cluster_ftb.cuh).
//
// The kernel, what bounds it on an H100 (f32 throughput, contraction off) and
// what its design does about that (a register tile of 4 rays per thread over
// a cp.async ring of column-major pieces, the exit bound folded into the
// ring's barrier) are in cluster_ftb.cuh, shared with the supergroup kernel;
// at W = 128 a cluster is one piece.

#include "cluster_ftb.cuh"

extern "C" int mcpt_cluster_intersect_ftb(
    const float* rays, int ray_stride, int n_subtiles, int tile, int n_chunks,
    const float* chunk_cap, const int* counts, const int* order,
    const float* qkeys, const int* heads, const int* wrows, int n_clusters,
    const float* tconst, int width, int mt, int n_split,
    unsigned long long* packed, float* out_t, int* out_tri,
    unsigned long long* tested, void* stream) {
  return mcpt::launch_cluster_ftb(rays, ray_stride, n_subtiles, tile, n_chunks,
                                  chunk_cap, counts, order, qkeys, heads,
                                  wrows, n_clusters, tconst, width, mt,
                                  n_split, packed, out_t, out_tri, tested,
                                  stream);
}
