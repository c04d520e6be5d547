// Nearest hit over each ray subtile's front-to-back candidate supergroups,
// with the early exit checked per supergroup.
//
// Replaces the TPU kernel montecarlopathtracing_tpu/kernels/cluster.py::
// _intersect_hbm_kernel (its pallas_call in cluster_intersect_hbm), which
// streams each candidate supergroup's block from HBM into a two-slot VMEM
// buffer.
//
// Table layout: the swizzled table (S, 16, sg * W), one supergroup of sg
// clusters per contiguous block with (cluster, column) lexicographic in the
// columns, so the triangle id written is supergroup * sg * W + column: a
// global id.  The candidate and exit unit is the supergroup, whatever its
// size (32 KB at sg 4, 256 KB at sg 32).  The cap is ray column 6 (9 with
// Moller-Trumbore).  `heads` and `wrows`, the key kernel's row list of
// cluster_rows.cuh, name the subtiles that have candidates and the order in
// which they start; n_split > 1 deals a subtile's
// 128-column pieces out to that many blocks, which meet in `packed`.
//
// Where the TPU kernel double-buffers whole supergroup blocks in VMEM, this
// one streams a supergroup as 128-column pieces (8 KB) through a three-slot
// cp.async ring that runs ahead into the next candidate, tests each piece on
// a register tile of 4 rays per thread, and deals the 128-column quarters
// of a subtile's candidates out to several blocks; the blocks of a subtile
// share their rays' best hits, and so the exit bound, through 64-bit
// atomics.  On
// an H100 it is bound by f32 throughput with contraction off; the kernel, its
// bound and its design are in cluster_ftb.cuh.

#include "cluster_ftb.cuh"

extern "C" int mcpt_cluster_intersect_hbm(
    const float* rays, int ray_stride, int n_subtiles, int tile,
    const int* counts, const int* order, const float* qkeys, const int* heads,
    const int* wrows, int n_super, const float* tconst, int super_cols,
    int mt, int n_split, unsigned long long* packed, float* out_t,
    int* out_tri, unsigned long long* tested, void* stream) {
  return mcpt::launch_cluster_ftb(rays, ray_stride, n_subtiles, tile,
                                  counts, order, qkeys, heads,
                                  wrows, n_super, tconst, super_cols, mt,
                                  n_split, packed, out_t, out_tri, tested,
                                  stream);
}
