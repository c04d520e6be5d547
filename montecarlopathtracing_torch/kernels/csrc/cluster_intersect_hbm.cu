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
// size (32 KB at sg 4, 256 KB at sg 32): the block stages it in pieces of
// 128 columns.  The cap is ray column 6 (9 with Moller-Trumbore).  Kernel,
// bound and design: cluster_ftb.cuh.

#include "cluster_ftb.cuh"

extern "C" int mcpt_cluster_intersect_hbm(
    const float* rays, int ray_stride, int n_subtiles, int tile,
    const int* counts, const int* order, const float* qkeys, int n_super,
    const float* tconst, int super_cols, int mt, float* out_t, int* out_tri,
    unsigned long long* tested, void* stream) {
  return mcpt::launch_cluster_ftb(rays, ray_stride, n_subtiles, tile, 1,
                                  nullptr, counts, order, qkeys, n_super,
                                  tconst, super_cols, mt, out_t, out_tri,
                                  tested, stream);
}
