// The per-ray LBVH walk: nearest hit of each ray over the scene's
// triangles, one thread per ray.
//
// Replaces no Pallas kernel of montecarlopathtracing_tpu/kernels/cluster.py:
// it is the counterpart of the XLA while loop of
// montecarlopathtracing_tpu/accel/lbvh.py::bvh_intersect (the JAX package's
// intersector="bvh_perray").  Its plain PyTorch version is
// accel/lbvh.py::bvh_intersect_plain, which steps every ray in lockstep and
// would end each step in a host sync on the card; here the loop is on the
// device.  The rules (walk_common.cuh holds the arithmetic):
//   * the heap is 1-based, leaves are k >= Lc and hold triangle k - Lc;
//   * a node is entered when its slab test passes with t_max = the ray's
//     best t (enter <= t_max); otherwise the walk advances to the next
//     subtree in preorder, and it ends at key 0 or after max_steps steps;
//   * a leaf's triangle wins when it is a hit, valid, t > 0 and t < best t
//     (strict, so an earlier leaf keeps a tie);
//   * a miss is t = 1e30, tri = -1.
//
// Bound on an H100: each step reads one 24-byte node and, at a leaf whose
// box passes, one triangle (48 bytes and its valid flag), and does about 19
// f32 operations for the slab test and 87 (compat) or 56 (MT) for a
// triangle test.  The inputs read once (rays, nodes, triangles) are ~17 MB
// at 100k triangles, and moving them outlasts the tests the rays' visits
// need, so the bound is the bytes; what
// keeps the kernel far above it is latency: every step is a dependent
// gather of a node that neighbouring rays share only while their trails
// agree, and the lanes of a warp step as long as their longest walk.  The
// design is the simplest one that is right: one ray per thread in
// registers, nodes and triangles read through the read-only cache.

#include "walk_common.cuh"

namespace {

using namespace mcpt_walk;

constexpr int kThreads = 128;

template <bool MT>
__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(const float* __restrict__ origin,
                const float* __restrict__ direction, int r,
                const float* __restrict__ node_min,
                const float* __restrict__ node_max, int lc,
                const float* __restrict__ v0, const float* __restrict__ v1,
                const float* __restrict__ v2, const float* __restrict__ geom_n,
                const unsigned char* __restrict__ tri_valid, int max_steps,
                float* __restrict__ out_t, int* __restrict__ out_tri) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r) return;
  const V3 o = load3(origin, i), d = load3(direction, i);
  const V3 inv{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  float best_t = kBig;
  int best_tri = -1;
  int k = 1;
  for (int step = 0; k > 0 && step < max_steps; ++step) {
    const bool hit_box =
        slab_hit(o, inv, load3(node_min, k), load3(node_max, k), best_t);
    const bool is_leaf = k >= lc;
    if (hit_box && is_leaf) {
      const int tri = k - lc;
      float t;
      const bool h = tri_test<MT>(o, d, load3(v0, tri), load3(v1, tri),
                                  load3(v2, tri), load3(geom_n, tri), t);
      if (h && __ldg(tri_valid + tri) && t > 0.0f && t < best_t) {
        best_t = t;
        best_tri = tri;
      }
    }
    k = (hit_box && !is_leaf) ? 2 * k : advance(k);
  }
  out_t[i] = best_tri >= 0 ? best_t : kBig;
  out_tri[i] = best_tri;
}

}  // namespace

// origin, direction (r, 3) f32; node_min, node_max (2 lc, 3) f32; v0, v1,
// v2, geom_n (lc, 3) f32; tri_valid (lc,) bool; out_t (r,) f32, out_tri
// (r,) i32.  mt selects the Moller-Trumbore test.  Returns the launch's
// CUDA error.
extern "C" int mcpt_bvh_walk(const float* origin, const float* direction,
                             int r, const float* node_min,
                             const float* node_max, int lc, const float* v0,
                             const float* v1, const float* v2,
                             const float* geom_n,
                             const unsigned char* tri_valid, int mt,
                             int max_steps, float* out_t, int* out_tri,
                             void* stream) {
  if (r <= 0) return (int)cudaGetLastError();
  const int blocks = (r + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (mt) {
    bvh_walk_kernel<true><<<blocks, kThreads, 0, s>>>(
        origin, direction, r, node_min, node_max, lc, v0, v1, v2, geom_n,
        tri_valid, max_steps, out_t, out_tri);
  } else {
    bvh_walk_kernel<false><<<blocks, kThreads, 0, s>>>(
        origin, direction, r, node_min, node_max, lc, v0, v1, v2, geom_n,
        tri_valid, max_steps, out_t, out_tri);
  }
  return (int)cudaGetLastError();
}
