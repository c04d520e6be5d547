// The packet LBVH walk: nearest hit of each ray, a packet of rays walking
// one shared trail down to fat leaves.
//
// Replaces no Pallas kernel of montecarlopathtracing_tpu/kernels/cluster.py:
// it is the counterpart of the XLA while loop (under lax.map over packets)
// of montecarlopathtracing_tpu/accel/lbvh.py::packet_intersect, the JAX
// package's intersector="bvh" and its "auto" off the TPU.  Its plain
// PyTorch version is accel/lbvh.py::packet_intersect_plain.  The rules
// (walk_common.cuh holds the arithmetic):
//   * one block per packet of `packet` consecutive rays, one thread per ray
//     (the wrapper pads the tail with parked rays, as the JAX package does);
//   * the block holds one heap key; each ray's slab test is capped at its
//     own best t, and the block descends when any ray hits
//     (__syncthreads_or) and the node lies above the fat leaves, which start
//     at fat_start = Lc / leaf_width;
//   * at a fat leaf whose box some ray hits, its leaf_width triangles from
//     tri0 = clip((k - fat_start) leaf_width, 0, Lc - leaf_width) go to
//     shared memory, and each ray that hit the box tests them in order: a
//     triangle wins when it is a hit, valid, t > 0 and t < the ray's best t
//     from before the leaf, and the lowest j wins at equal t (the JAX
//     package's argmin);
//   * the walk ends at key 0 or after max_steps steps (8 fat_start + 64);
//   * a miss is t = 1e30, tri = -1.
//
// Bound on an H100: that of the function, the nearest hit, which the
// per-ray walk computes too: the inputs read once (rays, nodes, triangles,
// ~17 MB at 100k triangles) and the slab and triangle tests the per-ray
// walk needs, about 19 f32 operations per (ray, node) slab test and 87
// (compat) or 56 (MT) per (ray, triangle) test; the bytes decide.  Every
// thread of a block reads the same node (one broadcast load), a leaf's
// triangles are staged once per
// block, and the tests run at full width, but the block waits at two
// barriers per step and tests a whole fat leaf for every ray that hit its
// box, so it does more tests than the per-ray walk; the packet's coherence
// (pixel tiles, shadow rays to one light) decides by how much.

#include "walk_common.cuh"

namespace {

using namespace mcpt_walk;

constexpr int kMaxPacket = 1024;
constexpr int kTriFloats = 12;  // v0, v1, v2, geom_n

template <bool MT>
__global__ void __launch_bounds__(kMaxPacket)
packet_walk_kernel(const float* __restrict__ origin,
                   const float* __restrict__ direction,
                   const float* __restrict__ node_min,
                   const float* __restrict__ node_max, int lc, int lw,
                   const float* __restrict__ v0, const float* __restrict__ v1,
                   const float* __restrict__ v2,
                   const float* __restrict__ geom_n,
                   const unsigned char* __restrict__ tri_valid, int max_steps,
                   float* __restrict__ out_t, int* __restrict__ out_tri) {
  extern __shared__ float s_tri[];  // [lw][12] floats, then [lw] valid flags
  float* s_valid = s_tri + lw * kTriFloats;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const V3 o = load3(origin, i), d = load3(direction, i);
  const V3 inv{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  const int fat_start = lc / lw;
  float best_t = kBig;
  int best_tri = -1;
  int k = 1;
  for (int step = 0; k > 0 && step < max_steps; ++step) {
    const bool hit =
        slab_hit(o, inv, load3(node_min, k), load3(node_max, k), best_t);
    const bool any_hit = __syncthreads_or(hit);
    const bool is_fat = k >= fat_start;
    if (any_hit && is_fat) {
      const int tri0 = min(max((k - fat_start) * lw, 0), lc - lw);
      for (int q = threadIdx.x; q < lw * (kTriFloats + 1); q += blockDim.x) {
        if (q < lw * kTriFloats) {
          const int j = q / kTriFloats, c = q % kTriFloats;
          const float* src = c < 3 ? v0 : c < 6 ? v1 : c < 9 ? v2 : geom_n;
          s_tri[q] = __ldg(src + 3 * (long)(tri0 + j) + c % 3);
        } else {
          const int j = q - lw * kTriFloats;
          s_valid[j] = __ldg(tri_valid + tri0 + j) ? 1.0f : 0.0f;
        }
      }
      __syncthreads();
      if (hit) {
        float cur = kBig;
        int cur_j = -1;
        for (int j = 0; j < lw; ++j) {
          const float* p = s_tri + j * kTriFloats;
          float t;
          const bool h = tri_test<MT>(o, d, V3{p[0], p[1], p[2]},
                                      V3{p[3], p[4], p[5]},
                                      V3{p[6], p[7], p[8]},
                                      V3{p[9], p[10], p[11]}, t);
          const bool ok = h && s_valid[j] != 0.0f && t > 0.0f && t < best_t;
          if (ok && t < cur) {
            cur = t;
            cur_j = j;
          }
        }
        if (cur_j >= 0) {  // cur < best_t by the accept rule
          best_t = cur;
          best_tri = tri0 + cur_j;
        }
      }
      __syncthreads();  // the stage is read before the next one overwrites it
    }
    k = (any_hit && !is_fat) ? 2 * k : advance(k);
  }
  out_t[i] = best_tri >= 0 ? best_t : kBig;
  out_tri[i] = best_tri;
}

}  // namespace

// origin, direction (n_packets * packet, 3) f32, padded; node_min, node_max
// (2 lc, 3) f32; v0, v1, v2, geom_n (lc, 3) f32; tri_valid (lc,) bool;
// out_t, out_tri (n_packets * packet,).  packet <= 1024, 1 <= leaf_width
// <= lc.  mt selects the Moller-Trumbore test.  Returns the launch's CUDA
// error.
extern "C" int mcpt_packet_walk(const float* origin, const float* direction,
                                int n_packets, int packet,
                                const float* node_min, const float* node_max,
                                int lc, int leaf_width, const float* v0,
                                const float* v1, const float* v2,
                                const float* geom_n,
                                const unsigned char* tri_valid, int mt,
                                int max_steps, float* out_t, int* out_tri,
                                void* stream) {
  if (n_packets <= 0) return (int)cudaGetLastError();
  if (packet < 1 || packet > kMaxPacket || leaf_width < 1 || leaf_width > lc)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)leaf_width * (kTriFloats + 1) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (mt) {
    packet_walk_kernel<true><<<n_packets, packet, smem, s>>>(
        origin, direction, node_min, node_max, lc, leaf_width, v0, v1, v2,
        geom_n, tri_valid, max_steps, out_t, out_tri);
  } else {
    packet_walk_kernel<false><<<n_packets, packet, smem, s>>>(
        origin, direction, node_min, node_max, lc, leaf_width, v0, v1, v2,
        geom_n, tri_valid, max_steps, out_t, out_tri);
  }
  return (int)cudaGetLastError();
}
