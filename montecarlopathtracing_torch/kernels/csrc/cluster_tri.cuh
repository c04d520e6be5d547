// Ray / triangle tests and the lexicographic best shared by the three
// intersect kernels (cluster_intersect.cu, cluster_intersect_ftb.cu,
// cluster_intersect_hbm.cu), so that all three round alike.
//
// The tests are those of montecarlopathtracing_tpu/kernels/cluster.py::
// _intersect_kernel and _intersect_hbm_kernel, over a staged block of the
// per-triangle constant table: 16 rows of `cols` columns in shared memory,
// one column per triangle.
//   compat (MT = false), rows n, n.v0, m_i = n x e_i, k_i:
//     t = (kn - n.o) / (n.d);  c_i = m_i.o + t * (m_i.d) - k_i;
//     inside = c1*c2 >= 0 && c1*c3 >= 0 && c2*c3 >= 0
//   Moller-Trumbore (MT = true), rows n_raw, kn, e1, e2, k_u, k_v, with the
//   per-ray w = o x d:
//     det = -n.d;  t = (n.o - kn) / det;  au = e2.w + k_u.d;
//     av = -(e1.w) + k_v.d;
//     inside = au*det >= 0 && av*det >= 0 && (det - au - av)*det >= 0
// A triangle is accepted when inside and 0 < t < 1e30.
//
// Built with -fmad=false and IEEE division; every expression keeps the TPU
// kernel's operation order, which is also the plain PyTorch version's
// (cluster_intersect_padded_plain), so the results agree bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>

namespace mcpt {

constexpr float kBig = 1e30f;
constexpr float kParked = 1e9f;  // origin of a parked ray

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float wx, wy, wz;  // o x d, Moller-Trumbore only
};

// Ray row [ox oy oz dx dy dz ...]; with MT, columns 6..8 hold w = o x d.
template <bool MT>
__device__ __forceinline__ Ray load_ray(const float* rp) {
  Ray r;
  r.ox = rp[0];
  r.oy = rp[1];
  r.oz = rp[2];
  r.dx = rp[3];
  r.dy = rp[4];
  r.dz = rp[5];
  r.wx = MT ? rp[6] : 0.0f;
  r.wy = MT ? rp[7] : 0.0f;
  r.wz = MT ? rp[8] : 0.0f;
  return r;
}

// Move the ray's origin to the park position (1e9 on every axis) and, with
// MT, recompute w = o x d in the order of ops.sampling.cross.
template <bool MT>
__device__ __forceinline__ void park_ray(Ray& r) {
  r.ox = r.oy = r.oz = kParked;
  if (MT) {
    r.wx = r.oy * r.dz - r.oz * r.dy;
    r.wy = r.oz * r.dx - r.ox * r.dz;
    r.wz = r.ox * r.dy - r.oy * r.dx;
  }
}

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      const float* row, int stride, int j) {
  return ax * row[j] + ay * row[stride + j] + az * row[2 * stride + j];
}

// Tests ray r against column j of the staged block tab[16][cols].  Returns
// whether the triangle is accepted, and its distance in t.
template <bool MT>
__device__ __forceinline__ bool tri_test(const Ray& r, const float* tab,
                                         int cols, int j, float& t) {
  bool inside;
  if (MT) {
    const float det = -dot3(r.dx, r.dy, r.dz, tab + 0 * cols, cols, j);
    const float o_n = dot3(r.ox, r.oy, r.oz, tab + 0 * cols, cols, j);
    t = (o_n - tab[3 * cols + j]) / det;
    const float au = dot3(r.wx, r.wy, r.wz, tab + 7 * cols, cols, j) +
                     dot3(r.dx, r.dy, r.dz, tab + 10 * cols, cols, j);
    const float av = -dot3(r.wx, r.wy, r.wz, tab + 4 * cols, cols, j) +
                     dot3(r.dx, r.dy, r.dz, tab + 13 * cols, cols, j);
    inside = (au * det >= 0.0f) && (av * det >= 0.0f) &&
             ((det - au - av) * det >= 0.0f);
  } else {
    const float n_o = dot3(r.ox, r.oy, r.oz, tab + 0 * cols, cols, j);
    const float n_d = dot3(r.dx, r.dy, r.dz, tab + 0 * cols, cols, j);
    t = (tab[3 * cols + j] - n_o) / n_d;
    const float c1 = dot3(r.ox, r.oy, r.oz, tab + 4 * cols, cols, j) +
                     t * dot3(r.dx, r.dy, r.dz, tab + 4 * cols, cols, j) -
                     tab[7 * cols + j];
    const float c2 = dot3(r.ox, r.oy, r.oz, tab + 8 * cols, cols, j) +
                     t * dot3(r.dx, r.dy, r.dz, tab + 8 * cols, cols, j) -
                     tab[11 * cols + j];
    const float c3 = dot3(r.ox, r.oy, r.oz, tab + 12 * cols, cols, j) +
                     t * dot3(r.dx, r.dy, r.dz, tab + 12 * cols, cols, j) -
                     tab[15 * cols + j];
    inside = (c1 * c2 >= 0.0f) && (c1 * c3 >= 0.0f) && (c2 * c3 >= 0.0f);
  }
  return inside && t > 0.0f && t < kBig;
}

// Running lexicographic (t, tri) minimum: the winner of the TPU kernel's
// deferred best (ties at equal t go to the lowest id), in any order.
__device__ __forceinline__ void lex_min(float& bt, int& bi, float t, int tri) {
  if (t < bt || (t == bt && tri < bi)) {
    bt = t;
    bi = tri;
  }
}

// Lanes of this thread's warp that exist (the block's last warp may be
// partial).
__device__ __forceinline__ unsigned warp_mask() {
  const int in_warp =
      min(32, (int)blockDim.x - ((int)threadIdx.x & ~31));
  return in_warp == 32 ? 0xffffffffu : (1u << in_warp) - 1u;
}

// Lexicographic minimum over the `split` threads of one ray: an aligned
// group of consecutive lanes of one warp (split is a power of two, at most
// 32, and divides the block size).  Every lane of the group gets the result.
__device__ __forceinline__ void lex_reduce(float& bt, int& bi, int split,
                                           unsigned mask) {
  for (int off = split >> 1; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(mask, bt, off);
    const int oi = __shfl_xor_sync(mask, bi, off);
    lex_min(bt, bi, ot, oi);
  }
}

// Threads per ray (a power of two, at most a warp), consecutive lanes: about
// 256-thread blocks for tiles up to 256 rays, one thread per ray beyond.
inline int ray_split(int tile) {
  int split = 1;
  while (split < 32 && tile * split * 2 <= 256) split *= 2;
  return split;
}

}  // namespace mcpt
