// Device code shared by the two LBVH walk kernels (bvh_walk.cu,
// packet_walk.cu): the node and triangle records they read, the slab test,
// the two ray / triangle tests and the preorder step of the stackless walk.
//
// The walks replace no Pallas kernel of
// montecarlopathtracing_tpu/kernels/cluster.py: they are the counterparts of
// the XLA while loops of montecarlopathtracing_tpu/accel/lbvh.py
// (bvh_intersect, packet_intersect), whose arithmetic is
// montecarlopathtracing_tpu/ops/intersect.py (ray_aabb, ray_triangle_compat,
// ray_triangle_mt).  The plain PyTorch versions are
// montecarlopathtracing_torch/accel/lbvh.py's bvh_intersect_plain and
// packet_intersect_plain, which call the port's ops/intersect.py; the
// kernels must agree with them bit for bit on the card, so:
//   * built with -fmad=false and IEEE division, every expression in the
//     order of ops/intersect.py;
//   * a three-term dot product (torch.sum(a * b, -1) there) adds its terms
//     in the order PyTorch's CUDA reduction adds three contiguous values:
//     two lanes, the first holding terms 0 and 2, then one shuffle, so
//     (a0 b0 + a2 b2) + a1 b1;
//   * the slab test's max and min propagate NaN as torch.amax / torch.amin
//     do (0 * inf on a slab plane misses the box), where fmaxf / fminf
//     would drop it;
//   * 1 / -0.0 is -inf, so that axis takes its near plane from the box max.
// What bounds the walks on an H100 is in each kernel's own note.

#pragma once

#include <cuda_runtime.h>

namespace mcpt_walk {

constexpr float kBig = 1e30f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* __restrict__ a, long i) {
  return V3{__ldg(a + 3 * i), __ldg(a + 3 * i + 1), __ldg(a + 3 * i + 2)};
}

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ float dot(V3 a, V3 b) {
  const float p0 = a.x * b.x, p1 = a.y * b.y, p2 = a.z * b.z;
  return (p0 + p2) + p1;
}

// NaN-propagating max and min (torch.amax / torch.amin).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

// ops/intersect.py::ray_aabb with t_max.
__device__ __forceinline__ bool slab_hit(V3 o, V3 inv, V3 bmin, V3 bmax,
                                         float t_max) {
  const bool nx = inv.x < 0.0f, ny = inv.y < 0.0f, nz = inv.z < 0.0f;
  const float tnx = ((nx ? bmax.x : bmin.x) - o.x) * inv.x;
  const float tny = ((ny ? bmax.y : bmin.y) - o.y) * inv.y;
  const float tnz = ((nz ? bmax.z : bmin.z) - o.z) * inv.z;
  const float tfx = ((nx ? bmin.x : bmax.x) - o.x) * inv.x;
  const float tfy = ((ny ? bmin.y : bmax.y) - o.y) * inv.y;
  const float tfz = ((nz ? bmin.z : bmax.z) - o.z) * inv.z;
  const float enter = nan_max(nan_max(tnx, tny), tnz);
  const float exit_ = nan_min(nan_min(tfx, tfy), tfz);
  return (enter <= exit_) && (exit_ >= 0.0f) && (enter <= t_max);
}

// slab_hit in fewer instructions where it may be: OCT < 0 is slab_hit
// itself; OCT >= 0 is for a ray whose origin, d and 1 / d are finite, on a
// box of finite values, where no slab value can be NaN (no 0 * inf), so
// fmaxf / fminf (one instruction each) give slab_hit's hit (they may differ
// only in the sign of a zero, which no comparison sees).  OCT 8 takes the
// near planes by the signs of 1 / d; OCT 0-7 has them fixed (bit 0, 1, 2
// set where inv.x, .y, .z < 0).
template <int OCT>
__device__ __forceinline__ bool slab_hit_as(V3 o, V3 inv, V3 bmin, V3 bmax,
                                            float t_max) {
  if (OCT < 0) return slab_hit(o, inv, bmin, bmax, t_max);
  const bool nx = OCT == 8 ? inv.x < 0.0f : (OCT & 1) != 0;
  const bool ny = OCT == 8 ? inv.y < 0.0f : (OCT & 2) != 0;
  const bool nz = OCT == 8 ? inv.z < 0.0f : (OCT & 4) != 0;
  const float tnx = ((nx ? bmax.x : bmin.x) - o.x) * inv.x;
  const float tny = ((ny ? bmax.y : bmin.y) - o.y) * inv.y;
  const float tnz = ((nz ? bmax.z : bmin.z) - o.z) * inv.z;
  const float tfx = ((nx ? bmin.x : bmax.x) - o.x) * inv.x;
  const float tfy = ((ny ? bmin.y : bmax.y) - o.y) * inv.y;
  const float tfz = ((nz ? bmin.z : bmax.z) - o.z) * inv.z;
  const float enter = fmaxf(fmaxf(tnx, tny), tnz);
  const float exit_ = fminf(fminf(tfx, tfy), tfz);
  return (enter <= exit_) && (exit_ >= 0.0f) && (enter <= t_max);
}

// Whether slab_hit_as<OCT >= 0> may stand for slab_hit on this ray (the
// tree's own values must be finite too).
__device__ __forceinline__ bool slab_finite(V3 o, V3 d, V3 inv) {
  return isfinite(o.x) && isfinite(o.y) && isfinite(o.z) && isfinite(d.x) &&
         isfinite(d.y) && isfinite(d.z) && isfinite(inv.x) &&
         isfinite(inv.y) && isfinite(inv.z);
}

// A triangle as one 48-byte record (SceneArrays.tri_records: v0, v1, v2,
// geom_n; NaN throughout where the slot is not valid, so either test
// fails on it), in three 16-byte loads.
constexpr int kTriFloats = 12;

struct Tri {
  V3 p0, p1, p2, gn;
};

__device__ __forceinline__ Tri load_tri(const float* __restrict__ tris, int tri) {
  const float4* p = reinterpret_cast<const float4*>(tris + kTriFloats * (long)tri);
  const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
  return Tri{V3{a.x, a.y, a.z}, V3{a.w, b.x, b.y}, V3{b.z, b.w, c.x},
             V3{c.y, c.z, c.w}};
}

// A node's box as one 24-byte record (BVHArrays.node_records: min xyz,
// max xyz), in three 8-byte loads.
constexpr int kNodeFloats = 6;

struct Box {
  float2 a, b, c;  // min x y, min z max x, max y z
  __device__ __forceinline__ V3 lo() const { return V3{a.x, a.y, b.x}; }
  __device__ __forceinline__ V3 hi() const { return V3{b.y, c.x, c.y}; }
};

__device__ __forceinline__ Box load_box(const float* __restrict__ nodes, long k) {
  const float2* p = reinterpret_cast<const float2*>(nodes + kNodeFloats * k);
  return Box{__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

// ops/intersect.py::ray_triangle_compat (hit, t); barycentrics are not needed.
__device__ __forceinline__ bool tri_compat(V3 o, V3 d, V3 p0, V3 p1, V3 p2,
                                           V3 gn, float& t) {
  const float denom = dot(gn, d);
  t = dot(sub(p0, o), gn) / denom;
  const V3 p{o.x + d.x * t, o.y + d.y * t, o.z + d.z * t};
  const float c1 = dot(cross(sub(p1, p0), sub(p, p0)), gn);
  const float c2 = dot(cross(sub(p2, p1), sub(p, p1)), gn);
  const float c3 = dot(cross(sub(p0, p2), sub(p, p2)), gn);
  return (c1 * c2 >= 0.0f) && (c1 * c3 >= 0.0f) && (c2 * c3 >= 0.0f) &&
         isfinite(t);
}

// ops/intersect.py::ray_triangle_mt (hit, t).
__device__ __forceinline__ bool tri_mt(V3 o, V3 d, V3 p0, V3 p1, V3 p2,
                                       float& t) {
  const V3 e1 = sub(p1, p0), e2 = sub(p2, p0);
  const V3 pvec = cross(d, e2);
  const float det = dot(e1, pvec);
  const float inv_det = 1.0f / det;
  const V3 tvec = sub(o, p0);
  const float u = dot(tvec, pvec) * inv_det;
  const V3 qvec = cross(tvec, e1);
  const float v = dot(d, qvec) * inv_det;
  t = dot(e2, qvec) * inv_det;
  return (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && isfinite(t);
}

template <bool MT>
__device__ __forceinline__ bool tri_test(V3 o, V3 d, const Tri& tri, float& t) {
  if (MT) return tri_mt(o, d, tri.p0, tri.p1, tri.p2, t);
  return tri_compat(o, d, tri.p0, tri.p1, tri.p2, tri.gn, t);
}

// accel/lbvh.py::_advance: the next subtree in preorder, 0 past the root.
// It strips k's t trailing ones (k >> t) and steps to the sibling (+ 1);
// k + 1 has t trailing zeros, so (k >> t) + 1 = (k + 1) >> t is the odd
// part of k + 1, and that is 1 exactly when k >> t is 0.  (Fewer
// instructions than dividing by ~k & (k + 1), and measured faster on an
// H100: PERF.md.)
__device__ __forceinline__ int advance(int k) {
  const int x = k + 1;
  const int a = x >> (__ffs(x) - 1);
  return a == 1 ? 0 : a;
}

}  // namespace mcpt_walk
