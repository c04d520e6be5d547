// Device code shared by the three intersect kernels (cluster_intersect.cu,
// cluster_intersect_ftb.cu, cluster_intersect_hbm.cu): the ray / triangle
// tests, the lexicographic best, the ray tile a thread holds, and the staged
// ring of table pieces.  All three round alike because they share it.
//
// Replaces the inner loops of montecarlopathtracing_tpu/kernels/cluster.py::
// _intersect_kernel and _intersect_hbm_kernel.  The tests, over one column
// (triangle) of the 16-row constant table:
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
//
// What bounds the tests on an H100, and what this code does about it.  A
// test is about 85 instructions once a*b+c may not contract (8 dot products
// of 5, an IEEE division of about 10, the sign products and compares), so an
// SM that executes 128 lanes a clock does at most about 1.5 tests a clock;
// its shared memory serves 32 lanes a clock.  With one ray per thread and
// one 4-byte load per table word (16 per test) the load pipe, not
// arithmetic, would set the pace, at 2 tests a clock at most.  Here
//   * a thread holds kRaysPerThread rays in registers and tests each staged
//     column against all of them, so a column is loaded once for 4 tests;
//   * a piece is staged column-major, 16 consecutive words per column, so a
//     column is four 16-byte loads (one load instruction per test); the four
//     float4 of column c sit at positions q ^ ((c >> 1) & 3), which keeps
//     both the staging writes and the loads free of bank conflicts;
//   * pieces are copied with cp.async (4 bytes per lane: the table is
//     row-major in device memory, so the copy transposes) into a ring of
//     kStages slots; the next piece is in flight while the current one is
//     tested, and one barrier per piece both publishes the copy and retires
//     the slot that the piece after next will overwrite.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>

namespace mcpt {

constexpr float kBig = 1e30f;
constexpr float kParked = 1e9f;  // origin of a parked ray

#ifndef MCPT_RAYS_PER_THREAD  // set only to measure other register tiles
#define MCPT_RAYS_PER_THREAD 4
#endif
constexpr int kRaysPerThread = MCPT_RAYS_PER_THREAD;
constexpr int kPieceCols = 128;  // table columns per staged piece (max)
constexpr int kStages = 3;       // slots of the ring
constexpr int kMaxThreads = 256;
// Blocks per SM the register allocation must allow: 3 blocks of 256 threads
// cap a thread at 80 registers, which the compat kernels meet without
// spilling (the Moller-Trumbore ones spill a few words); left to itself the
// compiler takes 90-109 for the front-to-back kernels and only 2 blocks fit.
#ifndef MCPT_MIN_BLOCKS
#define MCPT_MIN_BLOCKS 3
#endif

// Dynamic shared memory of a launch whose widest piece has `piece_cols`
// columns: kStages slots of 4 float4 per column (24 KB at 128 columns; a
// narrow table takes less, so more of its blocks fit an SM).
inline size_t ring_bytes(int piece_cols) {
  return sizeof(float4) * kStages * 4 * (size_t)piece_cols;
}

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

// How the threads of a block share a subtile of `tile` rays: a group of
// `split` consecutive lanes of one warp holds kRaysPerThread consecutive rays
// and splits the columns of a piece between its lanes.  The block is rounded
// up to whole warps; a group past the subtile's end, and a ray past it inside
// the last group, repeats the subtile's last ray and writes nothing.
struct BlockShape {
  int split;    // lanes per ray group: a power of two, at most 32
  int threads;  // a multiple of 32, at most kMaxThreads
};

// `piece_cols` is the widest piece the launch will stage: a lane gets at
// least kColsPerLane of its columns, so a narrow table (the built-in box is
// one cluster of 16 columns) runs on small blocks, many to an SM, instead of
// 256 threads with one column each.
#ifndef MCPT_COLS_PER_LANE  // set only to measure other block shapes
#define MCPT_COLS_PER_LANE 4
#endif
constexpr int kColsPerLane = MCPT_COLS_PER_LANE;

inline BlockShape block_shape(int tile, int piece_cols) {
  const int groups = (tile + kRaysPerThread - 1) / kRaysPerThread;
  int split = 1;
  while (split < 32 && groups * split * 2 <= kMaxThreads &&
         split * 2 * kColsPerLane <= piece_cols)
    split *= 2;
  return {split, (groups * split + 31) / 32 * 32};
}

// The rays of this thread's group, out of the subtile whose first ray row is
// `rp0`; `first` receives the index in the subtile of the group's first ray.
template <bool MT>
__device__ __forceinline__ void load_ray_tile(const float* rp0, int ray_stride,
                                              int tile, int split,
                                              Ray (&r)[kRaysPerThread],
                                              int& first) {
  first = (threadIdx.x / split) * kRaysPerThread;
#pragma unroll
  for (int i = 0; i < kRaysPerThread; ++i) {
    const int ray = min(first + i, tile - 1);
    r[i] = load_ray<MT>(rp0 + (size_t)ray * ray_stride);
  }
}

// ---------------------------------------------------------------------------
// The staged ring.
// ---------------------------------------------------------------------------

// Position of float4 q (table rows 4q..4q+3) of column c inside a slot.
__device__ __forceinline__ int col_vec(int c, int q) {
  return 4 * c + (q ^ ((c >> 1) & 3));
}

// Start the copy of `ncols` columns of a row-major table block (16 rows,
// `row_stride` floats apart, first column at `src`) into columns col0.. of
// `slot`.  A warp copies 8 columns x 4 rows per instruction: four 32-byte
// runs of device memory into 32 distinct banks.  The caller commits.
__device__ __forceinline__ void stage_cols(float4* slot, int col0,
                                           const float* __restrict__ src,
                                           int row_stride, int ncols) {
  const int lane = threadIdx.x & 31;
  const int cl = lane & 7;
  const int rl = lane >> 3;
  const int n_warps = blockDim.x >> 5;
  const int n_tasks = ((ncols + 7) >> 3) * 4;
  for (int task = threadIdx.x >> 5; task < n_tasks; task += n_warps) {
    const int c = (task >> 2) * 8 + cl;
    const int q = task & 3;
    if (c < ncols) {
      float* dst = reinterpret_cast<float*>(slot + col_vec(col0 + c, q)) + rl;
      __pipeline_memcpy_async(dst, src + (size_t)(4 * q + rl) * row_stride + c,
                              sizeof(float));
    }
  }
}

// One staged column: rows 0..15 as four float4.
struct Col {
  float4 a, b, c, d;
};

__device__ __forceinline__ Col load_col(const float4* slot, int c) {
  const float4* p = slot + 4 * c;
  const int x = (c >> 1) & 3;
  Col k;
  k.a = p[x];
  k.b = p[1 ^ x];
  k.c = p[2 ^ x];
  k.d = p[3 ^ x];
  return k;
}

// ---------------------------------------------------------------------------
// The tests.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// Tests ray r against the staged column k.  Returns whether the triangle is
// accepted, and its distance in t.
template <bool MT>
__device__ __forceinline__ bool tri_test(const Ray& r, const Col& k, float& t) {
  bool inside;
  if (MT) {
    // a = (n, kn), b = (e1, e2.x), c = (e2.yz, k_u.xy), d = (k_u.z, k_v)
    const float det = -dot3(r.dx, r.dy, r.dz, k.a.x, k.a.y, k.a.z);
    const float o_n = dot3(r.ox, r.oy, r.oz, k.a.x, k.a.y, k.a.z);
    t = (o_n - k.a.w) / det;
    const float au = dot3(r.wx, r.wy, r.wz, k.b.w, k.c.x, k.c.y) +
                     dot3(r.dx, r.dy, r.dz, k.c.z, k.c.w, k.d.x);
    const float av = -dot3(r.wx, r.wy, r.wz, k.b.x, k.b.y, k.b.z) +
                     dot3(r.dx, r.dy, r.dz, k.d.y, k.d.z, k.d.w);
    inside = (au * det >= 0.0f) && (av * det >= 0.0f) &&
             ((det - au - av) * det >= 0.0f);
  } else {
    // a = (n, kn), b = (m1, k1), c = (m2, k2), d = (m3, k3)
    const float n_o = dot3(r.ox, r.oy, r.oz, k.a.x, k.a.y, k.a.z);
    const float n_d = dot3(r.dx, r.dy, r.dz, k.a.x, k.a.y, k.a.z);
    t = (k.a.w - n_o) / n_d;
    const float c1 = dot3(r.ox, r.oy, r.oz, k.b.x, k.b.y, k.b.z) +
                     t * dot3(r.dx, r.dy, r.dz, k.b.x, k.b.y, k.b.z) - k.b.w;
    const float c2 = dot3(r.ox, r.oy, r.oz, k.c.x, k.c.y, k.c.z) +
                     t * dot3(r.dx, r.dy, r.dz, k.c.x, k.c.y, k.c.z) - k.c.w;
    const float c3 = dot3(r.ox, r.oy, r.oz, k.d.x, k.d.y, k.d.z) +
                     t * dot3(r.dx, r.dy, r.dz, k.d.x, k.d.y, k.d.z) - k.d.w;
    inside = (c1 * c2 >= 0.0f) && (c1 * c3 >= 0.0f) && (c2 * c3 >= 0.0f);
  }
  return inside && t > 0.0f && t < kBig;
}

// Order-preserving map between float and int (and back: an involution).
__device__ __forceinline__ int ordered_bits(int b) {
  return b ^ ((b >> 31) & 0x7fffffff);
}

// Running lexicographic (t, tri) minimum: the winner of the TPU kernel's
// deferred best (ties at equal t go to the lowest id), in any order.
__device__ __forceinline__ void lex_min(float& bt, int& bi, float t, int tri) {
  if (t < bt || (t == bt && tri < bi)) {
    bt = t;
    bi = tri;
  }
}

// The 64-bit word on which blocks that share a ray meet by atomicMin:
// (float bits of t) << 32 | triangle id.  An accepted t is positive, so the
// integer order of the words is the lexicographic (t, id) order, and the
// least word does not depend on the order of arrival.  The miss (1e30, -1)
// is the largest word there is; the caller presets every word to it.
constexpr unsigned long long kMissWord = 0x7149F2CAFFFFFFFFull;

__device__ __forceinline__ unsigned long long hit_word(float bt, int bi) {
  return bt < kBig ? ((unsigned long long)__float_as_uint(bt) << 32) |
                         (unsigned)bi
                   : kMissWord;
}

// Tests this thread's share of a staged piece (columns part, part + split,
// ... below ncols) against its rays; tri_of(c) is the triangle id of column
// c, asked only on a hit.
template <bool MT, class TriOf>
__device__ __forceinline__ void test_piece(const Ray (&r)[kRaysPerThread],
                                           const float4* slot, int ncols,
                                           int part, int split,
                                           float (&bt)[kRaysPerThread],
                                           int (&bi)[kRaysPerThread],
                                           TriOf tri_of) {
#ifndef MCPT_SKIP_TESTS  // defined only to time the copy pipeline alone
  for (int c = part; c < ncols; c += split) {
    const Col k = load_col(slot, c);
#pragma unroll
    for (int i = 0; i < kRaysPerThread; ++i) {
      float t;
      if (tri_test<MT>(r[i], k, t)) lex_min(bt[i], bi[i], t, tri_of(c));
    }
  }
#endif
}

// Lexicographic minimum over the `split` lanes of one ray group: an aligned
// run of consecutive lanes of one (whole) warp.  Every lane of the group
// gets the result.
__device__ __forceinline__ void lex_reduce(float& bt, int& bi, int split) {
  for (int off = split >> 1; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(0xffffffffu, bt, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    lex_min(bt, bi, ot, oi);
  }
}

}  // namespace mcpt
