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
// box passes, one 48-byte triangle record, and does about 19 f32 operations
// for the slab test and 87 (compat) or 56 (MT) for a triangle test.  The
// inputs read once (rays, nodes, triangles) are ~17 MB at 100k triangles,
// and moving them outlasts the tests the rays' visits need, so the bound is
// the bytes.  What keeps the kernel far above it (PERF.md, PR 9): a launch
// ends with its longest walks (up to ~1,000 steps against a mean of 43 at
// 100k), each step a node load that depends on the step before, mostly
// from L2 below the top levels.  Every ray is resident from the start (one
// wave of blocks), so the longest walks start first; what shortens them is
// a cheaper step:
//   * a node is one 24-byte record (BVHArrays.node_records), three 8-byte
//     loads, and the next node's load goes out before a leaf's test; a
//     triangle is one 48-byte record (SceneArrays.tri_records: v0, v1, v2,
//     geom_n, NaN in every slot that is not valid, so the test itself
//     rejects it), three 16-byte loads, made only at a leaf whose box
//     passes;
//   * a warp whose rays all have a finite origin, d and 1 / d, on a tree
//     of finite values, takes the slab test with fmaxf / fminf
//     (walk_common.cuh's slab_hit_as), and with its near planes fixed at
//     compile time when its rays share a direction octant (eight loops);
//   * a launch whose max_steps cannot end a walk counts no steps (measured
//     0.9% faster on an H100 at 100k than counting on every call, PERF.md).
// Tried and measured slower (PERF.md): both candidate boxes (and a leaf
// candidate's triangle) loaded a step ahead, in every warp or in warps of
// few live lanes; prefetch.global.L1 of the nodes two or three steps on;
// 32-byte node records; the top 11 levels in shared memory; persistent
// blocks that fetch rays; rounds after which a block moves its live rays to
// its first warps (SIMT efficiency 0.3 -> 0.6, the launch longer).
// -DMCPT_BVH_WALK_V1 builds the parent design instead (one thread per ray,
// 128-thread blocks, the node read by six scalar loads at the head of each
// step, the NaN-propagating slab test, a step counter), so that both can be
// timed on one card; -DMCPT_WALK_STATS builds a measurement version that
// writes kRayStats counters per ray (see mcpt_bvh_walk).

#include "walk_common.cuh"

namespace {

using namespace mcpt_walk;

#ifdef MCPT_BVH_WALK_V1
constexpr int kThreads = 128;
#else
constexpr int kThreads = 256;
#endif

// Counters per ray of a -DMCPT_WALK_STATS build (BVH_WALK_STATS of
// accel/lbvh.py): [0] steps, [1] leaf steps with a triangle test, [2] clock
// cycles of the ray's walk, of which [3] waiting for the node's box, [4] the
// slab test and the choice of the next key, [5] waiting for the leaf's
// triangle, [6] the triangle test; [7] the global index of the thread and
// [8] the block that walked it; [9] and [10] %globaltimer (ns) at its start
// and end; [11] steps taken as the only lane of its warp still walking, [12]
// steps at nodes of the top 11 levels (k < kTopNodes).
[[maybe_unused]] constexpr int kRayStats = 14;
// [13]: the sum over the ray's steps of 2^20 / (lanes of its warp stepping
// then): the warp iterations it took part in, shared among their lanes.
[[maybe_unused]] constexpr long long kShareOne = 1 << 20;
[[maybe_unused]] constexpr int kTopNodes = 2048;

#ifdef MCPT_WALK_STATS
#define WS_CLOCK(name) const long long name = clock64()
#define WS_ADD(i, x) (ws[i] += (x))
// An instruction that needs v before the next clock read (the clock read
// itself has no operand to wait on).
#define WS_AFTER(v) asm volatile("add.u32 %0, %0, %1;" : "+r"(ws_dep) : "r"((unsigned)(v)))
#define WS_BITS3(a) (__float_as_uint((a).x) ^ __float_as_uint((a).y) ^ __float_as_uint((a).z))
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#else
#define WS_CLOCK(name)
#define WS_ADD(i, x)
#define WS_AFTER(v)
#endif

// The stats row of ray i, written once by the thread that walked it.
#ifdef MCPT_WALK_STATS
#define WS_BEGIN                      \
  long long ws[kRayStats] = {};       \
  unsigned ws_dep = 0;                \
  const long long ws_ns0 = global_ns(); \
  WS_CLOCK(ws_c0)
#define WS_END(i)                                                          \
  do {                                                                     \
    WS_CLOCK(ws_c1);                                                       \
    if (stats != nullptr) {                                                \
      ws[2] = ws_c1 - ws_c0 + (ws_dep == 0x9e3779b9u ? 1 : 0);             \
      ws[7] = (long long)blockIdx.x * blockDim.x + threadIdx.x;            \
      ws[8] = blockIdx.x;                                                  \
      ws[9] = ws_ns0;                                                      \
      ws[10] = global_ns();                                                \
      for (int q = 0; q < kRayStats; ++q) stats[(long)(i) * kRayStats + q] = ws[q]; \
    }                                                                      \
  } while (0)
#else
#define WS_BEGIN
#define WS_END(i)
#endif

#ifdef MCPT_BVH_WALK_V1
// The parent design: one thread per ray; each step reads its node's box and,
// at a leaf whose box passes, its triangle by scalar loads at the head of
// the step that uses them (from the 24- and 48-byte records; the parent
// read five arrays and the valid flags).
template <bool MT, bool CAPPED>
__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(const float* __restrict__ origin,
                const float* __restrict__ direction, int r,
                const float* __restrict__ nodes, int lc,
                const float* __restrict__ tris, int max_steps, int finite_nodes,
                float* __restrict__ out_t, int* __restrict__ out_tri,
                long long* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r) return;
  WS_BEGIN;
  const V3 o = load3(origin, i), d = load3(direction, i);
  const V3 inv{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  float best_t = kBig;
  int best_tri = -1;
  int k = 1;
  for (int step = 0; k > 0 && step < max_steps; ++step) {
    WS_CLOCK(c0);
    const float* nb = nodes + kNodeFloats * (long)k;
    const V3 bmin{__ldg(nb), __ldg(nb + 1), __ldg(nb + 2)};
    const V3 bmax{__ldg(nb + 3), __ldg(nb + 4), __ldg(nb + 5)};
    WS_AFTER(WS_BITS3(bmin) ^ WS_BITS3(bmax));
    WS_CLOCK(c1);
    const bool hit_box = slab_hit(o, inv, bmin, bmax, best_t);
    const bool is_leaf = k >= lc;
    const int k_next = (hit_box && !is_leaf) ? 2 * k : advance(k);
    WS_AFTER(k_next);
    WS_CLOCK(c2);
    WS_ADD(0, 1);
    WS_ADD(3, c1 - c0);
    WS_ADD(4, c2 - c1);
#ifdef MCPT_WALK_STATS
    WS_ADD(11, __popc(__activemask()) == 1);
    WS_ADD(12, k < kTopNodes);
    WS_ADD(13, kShareOne / __popc(__activemask()));
#endif
    if (hit_box && is_leaf) {
      const int tri = k - lc;
      const float* p = tris + kTriFloats * (long)tri;
      const V3 p0{__ldg(p), __ldg(p + 1), __ldg(p + 2)};
      const V3 p1{__ldg(p + 3), __ldg(p + 4), __ldg(p + 5)};
      const V3 p2{__ldg(p + 6), __ldg(p + 7), __ldg(p + 8)};
      const V3 gn{__ldg(p + 9), __ldg(p + 10), __ldg(p + 11)};
      WS_AFTER(WS_BITS3(p0) ^ WS_BITS3(p1) ^ WS_BITS3(p2) ^ WS_BITS3(gn));
      WS_CLOCK(c3);
      float t;
      // An invalid slot's record is NaN: its t is NaN and the test fails.
      const bool h = tri_test<MT>(o, d, Tri{p0, p1, p2, gn}, t);
      if (h && t > 0.0f && t < best_t) {
        best_t = t;
        best_tri = tri;
      }
      WS_AFTER(__float_as_uint(best_t));
      WS_CLOCK(c4);
      WS_ADD(1, 1);
      WS_ADD(5, c3 - c2);
      WS_ADD(6, c4 - c3);
    }
    k = k_next;
  }
  out_t[i] = best_tri >= 0 ? best_t : kBig;
  out_tri[i] = best_tri;
  WS_END(i);
}

#else

// One ray's walk from the root with the slab test slab_hit_as<OCT>.  CAPPED:
// max_steps may end the walk (a walk visits each node at most once, so a
// cap of 2 lc steps or more never does).
template <bool MT, int OCT, bool CAPPED>
__device__ __forceinline__ void walk(V3 o, V3 d, V3 inv,
                                     const float* __restrict__ nodes, int lc,
                                     const float* __restrict__ tris, int max_steps,
                                     float& best_t, int& best_tri, long long* ws,
                                     unsigned& ws_dep) {
  int k = 1, steps = 0;
  Box box = load_box(nodes, 1);
  do {
    WS_CLOCK(c0);
    const V3 bmin = box.lo(), bmax = box.hi();
    WS_AFTER(WS_BITS3(bmin) ^ WS_BITS3(bmax));
    WS_CLOCK(c1);
    const bool hit_box = slab_hit_as<OCT>(o, inv, bmin, bmax, best_t);
    const bool is_leaf = k >= lc;
    const int k_next = (hit_box && !is_leaf) ? 2 * k : advance(k);
    WS_AFTER(k_next);
    WS_CLOCK(c2);
    WS_ADD(0, 1);
    WS_ADD(3, c1 - c0);
    WS_ADD(4, c2 - c1);
#ifdef MCPT_WALK_STATS
    WS_ADD(11, __popc(__activemask()) == 1);
    WS_ADD(12, k < kTopNodes);
    WS_ADD(13, kShareOne / __popc(__activemask()));
#endif
    // The next node's load goes out before the leaf's test.
    if (k_next > 0) box = load_box(nodes, k_next);
    if (hit_box && is_leaf) {
      const Tri tri = load_tri(tris, k - lc);
      WS_AFTER(WS_BITS3(tri.p0) ^ WS_BITS3(tri.p1) ^ WS_BITS3(tri.p2) ^
               WS_BITS3(tri.gn));
      WS_CLOCK(c3);
      float t;
      // An invalid slot's record is NaN: its t is NaN and the test fails.
      const bool h = tri_test<MT>(o, d, tri, t);
      if (h && t > 0.0f && t < best_t) {
        best_t = t;
        best_tri = k - lc;
      }
      WS_AFTER(__float_as_uint(best_t));
      WS_CLOCK(c4);
      WS_ADD(1, 1);
      WS_ADD(5, c3 - c2);
      WS_ADD(6, c4 - c3);
    }
    k = k_next;
  } while (k > 0 && (!CAPPED || ++steps < max_steps));
}

// The redesign (see the note at the top).
template <bool MT, bool CAPPED>
__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(const float* __restrict__ origin,
                const float* __restrict__ direction, int r,
                const float* __restrict__ nodes, int lc,
                const float* __restrict__ tris, int max_steps, int finite_nodes,
                float* __restrict__ out_t, int* __restrict__ out_tri,
                long long* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r) return;
  WS_BEGIN;
#ifndef MCPT_WALK_STATS
  long long* ws = nullptr;
  unsigned ws_dep = 0;
#endif
  const V3 o = load3(origin, i), d = load3(direction, i);
  const V3 inv{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  const bool fin = slab_finite(o, d, inv);
  const int oct = (inv.x < 0.0f) | (inv.y < 0.0f) << 1 | (inv.z < 0.0f) << 2;
  float best_t = kBig;
  int best_tri = -1;
  if (max_steps > 0) {
    // The whole warp takes one loop: its octant's when its rays are finite
    // and share one, else the fmaxf test with the signs read, else (a ray
    // or the tree that can make a NaN) the NaN-propagating test.
    const unsigned m = __activemask();
    const int oct0 = __shfl_sync(m, oct, __ffs(m) - 1);
    const int mode = !(finite_nodes && __all_sync(m, fin)) ? -1
                     : __all_sync(m, oct == oct0) ? oct0 : 8;
#define MCPT_WALK_AS(OCT)                                                    \
  walk<MT, OCT, CAPPED>(o, d, inv, nodes, lc, tris, max_steps, best_t, best_tri, \
                        ws, ws_dep)
    switch (mode) {
      case 0: MCPT_WALK_AS(0); break;
      case 1: MCPT_WALK_AS(1); break;
      case 2: MCPT_WALK_AS(2); break;
      case 3: MCPT_WALK_AS(3); break;
      case 4: MCPT_WALK_AS(4); break;
      case 5: MCPT_WALK_AS(5); break;
      case 6: MCPT_WALK_AS(6); break;
      case 7: MCPT_WALK_AS(7); break;
      case 8: MCPT_WALK_AS(8); break;
      default: MCPT_WALK_AS(-1); break;
    }
#undef MCPT_WALK_AS
  }
  out_t[i] = best_tri >= 0 ? best_t : kBig;
  out_tri[i] = best_tri;
  WS_END(i);
}

#endif

}  // namespace

// origin, direction (r, 3) f32; nodes (2 lc, 6) f32, 8-byte aligned, each
// row min xyz, max xyz (BVHArrays.node_records); tris (lc, 12) f32, 16-byte
// aligned, each row v0, v1, v2, geom_n and NaN where the slot is not valid
// (SceneArrays.tri_records); finite_nodes: every node value is finite
// (BVHArrays.finite); out_t (r,)
// f32, out_tri (r,) i32.  mt selects the Moller-Trumbore test.  stats:
// null, or (r, kRayStats) int64 that a -DMCPT_WALK_STATS build fills (other
// builds leave it alone).  Returns the launch's CUDA error.
extern "C" int mcpt_bvh_walk(const float* origin, const float* direction,
                             int r, const float* nodes, int lc,
                             const float* tris, int mt, int max_steps,
                             int finite_nodes, float* out_t, int* out_tri,
                             long long* stats, void* stream) {
  if (r <= 0) return (int)cudaGetLastError();
  const int blocks = (r + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  // A walk visits each of the 2 lc - 1 nodes at most once.
  const bool capped = max_steps < 2 * lc;
  auto kernel = mt ? (capped ? bvh_walk_kernel<true, true> : bvh_walk_kernel<true, false>)
                   : (capped ? bvh_walk_kernel<false, true> : bvh_walk_kernel<false, false>);
  kernel<<<blocks, kThreads, 0, s>>>(origin, direction, r, nodes, lc, tris,
                                     max_steps, finite_nodes, out_t, out_tri,
                                     stats);
  return (int)cudaGetLastError();
}
