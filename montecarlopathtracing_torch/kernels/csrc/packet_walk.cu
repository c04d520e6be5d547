// The packet LBVH walk: nearest hit of each ray, a packet of rays walking
// one shared trail down to fat leaves.
//
// Replaces no Pallas kernel of montecarlopathtracing_tpu/kernels/cluster.py:
// it is the counterpart of the XLA while loop (under lax.map over packets)
// of montecarlopathtracing_tpu/accel/lbvh.py::packet_intersect, the JAX
// package's intersector="bvh" and its "auto" off the TPU.  Its plain
// PyTorch version is accel/lbvh.py::packet_intersect_plain.  The rules
// (walk_common.cuh holds the arithmetic):
//   * one block per packet of `packet` consecutive rays (the wrapper pads
//     the tail with parked rays, as the JAX package does);
//   * the block holds one heap key; each ray's slab test is capped at its
//     own best t, and the block descends when any ray hits and the node
//     lies above the fat leaves, which start at fat_start = Lc / leaf_width;
//   * at a fat leaf whose box some ray hits, each ray that hit it tests the
//     leaf's leaf_width triangles from tri0 = clip((k - fat_start)
//     leaf_width, 0, Lc - leaf_width): a triangle wins when it is a hit,
//     valid, t > 0 and t < the ray's best t from before the leaf, and the
//     lowest j wins at equal t (the JAX package's argmin);
//   * the walk ends at key 0 or after max_steps steps (8 fat_start + 64);
//   * a miss is t = 1e30, tri = -1.
//
// Bound on an H100: that of the function, the nearest hit, which the
// per-ray walk computes too: the inputs read once (rays, nodes, triangles,
// ~17 MB at 100k triangles) and the slab and triangle tests the per-ray
// walk needs, about 19 f32 operations per (ray, node) slab test and 87
// (compat) or 56 (MT) per (ray, triangle) test; the bytes decide.  What
// keeps the kernel far above that bound is neither: a packet is one serial
// trail on one SM, so a launch lasts as long as its longest trail's steps
// (~1,900 on the 100k interior) times the time of one step, and a step is
// the node's box from device memory, the packet's 1,024 slab tests
// (~40 instructions each: issue-bound), the barrier that waits for the
// last warp, and at a fat leaf the triangle tests.  The design:
//   * four rays per thread (256 threads, 8 warps): per step each warp
//     loads the box once for four rays, runs four slab tests without a
//     branch between them, and the barrier waits for 8 warps, not 32;
//   * the boxes of both keys that can follow a step (2k, advance(k)) are
//     loaded while its slab tests and barrier run, as three 8-byte loads
//     of a 24-byte record per node (BVHArrays.node_records, the per-ray
//     walk's too); a triangle is one 48-byte record (SceneArrays.tri_records,
//     NaN where the slot is not valid, so its test fails without a flag);
//   * a warp whose rays' origins, d and 1 / d are all finite, on a tree of
//     finite values, takes a slab test with fmaxf / fminf: no 0 * inf can
//     arise, so it gives the NaN-propagating test's hits;
//   * a fat leaf is one round of tests, not leaf_width in series: each warp
//     lists its rays that hit the leaf's box (ballots) and gives the pairs
//     of ray s and triangle j to lane j of group s (lanes s lw .. s lw +
//     lw - 1, each lane loading its triangle j = lane % lw while the
//     barrier runs); a ray's pairs meet in the least (t bits) << 32 | j
//     over its group (xor shuffles; two 32-bit atomic minima in shared
//     memory when lw is no power of two), and the accept rule reads the
//     ray's best t from before the leaf, so the order cannot change the
//     result.  No block barrier but the step's OR.
// Tried and measured slower on these calls (PERF.md): copies of
// the boxes 2-4 steps ahead into shared memory with cp.async (from every
// warp, or from a ninth warp), register loads 2 steps ahead read by
// shuffles (the compiler waits for every load in flight at the first use),
// 1, 2, 3, 6 or 8 rays per thread.  On coherent packets, whose leaves most
// rays hit, the parent design's 32 warps test leaves faster; it stays as
// the thread-per-ray kernel, taken for trees whose fat leaves lie at most
// 4 levels below the root (kSmallTree: small scenes, whose walks are a few
// steps and mostly leaf tests).  -DMCPT_PACKET_WALK_V1 / _V2 build a
// library that takes one of the two kernels for every call, so both can be
// timed on one card; -DMCPT_WALK_STATS builds a measurement version that
// writes kWalkStats counters per packet (see mcpt_packet_walk).

#include "walk_common.cuh"

namespace {

using namespace mcpt_walk;

constexpr int kMaxPacket = 1024;
// Counters per packet of a -DMCPT_WALK_STATS build (PACKET_WALK_STATS of
// accel/lbvh.py): [0] steps, [1] fat-leaf visits with a box hit, [2] rays
// and [3] warps that hit at those visits, [4] clock cycles of the walk, as
// thread 0 sees them, of which [5] until the node's box is in registers,
// [6] the slab tests, [7] the step's barrier, [8] staging the leaf (V1: the
// triangles and a barrier; V2: the ballots and the warp's list), [9] the
// leaf tests (V1: with the closing barrier; V2: thread 0's warp's pairs and
// update).
constexpr int kWalkStats = 10;

#ifdef MCPT_WALK_STATS
#define WS_CLOCK(name) const long long name = clock64()
#define WS_ADD(i, x) (ws[i] += (x))
// An instruction that needs v before the next clock read (the clock read
// itself has no operand to wait on).
#define WS_AFTER(v) asm volatile("add.u32 %0, %0, %1;" : "+r"(ws_dep) : "r"((unsigned)(v)))
#else
#define WS_CLOCK(name)
#define WS_ADD(i, x)
#define WS_AFTER(v)
#endif


// The thread-per-ray kernel (the parent design): one thread per ray, the
// node read at the step's head, a fat leaf staged in shared memory and its
// triangles tested in series by each ray that hit its box.
template <bool MT>
__global__ void __launch_bounds__(kMaxPacket)
walk_thread_per_ray(const float* __restrict__ origin,
                   const float* __restrict__ direction, int packet,
                   const float* __restrict__ nodes, int lc, int lw,
                   const float* __restrict__ tris, int max_steps, int finite_nodes,
                   float* __restrict__ out_t, int* __restrict__ out_tri,
                   long long* __restrict__ stats) {
  extern __shared__ float s_tri[];  // [lw][12]: the leaf's triangle records
#ifdef MCPT_WALK_STATS
  long long ws[kWalkStats] = {};
  unsigned ws_dep = 0;
  __shared__ int s_cnt[2];
  if (threadIdx.x == 0) s_cnt[0] = s_cnt[1] = 0;
  WS_CLOCK(c_begin);
#endif
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const V3 o = load3(origin, i), d = load3(direction, i);
  const V3 inv{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  const int fat_start = lc / lw;
  float best_t = kBig;
  int best_tri = -1;
  int k = 1;
  for (int step = 0; k > 0 && step < max_steps; ++step) {
    WS_CLOCK(c0);
    const Box box = load_box(nodes, k);
    const V3 bmin = box.lo(), bmax = box.hi();
    WS_AFTER(__float_as_int(bmin.x) ^ __float_as_int(bmin.y) ^ __float_as_int(bmin.z) ^
             __float_as_int(bmax.x) ^ __float_as_int(bmax.y) ^ __float_as_int(bmax.z));
    WS_CLOCK(c0b);
    const bool hit = slab_hit(o, inv, bmin, bmax, best_t);
    WS_AFTER(hit);
    WS_CLOCK(c1);
    const bool any_hit = __syncthreads_or(hit);
    WS_AFTER(any_hit);
    WS_CLOCK(c2);
    WS_ADD(0, 1);
    WS_ADD(5, c0b - c0);
    WS_ADD(6, c1 - c0b);
    WS_ADD(7, c2 - c1);
    const bool is_fat = k >= fat_start;
    if (any_hit && is_fat) {
      const int tri0 = min(max((k - fat_start) * lw, 0), lc - lw);
      const float* src = tris + kTriFloats * (long)tri0;
      for (int q = threadIdx.x; q < lw * kTriFloats; q += blockDim.x)
        s_tri[q] = __ldg(src + q);
      __syncthreads();
      WS_CLOCK(c3);
      if (hit) {
        float cur = kBig;
        int cur_j = -1;
        for (int j = 0; j < lw; ++j) {
          const float* p = s_tri + j * kTriFloats;
          float t;
          // An invalid slot's record is NaN: its t is NaN and the test fails.
          const bool h = tri_test<MT>(o, d, Tri{V3{p[0], p[1], p[2]},
                                                V3{p[3], p[4], p[5]},
                                                V3{p[6], p[7], p[8]},
                                                V3{p[9], p[10], p[11]}}, t);
          const bool ok = h && t > 0.0f && t < best_t;
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
      WS_CLOCK(c4);
      WS_ADD(1, 1);
      WS_ADD(8, c3 - c2);
      WS_ADD(9, c4 - c3);
#ifdef MCPT_WALK_STATS
      const unsigned b = __ballot_sync(__activemask(), hit);
      if ((threadIdx.x & 31) == 0 && b) {
        atomicAdd(&s_cnt[0], __popc(b));
        atomicAdd(&s_cnt[1], 1);
      }
#endif
    }
    k = (any_hit && !is_fat) ? 2 * k : advance(k);
  }
  out_t[i] = best_tri >= 0 ? best_t : kBig;
  out_tri[i] = best_tri;
#ifdef MCPT_WALK_STATS
  WS_CLOCK(c_end);
  __syncthreads();
  if (threadIdx.x == 0 && stats != nullptr) {
    ws[2] = s_cnt[0];
    ws[3] = s_cnt[1];
    ws[4] = c_end - c_begin + (ws_dep == 0x9e3779b9u ? 1 : 0);
    for (int q = 0; q < kWalkStats; ++q) stats[blockIdx.x * kWalkStats + q] = ws[q];
  }
#endif
}

size_t thread_per_ray_smem(int packet, int lw, int* threads) {
  *threads = packet;
  return (size_t)lw * kTriFloats * sizeof(float);
}


constexpr int kRays = 4;          // rays per thread
constexpr int kList = 32 * kRays;  // a warp's rays
constexpr int kMaxThreads = ((kMaxPacket + kRays - 1) / kRays + 31) / 32 * 32;
constexpr int kUnroll = 4;             // rounds of pair tests in flight
constexpr unsigned kNone = ~0u;

// The test of pair (list slot s, triangle j) of a warp's list: the bits of
// t when the triangle wins against the ray's best t from before the leaf,
// else kNone.  With `staged` the lane already holds triangle j in `mine`;
// else it is read here.
template <bool MT>
__device__ __forceinline__ unsigned pair_t(int s, int j, bool live,
                                           const Tri& mine, bool staged,
                                           int tri0, const float* tris,
                                           const int* w_ray,
                                           const float* w_best,
                                           const float* s_rays, int packet) {
  const Tri tri = staged ? mine : load_tri(tris, tri0 + j);
  const int ray = w_ray[s];
  const V3 ro{s_rays[ray], s_rays[packet + ray], s_rays[2 * packet + ray]};
  const V3 rd{s_rays[3 * packet + ray], s_rays[4 * packet + ray],
              s_rays[5 * packet + ray]};
  float t;
  // An invalid slot's record is NaN: its t is NaN and the test fails.
  const bool h = tri_test<MT>(ro, rd, tri, t);
  return live && h && t > 0.0f && t < w_best[s]
             ? __float_as_uint(t) : kNone;
}

// The rays-per-thread kernel (the redesign; see the note at the top).
template <bool MT>
__global__ void __launch_bounds__(kMaxThreads)
walk_rays_per_thread(const float* __restrict__ origin,
                   const float* __restrict__ direction, int packet,
                   const float* __restrict__ nodes, int lc, int lw,
                   const float* __restrict__ tris, int max_steps, int finite_nodes,
                   float* __restrict__ out_t, int* __restrict__ out_tri,
                   long long* __restrict__ stats) {
  // Shared memory, per warp and list slot: the ray's least t bits and
  // least j among them, its best t from before the leaf, its block-local
  // index.  Then the packet's rays, [6][packet] (ox oy oz dx dy dz), for
  // the lanes that test another thread's ray.
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned* w_tmin = reinterpret_cast<unsigned*>(smem) + warp * kList;
  unsigned* w_jmin = w_tmin + n_warps * kList;
  float* w_best = reinterpret_cast<float*>(w_jmin + n_warps * kList);
  int* w_ray = reinterpret_cast<int*>(w_best + n_warps * kList);
  float* s_rays = reinterpret_cast<float*>(smem) + 4 * n_warps * kList;
#ifdef MCPT_WALK_STATS
  long long ws[kWalkStats] = {};
  unsigned ws_dep = 0;
  __shared__ int s_cnt[2];
  if (threadIdx.x == 0) s_cnt[0] = s_cnt[1] = 0;
  WS_CLOCK(c_begin);
#endif

  const long base = (long)blockIdx.x * packet;
  V3 o[kRays], inv[kRays];
  bool finite = true;  // every ray of the thread may take slab_hit_as<8>
  float best_t[kRays];
  int best_tri[kRays];
  bool act[kRays];  // the thread holds ray r
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int j = threadIdx.x + r * blockDim.x;
    act[r] = j < packet;
    o[r] = inv[r] = V3{0.0f, 0.0f, 0.0f};
    if (act[r]) {
      o[r] = load3(origin, base + j);
      const V3 d = load3(direction, base + j);
      inv[r] = V3{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
      finite = finite && slab_finite(o[r], d, inv[r]);
      s_rays[j] = o[r].x;
      s_rays[packet + j] = o[r].y;
      s_rays[2 * packet + j] = o[r].z;
      s_rays[3 * packet + j] = d.x;
      s_rays[4 * packet + j] = d.y;
      s_rays[5 * packet + j] = d.z;
    }
    best_t[r] = kBig;
    best_tri[r] = -1;
  }
  for (int q = lane; q < kList; q += 32) w_tmin[q] = w_jmin[q] = kNone;
  // The warp takes the cheaper slab test when its rays and the tree allow.
  const bool warp_finite = finite_nodes && __all_sync(~0u, finite);

  const int fat_start = lc / lw;
  const bool staged = lw <= 32;
  const int per_round = staged ? 32 / lw : 1;  // rays whose pairs fill a round
  const unsigned lanes_below = (1u << lane) - 1;
  int k = 1;
  // The node's box: three 8-byte loads of its record, the same address in
  // every lane.  Each step loads the boxes of both keys that can follow it
  // (2k, advance(k)) while its slab tests and barrier run.
  Box box = load_box(nodes, 1);
  for (int step = 0; k > 0 && step < max_steps; ++step) {
    WS_CLOCK(c0);
    const bool is_fat = k >= fat_start;
    const int tri0 = min(max((k - fat_start) * lw, 0), lc - lw);
    const V3 bmin = box.lo(), bmax = box.hi();
    const int k_down = is_fat ? 0 : 2 * k, k_next = advance(k);
    const Box none{};
    const Box down_box = k_down > 0 ? load_box(nodes, k_down) : none;
    const Box next_box = k_next > 0 ? load_box(nodes, k_next) : none;
    WS_AFTER(__float_as_int(bmin.x) ^ __float_as_int(bmin.y) ^ __float_as_int(bmin.z) ^
             __float_as_int(bmax.x) ^ __float_as_int(bmax.y) ^ __float_as_int(bmax.z));
    WS_CLOCK(c0b);
    // Bit r: ray r's box test passed.  The kRays tests have no branch
    // between them, so their instructions interleave.
    unsigned m = 0;
    if (warp_finite) {
#pragma unroll
      for (int r = 0; r < kRays; ++r)
        m |= (unsigned)(act[r] & slab_hit_as<8>(o[r], inv[r], bmin, bmax,
                                                best_t[r])) << r;
    } else {
#pragma unroll
      for (int r = 0; r < kRays; ++r)
        m |= (unsigned)(act[r] & slab_hit(o[r], inv[r], bmin, bmax, best_t[r]))
             << r;
    }
    // A fat leaf's triangle j = lane % lw, the one this lane tests in every
    // round of the leaf below, loaded while the barrier runs (in the warps
    // with a hit).
    Tri mine{};
    if (is_fat && staged && __any_sync(~0u, m != 0))
      mine = load_tri(tris, tri0 + lane % lw);
    WS_AFTER(m);
    WS_CLOCK(c1);
    const bool any_hit = __syncthreads_or(m != 0);
    WS_AFTER(any_hit);
    WS_CLOCK(c2);
    WS_ADD(0, 1);
    WS_ADD(5, c0b - c0);
    WS_ADD(6, c1 - c0b);
    WS_ADD(7, c2 - c1);
    if (any_hit && is_fat) {
      // This warp's rays that hit the box, listed in (ray slot, lane) order.
      int pos[kRays];
      int cnt = 0;
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        const unsigned b = __ballot_sync(~0u, (m >> r) & 1);
        pos[r] = cnt + __popc(b & lanes_below);
        cnt += __popc(b);
        if ((m >> r) & 1) {
          w_ray[pos[r]] = threadIdx.x + r * blockDim.x;
          w_best[pos[r]] = best_t[r];
        }
      }
      WS_CLOCK(c3);
      if (cnt > 0) {
        __syncwarp();
        const int g = lane / lw, j = lane - g * lw;
        if (staged && (lw & (lw - 1)) == 0) {
          // A round gives lanes g lw .. g lw + lw - 1 the pairs of list slot
          // s0 + g; kUnroll rounds run side by side.  A ray's pairs meet in
          // the least (t bits) << 32 | j over its aligned group of lanes
          // (xor shuffles), which lane j = 0 writes.
          for (int s0 = 0; s0 < cnt; s0 += per_round * kUnroll) {
            unsigned long long word[kUnroll];
            int s[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              s[u] = s0 + u * per_round + g;
              const bool live = s[u] < cnt;
              const unsigned tb = pair_t<MT>(live ? s[u] : 0, j, live, mine,
                                             true, tri0, tris, w_ray, w_best,
                                             s_rays, packet);
              word[u] = tb == kNone ? ~0ull
                                    : ((unsigned long long)tb << 32) | (unsigned)j;
            }
            for (int off = 1; off < lw; off <<= 1) {
#pragma unroll
              for (int u = 0; u < kUnroll; ++u)
                word[u] = min(word[u], __shfl_xor_sync(~0u, word[u], off));
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              if (j == 0 && s[u] < cnt && word[u] != ~0ull) {
                w_tmin[s[u]] = (unsigned)(word[u] >> 32);
                w_jmin[s[u]] = (unsigned)word[u];
              }
            }
          }
        } else if (staged) {
          // Other widths up to 32: the same rounds (lanes past the last
          // whole group idle), a ray's least t and then its least j at that
          // t by two 32-bit atomic minima.
          for (int s0 = 0; s0 < cnt; s0 += per_round * kUnroll) {
            unsigned tb[kUnroll];
            int s[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              s[u] = s0 + u * per_round + g;
              const bool live = g < per_round && s[u] < cnt;
              tb[u] = pair_t<MT>(live ? s[u] : 0, j, live, mine, true, tri0,
                                 tris, w_ray, w_best, s_rays, packet);
              if (tb[u] != kNone) atomicMin(w_tmin + s[u], tb[u]);
            }
            __syncwarp();
#pragma unroll
            for (int u = 0; u < kUnroll; ++u)
              if (tb[u] != kNone && tb[u] == w_tmin[s[u]])
                atomicMin(w_jmin + s[u], (unsigned)j);
          }
        } else {
          // Wider leaves: each slot's pairs 32 at a time, t in a first pass
          // and j in a second that repeats the same tests.
          for (int pass = 0; pass < 2; ++pass) {
            for (int s = 0; s < cnt; ++s) {
              for (int jw = lane; jw < lw; jw += 32) {
                const unsigned tb = pair_t<MT>(s, jw, true, Tri{}, false, tri0,
                                               tris, w_ray, w_best, s_rays, packet);
                if (tb == kNone) continue;
                if (pass == 0) atomicMin(w_tmin + s, tb);
                else if (tb == w_tmin[s]) atomicMin(w_jmin + s, (unsigned)jw);
              }
            }
            __syncwarp();
          }
        }
        __syncwarp();
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
          if ((m >> r) & 1) {
            const unsigned tb = w_tmin[pos[r]];
            if (tb != kNone) {  // t < best_t by the accept rule
              best_t[r] = __uint_as_float(tb);
              best_tri[r] = tri0 + (int)w_jmin[pos[r]];
              w_tmin[pos[r]] = w_jmin[pos[r]] = kNone;
            }
          }
        }
#ifdef MCPT_WALK_STATS
        if (lane == 0) {
          atomicAdd(&s_cnt[0], cnt);
          atomicAdd(&s_cnt[1], 1);
        }
#endif
      }
      WS_CLOCK(c4);
      WS_ADD(1, 1);
      WS_ADD(8, c3 - c2);
      WS_ADD(9, c4 - c3);
    }
    const bool down = any_hit && !is_fat;
    k = down ? k_down : k_next;
    box = down ? down_box : next_box;
  }
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int j = threadIdx.x + r * blockDim.x;
    if (act[r]) {
      out_t[base + j] = best_tri[r] >= 0 ? best_t[r] : kBig;
      out_tri[base + j] = best_tri[r];
    }
  }
#ifdef MCPT_WALK_STATS
  WS_CLOCK(c_end);
  __syncthreads();
  if (threadIdx.x == 0 && stats != nullptr) {
    ws[2] = s_cnt[0];
    ws[3] = s_cnt[1];
    ws[4] = c_end - c_begin + (ws_dep == 0x9e3779b9u ? 1 : 0);
    for (int q = 0; q < kWalkStats; ++q) stats[blockIdx.x * kWalkStats + q] = ws[q];
  }
#endif
}

size_t rays_per_thread_smem(int packet, int* threads) {
  const int t = ((packet + kRays - 1) / kRays + 31) / 32 * 32;
  *threads = t;
  return ((size_t)(t / 32) * kList * 4 + (size_t)6 * packet) * sizeof(float);
}


// Trees whose fat leaves lie at most this many keys deep (fat_start =
// Lc / leaf_width, 4 levels; at leaf width 8, scenes of up to 128 triangle
// slots) take the thread-per-ray kernel: their walks are a few steps, the
// leaf tests are most of a launch, and 32 warps hide those tests' latency
// better than 8.  On the built-in box split into 12-192 triangles (fat_start
// 2-32, kernel_experiments.py --kernels walk), the redesign took 1.89, 1.68,
// 1.52 and 1.37 times the thread-per-ray kernel's time up to fat_start 16,
// and 0.99 times at 32.
constexpr int kSmallTree = 16;

// Dynamic shared memory a block may take without an opt-in: the
// rays-per-thread kernel's ~40 KB at 1,024 rays fits, so the common launch
// makes no attribute call.
constexpr size_t kSmemNoOptIn = 48 * 1024;

template <bool MT>
int launch(const float* origin, const float* direction, int n_packets,
           int packet, const float* nodes, int lc, int leaf_width,
           const float* tris, int max_steps, int finite_nodes, float* out_t,
           int* out_tri, long long* stats, cudaStream_t s) {
#if defined(MCPT_PACKET_WALK_V1)
  const bool per_ray = true;  // a measurement build: the parent design only
#elif defined(MCPT_PACKET_WALK_V2)
  const bool per_ray = false;  // a measurement build: the redesign only
#else
  const bool per_ray = lc / leaf_width <= kSmallTree;
#endif
  auto kernel = per_ray ? walk_thread_per_ray<MT> : walk_rays_per_thread<MT>;
  int threads;
  const size_t smem = per_ray ? thread_per_ray_smem(packet, leaf_width, &threads)
                              : rays_per_thread_smem(packet, &threads);
  if (smem > kSmemNoOptIn) {  // a thread-per-ray leaf past ~940 triangles
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_packets, threads, smem, s>>>(
      origin, direction, packet, nodes, lc, leaf_width, tris, max_steps,
      finite_nodes, out_t, out_tri, stats);
  return (int)cudaGetLastError();
}

}  // namespace

// origin, direction (n_packets * packet, 3) f32, padded; nodes (2 lc, 6)
// f32, 8-byte aligned, each row min xyz, max xyz (BVHArrays.node_records);
// tris (lc, 12) f32, 16-byte aligned, each row v0, v1, v2, geom_n and NaN
// where the slot is not valid (SceneArrays.tri_records); finite_nodes:
// every node value is finite (BVHArrays.finite); out_t, out_tri (n_packets
// * packet,).  packet <= 1024, 1 <= leaf_width <= lc.  mt selects the
// Moller-Trumbore test.  stats: null, or (n_packets,
// kWalkStats) int64 that a -DMCPT_WALK_STATS build fills (other builds
// leave it alone).  Returns the launch's CUDA error.
extern "C" int mcpt_packet_walk(const float* origin, const float* direction,
                                int n_packets, int packet,
                                const float* nodes, int lc, int leaf_width,
                                const float* tris, int mt, int max_steps,
                                int finite_nodes, float* out_t, int* out_tri,
                                long long* stats, void* stream) {
  if (n_packets <= 0) return (int)cudaGetLastError();
  if (packet < 1 || packet > kMaxPacket || leaf_width < 1 || leaf_width > lc)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mt)
    return launch<true>(origin, direction, n_packets, packet, nodes, lc,
                        leaf_width, tris, max_steps, finite_nodes, out_t,
                        out_tri, stats, s);
  return launch<false>(origin, direction, n_packets, packet, nodes, lc,
                       leaf_width, tris, max_steps, finite_nodes, out_t,
                       out_tri, stats, s);
}
