// Cluster candidate keys, candidate lists and the front-to-back order, one
// row per (ray subtile, chunk).
//
// Replaces the TPU kernel montecarlopathtracing_tpu/kernels/cluster.py::
// _key_kernel at two of its call sites, with what the JAX package does
// between that kernel and the intersect kernel fused in:
//   mcpt_cluster_keys          its pallas_call in _candidate_keys, plus the
//                              ascending candidate compaction of _candidates
//                              (ftb=False) or the packed front-to-back sort
//                              of _ftb_order (ftb=True);
//   mcpt_cluster_keys_chunked  its pallas_call over a (K chunks, n_steps)
//                              grid in cluster_intersect_chunked: all K
//                              chunks in one launch, chunk k's AABB table
//                              against chunk k's view of the rays, plus
//                              _ftb_order.
//
// Contract, per row (subtile s of `tile` consecutive rays, chunk k) and per
// cluster c; every output pointer but counts may be null:
//   keys[row, c] = min over the subtile's rays of the clamped slab-entry
//                distance max(enter, 0) to cluster c's AABB, 1e30 where no
//                ray hits it.  A NaN slab distance (0 * inf) counts as an
//                open axis: tn -> -inf, tf -> +inf.  A subtile whose every
//                origin.x is > 5e8 (parked rays sit at 1e9) gets 1e30 for
//                every cluster.
//   counts[row] = the number of clusters with keys < 1e30 (the hits).
//   ids[row, 0:count] = the hit clusters, ascending.
//   order[row, 0:count], qkeys[row, 0:count] = the hit clusters front to
//                back and each one's key quantised down: the packed words
//                (key bits & ~mask) | c, mask = 2^idb - 1 over the id bits,
//                sorted ascending, then c = word & mask and
//                qkey = float(word & ~mask).  A miss's word sorts after every
//                hit's, so this is the first `count` entries of a sort of
//                all C words.  Needs n_clusters <= kSortMax (the words of a
//                row sit in shared memory).
//   heads, wrows = the work list of cluster_rows.cuh: every row with
//                count > 0 is appended to its bucket.
//   Entries of ids, order and qkeys past `count` are left unwritten.
// Rows are chunk-major (row = chunk * n_subtiles + s), caabb is (K, 8, C),
// and chunk_cap (K, R) says how chunk k sees ray r: a cap < 0 parks the ray
// for that chunk (its origin counts as 1e9 on every axis, as in the K copies
// of the rays that the TPU version builds).
//
// Bound: per (ray, cluster) pair about 20 f32 operations against 4 bytes of
// key written per (subtile, cluster); at tile 64 that is ~300 operations
// per byte, so with many clusters the kernel is bound by f32 operations (by
// their issue: contraction is off), not memory; a one-cluster table is bound
// by the rays' bytes and the launch.  What the design does about it:
//   * what depends on the ray alone is computed once per ray when the subtile
//     is staged in shared memory: 1 / d, which of the box's two planes per
//     axis is the near one (the sign octant of 1 / d), and whether the ray
//     can produce a NaN at all (only a non-finite or zero 1 / d or a
//     non-finite origin can).  All threads of a block work on the same ray
//     at the same time, so the loop over rays branches block-uniformly into
//     one of eight bodies with near and far fixed at compile time and no NaN
//     repair; a ray that needs the repair takes the general body;
//   * a thread holds kCpt clusters' AABBs in registers and loads a ray as two
//     16-byte words, so a pair costs well under one shared-memory load;
//   * a table of at most kNarrow clusters (the built-in box has one) gets a
//     warp per row with lanes over rays and a shuffle minimum, several rows
//     per block and no block-wide barrier;
//   * the compaction is a warp ballot plus a prefix over warp counts; the
//     front-to-back order is a rank sort of the row's hit words in shared
//     memory (they are distinct: the id is in the low bits), a few words for
//     most rows where a library sort orders all C.
//
// Built with -fmad=false and IEEE division, and every value is computed by
// the same expressions in the same order as the plain PyTorch version
// (cluster_keys_plain), so the outputs agree bit for bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "cluster_rows.cuh"

namespace {

constexpr int kThreads = 256;  // the most a block has
constexpr float kBig = 1e30f;
constexpr float kParked = 1e9f;  // origin of a parked ray
constexpr int kNarrow = 32;      // tables up to here: a warp per row
constexpr int kSortMax = 2048;   // clusters the shared-memory sort holds

#ifndef MCPT_KEYS_CLUSTERS_PER_THREAD  // set only to measure other tiles
#define MCPT_KEYS_CLUSTERS_PER_THREAD 4
#endif
constexpr int kCpt = MCPT_KEYS_CLUSTERS_PER_THREAD;
static_assert(kCpt >= 1 && kCpt * (kThreads / 32) <= 32,
              "the prefix over (slot, warp) counts is one warp wide");

// Ray codes: 0..7 the octant (bit a set: 1/d negative on axis a, so the
// box's high plane is the near one), kGeneral near/far by select,
// kRepair by select with the NaN repair.
constexpr int kGeneral = 8;
constexpr int kRepair = 9;

struct Params {
  const float* rays;
  int ray_stride;
  int n_subtiles;
  int tile;
  int n_chunks;
  const float* chunk_cap;
  const float* caabb;
  int n_clusters;
  int id_mask;  // 2^idb - 1, idb = max(1, bits of n_clusters - 1)
  float* keys;
  int* counts;
  int* ids;
  int* order;
  float* qkeys;
  int* heads;
  int* wrows;
};

// One ray as chunk `cap` sees it, staged as two float4: (ox oy oz code) and
// (1/dx 1/dy 1/dz 0).  Returns whether the ray is live (not parked).
__device__ __forceinline__ bool stage_ray(const float* ray, const float* cap,
                                          int r, float4* dst) {
  const bool moved = cap != nullptr && cap[r] < 0.0f;
  const float ox = moved ? kParked : ray[0];
  const float oy = moved ? kParked : ray[1];
  const float oz = moved ? kParked : ray[2];
  const float ix = 1.0f / ray[3];
  const float iy = 1.0f / ray[4];
  const float iz = 1.0f / ray[5];
  // (plane - o) * inv is NaN only as 0 * inf or from a non-finite operand:
  // plane and a live origin are finite, so only if inv is not finite; a
  // zero inv (infinite d) and a non-finite origin go the safe way too.
  const bool plain = isfinite(ox) && isfinite(oy) && isfinite(oz) &&
                     isfinite(ix) && isfinite(iy) && isfinite(iz) &&
                     ix != 0.0f && iy != 0.0f && iz != 0.0f;
  int code = kRepair;
#if !defined(MCPT_KEYS_ALWAYS_REPAIR)
  if (plain) {
#if defined(MCPT_KEYS_NO_OCTANT)
    code = kGeneral;
#else
    code = (ix < 0.0f ? 1 : 0) | (iy < 0.0f ? 2 : 0) | (iz < 0.0f ? 4 : 0);
#endif
  }
#endif
  dst[0] = make_float4(ox, oy, oz, __int_as_float(code));
  dst[1] = make_float4(ix, iy, iz, 0.0f);
  return !(ox > 5e8f);
}

template <bool REPAIR>
__device__ __forceinline__ void slab(float lo, float hi, float o, float inv,
                                     float& tn, float& tf) {
  const float near_ = inv < 0.0f ? hi : lo;
  const float far_ = inv < 0.0f ? lo : hi;
  tn = (near_ - o) * inv;
  tf = (far_ - o) * inv;
  if (REPAIR) {
    if (isnan(tn)) tn = -INFINITY;
    if (isnan(tf)) tf = INFINITY;
  }
}

__device__ __forceinline__ float slab_key(float nx, float fx, float ny,
                                          float fy, float nz, float fz) {
  const float enter = fmaxf(fmaxf(nx, ny), nz);
  const float exit_ = fminf(fminf(fx, fy), fz);
  const bool hit = (enter <= exit_) && (exit_ >= 0.0f);
  return hit ? fmaxf(enter, 0.0f) : kBig;
}

// One ray against one box, near and far by select.
template <bool REPAIR>
__device__ __forceinline__ float key_general(const float (&lo)[3],
                                             const float (&hi)[3], float4 o,
                                             float4 inv) {
  float nx, fx, ny, fy, nz, fz;
  slab<REPAIR>(lo[0], hi[0], o.x, inv.x, nx, fx);
  slab<REPAIR>(lo[1], hi[1], o.y, inv.y, ny, fy);
  slab<REPAIR>(lo[2], hi[2], o.z, inv.z, nz, fz);
  return slab_key(nx, fx, ny, fy, nz, fz);
}

// One ray of a known octant against one box: the same expressions with the
// selects resolved at compile time.
template <bool NX, bool NY, bool NZ>
__device__ __forceinline__ float key_octant(const float (&lo)[3],
                                            const float (&hi)[3], float4 o,
                                            float4 inv) {
  const float nx = ((NX ? hi[0] : lo[0]) - o.x) * inv.x;
  const float fx = ((NX ? lo[0] : hi[0]) - o.x) * inv.x;
  const float ny = ((NY ? hi[1] : lo[1]) - o.y) * inv.y;
  const float fy = ((NY ? lo[1] : hi[1]) - o.y) * inv.y;
  const float nz = ((NZ ? hi[2] : lo[2]) - o.z) * inv.z;
  const float fz = ((NZ ? lo[2] : hi[2]) - o.z) * inv.z;
  return slab_key(nx, fx, ny, fy, nz, fz);
}

#define MCPT_EACH_SLOT(expr)                 \
  _Pragma("unroll") for (int k = 0; k < kCpt; ++k) \
      best[k] = fminf(best[k], (expr))

// The wide kernel: one block per row, a thread per kCpt clusters.
__global__ void __launch_bounds__(kThreads)
cluster_keys_kernel(const Params p) {
  extern __shared__ float4 s_dyn[];  // [2 * tile] rays, then the hit words
  __shared__ int s_off[32];          // [slot * n_warps + warp]
  __shared__ int s_base;

  const int tile = p.tile;
  const int n_clusters = p.n_clusters;
  float4* s_ray = s_dyn;
  int* s_words = reinterpret_cast<int*>(s_dyn + 2 * tile);

  const int sub = blockIdx.x;
  const int chunk = blockIdx.y;
  const size_t out_row = (size_t)chunk * gridDim.x + sub;
  const int tid = threadIdx.x;
  const int n_thr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = n_thr >> 5;
  const float* rb = p.rays + (size_t)sub * tile * p.ray_stride;
  const float* caabb = p.caabb + (size_t)chunk * 8 * n_clusters;
  const float* cap =
      p.chunk_cap == nullptr ? nullptr : p.chunk_cap + out_row * tile;

  bool live = false;  // some ray of the subtile is not parked
  for (int r = tid; r < tile; r += n_thr)
    if (stage_ray(rb + (size_t)r * p.ray_stride, cap, r, s_ray + 2 * r))
      live = true;
  if (tid == 0) s_base = 0;
  const bool parked = !__syncthreads_or(live);

  float* krow = p.keys == nullptr ? nullptr : p.keys + out_row * n_clusters;
  if (parked) {  // block-wide: no candidate
    if (krow != nullptr)
      for (int c = tid; c < n_clusters; c += n_thr) krow[c] = kBig;
    if (tid == 0) p.counts[out_row] = 0;
    return;
  }
  int* irow = p.ids == nullptr ? nullptr : p.ids + out_row * n_clusters;
  const bool sorted = p.order != nullptr;

  for (int c0 = 0; c0 < n_clusters; c0 += n_thr * kCpt) {
    // Slot k of this thread is cluster c0 + k * n_thr + tid: ascending in
    // (slot, warp, lane).  A slot past the table gets an inverted box and
    // is never read.
    float lo[kCpt][3], hi[kCpt][3], best[kCpt];
#pragma unroll
    for (int k = 0; k < kCpt; ++k) {
      const int c = c0 + k * n_thr + tid;
      const bool in = c < n_clusters;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[k][a] = in ? caabb[a * n_clusters + c] : kBig;
        hi[k][a] = in ? caabb[(3 + a) * n_clusters + c] : -kBig;
      }
      best[k] = kBig;
    }
    for (int r = 0; r < tile; ++r) {
      const float4 o = s_ray[2 * r];
      const float4 inv = s_ray[2 * r + 1];
      switch (__float_as_int(o.w)) {  // the same for the whole block
        case 0: MCPT_EACH_SLOT((key_octant<0, 0, 0>(lo[k], hi[k], o, inv))); break;
        case 1: MCPT_EACH_SLOT((key_octant<1, 0, 0>(lo[k], hi[k], o, inv))); break;
        case 2: MCPT_EACH_SLOT((key_octant<0, 1, 0>(lo[k], hi[k], o, inv))); break;
        case 3: MCPT_EACH_SLOT((key_octant<1, 1, 0>(lo[k], hi[k], o, inv))); break;
        case 4: MCPT_EACH_SLOT((key_octant<0, 0, 1>(lo[k], hi[k], o, inv))); break;
        case 5: MCPT_EACH_SLOT((key_octant<1, 0, 1>(lo[k], hi[k], o, inv))); break;
        case 6: MCPT_EACH_SLOT((key_octant<0, 1, 1>(lo[k], hi[k], o, inv))); break;
        case 7: MCPT_EACH_SLOT((key_octant<1, 1, 1>(lo[k], hi[k], o, inv))); break;
        case kGeneral: MCPT_EACH_SLOT((key_general<false>(lo[k], hi[k], o, inv))); break;
        default: MCPT_EACH_SLOT((key_general<true>(lo[k], hi[k], o, inv))); break;
      }
    }

    // Keys out, and the hits compacted in ascending cluster order.
    unsigned ballot[kCpt];
#pragma unroll
    for (int k = 0; k < kCpt; ++k) {
      const int c = c0 + k * n_thr + tid;
      const bool in = c < n_clusters;
      if (in && krow != nullptr) krow[c] = best[k];
      ballot[k] = __ballot_sync(0xffffffffu, in && best[k] < kBig);
      if (lane == 0) s_off[k * n_warps + warp] = __popc(ballot[k]);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive prefix over the (slot, warp) counts
      const int n = kCpt * n_warps;
      const int v = lane < n ? s_off[lane] : 0;
      int inc = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += up;
      }
      const int base = s_base;
      __syncwarp();  // every lane has read s_base before lane 31 rewrites it
      if (lane < n) s_off[lane] = base + inc - v;
      if (lane == 31) s_base = base + inc;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kCpt; ++k) {
      if ((ballot[k] >> lane) & 1u) {
        const int c = c0 + k * n_thr + tid;
        const int pos = s_off[k * n_warps + warp] +
                        __popc(ballot[k] & ((1u << lane) - 1u));
        if (irow != nullptr) irow[pos] = c;
        if (sorted)
          s_words[pos] = (__float_as_int(best[k]) & ~p.id_mask) | c;
      }
    }
    __syncthreads();  // s_off is rewritten by the next pass
  }

  const int count = s_base;
  if (tid == 0) {
    p.counts[out_row] = count;
    if (p.heads != nullptr && count > 0)
      mcpt::list_append(p.heads, p.wrows, p.n_subtiles * p.n_chunks,
                        (int)out_row, count);
  }
  if (!sorted || count == 0) return;

  // Rank sort of the row's hit words: distinct non-negative ints.
  const int padded = (count + 3) & ~3;
  if (tid < padded - count) s_words[count + tid] = INT_MAX;
  __syncthreads();
  int* orow = p.order + out_row * n_clusters;
  float* qrow = p.qkeys + out_row * n_clusters;
  const int4* words4 = reinterpret_cast<const int4*>(s_words);
  for (int e = tid; e < count; e += n_thr) {
    const int w = s_words[e];
    int rank = 0;
    for (int j = 0; j < padded / 4; ++j) {
      const int4 v = words4[j];
      rank += (v.x < w) + (v.y < w) + (v.z < w) + (v.w < w);
    }
    orow[rank] = w & p.id_mask;
    qrow[rank] = __int_as_float(w & ~p.id_mask);
  }
}

// The narrow kernel (n_clusters <= kNarrow): one warp per row, lanes over
// the subtile's rays, lane c keeps cluster c's key.
__global__ void __launch_bounds__(kThreads)
cluster_keys_narrow_kernel(const Params p) {
  extern __shared__ float4 s_dyn[];  // [warps][2 * tile]
  const int tile = p.tile;
  const int n_clusters = p.n_clusters;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_rows = p.n_subtiles * p.n_chunks;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= n_rows) return;  // the whole warp; no block-wide barrier below
  const int chunk = row / p.n_subtiles;
  const int sub = row - chunk * p.n_subtiles;
  float4* s_ray = s_dyn + (size_t)warp * 2 * tile;
  const float* rb = p.rays + (size_t)sub * tile * p.ray_stride;
  const float* caabb = p.caabb + (size_t)chunk * 8 * n_clusters;
  const float* cap = p.chunk_cap == nullptr
                         ? nullptr
                         : p.chunk_cap + (size_t)row * tile;

  bool live = false;
  for (int r = lane; r < tile; r += 32)
    if (stage_ray(rb + (size_t)r * p.ray_stride, cap, r, s_ray + 2 * r))
      live = true;
  const bool parked = !__any_sync(0xffffffffu, live);
  __syncwarp();

  float key = kBig;
  if (!parked) {
    for (int c = 0; c < n_clusters; ++c) {
      float lo[3], hi[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[a] = caabb[a * n_clusters + c];
        hi[a] = caabb[(3 + a) * n_clusters + c];
      }
      float best = kBig;
      for (int r = lane; r < tile; r += 32)
        best = fminf(best, key_general<true>(lo, hi, s_ray[2 * r],
                                             s_ray[2 * r + 1]));
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        best = fminf(best, __shfl_xor_sync(0xffffffffu, best, d));
      if (lane == c) key = best;
    }
  }
  const bool in = lane < n_clusters;
  const size_t out0 = (size_t)row * n_clusters;
  if (in && p.keys != nullptr) p.keys[out0 + lane] = key;
  const bool h = in && key < kBig;
  const unsigned ballot = __ballot_sync(0xffffffffu, h);
  const int count = __popc(ballot);
  if (h && p.ids != nullptr)
    p.ids[out0 + __popc(ballot & ((1u << lane) - 1u))] = lane;
  if (p.order != nullptr && count > 0) {
    const int w = h ? (__float_as_int(key) & ~p.id_mask) | lane : INT_MAX;
    int rank = 0;
    for (int j = 0; j < 32; ++j)
      rank += __shfl_sync(0xffffffffu, w, j) < w;
    if (h) {
      p.order[out0 + rank] = lane;
      p.qkeys[out0 + rank] = __int_as_float(w & ~p.id_mask);
    }
  }
  if (lane == 0) {
    p.counts[row] = count;
    if (p.heads != nullptr && count > 0)
      mcpt::list_append(p.heads, p.wrows, n_rows, row, count);
  }
}

int launch_keys(Params p, void* stream) {
  if (p.n_subtiles <= 0 || p.n_chunks <= 0 || p.n_clusters <= 0)
    return (int)cudaGetLastError();
  if ((p.order == nullptr) != (p.qkeys == nullptr) ||
      (p.heads == nullptr) != (p.wrows == nullptr) ||
      (p.order != nullptr && p.n_clusters > kSortMax))
    return (int)cudaErrorInvalidValue;
  int idb = 1;
  while ((1 << idb) < p.n_clusters) ++idb;
  p.id_mask = (1 << idb) - 1;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t ray_bytes = sizeof(float4) * 2 * (size_t)p.tile;
  // The shape of a launch follows from the table's size and the tile alone.
  if (p.n_clusters <= kNarrow) {
    int warps = (int)(32768 / ray_bytes);
    warps = warps < 1 ? 1 : warps > kThreads / 32 ? kThreads / 32 : warps;
    const long long n_rows = (long long)p.n_subtiles * p.n_chunks;
    const unsigned grid = (unsigned)((n_rows + warps - 1) / warps);
    cluster_keys_narrow_kernel<<<grid, 32 * warps, ray_bytes * warps, s>>>(p);
  } else {
    int threads = ((p.n_clusters + kCpt - 1) / kCpt + 31) / 32 * 32;
    threads = threads > kThreads ? kThreads : threads;
    const size_t words =
        p.order == nullptr ? 0 : sizeof(int) * (size_t)((p.n_clusters + 3) & ~3);
    const dim3 grid(p.n_subtiles, p.n_chunks);
    cluster_keys_kernel<<<grid, threads, ray_bytes + words, s>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mcpt_cluster_keys(const float* rays, int ray_stride,
                                 int n_subtiles, int tile, const float* caabb,
                                 int n_clusters, float* keys, int* counts,
                                 int* ids, int* order, float* qkeys,
                                 int* heads, int* wrows, void* stream) {
  Params p{rays, ray_stride, n_subtiles, tile, 1, nullptr, caabb, n_clusters,
           0, keys, counts, ids, order, qkeys, heads, wrows};
  return launch_keys(p, stream);
}

extern "C" int mcpt_cluster_keys_chunked(const float* rays, int ray_stride,
                                         int n_subtiles, int tile,
                                         int n_chunks, const float* chunk_cap,
                                         const float* caabb, int n_clusters,
                                         float* keys, int* counts, int* order,
                                         float* qkeys, int* heads, int* wrows,
                                         void* stream) {
  Params p{rays, ray_stride, n_subtiles, tile, n_chunks, chunk_cap, caabb,
           n_clusters, 0, keys, counts, nullptr, order, qkeys, heads, wrows};
  return launch_keys(p, stream);
}
