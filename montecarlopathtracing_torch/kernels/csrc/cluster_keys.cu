// Cluster candidate keys and candidate lists, one block per (ray subtile,
// chunk).
//
// Replaces the TPU kernel montecarlopathtracing_tpu/kernels/cluster.py::
// _key_kernel at two of its call sites:
//   mcpt_cluster_keys          its pallas_call in _candidate_keys, with the
//                              ascending candidate compaction that
//                              _candidates does after it with ftb=False
//                              fused in (ids may be null: keys and counts
//                              only, for the front-to-back paths);
//   mcpt_cluster_keys_chunked  its pallas_call over a (K chunks, n_steps)
//                              grid in cluster_intersect_chunked: all K
//                              chunks in one launch, chunk k's AABB table
//                              against chunk k's view of the rays.
//
// Contract, per subtile s of `tile` consecutive rays and per cluster c:
//   keys[s, c] = min over the subtile's rays of the clamped slab-entry
//                distance max(enter, 0) to cluster c's AABB, 1e30 where no
//                ray hits it.  A NaN slab distance (0 * inf) counts as an
//                open axis: tn -> -inf, tf -> +inf.  A subtile whose every
//                origin.x is > 5e8 (parked rays sit at 1e9) gets 1e30 for
//                every cluster.
//   counts[s] = the number of clusters with keys < 1e30.
//   ids[s, 0:counts[s]] = those clusters, ascending.
//   ids[s, counts[s]:] is left unwritten.
// With chunks, rows are chunk-major (row = chunk * n_subtiles + s), caabb is
// (K, 8, C), and chunk_cap (K, R) says how chunk k sees ray r: a cap < 0
// parks the ray for that chunk (its origin counts as 1e9 on every axis, as
// in the K copies of the rays that the TPU version builds).
//
// Bound: per (ray, cluster) pair about 20 f32 operations against 4 bytes of
// key written per (subtile, cluster); at tile 64 that is ~300 operations
// per byte, so with many clusters the kernel is bound by f32 operations, not
// memory (a one-cluster table is bound by the rays' bytes).  The design
// keeps every operand on chip: the subtile's origins and reciprocal
// directions are staged once in shared memory, each thread holds one
// cluster's AABB in registers, and the only device-memory traffic is the
// rays in, the AABB table in (L2-resident, shared by all blocks) and the
// keys and lists out.  The compaction is a warp ballot plus a block-wide
// prefix over warp counts, so the candidate list needs no sort.
//
// Built with -fmad=false and IEEE division, so every value rounds exactly as
// the plain PyTorch version (cluster_keys_plain) computes it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 1e30f;
constexpr float kParked = 1e9f;  // origin of a parked ray

__device__ __forceinline__ void slab(float lo, float hi, float o, float inv,
                                     float& tn, float& tf) {
  const float near_ = inv < 0.0f ? hi : lo;
  const float far_ = inv < 0.0f ? lo : hi;
  tn = (near_ - o) * inv;
  tf = (far_ - o) * inv;
  if (isnan(tn)) tn = -INFINITY;
  if (isnan(tf)) tf = INFINITY;
}

__global__ void __launch_bounds__(kThreads)
cluster_keys_kernel(const float* __restrict__ rays, int ray_stride,
                    const float* __restrict__ chunk_cap,
                    const float* __restrict__ caabb_all, int n_clusters,
                    int tile, float* __restrict__ keys,
                    int* __restrict__ counts, int* __restrict__ ids) {
  extern __shared__ float s_ray[];  // [6][tile]: ox oy oz ix iy iz
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_base;

  const int sub = blockIdx.x;
  const int chunk = blockIdx.y;
  const size_t out_row = (size_t)chunk * gridDim.x + sub;
  const int tid = threadIdx.x;
  const float* rb = rays + (size_t)sub * tile * ray_stride;
  const float* caabb = caabb_all + (size_t)chunk * 8 * n_clusters;
  const float* cap =
      chunk_cap == nullptr ? nullptr : chunk_cap + out_row * tile;

  bool live = false;  // some ray of the subtile is not parked
  for (int r = tid; r < tile; r += kThreads) {
    const float* ray = rb + (size_t)r * ray_stride;
    const bool moved = cap != nullptr && cap[r] < 0.0f;
    const float ox = moved ? kParked : ray[0];
    s_ray[0 * tile + r] = ox;
    s_ray[1 * tile + r] = moved ? kParked : ray[1];
    s_ray[2 * tile + r] = moved ? kParked : ray[2];
    s_ray[3 * tile + r] = 1.0f / ray[3];
    s_ray[4 * tile + r] = 1.0f / ray[4];
    s_ray[5 * tile + r] = 1.0f / ray[5];
    if (!(ox > 5e8f)) live = true;
  }
  if (tid == 0) s_base = 0;
  const bool parked = !__syncthreads_or(live);

  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* krow = keys + out_row * n_clusters;
  int* irow = ids == nullptr ? nullptr : ids + out_row * n_clusters;

  for (int c0 = 0; c0 < n_clusters; c0 += kThreads) {
    const int c = c0 + tid;
    float best = kBig;
    if (c < n_clusters && !parked) {
      const float lx = caabb[0 * n_clusters + c];
      const float ly = caabb[1 * n_clusters + c];
      const float lz = caabb[2 * n_clusters + c];
      const float hx = caabb[3 * n_clusters + c];
      const float hy = caabb[4 * n_clusters + c];
      const float hz = caabb[5 * n_clusters + c];
      for (int r = 0; r < tile; ++r) {
        float nx, fx, ny, fy, nz, fz;
        slab(lx, hx, s_ray[0 * tile + r], s_ray[3 * tile + r], nx, fx);
        slab(ly, hy, s_ray[1 * tile + r], s_ray[4 * tile + r], ny, fy);
        slab(lz, hz, s_ray[2 * tile + r], s_ray[5 * tile + r], nz, fz);
        const float enter = fmaxf(fmaxf(nx, ny), nz);
        const float exit_ = fminf(fminf(fx, fy), fz);
        const bool hit = (enter <= exit_) && (exit_ >= 0.0f);
        best = fminf(best, hit ? fmaxf(enter, 0.0f) : kBig);
      }
    }
    if (c < n_clusters) krow[c] = best;

    const bool h = c < n_clusters && best < kBig;
    const unsigned ballot = __ballot_sync(0xffffffffu, h);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    if (tid == 0) {
      int acc = s_base;
      for (int w = 0; w < kThreads / 32; ++w) {
        const int v = s_warp[w];
        s_warp[w] = acc;
        acc += v;
      }
      s_base = acc;
    }
    __syncthreads();
    if (h && irow != nullptr)
      irow[s_warp[warp] + __popc(ballot & ((1u << lane) - 1u))] = c;
    __syncthreads();  // s_warp is rewritten by the next pass
  }
  if (tid == 0) counts[out_row] = s_base;
}

int launch_keys(const float* rays, int ray_stride, int n_subtiles, int tile,
                int n_chunks, const float* chunk_cap, const float* caabb,
                int n_clusters, float* keys, int* counts, int* ids,
                void* stream) {
  if (n_subtiles > 0 && n_chunks > 0) {
    const size_t smem = sizeof(float) * 6 * (size_t)tile;
    const dim3 grid(n_subtiles, n_chunks);
    cluster_keys_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        rays, ray_stride, chunk_cap, caabb, n_clusters, tile, keys, counts,
        ids);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mcpt_cluster_keys(const float* rays, int ray_stride,
                                 int n_subtiles, int tile, const float* caabb,
                                 int n_clusters, float* keys, int* counts,
                                 int* ids, void* stream) {
  return launch_keys(rays, ray_stride, n_subtiles, tile, 1, nullptr, caabb,
                     n_clusters, keys, counts, ids, stream);
}

extern "C" int mcpt_cluster_keys_chunked(const float* rays, int ray_stride,
                                         int n_subtiles, int tile,
                                         int n_chunks, const float* chunk_cap,
                                         const float* caabb, int n_clusters,
                                         float* keys, int* counts,
                                         void* stream) {
  return launch_keys(rays, ray_stride, n_subtiles, tile, n_chunks, chunk_cap,
                     caabb, n_clusters, keys, counts, nullptr, stream);
}
