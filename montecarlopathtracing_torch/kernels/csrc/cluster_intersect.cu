// Nearest hit over each ray subtile's candidate clusters, one block per
// subtile.
//
// Replaces the TPU kernel montecarlopathtracing_tpu/kernels/cluster.py::
// _intersect_kernel (its pallas_call in _cluster_intersect_padded) with
// ftb=False, in both of its triangle tests:
//   compat (MT = false), per-triangle rows n, n.v0, m_i = n x e_i, k_i:
//     t = (kn - n.o) / (n.d);  c_i = m_i.o + t * (m_i.d) - k_i;
//     inside = c1*c2 >= 0 && c1*c3 >= 0 && c2*c3 >= 0
//   Moller-Trumbore (MT = true), rows n_raw, kn, e1, e2, k_u, k_v, with the
//   per-ray w = o x d in ray columns 6..8:
//     det = -n.d;  t = (n.o - kn) / det;  au = e2.w + k_u.d;
//     av = -(e1.w) + k_v.d;
//     inside = au*det >= 0 && av*det >= 0 && (det - au - av)*det >= 0
// A triangle is accepted when inside and t > 0; the result per ray is the
// lexicographic minimum of (t, triangle id) over accepted triangles with
// t < 1e30, which is the winner of the TPU kernel's deferred best (ties at
// equal t go to the lowest id).  A miss is (1e30, -1).
//
// Bound: about 34 f32 operations per (ray, triangle) pair of a candidate
// cluster against 16 * W * 4 bytes of table per (subtile, cluster) pair, so
// at tile 64 (34 operations per table byte) the kernel is bound by f32
// operations, not memory.  The design keeps the rays in registers, stages
// each candidate cluster's 16 x W constant
// block in shared memory once per subtile (several clusters per stage when
// W < 128), and splits the W columns over S threads per ray; the S partial
// bests meet in a warp-shuffle reduction.  Candidate lists come ascending
// from cluster_keys; the order does not change the result.
//
// The triangle tests and the lexicographic best live in cluster_tri.cuh,
// shared with the front-to-back kernels.  Built with -fmad=false and IEEE
// division, and every expression keeps the TPU kernel's operation order, so
// t, the hit mask and the winner match the plain PyTorch version
// (cluster_intersect_padded_plain) bit for bit.

#include "cluster_tri.cuh"

namespace {

using namespace mcpt;

constexpr int kStageCols = 128;  // table columns staged per pass (min)

template <bool MT>
__global__ void cluster_intersect_kernel(
    const float* __restrict__ rays, int ray_stride,
    const int* __restrict__ counts, const int* __restrict__ ids,
    int n_clusters, const float* __restrict__ tconst, int width, int tile,
    int split, int stage_clusters, float* __restrict__ out_t,
    int* __restrict__ out_tri) {
  extern __shared__ float s_tab[];  // [16][stage_clusters * width]

  const int sub = blockIdx.x;
  const int tid = threadIdx.x;
  const int ray = tid / split;
  const int part = tid - ray * split;
  const Ray r =
      load_ray<MT>(rays + ((size_t)sub * tile + ray) * ray_stride);

  const int n = counts[sub];
  const int* cand = ids + (size_t)sub * n_clusters;
  float bt = kBig;
  int bi = INT_MAX;

  for (int k0 = 0; k0 < n; k0 += stage_clusters) {
    const int nk = min(stage_clusters, n - k0);
    const int cols = nk * width;
    __syncthreads();  // the previous stage is no longer read
    for (int idx = tid; idx < 16 * cols; idx += blockDim.x) {
      const int row = idx / cols;
      const int col = idx - row * cols;
      const int k = col / width;
      const int cc = col - k * width;
      const int cid = cand[k0 + k];
      s_tab[row * cols + col] =
          tconst[((size_t)cid * 16 + row) * width + cc];
    }
    __syncthreads();
    for (int j = part; j < cols; j += split) {
      float t;
      if (tri_test<MT>(r, s_tab, cols, j, t)) {
        const int k = j / width;
        lex_min(bt, bi, t, cand[k0 + k] * width + (j - k * width));
      }
    }
  }

  lex_reduce(bt, bi, split, warp_mask());
  if (part == 0) {
    const size_t g = (size_t)sub * tile + ray;
    out_t[g] = bt;
    out_tri[g] = bt < kBig ? bi : -1;
  }
}

}  // namespace

extern "C" int mcpt_cluster_intersect(const float* rays, int ray_stride,
                                      int n_subtiles, int tile,
                                      const int* counts, const int* ids,
                                      int n_clusters, const float* tconst,
                                      int width, int mt, float* out_t,
                                      int* out_tri, void* stream) {
  if (n_subtiles <= 0) return (int)cudaGetLastError();
  const int split = mcpt::ray_split(tile);
  const int threads = tile * split;
  const int stage_clusters = width >= kStageCols ? 1 : kStageCols / width;
  const size_t smem = sizeof(float) * 16 * (size_t)stage_clusters * width;
  cudaStream_t s = (cudaStream_t)stream;
  if (mt) {
    cluster_intersect_kernel<true><<<n_subtiles, threads, smem, s>>>(
        rays, ray_stride, counts, ids, n_clusters, tconst, width, tile, split,
        stage_clusters, out_t, out_tri);
  } else {
    cluster_intersect_kernel<false><<<n_subtiles, threads, smem, s>>>(
        rays, ray_stride, counts, ids, n_clusters, tconst, width, tile, split,
        stage_clusters, out_t, out_tri);
  }
  return (int)cudaGetLastError();
}
