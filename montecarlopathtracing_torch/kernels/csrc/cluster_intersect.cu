// Nearest hit over each ray subtile's candidate clusters.
//
// Replaces the TPU kernel montecarlopathtracing_tpu/kernels/cluster.py::
// _intersect_kernel (its pallas_call in _cluster_intersect_padded) with
// ftb=False, in both of its triangle tests (compat and Moller-Trumbore; the
// formulas are in cluster_tri.cuh).  A triangle is accepted when inside and
// 0 < t < 1e30; the result per ray is the lexicographic minimum of
// (t, triangle id) over accepted triangles, which is the winner of the TPU
// kernel's deferred best (ties at equal t go to the lowest id).  A miss is
// (1e30, -1).
//
// Bound on an H100: about 34 f32 operations per (ray, triangle) pair of a
// candidate cluster against 16 * W * 4 bytes of table per (subtile, cluster)
// pair, so at tile 64 the kernel is bound by f32 instruction throughput,
// not by memory; with contraction off (bitwise equality with eager PyTorch
// needs -fmad=false) the card reaches at most half its fused rate.  What
// keeps a kernel far below that here: a 4-byte shared-memory load per table
// word and test, a stage / barrier / test / barrier loop with nothing in
// flight, and one block per subtile however long its candidate list (the
// 100k-triangle interior has lists of 168 clusters against a mean of 5).
//
// The design:
//   * the tests run on a register tile of 4 rays per thread against a ring
//     of column-major pieces filled by cp.async (cluster_tri.cuh): one
//     16-byte load instruction per test, the next piece in flight while the
//     current one is tested, one barrier per piece;
//   * a piece holds up to 128 columns: several whole clusters when W is a
//     power of two below 128, else a run of one cluster's columns;
//   * there is no exit, so (subtile, candidate) pairs are independent: the
//     grid is (subtiles, n_split), and block (s, y) takes the y-th run of
//     `per` candidates of subtile s, per = max(kMinPer, ceil(count /
//     n_split)).  A long list is cut over up to n_split blocks and a short
//     one is not cut at all; blocks past a list's end leave at once;
//   * the blocks of a subtile meet in one atomicMin per ray on a 64-bit word
//     (hit_word in cluster_tri.cuh) whose integer order is the lexicographic
//     (t, id) order: the join is exact and does not depend on the order of
//     arrival.  The words start as the miss and the caller unpacks them.  With
//     n_split = 1 (a table of one cluster) there is nothing to join, and the
//     block writes (t, id) itself.

#include "cluster_tri.cuh"

namespace {

using namespace mcpt;

// Fewest candidates a block takes unless the list ends: with two pieces the
// second is copied while the first is tested.
constexpr int kMinPer = 2;

// packed (n_subtiles * tile,) u64, preset to kMissWord; or
// null with a grid of one block per subtile, which then writes out_t and
// out_tri (n_subtiles * tile,) itself.
// nk clusters make a piece (nk > 1: width = 1 << wshift, a power of two
// below kPieceCols); npu pieces make a cluster (npu > 1: width above
// kPieceCols).  One of the two is 1.  slot_cols is the widest piece, which
// sizes the ring's slots.
template <bool MT>
__global__ void __launch_bounds__(kMaxThreads, MCPT_MIN_BLOCKS)
cluster_intersect_kernel(
    const float* __restrict__ rays, int ray_stride,
    const int* __restrict__ counts, const int* __restrict__ ids,
    int n_clusters, const float* __restrict__ tconst, int width, int wshift,
    int nk, int npu, int slot_cols, int tile, int split,
    unsigned long long* __restrict__ packed, float* __restrict__ out_t,
    int* __restrict__ out_tri) {
  extern __shared__ float4 s_ring[];  // [kStages][4 * slot_cols]
  const int slot_vec = 4 * slot_cols;

  const int sub = blockIdx.x;
  const int n = counts[sub];
  int per = max(kMinPer, (n + (int)gridDim.y - 1) / (int)gridDim.y);
  per = (per + nk - 1) / nk * nk;  // whole pieces
  const int k_lo = blockIdx.y * per;
  if (k_lo >= n && packed != nullptr) return;  // the preset miss stands
  const int n_cand = max(0, min(n, k_lo + per) - k_lo);
  const int* cand = ids + (size_t)sub * n_clusters + k_lo;
  const int n_pieces = nk > 1 ? (n_cand + nk - 1) / nk : n_cand * npu;
  const size_t block_floats = (size_t)16 * width;

  // Columns of piece q.
  auto piece_cols = [&](int q) {
    if (nk > 1) return min(nk, n_cand - q * nk) << wshift;
    return min(kPieceCols, width - (q % npu) * kPieceCols);
  };
  auto stage = [&](int q) {
    float4* slot = s_ring + (q % kStages) * slot_vec;
    if (nk > 1) {
      const int m = min(nk, n_cand - q * nk);
      for (int u = 0; u < m; ++u)
        stage_cols(slot, u << wshift, tconst + cand[q * nk + u] * block_floats,
                   width, width);
    } else {
      const int c0 = (q % npu) * kPieceCols;
      stage_cols(slot, 0, tconst + cand[q / npu] * block_floats + c0, width,
                 min(kPieceCols, width - c0));
    }
    __pipeline_commit();
  };

  if (n_pieces > 0) stage(0);
  const int part = threadIdx.x % split;
  Ray r[kRaysPerThread];
  int first;
  load_ray_tile<MT>(rays + (size_t)sub * tile * ray_stride, ray_stride, tile,
                    split, r, first);
  float bt[kRaysPerThread];
  int bi[kRaysPerThread];
#pragma unroll
  for (int i = 0; i < kRaysPerThread; ++i) {
    bt[i] = kBig;
    bi[i] = INT_MAX;
  }

  for (int q = 0; q < n_pieces; ++q) {
    if (q + 1 < n_pieces)
      stage(q + 1);
    else
      __pipeline_commit();  // an empty group keeps the wait below uniform
    __pipeline_wait_prior(1);  // this thread's share of piece q has landed
    __syncthreads();           // everyone's has; piece q - 1 is no longer read
    const float4* slot = s_ring + (q % kStages) * slot_vec;
    if (nk > 1) {
      test_piece<MT>(r, slot, piece_cols(q), part, split, bt, bi, [&](int c) {
        return cand[q * nk + (c >> wshift)] * width + (c & (width - 1));
      });
    } else {
      const int base = cand[q / npu] * width + (q % npu) * kPieceCols;
      test_piece<MT>(r, slot, piece_cols(q), part, split, bt, bi,
                     [&](int c) { return base + c; });
    }
  }

#pragma unroll
  for (int i = 0; i < kRaysPerThread; ++i) {
    lex_reduce(bt[i], bi[i], split);
    if (part != 0 || first + i >= tile) continue;
    const size_t g = (size_t)sub * tile + first + i;
    if (packed == nullptr) {
      out_t[g] = bt[i];
      out_tri[g] = bt[i] < kBig ? bi[i] : -1;
    } else if (bt[i] < kBig) {
      atomicMin(packed + g, hit_word(bt[i], bi[i]));
    }
  }
}

}  // namespace

extern "C" int mcpt_cluster_intersect(const float* rays, int ray_stride,
                                      int n_subtiles, int tile,
                                      const int* counts, const int* ids,
                                      int n_clusters, const float* tconst,
                                      int width, int mt, int n_split,
                                      unsigned long long* packed,
                                      float* out_t, int* out_tri,
                                      void* stream) {
  if (n_subtiles <= 0) return (int)cudaGetLastError();
  if (packed == nullptr && n_split != 1) return (int)cudaErrorInvalidValue;
  const bool pow2 = (width & (width - 1)) == 0;
  const int nk = pow2 && width < kPieceCols ? kPieceCols / width : 1;
  const int npu = (width + kPieceCols - 1) / kPieceCols;
  // The widest piece of this launch.
  const int slot_cols = nk > 1 ? (n_clusters < nk ? n_clusters : nk) * width
                               : (width < kPieceCols ? width : kPieceCols);
  const BlockShape shape = block_shape(tile, slot_cols);
  const size_t smem = ring_bytes(slot_cols);
  int wshift = 0;
  while (pow2 && (1 << wshift) < width) ++wshift;
  const dim3 grid(n_subtiles, n_split);
  cudaStream_t s = (cudaStream_t)stream;
  if (mt) {
    cluster_intersect_kernel<true><<<grid, shape.threads, smem, s>>>(
        rays, ray_stride, counts, ids, n_clusters, tconst, width, wshift, nk,
        npu, slot_cols, tile, shape.split, packed, out_t, out_tri);
  } else {
    cluster_intersect_kernel<false><<<grid, shape.threads, smem, s>>>(
        rays, ray_stride, counts, ids, n_clusters, tconst, width, wshift, nk,
        npu, slot_cols, tile, shape.split, packed, out_t, out_tri);
  }
  return (int)cudaGetLastError();
}
