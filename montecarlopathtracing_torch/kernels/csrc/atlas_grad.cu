// The texture atlas gather's backward: per texel, the sum of the cotangent
// rows of the lanes that read it, one writer per texel, no float atomics.
//
// Replaces no TPU kernel.  No Pallas kernel of the JAX package (they are all
// in montecarlopathtracing_tpu/kernels/cluster.py) computes it: the JAX
// package's gather scene.atlas[idx] (montecarlopathtracing_tpu/integrator/
// wavefront.py, _gather_hit) leaves its backward to XLA's scatter-add.  It
// was added because the port's plain form, PyTorch's autograd of
// atlas[idx], gives each run of one index to one warp that adds the run
// serially, and every untextured, miss or dead lane reads texel 0 (or the
// last) with a zero cotangent: one run of tens of thousands of rows a call.
// Its wrapper (kernels/atlas.py) sends the untextured lanes to a sentinel
// key and sorts (key, lane) with torch.sort (a library call over all 32 key
// bits) before this kernel; the miss and dead lanes whose clamped triangle
// is textured stay one long run, which this kernel sums in parallel.
//
// Contract (mcpt_atlas_grad): keys (n,) int32 in ascending order, order (n,)
// int64 the lanes in that order (torch.sort(keys, stable=True)); ct (lanes,
// 3) f32 the cotangent rows, read at the lanes in order; out (n_texels, 3)
// f32, zero-filled by the caller.  For each key k < n_texels, out[k] = the
// sum of ct[order[p]] over the run of positions p with keys[p] == k, added
// in a fixed tree over p; the sentinel key n_texels adds nothing and its rows
// are not read.  parts (tiles, 2, 3) f32 and flags (tiles,) int32 are
// scratch, tiles = ceil(n / kTile) (anything else returns
// cudaErrorInvalidValue).  stats (3,) int64 or null: stats[0] += n,
// stats[1] += the keys below n_texels, stats[2] = max(stats[2], the longest
// run below n_texels).
//
// Bound: memory.  n x (4 B key + 12 B row) read and (n_texels, 3) f32
// written (the dense gradient, zero-filled ahead): ~5.0 MB at 65,536 lanes
// and 327,680 texels, ~1.5 us at 3.35 TB/s.  The launches and the sort cost
// more.  What the design does about it:
//   * a block takes a tile of kTile sorted positions, kItems consecutive to a
//     thread; a thread folds its items serially, a warp scans its threads'
//     (run-start flag, partial) pairs with shuffles (a head-flagged segmented
//     scan, Hillis-Steele: a fixed tree), and the warps' totals are combined
//     in warp order through shared memory;
//   * the last position of each run holds the run's sum and writes it, so a
//     run inside a tile has one writer; a run that crosses tiles leaves its
//     first tile's part (the tile's tail) and its last tile's part (the
//     tile's head) in parts, a tile wholly inside it its whole sum, and a
//     second kernel, a thread for each tile where such a run starts, adds
//     them in tile order;
//   * a run's length (for stats) comes from a binary search for its first
//     position, once a run, at its last position.
// The sums are the same bits from run to run and under graph replay; they
// may differ in the last bits from a serial sum.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // kernels/atlas.py TILE
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// flags: the tile's last run starts in the tile and goes on past it (kOwn),
// or the tile lies inside a run that started before it and goes on (kPass).
constexpr int kOwn = 1;
constexpr int kPass = 2;

// A segmented partial: f says a run starts within the span it covers, and
// (x, y, z) is the sum from the last such start (or the span's start).
struct Part {
  int f;
  float x, y, z;
};

// a then b: b's sum where a run starts in b, else a's sum plus b's.
__device__ __forceinline__ Part combine(const Part& a, const Part& b) {
  if (b.f) return b;
  return Part{a.f, a.x + b.x, a.y + b.y, a.z + b.z};
}

__device__ __forceinline__ int key_at(const int* keys, int n, int n_texels,
                                      int p) {
  return p < n ? keys[p] : n_texels;
}

// The first position in [0, hi) whose key is >= k.
__device__ __forceinline__ int lower_bound(const int* keys, int hi, int k) {
  int lo = 0;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < k) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) atlas_grad_tiles(
    const int* __restrict__ keys, const long long* __restrict__ order,
    const float* __restrict__ ct, int n, int n_texels, float* __restrict__ out,
    float* __restrict__ parts, int* __restrict__ flags,
    unsigned long long* __restrict__ stats) {
  __shared__ Part warp_total[kWarps];
  const int tile = blockIdx.x;
  const int base = tile * kTile;
  const int end = min(base + kTile, n);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p0 = base + threadIdx.x * kItems;
  // The tile's first run started in an earlier tile.
  const int k_first = keys[base];
  const bool carried_in = base > 0 && keys[base - 1] == k_first;

  if (stats != nullptr && tile == 0 && threadIdx.x == 0) {
    atomicAdd(stats, (unsigned long long)n);
    atomicAdd(stats + 1, (unsigned long long)lower_bound(keys, n, n_texels));
  }

  int k[kItems];
  bool head[kItems];
  float vx[kItems], vy[kItems], vz[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int p = p0 + i;
    k[i] = key_at(keys, n, n_texels, p);
    vx[i] = vy[i] = vz[i] = 0.0f;
    if (p < n && k[i] < n_texels) {
      const float* row = ct + 3 * order[p];
      vx[i] = row[0];
      vy[i] = row[1];
      vz[i] = row[2];
    }
  }
  // head: a run starts at the position, counting from the tile's start.
  head[0] = p0 == base || key_at(keys, n, n_texels, p0 - 1) != k[0];
#pragma unroll
  for (int i = 1; i < kItems; ++i) head[i] = k[i] != k[i - 1];

  // The thread's own partial, items in order.
  Part t{head[0], vx[0], vy[0], vz[0]};
#pragma unroll
  for (int i = 1; i < kItems; ++i)
    t = combine(t, Part{head[i], vx[i], vy[i], vz[i]});

  // Inclusive scan of the partials over the warp's threads.
  Part s = t;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Part up{__shfl_up_sync(kFull, s.f, off),
                  __shfl_up_sync(kFull, s.x, off),
                  __shfl_up_sync(kFull, s.y, off),
                  __shfl_up_sync(kFull, s.z, off)};
    if (lane >= off) s = combine(up, s);
  }
  // Exclusive: the threads before this one in the warp...
  const Part before{__shfl_up_sync(kFull, s.f, 1), __shfl_up_sync(kFull, s.x, 1),
                    __shfl_up_sync(kFull, s.y, 1), __shfl_up_sync(kFull, s.z, 1)};
  if (lane == 31) warp_total[warp] = s;
  __syncthreads();
  // ... after the warps before this one, in warp order.
  Part carry{0, 0.0f, 0.0f, 0.0f};
  if (warp > 0) {
    carry = warp_total[0];
    for (int j = 1; j < warp; ++j) carry = combine(carry, warp_total[j]);
  }
  if (lane > 0) carry = warp > 0 ? combine(carry, before) : before;

  float ax = 0.0f, ay = 0.0f, az = 0.0f;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int p = p0 + i;
    if (head[i]) {
      ax = vx[i]; ay = vy[i]; az = vz[i];
    } else if (i == 0) {
      ax = carry.x + vx[0]; ay = carry.y + vy[0]; az = carry.z + vz[0];
    } else {
      ax += vx[i]; ay += vy[i]; az += vz[i];
    }
    if (p >= n) continue;
    const bool last = key_at(keys, n, n_texels, p + 1) != k[i];
    const bool live = k[i] < n_texels;
    const bool first_run = carried_in && k[i] == k_first;
    if (p == end - 1) {
      int flag = 0;
      if (live && !last) {
        flag = first_run ? kPass : kOwn;
        float* q = parts + 6 * tile;
        q[0] = ax; q[1] = ay; q[2] = az;
      }
      flags[tile] = flag;
    }
    if (!live || !last) continue;
    float* q = first_run ? parts + 6 * tile + 3 : out + 3 * (long long)k[i];
    q[0] = ax; q[1] = ay; q[2] = az;
    if (stats != nullptr) {
      const int len = p + 1 - lower_bound(keys, p, k[i]);
      atomicMax(stats + 2, (unsigned long long)len);
    }
  }
}

// One thread a tile: where the tile's last run starts in it and goes on, the
// run's parts in tile order, written to out.
__global__ void atlas_grad_carry(const int* __restrict__ keys,
                                 const float* __restrict__ parts,
                                 const int* __restrict__ flags, int n_tiles,
                                 float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tiles || flags[t] != kOwn) return;
  const int k = keys[t * kTile + kTile - 1];
  float x = parts[6 * t], y = parts[6 * t + 1], z = parts[6 * t + 2];
  for (int u = t + 1; u < n_tiles; ++u) {
    const bool pass = flags[u] == kPass;
    const float* q = parts + 6 * u + (pass ? 0 : 3);
    x += q[0]; y += q[1]; z += q[2];
    if (!pass) break;
  }
  float* o = out + 3 * (long long)k;
  o[0] = x; o[1] = y; o[2] = z;
}

}  // namespace

extern "C" int mcpt_atlas_grad(const int* keys, const long long* order,
                               const float* ct, int n, int n_texels,
                               float* out, float* parts, int* flags,
                               int n_tiles, long long* stats, void* stream) {
  if (n < 0 || n_tiles != (n + kTile - 1) / kTile) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* st = reinterpret_cast<unsigned long long*>(stats);
  atlas_grad_tiles<<<n_tiles, kThreads, 0, s>>>(keys, order, ct, n, n_texels,
                                                out, parts, flags, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  atlas_grad_carry<<<(n_tiles + 127) / 128, 128, 0, s>>>(keys, parts, flags,
                                                        n_tiles, out);
  return (int)cudaGetLastError();
}
