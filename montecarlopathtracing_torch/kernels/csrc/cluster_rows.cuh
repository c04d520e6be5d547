// The work list of rows between the key kernel and the front-to-back
// intersect kernels: which (ray subtile, chunk) rows have a candidate at all,
// longest candidate lists first.
//
// Replaces what montecarlopathtracing_tpu/kernels/cluster.py leaves to its
// sequential grid: the TPU kernels (_key_kernel, _intersect_kernel with
// ftb=True, _intersect_hbm_kernel) visit every row in turn and skip an empty
// one with a scalar branch.  On this card a block per empty row is a launch
// slot wasted (a chunked call of the 400k-triangle frame has 14,336 rows and
// candidates in a fraction of them), and the launch ends on its longest rows
// unless they start first.
//
// Bound: bytes, and few of them (one int per listed row); the list costs the
// key kernel one atomicAdd per row with candidates.
//
// Layout, shared by producer and consumers:
//   heads (kBuckets,) i32         rows listed per bucket; zeroed by the
//                               caller before the key kernel.
//   rows  (kBuckets, n_rows) i32  bucket b's rows in rows[b, 0:heads[b]], in
//                               no particular order.
// Bucket 0 holds the longest lists, so a consumer that walks the buckets in
// order starts the long rows first.

#pragma once

namespace mcpt {

constexpr int kBuckets = 8;

// Bucket of a row with `count` > 0 candidates, by its power of two: 128 and
// more, 64-127, 32-63, 16-31, 8-15, 4-7, 2-3, 1.
__device__ __forceinline__ int bucket_of(int count) {
  return max(0, kBuckets - 1 - (31 - __clz(count)));
}

// Appends `row` (with `count` > 0 candidates) to the list.
__device__ __forceinline__ void list_append(int* heads, int* rows, int n_rows,
                                            int row, int count) {
  const int b = bucket_of(count);
  rows[(size_t)b * n_rows + atomicAdd(heads + b, 1)] = row;
}

// The list's entry number t, buckets in order; -1 past the end.
__device__ __forceinline__ int list_row(const int* heads, const int* rows,
                                        int n_rows, int t) {
#pragma unroll
  for (int b = 0; b < kBuckets; ++b) {
    const int n = heads[b];
    if (t < n) return rows[(size_t)b * n_rows + t];
    t -= n;
  }
  return -1;
}

}  // namespace mcpt
