// Device code of the stable segment partition, shared by partition.cu (the
// partition kernel) and round.cu (the round megakernel's first phase).
// partition.cu's source note says what bounds it and why it is cut this
// way.
//
// Segments s = 0..S-1 are disjoint position ranges [seg_start[s],
// seg_start[s] + seg_len[s]) of the row order.  Each is cut into chunks of
// kChunk positions, one block per (chunk, segment); a block whose chunk lies
// past its segment's end leaves at once, so the grid can be sized from N on
// the host without reading any segment length back.
//   count  per chunk, the number of positions that go left;
//   scan   per segment, the exclusive prefix of its chunk counts (in place)
//          and its total, the segment's left count;
//   move   each position's row to start + (lefts before it) when it goes
//          left, else to start + n_left + (rights before it): a stable
//          partition.  Ranks inside a chunk come from a warp ballot and
//          popcount plus the scan of the block's 32 warp totals.
// Positions outside every segment are never written.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lgbt {

constexpr int kChunk = 1024;  // positions per block, one per thread

// Exclusive prefix of ``v`` over the block's threads (blockDim.x == kChunk);
// ``*total`` receives the block's sum.  ``tmp`` is 32 ints of shared memory.
__device__ __forceinline__ int block_exclusive_sum(int v, int* tmp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();  // tmp may still be read by a previous call
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? tmp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) tmp[lane] = w;  // inclusive warp prefix
  }
  __syncthreads();
  *total = tmp[nw - 1];
  return (warp > 0 ? tmp[warp - 1] : 0) + x - v;
}

__global__ void __launch_bounds__(kChunk)
partition_count_kernel(const uint8_t* __restrict__ go, const int32_t* __restrict__ seg_start,
                       const int32_t* __restrict__ seg_len, int nchunks,
                       int32_t* __restrict__ counts) {
  const int s = blockIdx.y, c = blockIdx.x;
  const int64_t len = seg_len[s], lo = (int64_t)c * kChunk;
  if (lo >= len) return;
  const int64_t i = lo + threadIdx.x;
  const int flag = (i < len) && go[seg_start[s] + i];
  const int n = __syncthreads_count(flag);
  if (threadIdx.x == 0) counts[(int64_t)s * nchunks + c] = n;
}

// One block per segment: chunk counts -> exclusive chunk prefix, in place.
__global__ void __launch_bounds__(kChunk)
partition_scan_kernel(const int32_t* __restrict__ seg_len, int nchunks,
                      int32_t* __restrict__ counts, int32_t* __restrict__ n_left) {
  __shared__ int tmp[32];
  const int s = blockIdx.x;
  const int64_t len = seg_len[s];
  const int nc = (int)((len + kChunk - 1) / kChunk);
  int32_t* row = counts + (int64_t)s * nchunks;
  int carry = 0;
  for (int base = 0; base < nc; base += kChunk) {
    const int j = base + threadIdx.x;
    const int v = j < nc ? row[j] : 0;
    int total;
    const int ex = block_exclusive_sum(v, tmp, &total);
    if (j < nc) row[j] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) n_left[s] = carry;
}

__global__ void __launch_bounds__(kChunk)
partition_move_kernel(const int32_t* __restrict__ order, const uint8_t* __restrict__ go,
                      const int32_t* __restrict__ seg_start, const int32_t* __restrict__ seg_len,
                      const int32_t* __restrict__ n_left, int nchunks,
                      const int32_t* __restrict__ prefix, int32_t* __restrict__ out) {
  __shared__ int tmp[32];
  const int s = blockIdx.y, c = blockIdx.x;
  const int64_t len = seg_len[s], lo = (int64_t)c * kChunk;
  if (lo >= len) return;
  const int64_t start = seg_start[s];
  const int64_t i = lo + threadIdx.x;
  const bool valid = i < len;
  const bool left = valid && go[start + i];
  int total;
  const int rank_l = block_exclusive_sum(left ? 1 : 0, tmp, &total);
  if (!valid) return;
  const int64_t lefts_before = prefix[(int64_t)s * nchunks + c];
  int64_t dest;
  if (left) {
    dest = start + lefts_before + rank_l;
  } else {
    // valid positions are a prefix of the chunk: rights before me in the
    // chunk are the positions before me that do not go left
    dest = start + n_left[s] + (lo - lefts_before) + (threadIdx.x - rank_l);
  }
  out[dest] = order[start + i];
}

inline int partition_chunks(int64_t n) { return (int)((n + kChunk - 1) / kChunk); }

// count + scan (+ move): out must already hold order outside the segments.
// n_left_scan receives the scan's left counts; the move places right runs
// after n_left_move[s] (the same array for the partition kernel, the
// caller's precomputed counts for the round megakernel).
inline cudaError_t launch_partition(const int32_t* order, const uint8_t* go,
                                    const int32_t* seg_start, const int32_t* seg_len,
                                    const int32_t* n_left_move, int64_t n, int S,
                                    int32_t* counts, int32_t* n_left_scan, int32_t* out,
                                    cudaStream_t st) {
  const int nch = partition_chunks(n);
  dim3 grid((unsigned)nch, (unsigned)S);
  partition_count_kernel<<<grid, kChunk, 0, st>>>(go, seg_start, seg_len, nch, counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  partition_scan_kernel<<<S, kChunk, 0, st>>>(seg_len, nch, counts, n_left_scan);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  partition_move_kernel<<<grid, kChunk, 0, st>>>(
      order, go, seg_start, seg_len, n_left_move != nullptr ? n_left_move : n_left_scan, nch,
      counts, out);
  return cudaGetLastError();
}

}  // namespace lgbt
