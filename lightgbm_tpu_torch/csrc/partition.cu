// Stable segment partition for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/ops/partition_pallas.py::_partition_kernel (with its
// move sweep, emit_move_sweep).  The windowed grower keeps rows physically
// grouped by leaf; a round splits up to S leaves, whose position ranges
// [seg_start[s], seg_start[s] + seg_len[s]) are the segments.  For every
// segment it counts the positions that go left, then moves the segment's
// row ids stably into its left run followed by its right run.  Returns the
// new order (positions outside every segment keep order's value) and the
// left count of each segment.
//
// What bounds it on an H100.  The function must read go_left and the row id
// of every in-segment position and write the row id once: 4 + 1 + 4 bytes
// (12 with the 4-byte go flags the TPU kernel streams), about 3.6 MB at
// 400k rows, ~1 us at 3.35 TB/s.  Its cost on the card is launch latency
// (three small kernels plus the copy of untouched positions) and the
// blocks that find their chunk past the segment end.
//
// Design.  The TPU kernel walks segments in a sequential grid and streams
// each through double-buffered VMEM with read-modify-write DMA windows of
// a fixed size, over an order padded to n_pad.  None of that carries over:
// blocks run in parallel, in no order.  Here each segment is cut into
// 1024-position chunks (partition_common.cuh): a count pass, a scan of the
// chunk counts per segment, and a move pass in which each thread writes its
// own row to its final position, ranked by ballot/popcount inside the block
// plus the chunk's prefix.  Every block writes only positions inside its
// own segment, so nothing is padded or read back, and the output starts as
// a copy of the order (cudaMemcpyAsync) so untouched positions keep it.
// The grid is sized from N on the host (no segment length is read back, so
// the caller's round needs no host sync); chunks past a segment's end exit
// at once.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//             -shared -Xcompiler -fPIC (ops/cuda_build.py does this).

#include "partition_common.cuh"

extern "C" {

// order (n,) i32, go (n,) u8 per position, seg_start/seg_len (S,) i32;
// counts (S, ceil(n / 1024)) i32 scratch; n_left (S,) i32 and out (n,) i32
// outputs.  Returns a cudaError_t (0 = success).
int lgbt_partition(const void* order, const void* go, const void* seg_start,
                   const void* seg_len, long long n, int S, void* counts, void* n_left,
                   void* out, void* stream) {
  if (n <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemcpyAsync(out, order, (size_t)n * sizeof(int32_t),
                                  cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return (int)e;
  return (int)lgbt::launch_partition(
      static_cast<const int32_t*>(order), static_cast<const uint8_t*>(go),
      static_cast<const int32_t*>(seg_start), static_cast<const int32_t*>(seg_len), nullptr, n,
      S, static_cast<int32_t*>(counts), static_cast<int32_t*>(n_left),
      static_cast<int32_t*>(out), st);
}

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
