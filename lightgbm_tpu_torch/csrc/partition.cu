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
// What bounds it on an H100.  The function must read the row id (4 B) and
// go flag (1 B) of every in-segment position and write its row id once
// (4 B), and copy the row id of every other position (4 + 4 B): about 3.6
// MB at 400k rows, ~1 us at 3.35 TB/s.  That is less than the time of one
// launch, so its cost on the card is its launches and the chain of
// dependent memory round trips inside them: the kernel is as fast as it has
// few launches, no empty blocks and no serial step.
//
// Design.  The TPU kernel walks segments in a sequential grid and streams
// each through double-buffered VMEM with read-modify-write DMA windows of
// a fixed size, over an order padded to n_pad.  None of that carries over:
// blocks run in parallel, in no order.  Here (partition_common.cuh) the
// segments and the gaps between them are cut into 4096-position chunks (4
// positions a thread, so 4 loads in flight a thread) laid
// end to end in one flat space; one wave of blocks, launched cooperatively
// so that all are resident, takes them by block stride, so no block is
// empty and none waits on a block that is not running.  A count pass ranks
// each chunk's lefts by ballot and gets
// its segment prefix by decoupled look-back (status words that a launch
// epoch keeps apart from earlier launches, so no memset); the segment's last
// chunk writes n_left.  The right runs start at start + n_left, so no row
// moves before every chunk of its segment is counted: a grid-wide barrier
// (a cooperative launch, every block resident) separates the count pass
// from the move pass, which writes each in-segment row to its place and
// copies the gap chunks.  So every position of the output is written once,
// the order is not copied first, one launch does it all and nothing is read
// back, so the caller's round needs no host sync.  (On an H100 at 400k
// rows, a copy-engine copy of the order cost 5 us more a call, a count
// launch plus a move launch 4 us more, chunks claimed by atomic ticket 1 us
// more and one position a thread 3 us more: PERF.md, chip_smoke.py
// --variants.)  The round
// megakernel knows n_left and runs the fused pass of the same device code.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//             -shared -Xcompiler -fPIC (ops/cuda_build.py does this).

#include "partition_common.cuh"

// The lane mode's kernel: lane groups of ``group`` lanes in turn, each a
// partition of its own flat space (partition_kernel's passes on the
// group's offset arguments) with its own run of status words.
__global__ void __launch_bounds__(lgbt::kBlock)
    partition_lanes_kernel(lgbt::PartitionArgs a, int lanes, int group) {
  __shared__ lgbt::ChunkTable t;
  const unsigned epoch = *reinterpret_cast<volatile unsigned*>(a.scratch);
  const long long words = lgbt::chunks_of(group * a.lane_n) + (long long)group * a.lane_s;
  for (int g = 0; g * group < lanes; ++g) {
    const int lane0 = g * group;
    const int gl = lanes - lane0 < group ? lanes - lane0 : group;
    const long long pos = (long long)lane0 * a.lane_n, seg = (long long)lane0 * a.lane_s;
    lgbt::PartitionArgs ga = a;
    ga.order += pos;
    ga.go += pos;
    ga.out += pos;
    ga.seg_start += seg;
    ga.seg_len += seg;
    ga.n_left += seg;
    ga.n = gl * a.lane_n;
    ga.S = gl * a.lane_s;
    ga.status_off = g * words;
    __syncthreads();  // the block's threads are done with the last group's table
    lgbt::build_table(ga, t);
    if (blockIdx.x == 0 && threadIdx.x < ga.S && t.len[threadIdx.x] == 0)
      ga.n_left[threadIdx.x] = 0;
    lgbt::partition_chunks<lgbt::kCountMode>(ga, t, epoch);
    cooperative_groups::this_grid().sync();
    lgbt::partition_chunks<lgbt::kMoveMode>(ga, t, epoch);
  }
  lgbt::finish_launch(a.scratch);
}

extern "C" {

// order (n,) i32, go (n,) u8 per position, seg_start/seg_len (S,) i32;
// scratch: 2 u32 words + (ceil(n / 4096) + S) u64 words, zeroed before its
// first use and left ready by every launch; n_left (S,) i32 and out (n,)
// i32 outputs.  Takes 1 <= S <= 1024 and 1 <= n < 2^30.  Returns a
// cudaError_t (0 = success).
int lgbt_partition(const void* order, const void* go, const void* seg_start,
                   const void* seg_len, long long n, int S, void* scratch, void* n_left,
                   void* out, void* stream) {
  if (n <= 0 || n >= lgbt::kMaxRows) return (int)cudaErrorInvalidValue;
  lgbt::PartitionArgs a{static_cast<const int32_t*>(order), static_cast<const uint8_t*>(go),
                        static_cast<const int32_t*>(seg_start),
                        static_cast<const int32_t*>(seg_len), static_cast<int32_t*>(n_left),
                        (int)n, S, static_cast<unsigned*>(scratch), static_cast<int32_t*>(out)};
  return (int)lgbt::launch_partition(a, false, static_cast<cudaStream_t>(stream));
}

// The lane mode: lanes independent partitions in one launch.  order and
// go are (lanes, n), seg_start / seg_len (lanes, S) with starts relative to
// their lane's order; n_left (lanes, S) and out (lanes, n).  A lane group
// of G = 1024 / S lanes lies end to end in one flat space of G * n
// positions, whose G * S segments fill one chunk table; the launch's one
// wave takes the groups in turn (count, grid barrier, move each), each
// group's status words a run of their own in the scratch:
// 2 u32 words + ceil(lanes / G) * (ceil(G n / 4096) + G S) u64 words.
// Takes S <= 1024 and lanes * n < 2^30.
int lgbt_partition_lanes(const void* order, const void* go, const void* seg_start,
                         const void* seg_len, int lanes, long long n, int S, void* scratch,
                         void* n_left, void* out, void* stream) {
  const long long total = (long long)lanes * n;
  if (lanes < 1 || n <= 0 || S < 1 || S > lgbt::kMaxSegments || total >= lgbt::kMaxRows)
    return (int)cudaErrorInvalidValue;
  const int group = lgbt::kMaxSegments / S < lanes ? lgbt::kMaxSegments / S : lanes;
  lgbt::PartitionArgs a{static_cast<const int32_t*>(order), static_cast<const uint8_t*>(go),
                        static_cast<const int32_t*>(seg_start),
                        static_cast<const int32_t*>(seg_len), static_cast<int32_t*>(n_left),
                        (int)n, S, static_cast<unsigned*>(scratch),
                        static_cast<int32_t*>(out), (int)n, S, 0};
  const void* fn = reinterpret_cast<const void*>(partition_lanes_kernel);
  int grid = 0;
  cudaError_t e = lgbt::partition_grid(
      fn, lgbt::chunks_of((int)(group * n)) + 2 * (int64_t)group * S + 1, &grid);
  if (e != cudaSuccess) return (int)e;
  int n_lanes = lanes;
  void* args[] = {&a, &n_lanes, (void*)&group};
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(lgbt::kBlock);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = coop;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelExC(&cfg, fn, args);
}

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
