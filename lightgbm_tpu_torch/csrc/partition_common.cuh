// Device code of the stable segment partition, shared by partition.cu (the
// partition kernel) and round.cu (the round megakernel's first phase).
// partition.cu's source note says what bounds it and why it is cut this
// way.
//
// Segments s = 0..S-1 are disjoint position ranges [seg_start[s],
// seg_start[s] + seg_len[s]) of the row order, in any order; empty ones may
// sit anywhere.  The work is one flat space of chunks of kChunk positions,
// numbered by ticket:
//   segment chunks  each segment's chunks in position order, segment after
//                   segment, none spanning two segments;
//   gap chunks      the positions outside every segment: the gap before
//                   each non-empty segment (from the end of the non-empty
//                   segment before it in position order) and the gap after
//                   the last one, cut the same way.
// That is at most ceil(N / kChunk) + S segment chunks and ceil(N / kChunk) +
// 2S + 1 chunks in all.  A launch is one wave of blocks, launched
// cooperatively so that every block is resident: each builds the table of
// first tickets in shared memory (one segment a thread, so S <= kMaxSegments)
// and takes tickets blockIdx.x, blockIdx.x + gridDim.x, ... in order.  A
// chunk only waits on chunks with smaller tickets, each held by a resident
// block that reaches it after chunks smaller still, so no wait is circular
// and no claim needs an atomic.
//
// A chunk's position lo + j kBlock + tid (j < kItems) is thread tid's j-th.
// A segment chunk counts its go-left positions (one ballot a warp and item, a
// scan of the 32 kItems counts in position order), then learns the left
// count of the earlier chunks of its segment by decoupled look-back: it
// publishes its own count in its status word (its inclusive prefix at once
// if it is the segment's first chunk); warp 0 reads the words of up to 32
// earlier chunks of the segment at a time, sums their counts back to the
// nearest inclusive prefix, and publishes its own inclusive prefix.  A
// status word is [launch epoch 32 | flag 2 | count 30], written and read
// whole as one 64-bit word, so a count needs no fence of its own and a word
// of an earlier launch (another epoch) reads as not ready.  Counts need N <
// 2^30.
//
// Passes (partition_chunks):
//   count        count and look-back; the segment's last chunk writes
//                n_left[s], block 0 writes 0 for the empty segments;
//   move         after a count pass: each segment chunk reads its inclusive
//                prefix from its own status word, then moves; gap chunks
//                copy;
//   fused        count, look-back and move in one pass, n_left given.
// partition_kernel (the partition kernel, which computes n_left) runs the
// count pass, a grid-wide barrier and the move pass in one cooperative
// launch; partition_fused_kernel (the round megakernel's phase, whose
// caller knows n_left) runs the fused pass.
// The move puts a left row at start + (lefts before it) and a right row at
// start + n_left + (rights before it): a stable partition.  Every position of
// out is written exactly once, so out needs no copy of the order first.
//
// Scratch, as 32-bit words: [0] epoch, [1] blocks done, then the 64-bit
// status words, one a segment chunk.  The last block of a launch to finish
// resets the count of blocks done and moves the epoch on, so the next launch
// finds the scratch ready without a memset.  Launches that share a scratch
// must run in stream order.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lgbt {

constexpr int kBlock = 1024;               // threads a block
constexpr int kItems = 4;                  // positions a thread holds of a chunk
constexpr int kChunk = kBlock * kItems;    // positions a chunk
constexpr int kMaxSegments = kBlock;       // the chunk table holds one segment a thread
constexpr int kMaxRows = 1 << 30;     // status words hold counts in 30 bits
constexpr int kScratchWords = 2;      // 32-bit words before the status words

enum PartitionMode { kCountMode, kMoveMode, kFusedMode };

constexpr unsigned long long kAggregate = 1ull << 30;  // the chunk's own count
constexpr unsigned long long kInclusive = 2ull << 30;  // count through the chunk
constexpr unsigned long long kCountMask = (1ull << 30) - 1;

struct PartitionArgs {
  const int32_t* order;
  const uint8_t* go;
  const int32_t* seg_start;
  const int32_t* seg_len;
  int32_t* n_left;  // written by the count pass, read by the moves
  int n;
  int S;
  unsigned* scratch;
  int32_t* out;
  // lane mode: segment s lies lane_n * (s / lane_s) positions further on
  // (lane b's order occupies positions [b lane_n, (b + 1) lane_n) of the
  // flat space); lane_s = 0 reads seg_start as it is
  int lane_n;
  int lane_s;
  // status words this call's chunks start at, past the header (the lane
  // mode's lane groups each keep their own run of words)
  long long status_off;
};

struct ChunkTable {
  int start[kMaxSegments + 1];      // segment starts; [S] = N, the trailing gap's end
  int len[kMaxSegments];
  int seg_first[kMaxSegments + 1];  // first ticket of each segment; [S] = segment chunks
  int gap_lo[kMaxSegments + 1];     // start of the gap before each segment; [S] trailing
  int gap_first[kMaxSegments + 2];  // first ticket of each gap; [S + 1] = all chunks
  int warp_sum[32 * kItems];
  int max_end;
  int item, excl, n_left;
};

// Exclusive prefix of ``v`` over the block's threads (blockDim.x == kBlock);
// ``*total`` receives the block's sum.  ``tmp`` is 32 ints of shared memory.
__device__ __forceinline__ int block_exclusive_sum(int v, int* tmp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();  // tmp may still be read by a previous call
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = tmp[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    tmp[lane] = w;  // inclusive warp prefix
  }
  __syncthreads();
  *total = tmp[31];
  return (warp > 0 ? tmp[warp - 1] : 0) + x - v;
}

__host__ __device__ __forceinline__ int chunks_of(int len) { return (len + kChunk - 1) / kChunk; }

// The table of first tickets (ChunkTable), one segment a thread.
__device__ void build_table(const PartitionArgs& a, ChunkTable& t) {
  const int s = threadIdx.x;
  const bool has = s < a.S;
  const int st = has ? a.seg_start[s] + (a.lane_s > 0 ? (s / a.lane_s) * a.lane_n : 0) : 0;
  const int len = has ? a.seg_len[s] : 0;
  if (has) {
    t.start[s] = st;
    t.len[s] = len;
  }
  if (s == 0) t.max_end = 0;
  __syncthreads();
  // the gap before a non-empty segment starts where the non-empty segment
  // before it in position order ends (segments are disjoint)
  int lo = 0;
  if (len > 0) {
    for (int j = 0; j < a.S; ++j) {
      if (t.len[j] > 0 && t.start[j] < st) lo = max(lo, t.start[j] + t.len[j]);
    }
    atomicMax(&t.max_end, st + len);
  }
  int n_seg, n_gap;
  const int seg_ex = block_exclusive_sum(chunks_of(len), t.warp_sum, &n_seg);
  const int gap_ex = block_exclusive_sum(len > 0 ? chunks_of(max(st - lo, 0)) : 0,
                                         t.warp_sum, &n_gap);
  if (has) {
    t.seg_first[s] = seg_ex;
    t.gap_lo[s] = lo;
    t.gap_first[s] = n_seg + gap_ex;
  }
  if (s == 0) {
    const int end = t.max_end;  // complete: block_exclusive_sum synchronised
    t.start[a.S] = a.n;
    t.seg_first[a.S] = n_seg;
    t.gap_lo[a.S] = end;
    t.gap_first[a.S] = n_seg + n_gap;
    t.gap_first[a.S + 1] = n_seg + n_gap + chunks_of(a.n - end);
  }
  __syncthreads();
}

// The last entry r < count of ``first`` with first[r] <= k (ticket k falls
// in entry r's chunks; empty entries share their successor's first ticket).
__device__ __forceinline__ int entry_of(const int* first, int count, int k) {
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= k) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long w) {
  *reinterpret_cast<volatile unsigned long long*>(p) = w;
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// Warp 0 of the block that holds chunk c of a segment, whose status word is
// ``me``: publishes the chunk's count ``cnt``, then sums the counts of the
// earlier chunks of the segment back to the nearest inclusive prefix, 32
// words at a time, and publishes its own inclusive prefix.  Returns the left
// count of the earlier chunks, in every lane.
__device__ __forceinline__ int look_back(unsigned long long* me, int c, int cnt,
                                         unsigned epoch) {
  const int lane = threadIdx.x & 31;
  const unsigned long long tag = (unsigned long long)epoch << 32;
  if (c == 0) {
    if (lane == 0) store_status(me, tag | kInclusive | (unsigned long long)cnt);
    return 0;
  }
  if (lane == 0) store_status(me, tag | kAggregate | (unsigned long long)cnt);
  int excl = 0;
  for (int d0 = 1;;) {
    const int d = d0 + lane;  // how many chunks back this lane reads
    // chunk 0 of the segment is always inclusive, so no lane past it is summed
    const unsigned long long w = d <= c ? load_status(me - d) : tag | kInclusive;
    const bool ready = (w >> 32) == epoch && (w & (kAggregate | kInclusive)) != 0;
    const unsigned incl = __ballot_sync(0xffffffffu, ready && (w & kInclusive));
    const unsigned waiting = __ballot_sync(0xffffffffu, !ready);
    // lanes up to the nearest inclusive one (all 32 when there is none)
    const unsigned upto = incl ? ((incl & (0u - incl)) << 1) - 1u : 0xffffffffu;
    if (waiting & upto) continue;  // read the same words again
    excl += __reduce_add_sync(0xffffffffu, (upto >> lane) & 1u ? (int)(w & kCountMask) : 0);
    if (incl) break;
    d0 += 32;
  }
  if (lane == 0) store_status(me, tag | kInclusive | (unsigned long long)(excl + cnt));
  return excl;
}

// One pass over the chunks: tickets blockIdx.x, + gridDim.x, ...
template <int kMode>
__device__ void partition_chunks(const PartitionArgs& a, ChunkTable& t, unsigned epoch) {
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(a.scratch + kScratchWords) + a.status_off;
  const int n_seg = t.seg_first[a.S];
  const int total = kMode == kCountMode ? n_seg : t.gap_first[a.S + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = blockIdx.x; k < total; k += gridDim.x) {
    if (tid == 0)
      t.item = k < n_seg ? entry_of(t.seg_first, a.S, k) : entry_of(t.gap_first, a.S + 1, k);
    __syncthreads();
    if (k < n_seg) {
      const int s = t.item, c = k - t.seg_first[s];
      const int st = t.start[s], lo = c * kChunk, len = t.len[s];
      bool left[kItems];
      int32_t row[kItems];
      unsigned ballot[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = lo + j * kBlock + tid;
        left[j] = i < len && a.go[st + i];
        row[j] = kMode != kCountMode && i < len ? a.order[st + i] : 0;
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        ballot[j] = __ballot_sync(0xffffffffu, left[j]);
        if (lane == 0) t.warp_sum[j * 32 + warp] = __popc(ballot[j]);
      }
      __syncthreads();
      if (warp == 0) {
        // lane l holds the counts kItems l .. kItems l + kItems - 1
        int v[kItems], x = 0;
#pragma unroll
        for (int q = 0; q < kItems; ++q) {
          v[q] = t.warp_sum[lane * kItems + q];
          x += v[q];
        }
        const int own = x;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, o);
          if (lane >= o) x += y;
        }
        int run = x - own;  // lefts in the chunk before each (item, warp)
#pragma unroll
        for (int q = 0; q < kItems; ++q) {
          t.warp_sum[lane * kItems + q] = run;
          run += v[q];
        }
        const int cnt = __shfl_sync(0xffffffffu, x, 31);
        const int excl = kMode == kMoveMode
                             ? (int)(load_status(status + k) & kCountMask) - cnt
                             : look_back(status + k, c, cnt, epoch);
        if (lane == 0) {
          t.excl = excl;
          if (kMode == kCountMode) {
            if (k == t.seg_first[s + 1] - 1) a.n_left[s] = excl + cnt;
          } else {
            t.n_left = a.n_left[s];
          }
        }
      }
      __syncthreads();
      if (kMode != kCountMode) {
        const int excl = t.excl, n_left = t.n_left;
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const int i = j * kBlock + tid;  // place in the chunk
          if (lo + i >= len) break;
          const int rank = t.warp_sum[j * 32 + warp] + __popc(ballot[j] & ((1u << lane) - 1u));
          // valid positions are a prefix of the chunk, so the rights before
          // this one are the positions before it that do not go left
          a.out[left[j] ? st + excl + rank : st + n_left + (lo - excl) + (i - rank)] = row[j];
        }
      }
    } else {
      const int r = t.item;
      const int p0 = t.gap_lo[r] + (k - t.gap_first[r]) * kChunk + tid;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int p = p0 + j * kBlock;
        if (p < t.start[r]) a.out[p] = a.order[p];
      }
    }
    __syncthreads();  // the table's per-chunk words are rewritten next
  }
}

// The last block to finish readies the scratch for the next launch.
__device__ __forceinline__ void finish_launch(unsigned* scratch) {
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(scratch + 1, 1u) == gridDim.x - 1) {
      scratch[1] = 0;
      scratch[0] += 1;
    }
  }
}

// The tables and epoch every block starts from; block 0 writes n_left = 0
// for the empty segments when the launch computes n_left.
__device__ __forceinline__ unsigned begin_launch(const PartitionArgs& a, ChunkTable& t,
                                                 bool computes_n_left) {
  // every block reads the epoch before the last one moves it on
  const unsigned epoch = *reinterpret_cast<volatile unsigned*>(a.scratch);
  build_table(a, t);
  if (computes_n_left && blockIdx.x == 0 && threadIdx.x < a.S && t.len[threadIdx.x] == 0)
    a.n_left[threadIdx.x] = 0;
  return epoch;
}

// Count, grid-wide barrier, move (every block resident, so the barrier
// cannot wait on a block not yet run).
__global__ void __launch_bounds__(kBlock) partition_kernel(PartitionArgs a) {
  __shared__ ChunkTable t;
  const unsigned epoch = begin_launch(a, t, true);
  partition_chunks<kCountMode>(a, t, epoch);
  cooperative_groups::this_grid().sync();
  partition_chunks<kMoveMode>(a, t, epoch);
  finish_launch(a.scratch);
}

__global__ void __launch_bounds__(kBlock) partition_fused_kernel(PartitionArgs a) {
  __shared__ ChunkTable t;
  const unsigned epoch = begin_launch(a, t, false);
  partition_chunks<kFusedMode>(a, t, epoch);
  finish_launch(a.scratch);
}

// One wave of resident blocks of ``kernel``, at most ``chunks``.
inline cudaError_t partition_grid(const void* kernel, int64_t chunks, int* grid) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kBlock, 0);
  if (e != cudaSuccess) return e;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  *grid = (int)(chunks < (int64_t)sms * occ ? chunks : (int64_t)sms * occ);
  return cudaSuccess;
}

// The partition of a.order into a.out in one cooperative launch of one wave
// of resident blocks, at most one block a chunk: with ``n_left_given`` (the
// round megakernel) the fused pass, else count + move, which also writes
// a.n_left.  a.scratch holds kScratchWords words and then ceil(n / kChunk) +
// S status words, zeroed before its first launch.
inline cudaError_t launch_partition(PartitionArgs a, bool n_left_given, cudaStream_t st) {
  if (a.n < 1 || a.n >= kMaxRows || a.S < 1 || a.S > kMaxSegments)
    return cudaErrorInvalidValue;
  const void* fn = n_left_given ? reinterpret_cast<const void*>(partition_fused_kernel)
                                : reinterpret_cast<const void*>(partition_kernel);
  int grid = 0;
  cudaError_t e = partition_grid(fn, chunks_of(a.n) + 2 * (int64_t)a.S + 1, &grid);
  if (e != cudaSuccess) return e;
  void* args[] = {&a};
  // cooperative through the extensible launch, which stream capture records
  // as a kernel node with the cooperative attribute (a captured CUDA graph
  // then launches it cooperatively on every replay)
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kBlock);
  cfg.stream = st;
  cfg.attrs = coop;
  cfg.numAttrs = 1;
  return cudaLaunchKernelExC(&cfg, fn, args);
}

}  // namespace lgbt
