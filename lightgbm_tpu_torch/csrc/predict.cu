// Tree-ensemble traversal for Hopper (sm_90a): every row walks every tree to
// its leaf and adds the leaf values in tree order, in one launch.
//
// Replaces no TPU kernel: the JAX package predicts with XLA ops
// (lightgbm_tpu/ops/predict.py), and the port's plain walk
// (ops/predict.py::leaf_index, then leaf_sum) is the same level loop in
// PyTorch: ~20 tensor ops a level over (trees, rows) int64 planes, every
// (tree, row) pair walking the deepest tree's levels, then a gather and one
// add a tree.  That walk was the whole of the prediction cell's device time
// (~108 ms a call of ~98,557 rows x 500 trees; PERF.md), so it is done here
// in one kernel instead.
//
// What bounds it on an H100.  The bytes the call needs are few: the rows
// once (11 MB of float32 at 98,557 x 28), the pack once (~2.5 MB of nodes
// and leaf values, which stay in L2) and the answers once: a few
// microseconds at 3.35 TB/s.  The work is node visits, ~473 M at that
// call (pairs x mean leaf depth 9.6), and each visit is a chain of
// dependent loads: the node's record, then the row's value of its feature,
// then the child the comparison picks.  So the kernel is bound by the
// latency of those chains and by how many run at once, not by bytes or
// arithmetic.
//
// Design.
// * One thread walks one row; a block holds a tile of kRows rows and
//   grid.y covers the k classes.  The (row, class) thread adds trees c,
//   c + k, c + 2k, ... of [tree_lo, tree_hi) in order onto a float32
//   accumulator that starts at +0.0f (or at the row's base margin), which
//   is ops/predict.py::_tree_sum's order: the answer is bitwise leaf_sum's.
// * Each tree's loop ends at the row's leaf (while node >= 0): no level is
//   issued past it, where the plain walk runs every pair to the deepest
//   tree's depth.  Lanes of a warp whose leaves are shallower wait for the
//   warp's deepest lane; a traced call counts that (the counts below).
// * Rows.  The block stages its rows into shared memory feature-major
//   ([F][kRows]), so the 32 lanes of a warp read 32 different banks whatever
//   features their nodes test: a row value costs one shared-memory load in
//   the chain.  Rows wider than kMaxStagedBytes allows are read where they
//   lie (row-major, through L1): 5-40% slower at the cell's shapes.
// * Nodes.  One 16-byte record a node (ops/predict_cuda.py::node_table):
//   feature and flags, the float32 threshold (or a categorical node's
//   bitset offset), left and right child.  The block copies a group of
//   its class's trees (kNodeBytes of records: 8 trees of 255 leaves) into
//   shared memory, then every row walks the group, so each visit's record
//   is one shared-memory vector load.  Trees too large for one group are
//   read where they lie, through the read-only path (L1, then L2).  At
//   the cell's shapes the groups took 1.14 ms a launch of 98,557 rows
//   where the read-only path took 1.63, and two rows a thread, interleaved
//   to hide the chain's latency, 2.64 (PERF.md, PR 21).
// * Nothing is allocated and no (T, N) plane is written: the wrapper
//   allocates the (N,) or (N, k) answer, and one launch covers the call.
// * The decision is one __device__ function, line for line leaf_index's.
//
// Counts (traced calls only, a null pointer otherwise): walk_steps, the
// lane-steps the warps issued (32 x the deepest live lane's depth, a warp a
// tree), and walk_useful_steps, the sum of the rows' leaf depths, each
// reduced over the warp and added with one atomic a warp.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//             -shared -Xcompiler -fPIC (ops/cuda_build.py does this).

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;  // rows (threads) a block
constexpr int kMaxStagedBytes = 64 * 1024;  // a block's staged rows
constexpr int kNodeBytes = 32 * 1024;  // a block's group of trees' records
constexpr unsigned kFeatMask = (1u << 24) - 1;  // record word 0: feature
constexpr int kMissShift = 24, kDefaultLeftBit = 26, kCatBit = 27;
constexpr float kZero = 1e-35f;  // reference: kZeroThreshold

struct Args {
  const float* x;
  long long n;
  int F;
  const int4* nodes;
  const int* table;  // the same words, for the categorical bitsets
  const int* num_leaves;
  const float* leaf_value;
  int M, L, tree_lo, tree_hi, k;
  int group;  // trees of a class a group
  const float* base;
  const bool* active;
  float* out;
  unsigned long long* counts;
};

// The decision at node record r for the row value v: ops/predict.py::
// leaf_index line for line.  NaN is missing and reads as 0.0; missing type
// 2 (NaN) sends a missing value, type 1 (Zero) a missing or |v| <= kZero
// one, to the default side; otherwise v <= threshold in float32.  A
// categorical node sends v left when its truncated int is in the node's
// bitset (word count, then 32-bit words, low bit first); NaN, negative and
// out-of-range values go right.
template <bool kCat>
__device__ __forceinline__ bool go_left(const int4 r, float v, const int* table) {
  const bool miss = isnan(v);
  if (miss) v = 0.0f;
  const unsigned meta = static_cast<unsigned>(r.x);
  if (kCat && ((meta >> kCatBit) & 1u)) {
    const int iv = static_cast<int>(v);  // truncation, as static_cast<int>
    const int* set = table + r.y;
    if (miss || iv < 0 || (iv >> 5) >= set[0]) return false;
    return (static_cast<unsigned>(set[1 + (iv >> 5)]) >> (iv & 31)) & 1u;
  }
  const unsigned mt = (meta >> kMissShift) & 3u;
  const bool use_default = mt == 2u ? miss : (mt == 1u ? (miss || fabsf(v) <= kZero) : false);
  return use_default ? ((meta >> kDefaultLeftBit) & 1u) != 0u : v <= __int_as_float(r.y);
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <bool kCat, bool kStaged, bool kCount, bool kSmemNodes>
__global__ void __launch_bounds__(kRows) predict_kernel(const Args a) {
  extern __shared__ int4 smem[];
  const int c = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * kRows, row = row0 + threadIdx.x;
  const int tile_rows = (int)(a.n - row0 < kRows ? a.n - row0 : kRows);
  float* xs = reinterpret_cast<float*>(smem);
  if (kStaged) {
    const float* src = a.x + row0 * a.F;
    for (int e = threadIdx.x; e < tile_rows * a.F; e += kRows) {
      const int q = e / a.F;
      xs[(e - q * a.F) * kRows + q] = src[e];
    }
  }
  int4* snodes = smem + (kStaged ? (a.F * kRows + 3) / 4 : 0);
  __syncthreads();
  const bool in_tile = (int)threadIdx.x < tile_rows;
  const bool live = in_tile && (a.active == nullptr || a.active[row]);
  float acc = (in_tile && a.base != nullptr) ? a.base[row * a.k + c] : 0.0f;
  const float* xr = kStaged ? xs + threadIdx.x : a.x + row * a.F;
  const long long stride = kStaged ? kRows : 1;
  unsigned useful = 0, issued = 0;
  // a thread with no live row skips the trees, unless the block's barriers
  // or a count's warp reductions need every thread
  const bool walks = live || kCount || kSmemNodes;
  for (int t0 = a.tree_lo + c; walks && t0 < a.tree_hi; t0 += a.k * a.group) {
    const int left = (a.tree_hi - t0 + a.k - 1) / a.k;
    const int trees = left < a.group ? left : a.group;
    if (kSmemNodes) {
      __syncthreads();  // every row is done with the last group
      for (int e = threadIdx.x; e < trees * a.M; e += kRows) {
        const int i = e / a.M;
        snodes[e] = __ldg(a.nodes + (long long)(t0 + i * a.k) * a.M + (e - i * a.M));
      }
      __syncthreads();
    }
    for (int i = 0; i < trees; ++i) {
      const int t = t0 + i * a.k;
      const int4* tn = kSmemNodes ? snodes + i * a.M : a.nodes + (long long)t * a.M;
      int node = live && __ldg(a.num_leaves + t) > 1 ? 0 : -1;  // one leaf: leaf 0
      int depth = 0;
      while (node >= 0) {
        const int4 rec = kSmemNodes ? tn[node] : __ldg(tn + node);
        const float v = xr[(long long)(static_cast<unsigned>(rec.x) & kFeatMask) * stride];
        node = go_left<kCat>(rec, v, a.table) ? rec.z : rec.w;
        if (kCount) ++depth;
      }
      if (live) acc += __ldg(a.leaf_value + (long long)t * a.L + ~node);
      if (kCount) {
        useful += depth;
        issued += __reduce_max_sync(0xffffffffu, depth);
      }
    }
  }
  if (in_tile) a.out[row * a.k + c] = acc;
  if (kCount) {
    const unsigned long long u = warp_sum(useful);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(a.counts, 32ull * issued);
      atomicAdd(a.counts + 1, u);
    }
  }
}

template <bool kCat, bool kStaged, bool kCount, bool kSmemNodes>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto fn = predict_kernel<kCat, kStaged, kCount, kSmemNodes>;
  const long long smem = (kStaged ? ((long long)a.F * kRows + 3) / 4 * 16 : 0) +
                         (kSmemNodes ? (long long)a.group * a.M * 16 : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)((a.n + kRows - 1) / kRows), (unsigned)a.k);
  fn<<<grid, kRows, (size_t)smem, stream>>>(a);
  return cudaGetLastError();
}

// launch<flags...>, each flag chosen at run time
template <bool... kFlags, typename... Rest>
cudaError_t dispatch(const Args& a, cudaStream_t stream, bool flag, Rest... rest) {
  if constexpr (sizeof...(Rest) == 0) {
    return flag ? launch<kFlags..., true>(a, stream) : launch<kFlags..., false>(a, stream);
  } else {
    return flag ? dispatch<kFlags..., true>(a, stream, rest...)
                : dispatch<kFlags..., false>(a, stream, rest...);
  }
}

}  // namespace

extern "C" {

// x (n, F) f32 row-major; nodes: node_table's int32 words (16-byte
// aligned), tree t's node j at record t * M + j; num_leaves (T,) i32;
// leaf_value (T, L) f32; trees [tree_lo, tree_hi), tree i in class i % k;
// base (n, k) f32 or null (start at +0.0f); active (n,) bool or null (every
// row); out (n, k) f32; counts u64[2] zeroed by the caller, or null.
// Takes n >= 1, 1 <= k <= 65535, F < 2^24.  Returns a cudaError_t.
int lgbt_predict(const void* x, long long n, int F, const void* nodes, const void* num_leaves,
                 const void* leaf_value, int M, int L, int tree_lo, int tree_hi, int k,
                 int has_cat, const void* base, const void* active, void* out, void* counts,
                 void* stream) {
  if (n <= 0 || k < 1 || k > 65535 || F < 0 || F > (int)kFeatMask || M < 1 || L < 1 ||
      tree_lo < 0 || tree_hi < tree_lo)
    return (int)cudaErrorInvalidValue;
  const int per_class = (tree_hi - tree_lo + k - 1) / k;
  const int fit = kNodeBytes / (M * 16);  // trees a group of records holds
  const bool smem_nodes = fit >= 1;
  const int group = smem_nodes ? (fit < per_class ? fit : (per_class > 0 ? per_class : 1)) : 1;
  const Args a{static_cast<const float*>(x), n, F, static_cast<const int4*>(nodes),
               static_cast<const int*>(nodes), static_cast<const int*>(num_leaves),
               static_cast<const float*>(leaf_value), M, L, tree_lo, tree_hi, k, group,
               static_cast<const float*>(base), static_cast<const bool*>(active),
               static_cast<float*>(out), static_cast<unsigned long long*>(counts)};
  const bool staged = (long long)F * kRows * 4 <= kMaxStagedBytes;
  return (int)dispatch<>(a, static_cast<cudaStream_t>(stream), has_cat != 0, staged,
                         counts != nullptr, smem_nodes);
}

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
