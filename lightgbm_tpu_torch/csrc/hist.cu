// Multi-leaf histogram kernel for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/ops/hist_pallas.py::_direct_kernel, the one Pallas
// kernel on the main training path.  For a tile of leaf slots it computes, in
// one pass over the rows, per (slot, channel, feature, bin):
//   float:  sum of grad, sum of hess and the row count of the rows whose
//           mask is set and whose slot (leaf_slot - leaf_base) lies in
//           [0, tile);
//   int8:   the same sums of the int8-quantized grad_q / hess_q, exact in
//           int32.
// Output layout (tile, 3, F, B), channels (grad, hess, count) -- the JAX
// package's channel-first layout, so the two packages compare like for like.
//
// What bounds it on an H100.  The function must read mask and slot of
// every row (5 bytes) to learn which rows contribute, then only the
// contributing rows' bins (F * 2 bytes of int16) and grad and hess (4 bytes
// each in float, 1 in int8), in the 32-byte sectors those scattered rows
// touch, and write the histogram once.  At N = 1M, F = 28 with a third of
// the rows in the tile that is ~40 MB, ~12 us at 3.35 TB/s.  The kernel
// reads more: the float prologue reads grad and hess of every row, and each
// feature group re-reads its rows' mask and slot.  Its work is one
// shared-memory atomic per contributing row, feature and channel, so it is
// bound by shared-memory atomic throughput, not by arithmetic or bytes.
// chip_smoke.py measures it against that bound on the card (PERF.md);
// closing the gap is later work.
//
// Design.
// * Bins are read in the package's row-major (N, F) int16 layout: one block
//   reads the few contiguous features of its group for every row of its
//   chunk, so a row's bytes come from one or two cache lines.  No
//   feature-major copy is needed (the JAX package keeps one for its column
//   reads; the port's partition reads a single gathered column per row).
// * Each block owns a private accumulator in shared memory for
//   (slots of its slot group) x (features of its feature group) x B bins.
//   A (slot, feature) pair costs B * 20 bytes in float (two 64-bit sums and
//   a 32-bit count) and B * 12 bytes in int8, so at B = 255 a block holds
//   ~45 float pairs or ~75 int8 pairs in its 227 KB: features are split
//   into groups, and slots too when one feature's slots do not fit.  The
//   TPU kernel's accumulator carried across a sequential row grid has no
//   counterpart here (blocks run in no order), so rows are cut into chunks,
//   one block per (chunk, group), and each block adds its partial into the
//   global result with integer atomics when it finishes.
// * Determinism.  Float atomics would sum in a different order, and to
//   different bits, from run to run.  Float payloads are therefore summed
//   in 64-bit fixed point, as XGBoost's GPU histogram does: a prologue finds
//   max |grad| and max |hess| over the rows; each value v becomes
//   round(v * 2^s) with s = 62 - bitlen(N) - exponent(max), so no sum of up
//   to N values can overflow.  Integer addition is exact and order-free, so
//   two launches on the same inputs give identical bits, and the result is
//   the true sum rounded once to f32 (within 2^-(62 - bitlen(N)) of the
//   largest value per row).  The int8 path is exact in int32 already.
//   The plain PyTorch version in ops/hist_cuda.py does the same arithmetic
//   with index_add_, so kernel and plain version agree bit for bit.
// * Rows need not be a multiple of anything; rows with mask 0 or a slot
//   outside [0, tile) (e.g. -1 for inactive rows) are skipped; any F works.
// * A launch allocates nothing: the Python wrapper passes zeroed scratch.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//             -shared -Xcompiler -fPIC (ops/hist_cuda.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ int fixed_shift(unsigned int absmax_bits, int row_bits) {
  int e = 0;
  frexpf(__uint_as_float(absmax_bits), &e);  // max = mant * 2^e, mant in [0.5, 1)
  return 62 - row_bits - e;
}

__global__ void __launch_bounds__(kThreads)
absmax_kernel(const float* __restrict__ g, const float* __restrict__ h,
              int64_t n, unsigned int* __restrict__ out) {
  unsigned int mg = 0, mh = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    // |x| as bits orders like |x| itself for non-negative floats
    mg = max(mg, __float_as_uint(fabsf(g[i])));
    mh = max(mh, __float_as_uint(fabsf(h[i])));
  }
  // warp, then block, then one atomic per block: per-warp atomics on the
  // two words serialised (measured ~50 us per call at N = 1M)
  __shared__ unsigned int wg[32], wh[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    mg = max(mg, __shfl_down_sync(0xffffffffu, mg, o));
    mh = max(mh, __shfl_down_sync(0xffffffffu, mh, o));
  }
  if (lane == 0) {
    wg[warp] = mg;
    wh[warp] = mh;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    mg = lane < nw ? wg[lane] : 0u;
    mh = lane < nw ? wh[lane] : 0u;
    for (int o = 16; o > 0; o >>= 1) {
      mg = max(mg, __shfl_down_sync(0xffffffffu, mg, o));
      mh = max(mh, __shfl_down_sync(0xffffffffu, mh, o));
    }
    if (lane == 0) {
      atomicMax(&out[0], mg);
      atomicMax(&out[1], mh);
    }
  }
}

// One block: rows [chunk * rows_per_chunk, ...) x one (slot group, feature
// group).  kQuant selects the int8 payload (int32 sums) over the float one
// (64-bit fixed-point sums).
template <bool kQuant>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const int16_t* __restrict__ bins, const void* __restrict__ gp,
            const void* __restrict__ hp, const uint8_t* __restrict__ mask,
            const int32_t* __restrict__ slot, int64_t n, int F, int leaf_base,
            int tile, int B, int64_t rows_per_chunk, int FB, int SB,
            int n_fgroups, const unsigned int* __restrict__ absmax, int row_bits,
            unsigned long long* __restrict__ acc64, int* __restrict__ acc32) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int fg = blockIdx.y % n_fgroups;
  const int sg = blockIdx.y / n_fgroups;
  const int f0 = fg * FB, s0 = sg * SB;
  const int fcount = min(FB, F - f0), scount = min(SB, tile - s0);
  const int cells = SB * FB * B;
  using Sum = typename std::conditional<kQuant, int, unsigned long long>::type;
  Sum* sum_g = reinterpret_cast<Sum*>(smem);
  Sum* sum_h = sum_g + cells;
  int* cnt = reinterpret_cast<int*>(sum_h + cells);
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    sum_g[i] = 0;
    sum_h[i] = 0;
    cnt[i] = 0;
  }
  double scale_g = 0.0, scale_h = 0.0;
  if constexpr (!kQuant) {
    scale_g = ldexp(1.0, fixed_shift(absmax[0], row_bits));
    scale_h = ldexp(1.0, fixed_shift(absmax[1], row_bits));
  }
  __syncthreads();

  const int64_t r0 = (int64_t)blockIdx.x * rows_per_chunk;
  const int64_t r1 = (r0 + rows_per_chunk < n) ? r0 + rows_per_chunk : n;
  for (int64_t r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    if (!mask[r]) continue;
    const int s = slot[r] - leaf_base - s0;
    if (s < 0 || s >= scount) continue;
    Sum vg, vh;
    if constexpr (kQuant) {
      vg = (Sum)static_cast<const int8_t*>(gp)[r];
      vh = (Sum)static_cast<const int8_t*>(hp)[r];
    } else {
      vg = (Sum)__double2ll_rn((double)static_cast<const float*>(gp)[r] * scale_g);
      vh = (Sum)__double2ll_rn((double)static_cast<const float*>(hp)[r] * scale_h);
    }
    const int16_t* brow = bins + r * F + f0;
    const int base = s * FB * B;
    for (int fl = 0; fl < fcount; ++fl) {
      const int b = brow[fl];
      if ((unsigned)b >= (unsigned)B) continue;
      const int c = base + fl * B + b;
      atomicAdd(&sum_g[c], vg);
      atomicAdd(&sum_h[c], vh);
      atomicAdd(&cnt[c], 1);
    }
  }
  __syncthreads();

  // flush this block's partial: integer atomics, so the order is irrelevant
  const int fb_cells = fcount * B;
  const int64_t FBg = (int64_t)F * B;
  for (int i = threadIdx.x; i < scount * fb_cells; i += blockDim.x) {
    const int sl = i / fb_cells, rem = i % fb_cells;
    const int fl = rem / B, b = rem % B;
    const int c = (sl * FB + fl) * B + b;
    if (cnt[c] == 0) continue;  // no row landed here: all three sums are 0
    const int64_t cell = (int64_t)(f0 + fl) * B + b;
    const int64_t sidx = s0 + sl;
    if constexpr (kQuant) {
      atomicAdd(&acc32[(sidx * 3 + 0) * FBg + cell], (int)sum_g[c]);
      atomicAdd(&acc32[(sidx * 3 + 1) * FBg + cell], (int)sum_h[c]);
      atomicAdd(&acc32[(sidx * 3 + 2) * FBg + cell], cnt[c]);
    } else {
      atomicAdd(&acc64[(sidx * 2 + 0) * FBg + cell], (unsigned long long)sum_g[c]);
      atomicAdd(&acc64[(sidx * 2 + 1) * FBg + cell], (unsigned long long)sum_h[c]);
      atomicAdd(&acc32[sidx * FBg + cell], cnt[c]);
    }
  }
}

// fixed point -> f32, and the count channel -> f32: out (tile, 3, F, B)
__global__ void __launch_bounds__(kThreads)
finalize_kernel(const unsigned long long* __restrict__ acc64,
                const int* __restrict__ acc32, const unsigned int* __restrict__ absmax,
                int row_bits, int64_t tile, int64_t FBg, float* __restrict__ out) {
  const double inv_g = ldexp(1.0, -fixed_shift(absmax[0], row_bits));
  const double inv_h = ldexp(1.0, -fixed_shift(absmax[1], row_bits));
  const int64_t total = tile * FBg;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int64_t s = i / FBg, cell = i % FBg;
    const long long g = (long long)acc64[(s * 2 + 0) * FBg + cell];
    const long long h = (long long)acc64[(s * 2 + 1) * FBg + cell];
    out[(s * 3 + 0) * FBg + cell] = (float)((double)g * inv_g);
    out[(s * 3 + 1) * FBg + cell] = (float)((double)h * inv_h);
    out[(s * 3 + 2) * FBg + cell] = (float)acc32[i];
  }
}

struct Plan {
  int FB, SB, n_fgroups, n_sgroups;
  int64_t rows_per_chunk, row_chunks;
  size_t smem;
};

// Largest (slot group x feature group) block that fits the card's shared
// memory, balanced over the groups; enough row chunks for ~2 blocks per SM.
cudaError_t make_plan(int64_t n, int F, int tile, int B, int cell_bytes, Plan* p) {
  int dev = 0, smem_max = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int64_t pairs = (int64_t)smem_max / ((int64_t)B * cell_bytes);
  if (pairs < 1) return cudaErrorInvalidValue;  // one (slot, feature) row does not fit
  const int sb_max = (int)(pairs < tile ? pairs : tile);
  int fb_max = (int)(pairs / sb_max);
  if (fb_max > F) fb_max = F;
  p->n_sgroups = (tile + sb_max - 1) / sb_max;
  p->SB = (tile + p->n_sgroups - 1) / p->n_sgroups;
  p->n_fgroups = (F + fb_max - 1) / fb_max;
  p->FB = (F + p->n_fgroups - 1) / p->n_fgroups;
  const int64_t groups = (int64_t)p->n_fgroups * p->n_sgroups;
  int64_t chunks = (2 * (int64_t)sms + groups - 1) / groups;
  const int64_t max_chunks = (n + kThreads - 1) / kThreads;
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  p->rows_per_chunk = (n + chunks - 1) / chunks;
  p->row_chunks = (n + p->rows_per_chunk - 1) / p->rows_per_chunk;
  p->smem = (size_t)p->SB * p->FB * B * cell_bytes;
  return cudaSuccess;
}

template <bool kQuant>
cudaError_t launch_hist(const void* bins, const void* g, const void* h, const void* mask,
                        const void* slot, int64_t n, int F, int leaf_base, int tile, int B,
                        const unsigned int* absmax, int row_bits, unsigned long long* acc64,
                        int* acc32, cudaStream_t stream) {
  Plan p;
  cudaError_t e = make_plan(n, F, tile, B, kQuant ? 12 : 20, &p);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(hist_kernel<kQuant>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)p.smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)p.row_chunks, (unsigned)(p.n_fgroups * p.n_sgroups));
  hist_kernel<kQuant><<<grid, kThreads, p.smem, stream>>>(
      static_cast<const int16_t*>(bins), g, h, static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(slot), n, F, leaf_base, tile, B, p.rows_per_chunk, p.FB,
      p.SB, p.n_fgroups, absmax, row_bits, acc64, acc32);
  return cudaGetLastError();
}

int grid_for(int64_t total) {
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

extern "C" {

// Float histogram.  absmax (2 x u32), acc64 (tile, 2, F, B) and acc32
// (tile, F, B) must be zeroed by the caller; out is (tile, 3, F, B) f32.
// Returns a cudaError_t (0 = success).
int lgbt_hist_multi_f32(const void* bins, const void* grad, const void* hess,
                        const void* mask, const void* slot, long long n, int F,
                        int leaf_base, int tile, int B, int row_bits, void* absmax,
                        void* acc64, void* acc32, void* out, void* stream) {
  if (n <= 0 || F <= 0 || tile <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned int* am = static_cast<unsigned int*>(absmax);
  absmax_kernel<<<grid_for(n), kThreads, 0, st>>>(static_cast<const float*>(grad),
                                                  static_cast<const float*>(hess), n, am);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = launch_hist<false>(bins, grad, hess, mask, slot, n, F, leaf_base, tile, B, am, row_bits,
                         static_cast<unsigned long long*>(acc64), static_cast<int*>(acc32), st);
  if (e != cudaSuccess) return (int)e;
  const int64_t FBg = (int64_t)F * B;
  finalize_kernel<<<grid_for(tile * FBg), kThreads, 0, st>>>(
      static_cast<const unsigned long long*>(acc64), static_cast<const int*>(acc32), am,
      row_bits, tile, FBg, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// int8 histogram: out (tile, 3, F, B) int32, zeroed by the caller.
int lgbt_hist_multi_i8(const void* bins, const void* grad_q, const void* hess_q,
                       const void* mask, const void* slot, long long n, int F,
                       int leaf_base, int tile, int B, void* out, void* stream) {
  if (n <= 0 || F <= 0 || tile <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  return (int)launch_hist<true>(bins, grad_q, hess_q, mask, slot, n, F, leaf_base, tile, B,
                                nullptr, 0, nullptr, static_cast<int*>(out),
                                static_cast<cudaStream_t>(stream));
}

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
