// Device code of the multi-leaf histogram, shared by hist.cu (the
// histogram kernel proper) and round.cu (the round megakernel's window
// pass).  hist.cu's source note says what bounds it and why the sums are
// 64-bit fixed point; this header only holds the pieces both use.
//
// Two row sources, one accumulator:
//   direct  (kGather = false)  rows 0..n-1 of the (N, F) bin matrix, each
//           row's slot from leaf_slot[r] - leaf_base;
//   gather  (kGather = true)   slot s's rows are order[win_start[s] + i] for
//           i in [0, win_cnt[s]): the small-child windows of a round, read
//           through the partitioned row order without copying them.  Each
//           block serves one slot (SB = 1), so it only touches its slot's
//           rows.
// Both accumulate per block in shared memory and flush with integer
// atomics, so the sums do not depend on the order of rows or blocks: a
// window histogrammed here equals, bit for bit, the same rows gathered into
// a matrix and histogrammed directly with the same fixed-point exponents.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace lgbt {

constexpr int kThreads = 1024;

__device__ __forceinline__ int fixed_shift(unsigned int absmax_bits, int row_bits) {
  int e = 0;
  frexpf(__uint_as_float(absmax_bits), &e);  // max = mant * 2^e, mant in [0.5, 1)
  return 62 - row_bits - e;
}

// Fixed-point exponents of grad and hess: derived on the device from max |v|
// over the call's rows (absmax != nullptr), or given by the caller.
struct Shift {
  const unsigned int* absmax;
  int row_bits;
  int sg, sh;
};

__device__ __forceinline__ void shifts_of(const Shift& s, int* g, int* h) {
  if (s.absmax != nullptr) {
    *g = fixed_shift(s.absmax[0], s.row_bits);
    *h = fixed_shift(s.absmax[1], s.row_bits);
  } else {
    *g = s.sg;
    *h = s.sh;
  }
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

// One block: a chunk of rows x one (slot group, feature group).  kQuant
// selects the int8 payload (int32 sums) over the float one (64-bit
// fixed-point sums); kGather the window row source (see the top).
template <bool kQuant, bool kGather>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const int16_t* __restrict__ bins, const void* __restrict__ gp,
            const void* __restrict__ hp, const uint8_t* __restrict__ mask,
            const int32_t* __restrict__ slot, const int32_t* __restrict__ order,
            const int32_t* __restrict__ win_start, const int32_t* __restrict__ win_cnt,
            int64_t n, int F, int leaf_base, int tile, int B, int64_t rows_per_chunk,
            int FB, int SB, int n_fgroups, Shift shift,
            unsigned long long* __restrict__ acc64, int* __restrict__ acc32) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int fg = blockIdx.y % n_fgroups;
  const int sg = blockIdx.y / n_fgroups;
  const int f0 = fg * FB, s0 = sg * SB;
  const int fcount = min(FB, F - f0), scount = min(SB, tile - s0);
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_chunk;
  int64_t r1;
  int64_t wbase = 0;
  if constexpr (kGather) {
    // SB == 1: this block's rows are window positions [r0, r1) of slot s0
    const int64_t wcnt = win_cnt[s0];
    if (r0 >= wcnt) return;  // the whole block leaves: no barrier is skipped
    r1 = (r0 + rows_per_chunk < wcnt) ? r0 + rows_per_chunk : wcnt;
    wbase = win_start[s0];
  } else {
    r1 = (r0 + rows_per_chunk < n) ? r0 + rows_per_chunk : n;
  }
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
    int eg, eh;
    shifts_of(shift, &eg, &eh);
    scale_g = ldexp(1.0, eg);
    scale_h = ldexp(1.0, eh);
  }
  __syncthreads();

  for (int64_t i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
    int64_t r;
    int s;
    if constexpr (kGather) {
      r = order[wbase + i];
      s = 0;
    } else {
      r = i;
      s = slot[r] - leaf_base - s0;
      if (s < 0 || s >= scount) continue;
    }
    if (!mask[r]) continue;
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

struct Plan {
  int FB, SB, n_fgroups, n_sgroups;
  int64_t rows_per_chunk, row_chunks;
  size_t smem;
};

// Largest (slot group x feature group) block that fits the card's shared
// memory, balanced over the groups.  Direct rows: enough row chunks for ~2
// blocks per SM.  Window rows (one_slot): one slot a block, and chunks of
// a fixed row count over the largest window a slot can hold (n); blocks
// past their slot's window leave at once.
inline cudaError_t make_plan(int64_t n, int F, int tile, int B, int cell_bytes, bool one_slot,
                             Plan* p) {
  int dev = 0, smem_max = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int64_t pairs = (int64_t)smem_max / ((int64_t)B * cell_bytes);
  if (pairs < 1) return cudaErrorInvalidValue;  // one (slot, feature) row does not fit
  const int sb_max = one_slot ? 1 : (int)(pairs < tile ? pairs : tile);
  int fb_max = (int)(pairs / sb_max);
  if (fb_max > F) fb_max = F;
  p->n_sgroups = (tile + sb_max - 1) / sb_max;
  p->SB = (tile + p->n_sgroups - 1) / p->n_sgroups;
  p->n_fgroups = (F + fb_max - 1) / fb_max;
  p->FB = (F + p->n_fgroups - 1) / p->n_fgroups;
  if (one_slot) {
    p->rows_per_chunk = 4 * (int64_t)kThreads;
  } else {
    const int64_t groups = (int64_t)p->n_fgroups * p->n_sgroups;
    int64_t chunks = (2 * (int64_t)sms + groups - 1) / groups;
    const int64_t max_chunks = (n + kThreads - 1) / kThreads;
    if (chunks > max_chunks) chunks = max_chunks;
    if (chunks < 1) chunks = 1;
    p->rows_per_chunk = (n + chunks - 1) / chunks;
  }
  p->row_chunks = (n + p->rows_per_chunk - 1) / p->rows_per_chunk;
  if (p->row_chunks < 1) p->row_chunks = 1;
  p->smem = (size_t)p->SB * p->FB * B * cell_bytes;
  return cudaSuccess;
}

inline int grid_for(int64_t total) {
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace lgbt
