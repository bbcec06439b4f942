// Device code of the multi-leaf histogram, shared by hist.cu (the
// histogram kernel proper) and round.cu (the round megakernel's window
// pass).  hist.cu's source note says what bounds it and why the sums are
// 64-bit fixed point; this header holds the pieces both use.
//
// Two row sources, one accumulator:
//   direct  (kGather = false)  rows 0..n-1 of the (N, F) bin matrix, each
//           row's slot from leaf_slot[r] - leaf_base;
//   gather  (kGather = true)   the round's windows laid end to end in a
//           flat space of positions, as ops/hist_cuda.py::window_rows lays
//           them: position p of slot s is row order[win_start[s] + p -
//           off[s]], off the prefix of win_cnt, and positions past W are
//           dropped.  The small-child windows are read through the
//           partitioned row order without copying them (B3's window pass,
//           round.cu, and B1's window mode, hist.cu).
// Both accumulate per block in shared memory and flush with integer
// atomics, so the sums do not depend on the order of rows or blocks: a
// window histogrammed here equals, bit for bit, the same rows gathered into
// a matrix and histogrammed directly with the same fixed-point exponents.
//
// Three payloads: float (grad and hess f32), bf16 (the same values rounded
// to bfloat16 by the caller, read as 2 bytes each and widened exactly to
// f32, then summed in the same fixed point: the JAX package's
// hist_precision=bf16) and int8 (exact int32 sums).
//
// Work layout.  The work is a flat space of (group, position) units, a
// group being a (slot group, feature group) of the plan, or a feature group
// in gather mode.  The grid is one wave of resident blocks (or fewer for a
// small call), and block b takes the b-th equal range of that space, so no
// block is empty and every block ends together.  Where its range crosses a
// group boundary, or in gather mode a window boundary, the block flushes
// the cells it holds and goes on.
//
// Accumulator.  A float cell holds its 64-bit fixed-point sum as two
// 32-bit words: the low word takes the value's low 32 bits as an unsigned
// atomicAdd, which returns the old word, and the signed high word takes
// value >> 32 plus a carry when that add wrapped.  Hopper has native 32-bit
// shared atomics but no 64-bit shared add (it loops on a compare-and-swap),
// so a (row, feature) costs five native adds (two words of grad, two of
// hess, the count).  Integer addition is exact and order-free, so the flush
// recombines (hi << 32) + lo into the same integer as one 64-bit sum.  The
// int8 payload sums in plain int32 words.
//
// Rows.  A warp takes 32 consecutive positions at a time: each lane reads
// one position's row id, mask, slot and payload (coalesced where the
// positions are), a ballot keeps the rows that contribute, and the warp then
// walks the (row, feature) pairs of those rows 32 at a time, each lane
// reading one int16 bin (a warp reads a row's feature group as one or two
// contiguous requests) after __shfl_sync hands it the row's values.  The
// bin loads of kLookahead pair steps are in flight before their atomics
// issue.  Bins of neighbouring features sit an odd stride (B | 1) apart, so
// a warp's lanes at the same bin of different features fall on different
// banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace lgbt {

constexpr int kThreads = 1024;
constexpr int kLookahead = 4;  // pair steps whose bin loads are in flight together

__device__ __forceinline__ int fixed_shift(unsigned int absmax_bits, int row_bits) {
  int e = 0;
  frexpf(__uint_as_float(absmax_bits), &e);  // max = mant * 2^e, mant in [0.5, 1)
  return 62 - row_bits - e;
}

// Fixed-point exponents of grad and hess: derived on the device from max |v|
// over the call's rows (absmax != nullptr), or given by the caller as an
// int32[2] in device memory (given), so a captured CUDA graph reads each
// tree's exponents when it replays instead of baking in the first tree's.
struct Shift {
  const unsigned int* absmax;
  int row_bits;
  const int* given;
};

__device__ __forceinline__ void shifts_of(const Shift& s, int* g, int* h) {
  if (s.absmax != nullptr) {
    *g = fixed_shift(s.absmax[0], s.row_bits);
    *h = fixed_shift(s.absmax[1], s.row_bits);
  } else {
    *g = s.given[0];
    *h = s.given[1];
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class T>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ g, const T* __restrict__ h,
              int64_t n, unsigned int* __restrict__ out) {
  unsigned int mg = 0, mh = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    // |x| as bits orders like |x| itself for non-negative floats
    mg = max(mg, __float_as_uint(fabsf(to_f32(g[i]))));
    mh = max(mh, __float_as_uint(fabsf(to_f32(h[i]))));
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

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// Stride between neighbouring features' bins in shared memory: odd, so the
// same bin of consecutive features lands on consecutive banks.
__host__ __device__ __forceinline__ int bin_stride(int B) { return B | 1; }

// Position of the n-th (from 0) set bit of m; needs n < popc(m).
__device__ __forceinline__ int nth_set_bit(unsigned m, int n) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (n >= c) {
      n -= c;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// v into a (lo, hi) split-word cell: native 32-bit atomics only.
__device__ __forceinline__ void add_split(unsigned* lo, int* hi, long long v) {
  const unsigned l = (unsigned)(unsigned long long)v;
  const unsigned old = atomicAdd(lo, l);
  const int h = (int)(v >> 32) + (old + l < old ? 1 : 0);  // carry out of the low word
  if (h != 0) atomicAdd(hi, h);
}

__device__ __forceinline__ unsigned long long join_split(unsigned lo, int hi) {
  return ((unsigned long long)(unsigned)hi << 32) | lo;
}

struct HistArgs {
  const int16_t* bins;
  const void* g;  // float, bf16 or int8 payloads
  const void* h;
  const uint8_t* mask;
  const int32_t* slot;       // direct mode
  const int32_t* order;      // gather mode
  const int32_t* win_start;  // gather mode (tile,)
  const int32_t* win_cnt;    // gather mode (tile,)
  int64_t n;                 // rows (direct) or the window bound W (gather)
  int F, leaf_base, tile, B;
  int FB, SB, n_fgroups, n_sgroups;
  Shift shift;
  unsigned long long* acc64;  // float: (tile, 2, F, B) fixed-point sums
  int* acc32;                 // float: (tile, F, B) counts; int8: (tile, 3, F, B)
  // lane mode (kLanes): lane blockIdx.y's position p reads row rows[p] of
  // the shared bins, its slot from slot[p], and that lane's payloads, mask,
  // exponent pair and accumulators; rows, slot are (lanes, n), the payloads
  // and mask (lanes, lane_rows), shift.given (lanes, 2)
  const int32_t* rows;
  int64_t lane_rows;
};

// Shared words of one cell: lo_g, hi_g, lo_h, hi_h, count (float) or g, h,
// count (int8), each an array of SB * FB * bin_stride(B) words.
template <bool kQuant>
struct Cells {
  static constexpr int kWords = kQuant ? 3 : 5;
  static constexpr int kBytes = kWords * 4;
};

// kBf16: the float path reading __nv_bfloat16 payloads (kQuant false).
// kLanes: the direct mode over a lane axis (gridDim.y lanes, HistArgs'
// lane fields): each block moves its pointers to its lane's slices, so a
// block's shared footprint is the solo call's and every lane keeps its
// own exponents
template <bool kQuant, bool kGather, bool kBf16 = false, bool kLanes = false>
__global__ void __launch_bounds__(kThreads) hist_kernel(HistArgs a) {
  static_assert(!(kQuant && kBf16), "bf16 is a float payload");
  static_assert(!(kGather && kLanes), "lanes read rows through their own row ids");
  if constexpr (kLanes) {
    const int64_t lane = blockIdx.y;
    const int64_t pay = kQuant ? 1 : (kBf16 ? 2 : 4);
    const int64_t FBg = (int64_t)a.F * a.B;
    a.g = static_cast<const unsigned char*>(a.g) + lane * a.lane_rows * pay;
    a.h = static_cast<const unsigned char*>(a.h) + lane * a.lane_rows * pay;
    a.mask += lane * a.lane_rows;
    a.rows += lane * a.n;
    a.slot += lane * a.n;
    if (a.shift.given != nullptr) a.shift.given += 2 * lane;
    if (a.acc64 != nullptr) a.acc64 += lane * a.tile * 2 * FBg;
    a.acc32 += lane * a.tile * (kQuant ? 3 : 1) * FBg;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kWords = Cells<kQuant>::kWords;
  const int Bs = bin_stride(a.B);
  const int cells = a.SB * a.FB * Bs;
  unsigned* w = reinterpret_cast<unsigned*>(smem);
  int* off = reinterpret_cast<int*>(w + kWords * cells);  // gather: tile + 1 offsets
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  int64_t span;  // positions per group
  int64_t groups;
  if constexpr (kGather) {
    if (threadIdx.x == 0) {
      int o = 0;
      off[0] = 0;
      for (int s = 0; s < a.tile; ++s) {
        o += a.win_cnt[s];
        off[s + 1] = o;
      }
    }
    __syncthreads();
    span = min64(off[a.tile], a.n);  // window_rows drops positions past W
    groups = a.n_fgroups;
  } else {
    span = a.n;
    groups = (int64_t)a.n_fgroups * a.n_sgroups;
  }
  const int64_t units = span * groups;
  const int64_t per = (units + gridDim.x - 1) / gridDim.x;
  const int64_t u0 = (int64_t)blockIdx.x * per;
  const int64_t u1 = min64(units, u0 + per);
  if (u0 >= u1) return;  // the whole block leaves: no barrier is skipped

  for (int i = threadIdx.x; i < kWords * cells; i += kThreads) w[i] = 0;
  double scale_g = 0.0, scale_h = 0.0;
  if constexpr (!kQuant) {
    int eg, eh;
    shifts_of(a.shift, &eg, &eh);
    scale_g = ldexp(1.0, eg);
    scale_h = ldexp(1.0, eh);
  }
  __syncthreads();

  for (int64_t u = u0; u < u1;) {
    const int64_t grp = u / span;
    const int64_t p = u - grp * span;
    int64_t q = min64(span, p + (u1 - u));  // this segment: positions [p, q)
    const int fg = (int)(grp % a.n_fgroups);
    int s0, scount;
    int64_t wbase = 0;
    if constexpr (kGather) {
      int s = 0;
      while (off[s + 1] <= p) ++s;  // empty windows are skipped
      q = min64(q, off[s + 1]);
      wbase = (int64_t)a.win_start[s] - off[s];
      s0 = s;
      scount = 1;
    } else {
      s0 = (int)(grp / a.n_fgroups) * a.SB;
      scount = min(a.SB, a.tile - s0);
    }
    const int f0 = fg * a.FB;
    const int fcount = min(a.FB, a.F - f0);
    // pair k = i * fcount + fl of a warp's taken rows: lane l starts at
    // pair l and steps by 32
    const int di = 32 / fcount, dfl = 32 % fcount;
    const int i_first = lane / fcount, fl_first = lane % fcount;

    for (int64_t pb = p + (int64_t)warp * 32; pb < q; pb += kThreads) {
      const int64_t pos = pb + lane;
      bool take = pos < q;
      int r = 0, base = 0;
      uint32_t gv = 0, hv = 0;  // payload bits (float) or int8 values
      if (take) {
        if constexpr (kGather) {
          r = a.order[wbase + pos];
        } else {
          r = kLanes ? a.rows[pos] : (int)pos;
          const int sl = a.slot[pos] - a.leaf_base - s0;
          take = sl >= 0 && sl < scount;
          base = sl * a.FB * Bs;
        }
        take = take && a.mask[r];
        if (take) {
          if constexpr (kQuant) {
            gv = (uint32_t)(int)static_cast<const int8_t*>(a.g)[r];
            hv = (uint32_t)(int)static_cast<const int8_t*>(a.h)[r];
          } else if constexpr (kBf16) {
            gv = __float_as_uint(__bfloat162float(static_cast<const __nv_bfloat16*>(a.g)[r]));
            hv = __float_as_uint(__bfloat162float(static_cast<const __nv_bfloat16*>(a.h)[r]));
          } else {
            gv = __float_as_uint(static_cast<const float*>(a.g)[r]);
            hv = __float_as_uint(static_cast<const float*>(a.h)[r]);
          }
        }
      }
      const unsigned act = __ballot_sync(0xffffffffu, take);
      const int nact = __popc(act);
      if (nact == 0) continue;
      // compact: lane j holds the j-th taken row
      const int src = lane < nact ? nth_set_bit(act, lane) : 0;
      const int rc = __shfl_sync(0xffffffffu, r, src);
      const int bc = __shfl_sync(0xffffffffu, base, src);
      const uint32_t gc = __shfl_sync(0xffffffffu, gv, src);
      const uint32_t hc = __shfl_sync(0xffffffffu, hv, src);

      const int steps = (nact * fcount + 31) >> 5;
      int i = i_first, fl = fl_first;
      for (int t = 0; t < steps; t += kLookahead) {
        int cell[kLookahead], bin[kLookahead];
        uint32_t pg[kLookahead], ph[kLookahead];
#pragma unroll
        for (int k = 0; k < kLookahead; ++k) {
          const int from = i < 31 ? i : 31;
          const int rr = __shfl_sync(0xffffffffu, rc, from);
          cell[k] = __shfl_sync(0xffffffffu, bc, from) + fl * Bs;
          pg[k] = __shfl_sync(0xffffffffu, gc, from);
          ph[k] = __shfl_sync(0xffffffffu, hc, from);
          bin[k] = i < nact ? (int)a.bins[(int64_t)rr * a.F + f0 + fl] : -1;
          i += di;
          fl += dfl;
          if (fl >= fcount) {
            fl -= fcount;
            ++i;
          }
        }
#pragma unroll
        for (int k = 0; k < kLookahead; ++k) {
          if ((unsigned)bin[k] >= (unsigned)a.B) continue;
          const int c = cell[k] + bin[k];
          if constexpr (kQuant) {
            atomicAdd((int*)&w[c], (int)pg[k]);
            atomicAdd((int*)&w[cells + c], (int)ph[k]);
            atomicAdd(&w[2 * cells + c], 1u);
          } else {
            add_split(&w[c], (int*)&w[cells + c],
                      __double2ll_rn((double)__uint_as_float(pg[k]) * scale_g));
            add_split(&w[2 * cells + c], (int*)&w[3 * cells + c],
                      __double2ll_rn((double)__uint_as_float(ph[k]) * scale_h));
            atomicAdd(&w[4 * cells + c], 1u);
          }
        }
      }
    }
    __syncthreads();

    // flush this segment's cells into the global sums and zero them:
    // integer atomics, so the order is irrelevant
    const int fb_cells = fcount * a.B;
    const int64_t FBg = (int64_t)a.F * a.B;
    for (int x = threadIdx.x; x < scount * fb_cells; x += kThreads) {
      const int sl = x / fb_cells, rem = x - sl * fb_cells;
      const int fl = rem / a.B, b = rem - fl * a.B;
      const int c = (sl * a.FB + fl) * Bs + b;
      const unsigned cnt = w[(kWords - 1) * cells + c];
      if (cnt == 0) continue;  // no row landed here: every word is 0
      const int64_t cell = (int64_t)(f0 + fl) * a.B + b;
      const int64_t sidx = s0 + sl;
      if constexpr (kQuant) {
        atomicAdd(&a.acc32[(sidx * 3 + 0) * FBg + cell], (int)w[c]);
        atomicAdd(&a.acc32[(sidx * 3 + 1) * FBg + cell], (int)w[cells + c]);
        atomicAdd(&a.acc32[(sidx * 3 + 2) * FBg + cell], (int)cnt);
        w[c] = 0;
        w[cells + c] = 0;
      } else {
        atomicAdd(&a.acc64[(sidx * 2 + 0) * FBg + cell], join_split(w[c], (int)w[cells + c]));
        atomicAdd(&a.acc64[(sidx * 2 + 1) * FBg + cell],
                  join_split(w[2 * cells + c], (int)w[3 * cells + c]));
        atomicAdd(&a.acc32[sidx * FBg + cell], (int)cnt);
        w[c] = 0;
        w[cells + c] = 0;
        w[2 * cells + c] = 0;
        w[3 * cells + c] = 0;
      }
      w[(kWords - 1) * cells + c] = 0;
    }
    __syncthreads();
    u += q - p;
  }
}

struct Plan {
  int FB, SB, n_fgroups, n_sgroups;
  size_t smem;
  int blocks;
};

// Shared-memory plan and grid of one hist_kernel launch.  A (slot,
// feature) pair costs bin_stride(B) cells; of the splits (SB slots x FB
// features) that fit the card's shared memory (less the kernel's static
// shared memory), the one that reads the fewest bytes a row: every (slot
// group, feature group) re-reads each row's slot and mask (5 B), and each
// feature group reads the row's FB bins in 32-B sectors.  Gather mode
// (one_slot) holds one slot a block.  The grid is one wave of resident
// blocks (blocks per SM from the occupancy API at the plan's shared
// memory), or fewer where the call has under kThreads units a block;
// units_max bounds the positions per group (rows, or W).
//
// Everything but the grid depends only on (kernel, device, F, tile, B, the
// cell size, one_slot, extra shared memory), so it is worked out once per
// such key and kept in a host table: a launch then costs one cudaGetDevice
// and a table lookup instead of the device queries, the attribute set and
// the occupancy query (the small calls' fixed cost, PERF.md A29).
struct PlanShape {
  int FB, SB, n_fgroups, n_sgroups;
  size_t smem;
  int64_t resident;  // blocks of the card resident at once at that shared memory
};

using PlanKey = std::tuple<const void*, int, int, int, int, int, bool, size_t>;

inline std::mutex& plan_mutex() {
  static std::mutex m;
  return m;
}

inline std::map<PlanKey, PlanShape>& plan_table() {
  static std::map<PlanKey, PlanShape> t;
  return t;
}

template <class Kernel>
inline cudaError_t plan_shape(Kernel kernel, int dev, int F, int tile, int B, int cell_bytes,
                              bool one_slot, size_t extra_smem, PlanShape* p) {
  int smem_max = 0, sms = 0;
  cudaError_t e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  const int64_t pair_bytes = (int64_t)bin_stride(B) * cell_bytes;
  const int64_t pairs =
      ((int64_t)smem_max - (int64_t)fa.sharedSizeBytes - (int64_t)extra_smem) / pair_bytes;
  if (pairs < 1) return cudaErrorInvalidValue;  // one (slot, feature) row does not fit
  const int sb_max = one_slot ? 1 : (int)(pairs < tile ? pairs : tile);
  int64_t best = -1;
  for (int sb = 1; sb <= sb_max; ++sb) {
    int fb_max = (int)(pairs / sb);
    if (fb_max > F) fb_max = F;
    const int n_sg = (tile + sb - 1) / sb;
    const int n_fg = (F + fb_max - 1) / fb_max;
    const int fb = (F + n_fg - 1) / n_fg;
    const int64_t row_bytes = (int64_t)n_fg * (n_sg * 5 + 32 * ((2 * fb + 31) / 32 + 1));
    if (best < 0 || row_bytes < best) {
      best = row_bytes;
      p->n_sgroups = n_sg;
      p->SB = (tile + n_sg - 1) / n_sg;
      p->n_fgroups = n_fg;
      p->FB = fb;
    }
  }
  p->smem = (size_t)p->SB * p->FB * pair_bytes + extra_smem;
  // the kernel's ceiling, not this plan's size: every key of the kernel
  // shares the attribute, and a smaller ceiling would refuse an earlier
  // key's launches
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_max - (int)fa.sharedSizeBytes);
  if (e != cudaSuccess) return e;
  int occ = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, p->smem);
  if (e != cudaSuccess) return e;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  p->resident = (int64_t)sms * occ;
  return cudaSuccess;
}

template <class Kernel>
inline cudaError_t make_plan(Kernel kernel, int64_t units_max, int F, int tile, int B,
                             int cell_bytes, bool one_slot, size_t extra_smem, Plan* p) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const PlanKey key{reinterpret_cast<const void*>(kernel), dev, F, tile, B, cell_bytes,
                    one_slot, extra_smem};
  PlanShape s;
  {
    std::lock_guard<std::mutex> lock(plan_mutex());
    auto it = plan_table().find(key);
    if (it == plan_table().end()) {
      e = plan_shape(kernel, dev, F, tile, B, cell_bytes, one_slot, extra_smem, &s);
      if (e != cudaSuccess) return e;
      plan_table().emplace(key, s);
    } else {
      s = it->second;
    }
  }
  p->FB = s.FB;
  p->SB = s.SB;
  p->n_fgroups = s.n_fgroups;
  p->n_sgroups = s.n_sgroups;
  p->smem = s.smem;
  const int64_t wave = s.resident;  // one wave of resident blocks
  const int64_t units = units_max * s.n_fgroups * (one_slot ? 1 : s.n_sgroups);
  const int64_t wanted = (units + kThreads - 1) / kThreads;
  p->blocks = (int)(wanted < 1 ? 1 : (wanted < wave ? wanted : wave));
  return cudaSuccess;
}

inline int grid_for(int64_t total) {
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace lgbt
