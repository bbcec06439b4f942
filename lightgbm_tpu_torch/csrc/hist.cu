// Multi-leaf histogram kernel for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/ops/hist_pallas.py::_direct_kernel, the one Pallas
// kernel on the main training path.  For a tile of leaf slots it computes, in
// one pass over the rows, per (slot, channel, feature, bin):
//   float:  sum of grad, sum of hess and the row count of the rows whose
//           mask is set and whose slot (leaf_slot - leaf_base) lies in
//           [0, tile);
//   bf16:   the float sums of grad and hess rounded to bfloat16 (the JAX
//           package's hist_precision=bf16, ops/hist_pallas.py's rounded
//           3-lane payload), read as 2 bytes each;
//   int8:   the same sums of the int8-quantized grad_q / hess_q, exact in
//           int32.
// Output layout (tile, 3, F, B), channels (grad, hess, count) -- the JAX
// package's channel-first layout, so the two packages compare like for like.
//
// What bounds it on an H100.  The function must read mask and slot of
// every row (5 bytes) to learn which rows contribute, then only the
// contributing rows' bins (F * 2 bytes of int16) and grad and hess (4 bytes
// each in float, 2 in bf16, 1 in int8), in the 32-byte sectors those scattered rows
// touch, and write the histogram once.  At N = 1M, F = 28 with a third of
// the rows in the tile that is ~40 MB, ~12 us at 3.35 TB/s; the Epsilon
// root pass (N = 400k, F = 2000, every row) reads 1.6 GB of bins, ~0.48 ms.
// Its work is one shared-memory atomic per contributing row, feature and
// 32-bit word (five in float, three in int8), so it is bound on the card by
// shared-memory atomic throughput, not by arithmetic or bytes.
// chip_smoke.py measures it against that bound on the card (PERF.md).
//
// Design.
// * Bins are read in the package's row-major (N, F) int16 layout: a warp
//   reads the contiguous features of its group for one row in one or two
//   requests, so a row's bytes come from one or two cache lines.  No
//   feature-major copy is needed (the JAX package keeps one for its column
//   reads; the port's partition reads a single gathered column per row).
// * Each block owns a private accumulator in shared memory for
//   (slots of its slot group) x (features of its feature group) x B bins.
//   A (slot, feature) pair costs B * 20 bytes in float (a 64-bit sum of
//   grad and of hess, each kept as two 32-bit words, and a 32-bit count) and
//   B * 12 bytes in int8, so at B = 255 a block holds ~45 float pairs or ~75
//   int8 pairs in its 227 KB: features are split into groups, and slots too
//   when one feature's slots do not fit; make_plan picks the split that
//   reads the fewest bytes a row.  The TPU kernel's accumulator carried
//   across a sequential row grid has no counterpart here (blocks run in no
//   order): the grid is one wave of resident blocks, each taking an equal
//   range of the (group, row) space, and each adds its partial into the
//   global result with integer atomics when its range leaves a group
//   (hist_common.cuh says how the rows are read and added).
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
// Two further modes (ops/hist_cuda.py):
// * lanes (the booster fleet's window pass, the TPU kernel under
//   jax.vmap): the grid gains a lane axis (blockIdx.y), each lane reading
//   the shared bins through its own row ids (no (W, F) copy a lane), with
//   its own payloads, mask and exponent pair, so each lane's slice equals
//   its solo call bit for bit and each block's shared footprint is the
//   solo one's;
// * carried (the out-of-core spill grower's chunk sweep): each call adds a
//   chunk's rows into accumulators the caller keeps across calls, and the
//   f32 conversion runs once, after the last chunk: integer sums are
//   order-free, so any chunking gives the in-memory call's bits.
//
// * The exponent may also be given (shift, an int32[2] in device memory):
//   the windowed grower fixes it once per tree from all N rows, so a
//   histogram of a window of
//   rows, here or in the round megakernel (round.cu, which shares this
//   device code through hist_common.cuh), rounds exactly as the full-N
//   pass of the rounds grower would.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//             -shared -Xcompiler -fPIC (ops/cuda_build.py does this).

#include "hist_common.cuh"

namespace {

using lgbt::kThreads;
using lgbt::Plan;
using lgbt::Shift;

// fixed point -> f32, and the count channel -> f32: out (tile, 3, F, B)
__global__ void __launch_bounds__(kThreads)
finalize_kernel(const unsigned long long* __restrict__ acc64,
                const int* __restrict__ acc32, Shift shift, int64_t tile, int64_t FBg,
                float* __restrict__ out) {
  int eg, eh;
  lgbt::shifts_of(shift, &eg, &eh);
  const double inv_g = ldexp(1.0, -eg);
  const double inv_h = ldexp(1.0, -eh);
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

// fixed point -> f32 over a lane axis: acc64 (L, tile, 2, F, B), acc32 (L,
// tile, F, B), out (L, tile, 3, F, B), lane l's exponents shift[2l], [2l + 1]
__global__ void __launch_bounds__(kThreads)
finalize_lanes_kernel(const unsigned long long* __restrict__ acc64,
                      const int* __restrict__ acc32, const int* __restrict__ shift,
                      int64_t lanes, int64_t tile, int64_t FBg, float* __restrict__ out) {
  const int64_t total = lanes * tile * FBg;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int64_t ls = i / FBg, cell = i % FBg;  // ls = lane * tile + slot
    const int64_t lane = ls / tile;
    const double inv_g = ldexp(1.0, -shift[2 * lane]);
    const double inv_h = ldexp(1.0, -shift[2 * lane + 1]);
    const long long g = (long long)acc64[(ls * 2 + 0) * FBg + cell];
    const long long h = (long long)acc64[(ls * 2 + 1) * FBg + cell];
    out[(ls * 3 + 0) * FBg + cell] = (float)((double)g * inv_g);
    out[(ls * 3 + 1) * FBg + cell] = (float)((double)h * inv_h);
    out[(ls * 3 + 2) * FBg + cell] = (float)acc32[i];
  }
}

// The lane mode: one launch over a (blocks, lanes) grid, each lane's blocks
// taking equal ranges of its W positions, about one wave in all.
template <bool kQuant, bool kBf16>
cudaError_t launch_hist_lanes(const void* bins, const void* g, const void* h, const void* mask,
                              const void* rows, const void* slot, int64_t n_rows, int64_t W,
                              int F, int lanes, int tile, int B, const int* shift_dev,
                              unsigned long long* acc64, int* acc32, cudaStream_t stream) {
  Plan p;
  cudaError_t e = lgbt::make_plan(lgbt::hist_kernel<kQuant, false, kBf16, true>, W, F, tile,
                                  B, lgbt::Cells<kQuant>::kBytes, false, 0, &p);
  if (e != cudaSuccess) return e;
  lgbt::HistArgs a{static_cast<const int16_t*>(bins), g, h, static_cast<const uint8_t*>(mask),
                   static_cast<const int32_t*>(slot), nullptr, nullptr, nullptr, W, F,
                   0, tile, B, p.FB, p.SB, p.n_fgroups, p.n_sgroups,
                   Shift{nullptr, 0, shift_dev}, acc64, acc32,
                   static_cast<const int32_t*>(rows), n_rows};
  const int bx = (p.blocks + lanes - 1) / lanes;
  lgbt::hist_kernel<kQuant, false, kBf16, true>
      <<<dim3(bx < 1 ? 1 : bx, lanes), kThreads, p.smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kQuant, bool kBf16 = false>
cudaError_t launch_hist(const void* bins, const void* g, const void* h, const void* mask,
                        const void* slot, int64_t n, int F, int leaf_base, int tile, int B,
                        Shift shift, unsigned long long* acc64, int* acc32,
                        cudaStream_t stream) {
  Plan p;
  cudaError_t e = lgbt::make_plan(lgbt::hist_kernel<kQuant, false, kBf16>, n, F, tile, B,
                                  lgbt::Cells<kQuant>::kBytes, false, 0, &p);
  if (e != cudaSuccess) return e;
  lgbt::HistArgs a{static_cast<const int16_t*>(bins), g, h, static_cast<const uint8_t*>(mask),
                   static_cast<const int32_t*>(slot), nullptr, nullptr, nullptr, n, F,
                   leaf_base, tile, B, p.FB, p.SB, p.n_fgroups, p.n_sgroups, shift, acc64,
                   acc32};
  lgbt::hist_kernel<kQuant, false, kBf16><<<p.blocks, kThreads, p.smem, stream>>>(a);
  return cudaGetLastError();
}

// The float and bf16 histograms: payload type T (float or __nv_bfloat16).
template <class T>
int hist_float(const void* bins, const void* grad, const void* hess, const void* mask,
               const void* slot, long long n, int F, int leaf_base, int tile, int B,
               int row_bits, const void* shift_dev, void* absmax, void* acc64, void* acc32,
               void* out, void* stream) {
  if (n <= 0 || F <= 0 || tile <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shift shift{nullptr, row_bits, static_cast<const int*>(shift_dev)};
  if (shift_dev == nullptr) {
    unsigned int* am = static_cast<unsigned int*>(absmax);
    lgbt::absmax_kernel<T><<<lgbt::grid_for(n), kThreads, 0, st>>>(
        static_cast<const T*>(grad), static_cast<const T*>(hess), n, am);
    cudaError_t e0 = cudaGetLastError();
    if (e0 != cudaSuccess) return (int)e0;
    shift.absmax = am;
  }
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  cudaError_t e = launch_hist<false, kBf16>(bins, grad, hess, mask, slot, n, F, leaf_base,
                                            tile, B, shift,
                                            static_cast<unsigned long long*>(acc64),
                                            static_cast<int*>(acc32), st);
  if (e != cudaSuccess) return (int)e;
  const int64_t FBg = (int64_t)F * B;
  finalize_kernel<<<lgbt::grid_for(tile * FBg), kThreads, 0, st>>>(
      static_cast<const unsigned long long*>(acc64), static_cast<const int*>(acc32), shift,
      tile, FBg, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Float histogram.  acc64 (tile, 2, F, B) and acc32 (tile, F, B) must be
// zeroed by the caller; out is (tile, 3, F, B) f32.  With shift (int32[2] in
// device memory) the fixed-point exponents are shift[0], shift[1]; with
// shift = nullptr they come from max |grad|, max |hess| over the n rows
// (absmax, 2 x u32, zeroed by the caller) and row_bits = bitlen(n).  Returns
// a cudaError_t (0 = success).
int lgbt_hist_multi_f32(const void* bins, const void* grad, const void* hess,
                        const void* mask, const void* slot, long long n, int F,
                        int leaf_base, int tile, int B, int row_bits, const void* shift_dev,
                        void* absmax, void* acc64, void* acc32, void* out, void* stream) {
  return hist_float<float>(bins, grad, hess, mask, slot, n, F, leaf_base, tile, B, row_bits,
                           shift_dev, absmax, acc64, acc32, out, stream);
}

// bf16 histogram: lgbt_hist_multi_f32's contract with grad and hess given
// as bfloat16 (n,) arrays; the exponents come from max |v| of those values.
int lgbt_hist_multi_bf16(const void* bins, const void* grad, const void* hess,
                         const void* mask, const void* slot, long long n, int F,
                         int leaf_base, int tile, int B, int row_bits, const void* shift_dev,
                         void* absmax, void* acc64, void* acc32, void* out, void* stream) {
  return hist_float<__nv_bfloat16>(bins, grad, hess, mask, slot, n, F, leaf_base, tile, B,
                                   row_bits, shift_dev, absmax, acc64, acc32, out, stream);
}

// int8 histogram: out (tile, 3, F, B) int32, zeroed by the caller.
int lgbt_hist_multi_i8(const void* bins, const void* grad_q, const void* hess_q,
                       const void* mask, const void* slot, long long n, int F,
                       int leaf_base, int tile, int B, void* out, void* stream) {
  if (n <= 0 || F <= 0 || tile <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  return (int)launch_hist<true>(bins, grad_q, hess_q, mask, slot, n, F, leaf_base, tile, B,
                                Shift{nullptr, 0, nullptr}, nullptr, static_cast<int*>(out),
                                static_cast<cudaStream_t>(stream));
}

// The carried-accumulator float mode (a sweep over row chunks): adds the
// n rows' fixed-point sums into the caller's acc64 (tile, 2, F, B) and
// acc32 (tile, F, B), which carry over from earlier calls, with the
// exponents shift (int32[2] in device memory, required: the whole sweep's);
// with finalize != 0 it then writes out (tile, 3, F, B) f32 from the
// accumulators, once, after the sweep's last chunk.
int lgbt_hist_multi_f32_carry(const void* bins, const void* grad, const void* hess,
                              const void* mask, const void* slot, long long n, int F,
                              int leaf_base, int tile, int B, const void* shift_dev,
                              void* acc64, void* acc32, void* out, int finalize,
                              void* stream) {
  if (n < 0 || F <= 0 || tile <= 0 || B <= 0 || shift_dev == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shift shift{nullptr, 0, static_cast<const int*>(shift_dev)};
  if (n > 0) {
    cudaError_t e = launch_hist<false>(bins, grad, hess, mask, slot, n, F, leaf_base, tile, B,
                                       shift, static_cast<unsigned long long*>(acc64),
                                       static_cast<int*>(acc32), st);
    if (e != cudaSuccess) return (int)e;
  }
  if (finalize) {
    const int64_t FBg = (int64_t)F * B;
    finalize_kernel<<<lgbt::grid_for(tile * FBg), kThreads, 0, st>>>(
        static_cast<const unsigned long long*>(acc64), static_cast<const int*>(acc32), shift,
        tile, FBg, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

// The lane mode, float or bf16 (bf16 != 0): lanes histograms in one launch
// over the shared bins (n_rows, F).  Lane l's position p (p < W) is row
// rows[l, p] in slot slot[l, p] (skipped outside [0, tile)), weighed by
// grad/hess[l, row] where mask[l, row]; shift (lanes, 2) int32 holds each
// lane's exponents.  acc64 (lanes, tile, 2, F, B) and acc32 (lanes, tile,
// F, B) zeroed by the caller; out (lanes, tile, 3, F, B) f32.
int lgbt_hist_multi_lanes_f32(const void* bins, const void* grad, const void* hess,
                              const void* mask, const void* rows, const void* slot,
                              long long n_rows, long long W, int F, int lanes, int tile,
                              int B, const void* shift_dev, void* acc64, void* acc32,
                              void* out, int bf16, void* stream) {
  if (n_rows <= 0 || W <= 0 || F <= 0 || lanes <= 0 || lanes > 65535 || tile <= 0 ||
      B <= 0 || shift_dev == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sh = static_cast<const int*>(shift_dev);
  auto* a64 = static_cast<unsigned long long*>(acc64);
  auto* a32 = static_cast<int*>(acc32);
  cudaError_t e =
      bf16 ? launch_hist_lanes<false, true>(bins, grad, hess, mask, rows, slot, n_rows, W, F,
                                            lanes, tile, B, sh, a64, a32, st)
           : launch_hist_lanes<false, false>(bins, grad, hess, mask, rows, slot, n_rows, W, F,
                                             lanes, tile, B, sh, a64, a32, st);
  if (e != cudaSuccess) return (int)e;
  const int64_t FBg = (int64_t)F * B;
  finalize_lanes_kernel<<<lgbt::grid_for((int64_t)lanes * tile * FBg), kThreads, 0, st>>>(
      a64, a32, sh, lanes, tile, FBg, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The lane mode, int8: out (lanes, tile, 3, F, B) int32, zeroed by the caller.
int lgbt_hist_multi_lanes_i8(const void* bins, const void* grad_q, const void* hess_q,
                             const void* mask, const void* rows, const void* slot,
                             long long n_rows, long long W, int F, int lanes, int tile, int B,
                             void* out, void* stream) {
  if (n_rows <= 0 || W <= 0 || F <= 0 || lanes <= 0 || lanes > 65535 || tile <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch_hist_lanes<true, false>(bins, grad_q, hess_q, mask, rows, slot, n_rows, W,
                                             F, lanes, tile, B, nullptr, nullptr,
                                             static_cast<int*>(out),
                                             static_cast<cudaStream_t>(stream));
}

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
