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
// * A launch allocates nothing: the Python wrapper passes the scratch.
//
// Launches.  A call's accumulation needs zeroed 64-bit sums, the exponent
// pair (from max |grad|, max |hess| unless given) and, after every block
// has flushed, the f32 conversion.  The wrapper hands over one
// uninitialised scratch (the accumulators and the two maxima words end to
// end), so a call is one memset of it, the maxima kernel (derived
// exponents only), the accumulation and the conversion.  The
// accumulation's plan comes from a host table (hist_common.cuh), so no
// launch repeats the device queries.  A 100,000-row, one-feature call
// (PERF.md, A29) was host-bound at 4 memsets + 3 kernels with the queries
// at every launch; a cooperative launch of all four steps with grid
// barriers saved no more than the spread of the call's time (PERF.md) and
// was taken out.
//
// Three further modes (ops/hist_cuda.py):
// * lanes (the booster fleet's window pass, the TPU kernel under
//   jax.vmap): the grid gains a lane axis (blockIdx.y), each lane reading
//   the shared bins through its own row ids (no (W, F) copy a lane), with
//   its own payloads, mask and exponent pair, so each lane's slice equals
//   its solo call bit for bit and each block's shared footprint is the
//   solo one's;
// * carried (the out-of-core spill grower's chunk sweep): each call adds a
//   chunk's rows into accumulators the caller keeps across calls, and the
//   f32 conversion runs once, after the last chunk: integer sums are
//   order-free, so any chunking gives the in-memory call's bits;
// * window (the three-pass round's window pass, float, bf16, int8 and
//   carried): the gather mode of hist_common.cuh, which B3 also runs: the
//   round's windows read through the partitioned row order, each row's
//   feature group read contiguously as in the direct mode, with no (W, F)
//   copy of the window (the copy cost more than the kernel: PERF.md).
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

// What a call does around its accumulation.
struct Steps {
  unsigned* zero;      // u32 words zeroed first (the call's own accumulators), or null
  int64_t zero_words;
  unsigned* absmax;    // derived exponents: absmax_kernel's two max words, which
                       // directly follow the zeroed words (one memset zeroes both);
                       // else null
  float* out;          // the f32 conversion's output (tile, 3, F, B), or null
  const unsigned long long* acc64;  // the sums it converts
  const int* acc32;
};

// One call of the direct or the gather mode: the memset, maxima,
// accumulation and conversion launches (units_max: rows or W; one_slot and
// extra shared memory: gather mode's).  a's plan fields are filled here.
template <bool kQuant, bool kGather, bool kBf16>
cudaError_t run_hist(lgbt::HistArgs a, int64_t units_max, size_t extra_smem, Steps st,
                     cudaStream_t stream) {
  cudaError_t e;
  if (st.zero != nullptr) {
    const size_t bytes = (size_t)(st.zero_words + (st.absmax != nullptr ? 2 : 0)) * 4;
    e = cudaMemsetAsync(st.zero, 0, bytes, stream);
    if (e != cudaSuccess) return e;
  }
  if constexpr (!kQuant && !kGather) {
    if (st.absmax != nullptr) {
      using T = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
      lgbt::absmax_kernel<T><<<lgbt::grid_for(a.n), kThreads, 0, stream>>>(
          static_cast<const T*>(a.g), static_cast<const T*>(a.h), a.n, st.absmax);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
      a.shift.absmax = st.absmax;
    }
  }
  auto fn = lgbt::hist_kernel<kQuant, kGather, kBf16>;
  Plan p;
  e = lgbt::make_plan(fn, units_max, a.F, a.tile, a.B, lgbt::Cells<kQuant>::kBytes, kGather,
                      extra_smem, &p);
  if (e != cudaSuccess) return e;
  a.FB = p.FB;
  a.SB = p.SB;
  a.n_fgroups = p.n_fgroups;
  a.n_sgroups = p.n_sgroups;
  fn<<<p.blocks, kThreads, p.smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || st.out == nullptr) return e;
  const int64_t FBg = (int64_t)a.F * a.B;
  finalize_kernel<<<lgbt::grid_for(a.tile * FBg), kThreads, 0, stream>>>(
      st.acc64, st.acc32, a.shift, a.tile, FBg, st.out);
  return cudaGetLastError();
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

// Scratch of a float call: acc64 (tile, 2, F, B) u64, acc32 (tile, F, B)
// i32, then, where the call derives its exponents, absmax_kernel's 2 u32
// words.
struct FloatScratch {
  unsigned long long* acc64;
  int* acc32;
  unsigned* absmax;
  int64_t acc_words;  // u32 words of acc64 and acc32
};

FloatScratch float_scratch(void* scratch, int tile, int F, int B) {
  const int64_t cells = (int64_t)tile * F * B;
  auto* base = static_cast<unsigned char*>(scratch);
  return FloatScratch{reinterpret_cast<unsigned long long*>(base),
                      reinterpret_cast<int*>(base + cells * 16),
                      reinterpret_cast<unsigned*>(base + cells * 20), cells * 5};
}

// The float and bf16 direct histograms: payload type T (float or __nv_bfloat16).
template <class T>
int hist_float(const void* bins, const void* grad, const void* hess, const void* mask,
               const void* slot, long long n, int F, int leaf_base, int tile, int B,
               int row_bits, const void* shift_dev, void* scratch, void* out, void* stream) {
  if (n <= 0 || F <= 0 || tile <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const FloatScratch sc = float_scratch(scratch, tile, F, B);
  lgbt::HistArgs a{static_cast<const int16_t*>(bins), grad, hess,
                   static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(slot),
                   nullptr, nullptr, nullptr, n, F, leaf_base, tile, B, 0, 0, 0, 0,
                   Shift{nullptr, row_bits, static_cast<const int*>(shift_dev)}, sc.acc64,
                   sc.acc32};
  Steps st{reinterpret_cast<unsigned*>(sc.acc64), sc.acc_words,
           shift_dev == nullptr ? sc.absmax : nullptr, static_cast<float*>(out), sc.acc64,
           sc.acc32};
  return (int)run_hist<false, false, kBf16>(a, n, 0, st, static_cast<cudaStream_t>(stream));
}

// The window (gather) mode's HistArgs: W positions through order.
lgbt::HistArgs window_args(const void* bins, const void* g, const void* h, const void* mask,
                           const void* order, const void* win_start, const void* win_cnt,
                           long long W, int F, int tile, int B, const void* shift_dev,
                           unsigned long long* acc64, int* acc32) {
  return lgbt::HistArgs{static_cast<const int16_t*>(bins), g, h,
                        static_cast<const uint8_t*>(mask), nullptr,
                        static_cast<const int32_t*>(order),
                        static_cast<const int32_t*>(win_start),
                        static_cast<const int32_t*>(win_cnt), W, F, 0, tile, B, 0, 0, 0, 0,
                        Shift{nullptr, 0, static_cast<const int*>(shift_dev)}, acc64, acc32};
}

size_t window_smem(int tile) { return (size_t)(tile + 1) * sizeof(int); }

template <class T>
int window_float(const void* bins, const void* grad, const void* hess, const void* mask,
                 const void* order, const void* win_start, const void* win_cnt, long long W,
                 int F, int tile, int B, const void* shift_dev, void* scratch, void* out,
                 void* stream) {
  if (W <= 0 || F <= 0 || tile <= 0 || B <= 0 || shift_dev == nullptr)
    return (int)cudaErrorInvalidValue;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const FloatScratch sc = float_scratch(scratch, tile, F, B);
  Steps st{reinterpret_cast<unsigned*>(sc.acc64), sc.acc_words, nullptr,
           static_cast<float*>(out), sc.acc64, sc.acc32};
  return (int)run_hist<false, true, kBf16>(
      window_args(bins, grad, hess, mask, order, win_start, win_cnt, W, F, tile, B, shift_dev,
                  sc.acc64, sc.acc32),
      W, window_smem(tile), st, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Float histogram.  scratch: (tile x F x B) x 20 bytes, then with shift =
// nullptr 8 more (acc64, acc32 and the maxima; zeroed here); out is
// (tile, 3, F, B) f32, every cell written.  With shift (int32[2] in device
// memory) the fixed-point exponents are shift[0], shift[1]; with shift =
// nullptr they come from max |grad|, max |hess| over the n rows and
// row_bits = bitlen(n).  Returns a cudaError_t (0 = success).
int lgbt_hist_multi_f32(const void* bins, const void* grad, const void* hess,
                        const void* mask, const void* slot, long long n, int F,
                        int leaf_base, int tile, int B, int row_bits, const void* shift_dev,
                        void* scratch, void* out, void* stream) {
  return hist_float<float>(bins, grad, hess, mask, slot, n, F, leaf_base, tile, B, row_bits,
                           shift_dev, scratch, out, stream);
}

// bf16 histogram: lgbt_hist_multi_f32's contract with grad and hess given
// as bfloat16 (n,) arrays; the exponents come from max |v| of those values.
int lgbt_hist_multi_bf16(const void* bins, const void* grad, const void* hess,
                         const void* mask, const void* slot, long long n, int F,
                         int leaf_base, int tile, int B, int row_bits, const void* shift_dev,
                         void* scratch, void* out, void* stream) {
  return hist_float<__nv_bfloat16>(bins, grad, hess, mask, slot, n, F, leaf_base, tile, B,
                                   row_bits, shift_dev, scratch, out, stream);
}

// int8 histogram: out (tile, 3, F, B) int32, zeroed here.
int lgbt_hist_multi_i8(const void* bins, const void* grad_q, const void* hess_q,
                       const void* mask, const void* slot, long long n, int F,
                       int leaf_base, int tile, int B, void* out, void* stream) {
  if (n <= 0 || F <= 0 || tile <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  lgbt::HistArgs a{static_cast<const int16_t*>(bins), grad_q, hess_q,
                   static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(slot),
                   nullptr, nullptr, nullptr, n, F, leaf_base, tile, B, 0, 0, 0, 0,
                   Shift{nullptr, 0, nullptr}, nullptr, static_cast<int*>(out)};
  Steps st{static_cast<unsigned*>(out), (int64_t)tile * 3 * F * B, nullptr, nullptr,
           nullptr, nullptr};
  return (int)run_hist<true, false, false>(a, n, 0, st, static_cast<cudaStream_t>(stream));
}

// The carried-accumulator float mode (a sweep over row chunks): adds the
// n rows' fixed-point sums into the caller's acc64 (tile, 2, F, B) and
// acc32 (tile, F, B), which carry over from earlier calls, with the
// exponents shift (int32[2] in device memory, required: the whole sweep's);
// with finalize != 0 it then writes out (tile, 3, F, B) f32 from the
// accumulators, once, after the sweep's last chunk (n = 0: the conversion
// alone).
int lgbt_hist_multi_f32_carry(const void* bins, const void* grad, const void* hess,
                              const void* mask, const void* slot, long long n, int F,
                              int leaf_base, int tile, int B, const void* shift_dev,
                              void* acc64, void* acc32, void* out, int finalize,
                              void* stream) {
  if (n < 0 || F <= 0 || tile <= 0 || B <= 0 || shift_dev == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* a64 = static_cast<unsigned long long*>(acc64);
  auto* a32 = static_cast<int*>(acc32);
  float* o = finalize ? static_cast<float*>(out) : nullptr;
  Shift shift{nullptr, 0, static_cast<const int*>(shift_dev)};
  if (n > 0) {
    lgbt::HistArgs a{static_cast<const int16_t*>(bins), grad, hess,
                     static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(slot),
                     nullptr, nullptr, nullptr, n, F, leaf_base, tile, B, 0, 0, 0, 0, shift,
                     a64, a32};
    return (int)run_hist<false, false, false>(a, n, 0, Steps{nullptr, 0, nullptr, o, a64, a32},
                                              st);
  }
  if (o != nullptr) {
    const int64_t FBg = (int64_t)F * B;
    finalize_kernel<<<lgbt::grid_for(tile * FBg), kThreads, 0, st>>>(a64, a32, shift, tile,
                                                                      FBg, o);
  }
  return (int)cudaGetLastError();
}

// The window mode (the three-pass round's window pass): slot s holds the
// rows order[win_start[s] + i], i < win_cnt[s], the windows laid end to end
// in W positions (positions past W dropped), each row weighed where
// mask[row]; the histogram of those rows gathered, bit for bit, without
// gathering them.  Float: shift (int32[2] in device memory) required,
// scratch and out as lgbt_hist_multi_f32's.
int lgbt_hist_window_f32(const void* bins, const void* grad, const void* hess,
                         const void* mask, const void* order, const void* win_start,
                         const void* win_cnt, long long W, int F, int tile, int B,
                         const void* shift_dev, void* scratch, void* out, void* stream) {
  return window_float<float>(bins, grad, hess, mask, order, win_start, win_cnt, W, F, tile, B,
                             shift_dev, scratch, out, stream);
}

// The window mode over bfloat16 payloads (grad and hess (n,) bf16).
int lgbt_hist_window_bf16(const void* bins, const void* grad, const void* hess,
                          const void* mask, const void* order, const void* win_start,
                          const void* win_cnt, long long W, int F, int tile, int B,
                          const void* shift_dev, void* scratch, void* out, void* stream) {
  return window_float<__nv_bfloat16>(bins, grad, hess, mask, order, win_start, win_cnt, W, F,
                                     tile, B, shift_dev, scratch, out, stream);
}

// The window mode, int8: out (tile, 3, F, B) int32, zeroed here.
int lgbt_hist_window_i8(const void* bins, const void* grad_q, const void* hess_q,
                        const void* mask, const void* order, const void* win_start,
                        const void* win_cnt, long long W, int F, int tile, int B, void* out,
                        void* stream) {
  if (W <= 0 || F <= 0 || tile <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  Steps st{static_cast<unsigned*>(out), (int64_t)tile * 3 * F * B, nullptr, nullptr, nullptr,
           nullptr};
  return (int)run_hist<true, true, false>(
      window_args(bins, grad_q, hess_q, mask, order, win_start, win_cnt, W, F, tile, B,
                  nullptr, nullptr, static_cast<int*>(out)),
      W, window_smem(tile), st, static_cast<cudaStream_t>(stream));
}

// The window mode, carried (the sharded round's window pass): adds the
// windows' fixed-point sums, with the exponents shift (required), into the
// caller's acc64 (tile, 2, F, B) and acc32 (tile, F, B), for the caller to
// merge across ranks and convert once.
int lgbt_hist_window_f32_carry(const void* bins, const void* grad, const void* hess,
                               const void* mask, const void* order, const void* win_start,
                               const void* win_cnt, long long W, int F, int tile, int B,
                               const void* shift_dev, void* acc64, void* acc32,
                               void* stream) {
  if (W <= 0 || F <= 0 || tile <= 0 || B <= 0 || shift_dev == nullptr)
    return (int)cudaErrorInvalidValue;
  auto* a64 = static_cast<unsigned long long*>(acc64);
  auto* a32 = static_cast<int*>(acc32);
  return (int)run_hist<false, true, false>(
      window_args(bins, grad, hess, mask, order, win_start, win_cnt, W, F, tile, B, shift_dev,
                  a64, a32),
      W, window_smem(tile), Steps{nullptr, 0, nullptr, nullptr, a64, a32},
      static_cast<cudaStream_t>(stream));
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
