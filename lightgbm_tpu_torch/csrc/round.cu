// The round megakernel for Hopper (sm_90a): one windowed boosting round's
// partition, window histograms, sibling subtraction and per-feature split
// search behind one C entry point.
//
// Replaces lightgbm_tpu/ops/round_pallas.py::_mk_kernel, both modes: the
// fused one (fuse_tail=True, lgbt_round) and the unfused one
// (fuse_tail=False, lgbt_round_unfused: phases 1 and 2 only, the sums left
// in fixed point for the sharded round to merge across ranks).
// Given a round's split segments with their left counts, and the windows
// (the small child of each split, in the new order), it computes:
//   1. partition: each segment's row ids moved stably into its left run and
//      then its right run, the other positions copied (partition_common.cuh,
//      the partition kernel's device code as one fused launch, since n_left
//      arrives precomputed);
//   2. window histograms: for slot s, the (grad, hess, count) histograms of
//      rows order'[win_start[s] + i], i < win_cnt[s], read from the
//      row-major (N, F) bins through the new order (hist_common.cuh, the
//      histogram kernel's device code in its gather mode);
//   3. subtraction: left = small_left ? fresh : parent - fresh, right the
//      other one, written as (T, 3, F, B) f32;
//   4. split search: per (candidate, feature), candidates being the T left
//      and T right children, the first maximizing threshold over the bins
//      with its gain, direction of missing values and left sums; on the
//      features of the categorical mask (the TPU kernel's has_cat tail) the
//      first maximizing categorical candidate instead, with its variant
//      (one-hot, ascending or descending prefix); and with feature_contri
//      (its has_contri tail) each gain that passed min_gain_to_split
//      scaled by max(0, contri[f]); with cegb_penalty_split the parent
//      count times the penalty subtracted; an adjusted gain is kept only
//      if it stays above 0.
//
// What bounds it on an H100.  The partition reads 5 B and writes 4 B per
// in-segment position and copies 4 B of every other one.  The window pass
// must read each window row's 4 KB of bins at F = 2000 (in 32-B sectors)
// plus its order entry, mask, grad and hess.  The tail reads the parent
// histograms and writes left and right once: 3 x T x 3 x F x B x 4 B = 183
// MB at T = 10, F = 2000, B = 255, ~55 us, and the split search's 2T x F x B
// candidates cost ~40 float operations each.
// So it is bytes-bound; the window pass itself is bound on the card by
// shared-memory atomics (five native 32-bit adds per row and feature), as
// the histogram kernel is.
//
// Design.  The TPU kernel runs its three phases in one sequential grid step
// with VMEM carries.  Blocks on the card run in no order, so the phases are
// consecutive launches on one stream behind one entry point; the bin matrix
// is still read once per round (the window pass), which is the kernel's
// purpose.  The window pass is the histogram kernel's gather mode
// (hist_common.cuh): the windows lie end to end in a flat space of
// positions, one wave of blocks splits (feature group, position) units
// evenly, each block holds one slot and as many features as fit 227 KB of
// shared memory and flushes once per (window, feature group) its range
// touches.  Its grid comes from W and the card, so no count is read back,
// and positions past W are dropped as the plain version's window_rows drops
// them.  Sums are the histogram kernel's 64-bit fixed point with the tree's
// exponents (sg, sh), so left/right equal bit for bit what the three-pass
// round gets from the histogram kernel on the gathered window.  The split
// search is one warp per (candidate, feature): each lane sums its run of
// ceil(B / 32) contiguous bins in float64, one warp scan of the lane totals
// gives each lane its prefix, and the lane then walks its bins evaluating
// each bin's gain with the formulas of ops/split.py::gain_plane in the same
// operation order (compiled with --fmad=false, so no multiply-add is
// contracted); the prefix sums are the plain version's float64 cumsum rounded to float
// (exact, so the order of the additions does not matter, while every
// partial sum fits 53 bits), and a warp reduction on (gain, lowest bin)
// gives torch.argmax's first maximum.
//
// The categorical search (cat_gain_kernel) is one block of 256 threads per
// (candidate, categorical feature), a thread a bin (B <= 256).  One-hot
// candidates need no order.  The many-vs-many ones sort the (key, bin)
// pairs in shared memory by a bitonic network, the key being
// sum_g / (sum_h + cat_smooth) of a used bin and +inf of the others, with
// the bin as the tie key, so the order is the stable sort of
// ops/split.py::gain_plane (torch.argsort, stable); a block scan in float64
// of the sorted bins gives each prefix's sums, rounded to float as the
// plain version's float64 cumsum is; the gains use lambda_l2 + cat_l2 in
// gain_plane's operation order.  Blocks of numerical features leave at
// once.  The winning candidate's left-bin mask is not written: ops/split.py
// ::categorical_winner_mask replays it from the winner's histogram column,
// as the JAX package does outside its kernel.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//             --fmad=false -shared -Xcompiler -fPIC (ops/cuda_build.py).

#include <climits>
#include <cmath>

#include "hist_common.cuh"
#include "partition_common.cuh"

namespace {

using lgbt::kThreads;

constexpr float kEps = 1e-15f;      // ops/split.py KEPSILON
constexpr float kMinScore = -1e30f;  // ops/split.py KMIN_SCORE
constexpr int kCatThreads = 256;     // categorical search: a thread a bin

struct GainParams {
  float l1, l2, min_data, min_hess, min_gain, max_delta, path_smooth;
  int use_smooth;
  float l2_cat, cat_smooth;  // l2_cat = lambda_l2 + cat_l2
  int max_cat_threshold, max_cat_to_onehot;
  float split_pen;  // cegb_tradeoff * cegb_penalty_split, or < 0 when off
};

// fixed point -> f32 for the fresh (window) histograms, then the sibling by
// subtraction from the parent; writes left and right (T, 3, F, B)
__global__ void __launch_bounds__(kThreads)
subtract_kernel(const unsigned long long* __restrict__ acc64, const int* __restrict__ acc32,
                const int* __restrict__ shift, const float* __restrict__ parent,
                const int32_t* __restrict__ small_left, int64_t T, int64_t FBg,
                float* __restrict__ left, float* __restrict__ right) {
  const double inv_g = ldexp(1.0, -shift[0]);
  const double inv_h = ldexp(1.0, -shift[1]);
  const int64_t total = T * FBg;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int64_t s = i / FBg, cell = i % FBg;
    float fr[3];
    fr[0] = (float)((double)(long long)acc64[(s * 2 + 0) * FBg + cell] * inv_g);
    fr[1] = (float)((double)(long long)acc64[(s * 2 + 1) * FBg + cell] * inv_h);
    fr[2] = (float)acc32[i];
    const bool sl = small_left[s] != 0;
    for (int ch = 0; ch < 3; ++ch) {
      const int64_t o = (s * 3 + ch) * FBg + cell;
      const float big = parent[o] - fr[ch];
      left[o] = sl ? fr[ch] : big;
      right[o] = sl ? big : fr[ch];
    }
  }
}

// torch.sign, clamp_min(x, 0) and ops/split.py's helpers, op for op
__device__ __forceinline__ float sgn(float x) { return (float)((x > 0.f) - (x < 0.f)); }

__device__ __forceinline__ float thr_l1(float g, float l1) {
  float a = fabsf(g) - l1;
  a = a < 0.f ? 0.f : a;
  return sgn(g) * a;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

__device__ __forceinline__ float leaf_output(float g, float h, const GainParams& p) {
  float out = (-thr_l1(g, p.l1)) / ((h + p.l2) + kEps);
  if (p.max_delta > 0.f) out = clampf(out, -p.max_delta, p.max_delta);
  return out;
}

__device__ __forceinline__ float leaf_output_smoothed(float g, float h, float c, float po,
                                                      const GainParams& p) {
  const float raw = leaf_output(g, h, p);
  const float alpha = c / (c + p.path_smooth);
  return raw * alpha + po * (1.f - alpha);
}

__device__ __forceinline__ float gain_given_output(float g, float h, float out,
                                                   const GainParams& p) {
  const float tg = thr_l1(g, p.l1);
  return -((2.f * tg) * out + (((h + p.l2) + kEps) * out) * out);
}

__device__ __forceinline__ float leaf_gain_l2(float g, float h, float l2,
                                              const GainParams& p) {
  const float tg = thr_l1(g, p.l1);
  const float denom = (h + l2) + kEps;
  if (p.max_delta > 0.f) {
    const float out = clampf((-tg) / denom, -p.max_delta, p.max_delta);
    return -((2.f * tg) * out + (denom * out) * out);
  }
  return (tg * tg) / denom;
}

__device__ __forceinline__ float leaf_gain(float g, float h, const GainParams& p) {
  return leaf_gain_l2(g, h, p.l2, p);
}

__device__ __forceinline__ bool split_ok(float lc, float rc, float lh, float rh,
                                         const GainParams& p) {
  return lc >= p.min_data && rc >= p.min_data && lh >= p.min_hess && rh >= p.min_hess;
}

// the min_gain_to_split gate, then feature_contri (contri may be null) and
// the CEGB split penalty on the parent count pc; an adjusted gain must stay
// above 0
__device__ __forceinline__ float gate(float g, const float* __restrict__ contri, int f,
                                      float pc, const GainParams& p) {
  if (!(g > kMinScore / 2.f && g > p.min_gain)) return kMinScore;
  if (contri != nullptr) {
    float k = contri[f];
    k = k < 0.f ? 0.f : k;
    g = g * k;
  }
  if (p.split_pen >= 0.f) g = g - p.split_pen * pc;
  if ((contri != nullptr || p.split_pen >= 0.f) && !(g > 0.f)) return kMinScore;
  return g;
}

__device__ __forceinline__ float direction_gain(float lg, float lh, float lc, float rg, float rh,
                                                float rc, float po, float gain_parent,
                                                const GainParams& p) {
  if (!p.use_smooth) return (leaf_gain(lg, lh, p) + leaf_gain(rg, rh, p)) - gain_parent;
  const float out_l = leaf_output_smoothed(lg, lh, lc, po, p);
  const float out_r = leaf_output_smoothed(rg, rh, rc, po, p);
  return (gain_given_output(lg, lh, out_l, p) + gain_given_output(rg, rh, out_r, p)) -
         gain_parent;
}

// One warp per (candidate, feature): candidates 0..T-1 are the left
// children, T..2T-1 the right ones.  cand (4, 2T): parent sum_g, sum_h,
// count and output of each candidate.  Lane l holds the K = ceil(B / 32)
// bins [l K, l K + K): a serial pass sums them, one warp scan turns the lane
// totals into each lane's exclusive prefix, and a second serial pass (its
// loads hit L1) evaluates each bin on the running prefix.
__global__ void __launch_bounds__(256)
gain_kernel(const float* __restrict__ left, const float* __restrict__ right, int T, int F,
            int B, const int32_t* __restrict__ nbpf, const int32_t* __restrict__ mbpf,
            const uint8_t* __restrict__ fmask, const uint8_t* __restrict__ cmask,
            const float* __restrict__ contri, const float* __restrict__ cand, GainParams p,
            float* __restrict__ o_gain, int32_t* __restrict__ o_thr,
            uint8_t* __restrict__ o_left, int32_t* __restrict__ o_var, float* __restrict__ o_lg,
            float* __restrict__ o_lh, float* __restrict__ o_lc) {
  const int lane = threadIdx.x & 31;
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int C = 2 * T;
  if (i >= (int64_t)C * F) return;  // whole warps leave
  const int c = (int)(i / F), f = (int)(i % F);
  if (cmask != nullptr && cmask[f]) return;  // cat_gain_kernel's
  const int64_t FB = (int64_t)F * B;
  const float* h = (c < T ? left + (int64_t)c * 3 * FB : right + (int64_t)(c - T) * 3 * FB) +
                   (int64_t)f * B;
  const float* hg = h;
  const float* hh = h + FB;
  const float* hc = h + 2 * FB;
  const float pg = cand[c], ph = cand[C + c], pc = cand[2 * C + c], po = cand[3 * C + c];
  const int mb = mbpf[f];
  const int last_nm = nbpf[f] - (mb >= 0 ? 2 : 1);
  const bool fon = fmask[f] != 0;
  // the missing bin's sums (a sum over bins of which one is non-zero)
  float mg = 0.f, mh = 0.f, mc = 0.f;
  if (mb >= 0 && mb < B) {
    mg = 0.f + hg[mb];
    mh = 0.f + hh[mb];
    mc = 0.f + hc[mb];
  }
  const float gain_parent = p.use_smooth ? gain_given_output(pg, ph, po, p) : leaf_gain(pg, ph, p);
  const int K = (B + 31) / 32;
  const int lo = lane * K, hi = min(B, lo + K);
  double tg = 0.0, th = 0.0, tc = 0.0;
  for (int b = lo; b < hi; ++b) {
    if (b != mb) {  // the missing bin is left out of the scan
      tg += (double)hg[b];
      th += (double)hh[b];
      tc += (double)hc[b];
    }
  }
  double xg = tg, xh = th, xc = tc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double yg = __shfl_up_sync(0xffffffffu, xg, o);
    const double yh = __shfl_up_sync(0xffffffffu, xh, o);
    const double yc = __shfl_up_sync(0xffffffffu, xc, o);
    if (lane >= o) {
      xg += yg;
      xh += yh;
      xc += yc;
    }
  }
  // exclusive prefix: exact, as every partial sum is while it fits 53 bits
  double cg = xg - tg, chs = xh - th, cc = xc - tc;
  // this lane's first maximum over its bins
  float best = -INFINITY, blg = 0.f, blh = 0.f, blc = 0.f;
  int bthr = INT_MAX;
  bool bleft = false;
  for (int b = lo; b < hi; ++b) {
    if (b != mb) {
      cg += (double)hg[b];
      chs += (double)hh[b];
      cc += (double)hc[b];
    }
    const float sg = (float)cg, sh = (float)chs, sc = (float)cc;
    const bool valid = fon && b < last_nm;
    float gd[2], st[2][3];
    for (int d = 0; d < 2; ++d) {  // d = 0: missing -> right, 1: -> left
      const float lg = sg + (d ? mg : 0.f), lh = sh + (d ? mh : 0.f), lc = sc + (d ? mc : 0.f);
      const float rg = pg - lg, rh = ph - lh, rc = pc - lc;
      const bool ok = valid && lc >= p.min_data && rc >= p.min_data && lh >= p.min_hess &&
                      rh >= p.min_hess;
      gd[d] = ok ? direction_gain(lg, lh, lc, rg, rh, rc, po, gain_parent, p) : kMinScore;
      st[d][0] = lg;
      st[d][1] = lh;
      st[d][2] = lc;
    }
    const bool use_left = gd[1] > gd[0];  // ties keep missing -> right
    const float g = gate(use_left ? gd[1] : gd[0], contri, f, pc, p);
    if (g > best) {  // bins rise within a lane: the first maximum stays
      best = g;
      bthr = b;
      bleft = use_left;
      const int d = use_left ? 1 : 0;
      blg = st[d][0];
      blh = st[d][1];
      blc = st[d][2];
    }
  }
  // first maximum across the lanes: the larger gain, then the lower bin
  float vb = best;
  int ib = bthr;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, vb, o);
    const int oi = __shfl_xor_sync(0xffffffffu, ib, o);
    if (ov > vb || (ov == vb && oi < ib)) {
      vb = ov;
      ib = oi;
    }
  }
  if (ib == bthr) {  // the lane that holds the winning bin
    o_gain[i] = best;
    o_thr[i] = bthr;
    o_left[i] = bleft ? 1 : 0;
    o_var[i] = -1;
    o_lg[i] = blg;
    o_lh[i] = blh;
    o_lc[i] = blc;
  }
}

// Inclusive float64 scan of (x, y, z) over the block's 256 threads.
__device__ __forceinline__ void block_scan3(double* x, double* y, double* z,
                                            double (*ws)[kCatThreads / 32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double a = __shfl_up_sync(0xffffffffu, *x, o);
    const double b = __shfl_up_sync(0xffffffffu, *y, o);
    const double c = __shfl_up_sync(0xffffffffu, *z, o);
    if (lane >= o) {
      *x += a;
      *y += b;
      *z += c;
    }
  }
  if (lane == 31) {
    ws[0][warp] = *x;
    ws[1][warp] = *y;
    ws[2][warp] = *z;
  }
  __syncthreads();
  double ox = 0.0, oy = 0.0, oz = 0.0;
  for (int w = 0; w < warp; ++w) {
    ox += ws[0][w];
    oy += ws[1][w];
    oz += ws[2][w];
  }
  *x += ox;
  *y += oy;
  *z += oz;
  __syncthreads();  // ws is reused by the next scan
}

// Stable ascending sort of (key, bin) pairs in shared memory, a thread an
// element: a bitonic network whose order is (key, then bin), which is total
// over distinct bins, so it ends at the stable sort's order.
__device__ __forceinline__ void bitonic_sort(float* key, int* bin) {
  const int t = threadIdx.x;
  __syncthreads();
  for (int k = 2; k <= kCatThreads; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int o = t ^ j;
      if (o > t) {
        const float ka = key[t], kb = key[o];
        const int ia = bin[t], ib = bin[o];
        const bool a_after_b = ka > kb || (ka == kb && ia > ib);
        if (a_after_b == ((t & k) == 0)) {
          key[t] = kb;
          key[o] = ka;
          bin[t] = ib;
          bin[o] = ia;
        }
      }
      __syncthreads();
    }
  }
}

// One block per (candidate, categorical feature); thread t is bin t (and,
// after a sort, the prefix of length t + 1).  Writes the (candidate,
// feature) outputs gain_kernel leaves to it, with the winning variant.
__global__ void __launch_bounds__(kCatThreads)
cat_gain_kernel(const float* __restrict__ left, const float* __restrict__ right, int T, int F,
                int B, const int32_t* __restrict__ mbpf, const uint8_t* __restrict__ fmask,
                const uint8_t* __restrict__ cmask, const float* __restrict__ contri,
                const float* __restrict__ cand, GainParams p, float* __restrict__ o_gain,
                int32_t* __restrict__ o_thr, uint8_t* __restrict__ o_left,
                int32_t* __restrict__ o_var, float* __restrict__ o_lg, float* __restrict__ o_lh,
                float* __restrict__ o_lc) {
  const int64_t i = blockIdx.x;
  const int C = 2 * T;
  const int c = (int)(i / F), f = (int)(i % F);
  if (!cmask[f]) return;  // the whole block: numerical features are gain_kernel's
  __shared__ float s_g[kCatThreads], s_h[kCatThreads], s_c[kCatThreads];
  __shared__ float s_key[kCatThreads];
  __shared__ int s_bin[kCatThreads];
  __shared__ double s_ws[3][kCatThreads / 32];
  __shared__ float s_best[kCatThreads / 32];
  __shared__ int s_bt[kCatThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t FB = (int64_t)F * B;
  const float* h = (c < T ? left + (int64_t)c * 3 * FB : right + (int64_t)(c - T) * 3 * FB) +
                   (int64_t)f * B;
  const float pg = cand[c], ph = cand[C + c], pc = cand[2 * C + c];
  const int mb = mbpf[f];
  // the bin with the missing bin zeroed (gain_plane's hist_nm)
  float g = 0.f, hh = 0.f, cc = 0.f;
  if (t < B && t != mb) {
    g = h[t];
    hh = h[FB + t];
    cc = h[2 * FB + t];
  }
  s_g[t] = g;
  s_h[t] = hh;
  s_c[t] = cc;
  const bool used = t < B && cc > 0.f && t != mb;
  const int num_used = __syncthreads_count(used);
  const float gain_parent = leaf_gain_l2(pg, ph, p.l2_cat, p);
  // one-hot: bin t alone goes left
  float gain_oh = kMinScore;
  if (used && split_ok(cc, pc - cc, hh, ph - hh, p))
    gain_oh = (leaf_gain_l2(g, hh, p.l2_cat, p) + leaf_gain_l2(pg - g, ph - hh, p.l2_cat, p)) -
              gain_parent;
  const float ratio = g / (hh + p.cat_smooth);
  const int k_len = t + 1;
  const bool len_ok = k_len <= p.max_cat_threshold && k_len <= (num_used + 1) / 2 &&
                      k_len < num_used;
  float gd[2], st[2][3];
  for (int d = 0; d < 2; ++d) {  // d = 0: ascending keys, 1: descending
    // ``+ 0.f`` and ``0.f -`` turn -0 into +0, as ops/split.py::_cat_keys
    s_key[t] = used ? (d == 0 ? ratio + 0.f : 0.f - ratio) : INFINITY;
    s_bin[t] = t;
    bitonic_sort(s_key, s_bin);
    const int sb = s_bin[t];
    double x = sb < B ? (double)s_g[sb] : 0.0;
    double y = sb < B ? (double)s_h[sb] : 0.0;
    double z = sb < B ? (double)s_c[sb] : 0.0;
    block_scan3(&x, &y, &z, s_ws);
    const float lg = (float)x, lh = (float)y, lc = (float)z;
    gd[d] = (len_ok && split_ok(lc, pc - lc, lh, ph - lh, p))
                ? (leaf_gain_l2(lg, lh, p.l2_cat, p) +
                   leaf_gain_l2(pg - lg, ph - lh, p.l2_cat, p)) -
                      gain_parent
                : kMinScore;
    st[d][0] = lg;
    st[d][1] = lh;
    st[d][2] = lc;
  }
  const bool onehot = num_used <= p.max_cat_to_onehot;
  const int var = onehot ? 0 : (gd[1] > gd[0] ? 2 : 1);
  float gain = onehot ? gain_oh : (gd[1] > gd[0] ? gd[1] : gd[0]);
  if (!fmask[f]) gain = kMinScore;
  gain = t < B ? gate(gain, contri, f, pc, p) : -INFINITY;
  // first maximum over the bins: the larger gain, then the lower bin
  float vb = gain;
  int ib = t;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, vb, o);
    const int oi = __shfl_xor_sync(0xffffffffu, ib, o);
    if (ov > vb || (ov == vb && oi < ib)) {
      vb = ov;
      ib = oi;
    }
  }
  if (lane == 0) {
    s_best[warp] = vb;
    s_bt[warp] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    vb = lane < kCatThreads / 32 ? s_best[lane] : -INFINITY;
    ib = lane < kCatThreads / 32 ? s_bt[lane] : INT_MAX;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, vb, o);
      const int oi = __shfl_xor_sync(0xffffffffu, ib, o);
      if (ov > vb || (ov == vb && oi < ib)) {
        vb = ov;
        ib = oi;
      }
    }
    if (lane == 0) s_bt[0] = ib;
  }
  __syncthreads();
  if (t == s_bt[0]) {
    const int64_t o = (int64_t)c * F + f;
    o_gain[o] = gain;
    o_thr[o] = t;
    o_left[o] = 0;
    o_var[o] = var;
    o_lg[o] = var == 0 ? g : st[var - 1][0];
    o_lh[o] = var == 0 ? hh : st[var - 1][1];
    o_lc[o] = var == 0 ? cc : st[var - 1][2];
  }
}

}  // namespace

// Phases 1 and 2 of a round, shared by the fused entry (lgbt_round) and the
// unfused one (lgbt_round_unfused): the partition into out_order, then the
// window histograms' fixed-point sums into acc64 / acc32 (zeroed here).
static cudaError_t partition_and_window(const void* bins, long long n, int F, int B, int T,
                                        const void* order, const void* go,
                                        const void* seg_start, const void* seg_len,
                                        const void* n_left, void* scratch, void* out_order,
                                        const void* grad, const void* hess, const void* mask,
                                        const void* win_start, const void* win_cnt,
                                        long long W, const int* sh_dev, void* acc64,
                                        void* acc32, cudaStream_t st) {
  // ---- 1. partition (the fused launch only reads n_left) ----
  lgbt::PartitionArgs pa{static_cast<const int32_t*>(order), static_cast<const uint8_t*>(go),
                         static_cast<const int32_t*>(seg_start),
                         static_cast<const int32_t*>(seg_len),
                         const_cast<int32_t*>(static_cast<const int32_t*>(n_left)), (int)n, T,
                         static_cast<unsigned*>(scratch), static_cast<int32_t*>(out_order)};
  cudaError_t e = lgbt::launch_partition(pa, true, st);
  if (e != cudaSuccess) return e;
  // ---- 2. window histograms through the new order ----
  const int64_t FBg = (int64_t)F * B;
  e = cudaMemsetAsync(acc64, 0, (size_t)T * 2 * FBg * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(acc32, 0, (size_t)T * FBg * sizeof(int), st);
  if (e != cudaSuccess) return e;
  lgbt::Plan p;
  const size_t off_bytes = (size_t)(T + 1) * sizeof(int);
  e = lgbt::make_plan(lgbt::hist_kernel<false, true>, W, F, T, B, lgbt::Cells<false>::kBytes,
                      true, off_bytes, &p);
  if (e != cudaSuccess) return e;
  lgbt::HistArgs a{static_cast<const int16_t*>(bins), grad, hess,
                   static_cast<const uint8_t*>(mask), nullptr,
                   static_cast<const int32_t*>(out_order), static_cast<const int32_t*>(win_start),
                   static_cast<const int32_t*>(win_cnt), W, F, 0, T, B, p.FB, p.SB, p.n_fgroups,
                   p.n_sgroups, lgbt::Shift{nullptr, 0, sh_dev},
                   static_cast<unsigned long long*>(acc64), static_cast<int*>(acc32)};
  lgbt::hist_kernel<false, true><<<p.blocks, kThreads, p.smem, st>>>(a);
  return cudaGetLastError();
}

extern "C" {

// One round.  Shapes: bins (n, F) i16; order, out_order (n,) i32; go (n,)
// u8 per position; seg_start, seg_len, n_left, win_start, win_cnt,
// small_left (T,) i32; grad, hess (n,) f32; mask (n,) u8; parent, left,
// right (T, 3, F, B) f32; nbpf, mbpf (F,) i32; fmask (F,) u8; cand (4, 2T)
// f32; cmask (F,) u8 the categorical features and contri (F,) f32 the
// feature_contri multipliers, each null when not given (cmask needs B <=
// 256); the seven per-feature outputs (2T, F); shift, the tree's fixed-point
// exponents of grad and hess, int32[2] in device memory (read when the
// kernels run, so a captured graph takes each tree's).  Scratch: the partition's
// (partition.cu: 2 u32 words + (ceil(n/4096) + T) u64 words, zeroed before
// its first use and left ready by every launch), acc64 (T, 2, F, B) u64,
// acc32 (T, F, B) i32 (zeroed here).  W bounds the windows' total row
// count: positions past it are dropped, as window_rows drops them.  Takes
// T <= 1024 and n < 2^30.  Returns a cudaError_t (0 = success).
int lgbt_round(const void* bins, long long n, int F, int B, int T, const void* order,
               const void* go, const void* seg_start, const void* seg_len, const void* n_left,
               void* scratch, void* out_order, const void* grad,
               const void* hess, const void* mask, const void* win_start, const void* win_cnt,
               const void* small_left, long long W, const void* shift, void* acc64, void* acc32,
               const void* parent, void* left, void* right, const void* nbpf, const void* mbpf,
               const void* fmask, const void* cmask, const void* contri, const void* cand,
               float l1, float l2, float min_data, float min_hess, float min_gain,
               float max_delta, float path_smooth, int use_smooth, float l2_cat,
               float cat_smooth, int max_cat_threshold, int max_cat_to_onehot,
               float split_pen, void* o_gain,
               void* o_thr, void* o_left, void* o_var, void* o_lg, void* o_lh, void* o_lc,
               void* stream) {
  if (n <= 0 || n >= lgbt::kMaxRows || F <= 0 || B <= 0 || T <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  if (cmask != nullptr && B > kCatThreads) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t FBg = (int64_t)F * B;
  const int* sh_dev = static_cast<const int*>(shift);
  cudaError_t e = partition_and_window(bins, n, F, B, T, order, go, seg_start, seg_len, n_left,
                                       scratch, out_order, grad, hess, mask, win_start,
                                       win_cnt, W, sh_dev, acc64, acc32, st);
  if (e != cudaSuccess) return (int)e;
  // ---- 3. subtraction ----
  subtract_kernel<<<lgbt::grid_for(T * FBg), kThreads, 0, st>>>(
      static_cast<const unsigned long long*>(acc64), static_cast<const int*>(acc32), sh_dev,
      static_cast<const float*>(parent), static_cast<const int32_t*>(small_left), T, FBg,
      static_cast<float*>(left), static_cast<float*>(right));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // ---- 4. per-feature split search ----
  GainParams gp{l1,        l2,         min_data,          min_hess,
                min_gain,  max_delta,  path_smooth,       use_smooth,
                l2_cat,    cat_smooth, max_cat_threshold, max_cat_to_onehot,
                split_pen};
  const int64_t warps = (int64_t)2 * T * F;
  const uint8_t* cm = static_cast<const uint8_t*>(cmask);
  const float* fc = static_cast<const float*>(contri);
  gain_kernel<<<(unsigned)((warps * 32 + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(left), static_cast<const float*>(right), T, F, B,
      static_cast<const int32_t*>(nbpf), static_cast<const int32_t*>(mbpf),
      static_cast<const uint8_t*>(fmask), cm, fc, static_cast<const float*>(cand), gp,
      static_cast<float*>(o_gain), static_cast<int32_t*>(o_thr), static_cast<uint8_t*>(o_left),
      static_cast<int32_t*>(o_var), static_cast<float*>(o_lg), static_cast<float*>(o_lh),
      static_cast<float*>(o_lc));
  e = cudaGetLastError();
  if (e != cudaSuccess || cm == nullptr) return (int)e;
  cat_gain_kernel<<<(unsigned)(2 * (int64_t)T * F), kCatThreads, 0, st>>>(
      static_cast<const float*>(left), static_cast<const float*>(right), T, F, B,
      static_cast<const int32_t*>(mbpf), static_cast<const uint8_t*>(fmask), cm, fc,
      static_cast<const float*>(cand), gp, static_cast<float*>(o_gain),
      static_cast<int32_t*>(o_thr), static_cast<uint8_t*>(o_left), static_cast<int32_t*>(o_var),
      static_cast<float*>(o_lg), static_cast<float*>(o_lh), static_cast<float*>(o_lc));
  return (int)cudaGetLastError();
}

// One round without its tail: the partition and the window pass only, as
// round_pallas.py's _mk_kernel with fuse_tail=False (the sharded round's
// mode: the window sums are merged across ranks before the subtraction and
// the split search run).  Shapes and scratch as lgbt_round's; the window
// pass's fixed-point sums are left unconverted in acc64 (T, 2, F, B) u64 and
// acc32 (T, F, B) i32, zeroed here, for the caller to merge exactly and
// convert once.  Returns a cudaError_t (0 = success).
int lgbt_round_unfused(const void* bins, long long n, int F, int B, int T, const void* order,
                       const void* go, const void* seg_start, const void* seg_len,
                       const void* n_left, void* scratch, void* out_order, const void* grad,
                       const void* hess, const void* mask, const void* win_start,
                       const void* win_cnt, long long W, const void* shift, void* acc64,
                       void* acc32, void* stream) {
  if (n <= 0 || n >= lgbt::kMaxRows || F <= 0 || B <= 0 || T <= 0 || W <= 0 ||
      shift == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)partition_and_window(bins, n, F, B, T, order, go, seg_start, seg_len, n_left,
                                   scratch, out_order, grad, hess, mask, win_start, win_cnt,
                                   W, static_cast<const int*>(shift), acc64, acc32,
                                   static_cast<cudaStream_t>(stream));
}

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
