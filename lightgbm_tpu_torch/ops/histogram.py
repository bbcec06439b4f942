"""Histogram construction: the dispatchers the growers call.

Counterpart of lightgbm_tpu/ops/histogram.py.  Every entry goes to the one
multi-leaf kernel (ops/hist_cuda.py): a CUDA tensor launches it, a CPU
tensor takes its plain version.  The JAX package's XLA one-hot strategy for
narrow bins (<= 64) was a matrix-unit choice for the TPU and has no
counterpart here; the same kernel serves every bin count.

Layout is channel-first (3, F, B) / (L, 3, F, B), channels (grad, hess,
count), as in the JAX package.

``unbundle_hists`` turns histograms over EFB bundle columns (io/efb.py)
back into per-feature ones with plain torch ops, as the JAX package does it
outside any Pallas kernel; ``histogram_scatter`` is the JAX package's
single-leaf scatter histogram, the CPU reference B1's float path is held
to.
"""

from __future__ import annotations

import torch

from . import hist_cuda


def histogram_multi(bins, grad, hess, mask, leaf_slot, leaf_base: int,
                    num_leaves_tile: int, num_bins: int, shift=None,
                    precision: str = "f32") -> torch.Tensor:
    """Per-leaf histograms for leaves [leaf_base, leaf_base + tile) in one
    pass: (tile, 3, F, B) f32.  ``shift``: the fixed-point exponents;
    ``precision``: f32, or bf16 (grad and hess rounded to bfloat16, the
    JAX package's hist_precision=bf16; hist_cuda.histogram_multi)."""
    return hist_cuda.histogram_multi(bins, grad, hess, mask, leaf_slot,
                                     leaf_base, num_leaves_tile, num_bins,
                                     shift=shift, precision=precision)


def histogram_multi_quantized(bins, grad_q, hess_q, mask, leaf_slot,
                              leaf_base: int, num_leaves_tile: int,
                              num_bins: int) -> torch.Tensor:
    """Quantized sibling of :func:`histogram_multi`: (tile, 3, F, B) int32."""
    return hist_cuda.histogram_multi_quantized(
        bins, grad_q, hess_q, mask, leaf_slot, leaf_base, num_leaves_tile,
        num_bins)


def fix_histogram_subtract(parent: torch.Tensor,
                           child: torch.Tensor) -> torch.Tensor:
    """Sibling histogram by subtraction (reference: the histogram
    subtraction trick) -- exact because bins are identical."""
    return parent - child


def histogram_scatter(bins, grad, hess, mask, num_bins: int) -> torch.Tensor:
    """Masked single-leaf histogram over all features, (3, F, B) f32, by an
    f32 scatter-add (the JAX package's histogram_scatter): rows with mask 0
    add zeros."""
    n, f = bins.shape
    m = mask.to(grad.dtype)
    flat = (bins.long() + torch.arange(f, device=bins.device)[None, :] * num_bins)
    payload = torch.stack([grad * m, hess * m, m])[:, :, None].expand(3, n, f)
    hist = torch.zeros((3, f * num_bins), dtype=grad.dtype, device=bins.device)
    hist.index_add_(1, flat.reshape(-1), payload.reshape(3, -1))
    return hist.reshape(3, f, num_bins)


def unbundle_hists(h: torch.Tensor, efb_gather: torch.Tensor,
                   efb_default: torch.Tensor, num_feature: int,
                   num_bins: int) -> torch.Tensor:
    """(tile, 3, F_b, B) bundle histograms -> (tile, 3, F, B) per-feature
    histograms (the JAX package's unbundle_hists): each feature's
    non-default slots are gathered (``efb_gather``: (F * B,) int64 into the
    flat (F_b * B) bundle cells, F_b * B reading zero), and its default bin
    (``efb_default``, (F, B) bool) is the leaf total less the rest.

    int32 histograms (quantized training) unbundle exactly.  For f32 ones
    the sums of the fill are float64, one reduction kernel over a fixed
    shape, so the graph and eager rounds give the same bits; f32 values
    whose magnitudes span less than 2^21 within a leaf add exactly, in any
    order, which makes the card's fill the CPU's too."""
    tile = h.shape[0]
    flat = torch.cat([h.reshape(tile, 3, -1), h.new_zeros(tile, 3, 1)], dim=2)
    hf = flat.index_select(2, efb_gather).view(tile, 3, num_feature, num_bins)
    acc = torch.int64 if not h.is_floating_point() else torch.float64
    fill = (h[:, :, 0, :].sum(dim=2, dtype=acc)[:, :, None]
            - hf.sum(dim=3, dtype=acc)).to(h.dtype)
    return torch.where(efb_default, fill[..., None], hf)


def unbundle(h: torch.Tensor, efb, num_bins: int) -> torch.Tensor:
    """``h`` over the bundle columns unbundled with the EFB tables ``efb``
    (Dataset.efb_device_tables(): bundled matrix, gather, default), or
    ``h`` itself without a plan."""
    if efb is None:
        return h
    return unbundle_hists(h, efb[1], efb[2], efb[2].shape[0], num_bins)


# ---------------------------------------------------------------------------
# the sharded growers' merges (parallel/): exact, so R ranks grow the serial
# tree bit for bit
# ---------------------------------------------------------------------------
def global_shift(grad, hess, shard) -> torch.Tensor:
    """The tree's fixed-point exponent pair over all ranks' rows
    (hist_cuda.fixed_shift_tensor of the whole): the global N of ``shard``
    (parallel/mesh.py::RowShard) and one pmax of the two maxima."""
    from ..parallel import collectives as C

    n = int(shard.num_data)
    if grad.shape[0]:
        am = torch.stack([grad.float().abs().max(), hess.float().abs().max()])
    else:
        am = torch.zeros(2, dtype=torch.float32, device=grad.device)
    am = C.pmax(am, shard.mesh)
    return (62 - n.bit_length() - torch.frexp(am).exponent).to(torch.int32)


def owned_features(num_feature: int, mesh) -> tuple:
    """The scatter merge's feature blocks: (first feature of this rank's
    block, block width k, padded width R * k)."""
    k = -(-num_feature // mesh.size)
    return mesh.rank * k, k, k * mesh.size


def _scatter_features(x: torch.Tensor, fdim: int, mesh) -> torch.Tensor:
    """psum_scatter of ``x`` over its feature dim ``fdim``: the features laid
    out first, padded with zero features to a multiple of R; returns this
    rank's block in x's layout."""
    from ..parallel import collectives as C

    _f0, _k, fp = owned_features(x.shape[fdim], mesh)
    xm = x.movedim(fdim, 0)
    if fp > xm.shape[0]:
        xm = torch.cat([xm, xm.new_zeros((fp - xm.shape[0],) + tuple(xm.shape[1:]))])
    return C.psum_scatter(xm, mesh).movedim(0, fdim).contiguous()


def merge_fixed(acc64, acc32, mesh, merge: str = "psum"):
    """Rank-local fixed-point window sums (acc64 (T, 2, F, B) int64, acc32
    (T, F, B) int32) merged across ``mesh``, left in fixed point: the
    summed (acc64, acc32) with ``merge="psum"`` (all_reduce), this rank's
    (T, ., k, B) feature block with ``"scatter"`` (reduce_scatter over the
    features).  Integer sums do not depend on their order."""
    from ..parallel import collectives as C

    mesh.stats["merges"] += 1
    mesh.stats["merge_bytes"] += acc64.numel() * 8 + acc32.numel() * 4
    if merge == "psum":
        return C.psum(acc64, mesh), C.psum(acc32, mesh)
    if merge == "scatter":
        return _scatter_features(acc64, 2, mesh), _scatter_features(acc32, 1, mesh)
    raise ValueError(f"merge must be 'psum' or 'scatter', got {merge!r}")


def merge_carry(acc64, acc32, shift, mesh, merge: str = "psum") -> torch.Tensor:
    """merge_fixed, converted to f32 once: (T, 3, F, B) (or this rank's
    feature block under the scatter merge), the serial histogram bit for
    bit."""
    return hist_cuda.carry_convert(*merge_fixed(acc64, acc32, mesh, merge), shift)


def pack_fixed(acc64, acc32) -> torch.Tensor:
    """Fixed-point sums as one (T, 3, F, B) int64 tensor (counts widened):
    the hierarchical learner's slice-domain histograms, which subtract and
    merge exactly."""
    return torch.cat([acc64, acc32[:, None].to(torch.int64)], dim=1)


def fixed_to_f32(h: torch.Tensor, shift) -> torch.Tensor:
    """pack_fixed's (T, 3, F, B) int64 converted to f32 as B1 converts
    (hist_cuda.carry_convert: one launch of the carried mode on the card)."""
    return hist_cuda.carry_convert(h[:, :2].contiguous(),
                                   h[:, 2].to(torch.int32).contiguous(), shift)


def merge_int(h: torch.Tensor, mesh, merge: str = "psum") -> torch.Tensor:
    """int8-quantized (T, 3, F, B) int32 histograms merged as merge_carry
    merges (exact: integers)."""
    from ..parallel import collectives as C

    mesh.stats["merges"] += 1
    mesh.stats["merge_bytes"] += h.numel() * 4
    if merge == "psum":
        return C.psum(h, mesh)
    if merge == "scatter":
        return _scatter_features(h, 2, mesh)
    raise ValueError(f"merge must be 'psum' or 'scatter', got {merge!r}")


def dcn_merge(h: torch.Tensor, dcn) -> torch.Tensor:
    """Fixed-point histograms (ops/histogram.py::pack_fixed, (C, 3, F, B)
    int64) summed over the dcn axis as the flat merge sends them: the
    grad and hess sums int64, the counts int32."""
    from ..parallel import collectives as C

    sums, counts = h[:, :2].contiguous(), h[:, 2].to(torch.int32).contiguous()
    dcn.stats["merges"] += 1
    dcn.stats["merge_bytes"] += sums.numel() * 8 + counts.numel() * 4
    return torch.cat([C.psum(sums, dcn), C.psum(counts, dcn)[:, None].to(torch.int64)],
                     dim=1)


def _merged(acc, mesh, merge: str, convert: bool):
    """Carried sums merged across ``mesh``: converted once (merge_carry),
    or, with ``convert=False``, left in fixed point (pack_fixed)."""
    if not convert:
        return pack_fixed(*merge_fixed(acc.acc64, acc.acc32, mesh, merge))
    return merge_carry(acc.acc64, acc.acc32, acc.shift, mesh, merge)


def _f32_payload(grad, hess, precision: str):
    """The carried passes' f32 payload: with ``precision="bf16"`` grad and
    hess rounded to bfloat16 first, whose float32 values sum to the same
    integers as the bf16 pass's."""
    g, h = hist_cuda._payload(grad, hess, precision)
    return g.float().contiguous(), h.float().contiguous()


def histogram_multi_merged(bins, grad, hess, mask, leaf_slot, leaf_base: int,
                           tile: int, num_bins: int, shift, mesh,
                           merge: str = "psum", precision: str = "f32",
                           convert: bool = True):
    """histogram_multi over the rows of every rank: each rank sums its rows
    into B1's carried accumulators (the fixed-point exponents ``shift`` must
    be the global ones, global_shift), the accumulators are merged
    (merge_carry) and converted once (``convert=False``: left in fixed
    point, pack_fixed)."""
    acc = hist_cuda.CarryAccumulator(tile, bins.shape[1], num_bins, shift,
                                     bins.device)
    hist_cuda.histogram_multi_carry(bins, *_f32_payload(grad, hess, precision), mask,
                                    leaf_slot, leaf_base, acc)
    return _merged(acc, mesh, merge, convert)


def histogram_multi_quantized_merged(bins, grad_q, hess_q, mask, leaf_slot,
                                     leaf_base: int, tile: int, num_bins: int,
                                     mesh, merge: str = "psum") -> torch.Tensor:
    return merge_int(histogram_multi_quantized(bins, grad_q, hess_q, mask,
                                               leaf_slot, leaf_base, tile,
                                               num_bins), mesh, merge)


def histogram_window_merged(bins, grad, hess, mask, order, win_start, win_cnt,
                            tile: int, num_bins: int, *, W: int, shift, mesh,
                            merge: str = "psum", precision: str = "f32",
                            convert: bool = True):
    """The sharded three-pass round's window pass: each rank's windows read
    through its order into B1's carried accumulators (the carried window
    mode, hist_cuda.histogram_window_carry, with the global exponents
    ``shift``), merged and converted as histogram_multi_merged does."""
    acc = hist_cuda.CarryAccumulator(tile, bins.shape[1], num_bins, shift,
                                     bins.device)
    hist_cuda.histogram_window_carry(bins, *_f32_payload(grad, hess, precision), mask,
                                     order, win_start, win_cnt, acc, W=W)
    return _merged(acc, mesh, merge, convert)


def histogram_window_quantized_merged(bins, grad_q, hess_q, mask, order, win_start,
                                      win_cnt, tile: int, num_bins: int, *, W: int,
                                      mesh, merge: str = "psum") -> torch.Tensor:
    return merge_int(hist_cuda.histogram_window_quantized(
        bins, grad_q, hess_q, mask, order, win_start, win_cnt, tile, num_bins, W=W),
        mesh, merge)
