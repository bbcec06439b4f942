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
