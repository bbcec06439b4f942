"""Histogram construction: the dispatchers the growers call.

Counterpart of lightgbm_tpu/ops/histogram.py.  Every entry goes to the one
multi-leaf kernel (ops/hist_cuda.py): a CUDA tensor launches it, a CPU
tensor takes its plain version.  The JAX package's XLA one-hot strategy for
narrow bins (<= 64) was a matrix-unit choice for the TPU and has no
counterpart here; the same kernel serves every bin count.

Layout is channel-first (3, F, B) / (L, 3, F, B), channels (grad, hess,
count), as in the JAX package.
"""

from __future__ import annotations

import torch

from . import hist_cuda


def histogram_multi(bins, grad, hess, mask, leaf_slot, leaf_base: int,
                    num_leaves_tile: int, num_bins: int) -> torch.Tensor:
    """Per-leaf histograms for leaves [leaf_base, leaf_base + tile) in one
    pass: (tile, 3, F, B) f32."""
    return hist_cuda.histogram_multi(bins, grad, hess, mask, leaf_slot,
                                     leaf_base, num_leaves_tile, num_bins)


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
