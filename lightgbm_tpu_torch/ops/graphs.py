"""Captured rounds: CUDA graphs keyed by their static arguments.

Counterpart of ``jax.jit(..., donate_argnums=(0,))`` around the JAX
package's round functions (ops/treegrow_windowed.py::_round_fused, and the
rounds grower's round in ops/treegrow_fast.py).  A round function reads one
set of static buffers, which the grower loads before each tree's first
round (the state, then that tree's inputs: gradients, quantized lanes,
masks, the exponent pair), and copies its new state back into them, as a
donated dispatch updates its state in place.  Every graph of a cache reads
and writes the same buffers, so the key may change from round to round.

On the card each distinct key (the windowed grower's window rung, the
rounds grower's tile, with the rest of the round's static arguments) is
captured once per training, and every round, the first included, is one
``replay()``.  Before a capture the round runs once on the capture stream
on copies of the buffers, so that the kernels are built and loaded and the
partition scratch exists, and the state is left as it was.  The graphs of a
cache share one memory pool: their rounds never run at once.  On the CPU
the same round function runs eagerly on the same buffers, with no capture.

Nothing falls back: a failed capture or replay raises, and a tree whose
buffers or fixed inputs do not match the captured ones is refused.

A capture runs in CUDA's thread-local capture mode (``CAPTURE_ERROR_MODE``)
on its private stream, so a serving thread of the same process may launch,
allocate, pin host memory and read the card while a training thread
captures (train while serving, as the JAX package's continual runtime
does).  torch's default, the global mode, makes such a call in any thread
fail the capture.  The captured work is the same in either mode.
"""

from __future__ import annotations

from typing import Callable, Hashable

import torch

from ..utils import sanitizer as _san
from . import cuda_build, partition_cuda

# cudaStreamCaptureModeThreadLocal: only the capturing thread is held to
# the capture's rules (the module docstring)
CAPTURE_ERROR_MODE = "thread_local"


def _map(fn, tree):
    """``fn`` over the tensors of a tree of (named) tuples; None stays."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        out = [_map(fn, t) for t in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree)


def copy_into(dst, src) -> None:
    """Copy the tensors of ``src`` into those of ``dst`` (same structure,
    shapes and dtypes; a tensor that is its own destination is skipped)."""
    if dst is None or src is None:
        if dst is not src:
            raise ValueError("static buffers and values differ in structure")
        return
    if isinstance(dst, tuple):
        if not isinstance(src, tuple) or len(src) != len(dst):
            raise ValueError("static buffers and values differ in structure")
        for d, s in zip(dst, src):
            copy_into(d, s)
        return
    if _spec(dst) != _spec(src):
        raise ValueError(f"static buffer {_spec(dst)} cannot take {_spec(src)}")
    if dst is not src:
        dst.copy_(src)


def _spec(t: torch.Tensor):
    """Shape, dtype and device: what a static buffer fixes."""
    return tuple(t.shape), t.dtype, t.device


class RoundGraphs:
    """A cache of captured rounds and the static buffers they share."""

    def __init__(self, device):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.capture = device.type == "cuda"
        self.buffers = None
        self._fixed = None
        self._graphs: dict = {}  # key -> (CUDAGraph, launch tally)
        self._held: list = []  # partition scratch the graphs baked in
        if self.capture:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device)

    def load(self, values, fixed=()):
        """Copy one tree's ``values`` (a tree of tensors) into the static
        buffers, which the first call allocates as copies of its values.
        ``fixed`` are the tensors the rounds read where they lie (bins, the
        per-feature tables): they must be the very tensors of the first
        call.  Returns the buffers."""
        sig = [(t.data_ptr(), *_spec(t)) for t in fixed]
        if self.buffers is None:
            self.buffers = _map(torch.clone, values)
            self._fixed = sig
        elif sig != self._fixed:
            raise ValueError("the rounds were captured on other fixed inputs "
                             "(bins or per-feature tables)")
        else:
            copy_into(self.buffers, values)
        return self.buffers

    def run(self, key: Hashable, body: Callable) -> None:
        """One round: ``body(buffers)`` reads and writes the static
        buffers.  On the card, the replay of the graph captured for ``key``
        (captured now if it is new)."""
        if self.buffers is None:
            raise RuntimeError("RoundGraphs.run before load")
        if not self.capture:
            body(self.buffers)
            _san.record_replay(False)
            return
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(body)
        graph, tally = entry
        graph.replay()
        for counts, name in tally:
            counts[name] += 1
        _san.record_replay(True)

    def launches_per_replay(self) -> dict:
        """{key: {kernel wrapper: launches a replay}} of every graph."""
        out = {}
        for key, (_, tally) in self._graphs.items():
            per = out.setdefault(key, {})
            for _, name in tally:
                per[name] = per.get(name, 0) + 1
        return out

    def _capture(self, body: Callable):
        cur = torch.cuda.current_stream(self.device)
        side = self._stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            body(_map(torch.clone, self.buffers))  # warm-up on copies
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()  # jaxlint: disable=R2 (once a key: run() keeps the graph in self._graphs and replays it)
        tally: list = []
        cuda_build._tallies.append(tally)
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=side,
                                  capture_error_mode=CAPTURE_ERROR_MODE):
                body(self.buffers)
        finally:
            cuda_build._tallies.pop()
        held = partition_cuda.scratch_of(self.device, side.cuda_stream)
        if held is not None:
            self._held.append(held)
        _san.record_capture()
        return graph, tally
