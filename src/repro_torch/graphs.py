"""Compiled steps: the port's counterpart of ``jax.jit``.

The reference jits its engine's decode step (``repro/serve/engine.py:67``)
and its train step (``repro/train/train_step.py:70``). On the card the port
captures the same steps as CUDA graphs: ``CompiledStep`` wraps a step
function and calls it over static inputs, the tensors of its first call.

- The first call runs the function eagerly. It is a real step, and its
  result is returned: it also makes every lazy workspace (the kernels'
  ``_WORKSPACE`` entries) and loads every library, which must exist
  before a capture, and neither the engine's live cache nor a train state
  allows a throwaway step.
- The second call frees the allocator's cached blocks
  (``torch.cuda.empty_cache``, so the warm-up's freed activations are not
  held twice beside the graph's private pool), captures the function into
  a ``torch.cuda.CUDAGraph`` with Python's garbage collector held off, and
  replays it once.
- Every later call replays. Outputs are the captured tensors, overwritten
  by each replay.

A call whose tensors differ from the first call's (other tensors, or the
same ones with another shape, stride or dtype) raises: a graph never
replays over stale inputs. There is no switch and no fallback: a capture
or replay that fails raises. On the CPU the same function runs eagerly at
every call, over the same static inputs.

A replay runs no Python, so the kernels' launch counters (the wrappers'
``launches``) would stop counting. The capture records how far each moved
while the function was captured, puts them back (a capture executes
nothing), and each replay adds that much: the counters go on counting
kernel executions.
"""
from __future__ import annotations

import gc
import time
from typing import Callable

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ssd_scan as _scan
from repro_torch.models.common import tree_leaves


def counters() -> list:
    """The kernel wrappers whose ``launches`` count kernel executions,
    looked up at each call."""
    return [_decode.decode_attention, _flash.flash_attention_fwd,
            _flash.flash_attention_bwd, _scan.ssd_scan_fwd,
            _scan.ssd_scan_bwd]


def graphed(device: torch.device) -> bool:
    """Whether steps on ``device`` run as CUDA graphs: on a card only."""
    return device.type == "cuda"


def _layout(t: torch.Tensor) -> tuple:
    return (t.device, t.dtype, tuple(t.shape), t.stride(), t.data_ptr())


class CompiledStep:
    """``fn(*args)`` captured as a CUDA graph on the card (see the module
    docstring). ``args`` are trees (dicts, lists, tuples, NamedTuples) of
    tensors; the first call's tensors are the step's static inputs, kept
    alive here so their memory is never handed to another tensor.

    ``captures`` and ``capture_s`` count every capture of every instance
    and the host seconds they took (the smoke reports their cost);
    ``calls`` and ``replays`` count this instance's calls and replays."""

    captures = 0
    capture_s = 0.0

    def __init__(self, fn: Callable, device: str | torch.device) -> None:
        self.fn = fn
        self.device = torch.device(device)
        self.calls = 0
        self.replays = 0
        self._inputs: list | None = None    # (tensor, layout) of call 1
        self._graph = None
        self._out = None
        self._delta: list[int] = []

    def _check(self, args: tuple) -> None:
        """Records the static inputs (the tensors of ``args``) at the first
        call, after it ran, so a state leaf that step added counts; at
        every later call raises unless ``args`` holds the same tensors."""
        leaves = tree_leaves(args)
        if self._inputs is None:
            self._inputs = [(t, _layout(t)) for t in leaves]
        elif len(leaves) != len(self._inputs) or any(
                _layout(t) != layout for t, (_, layout) in
                zip(leaves, self._inputs)):
            raise ValueError(
                "a compiled step takes the tensors of its first call: these "
                "differ in number, place, shape, stride or dtype; copy new "
                "values into the static inputs instead")

    def __call__(self, *args):
        self.calls += 1
        if self.calls == 1:
            out = self.fn(*args)
            self._check(args)
            return out
        self._check(args)
        if not graphed(self.device):
            return self.fn(*args)
        if self._graph is None:
            self._capture(args)
        self._graph.replay()
        for fn, n in zip(counters(), self._delta):
            fn.launches += n
        self.replays += 1
        return self._out

    def _capture(self, args: tuple) -> None:
        """Captures ``fn(*args)``. A garbage collection inside the capture
        could destroy another graph (an engine left in a reference cycle),
        a call the capture refuses, so the collector is held off until the
        capture ends."""
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        fns = counters()
        before = [fn.launches for fn in fns]
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                out = self.fn(*args)
        finally:
            if collecting:
                gc.enable()
        self._delta = [fn.launches - n for fn, n in zip(fns, before)]
        for fn, n in zip(fns, before):
            fn.launches = n
        self._graph, self._out = graph, out
        CompiledStep.captures += 1
        CompiledStep.capture_s += time.perf_counter() - t0
