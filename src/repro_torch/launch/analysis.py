"""Semantic FLOP and byte accounting of a step as PyTorch runs it
(counterpart of ``repro/launch/analysis.py``).

The reference walks the jaxpr, multiplying scan bodies by their trip
counts. Eager PyTorch runs every layer, so a dispatch mode over the step
sees each layer's ops once per layer, and a ``torch.utils.checkpoint``
recompute as the ops the backward runs again: nothing to multiply out.
The step runs on the ``meta`` device, so it allocates and computes
nothing.

FLOPs counted (the reference's accounting): matrix products at
2*m*n*k*batch, from ``FlopCounterMode``'s table
(``torch.utils.flop_counter.flop_registry``); every other op at 1 FLOP per
output element, except views, which compute nothing.

Bytes counted (HBM-traffic proxy): operand + result sizes of the ops that
hit HBM even after fusion (``HBM_OPS``: the reference's ``_HBM_OPS``
mapped to aten — matrix products, gathers and embedding lookups, scatters
and index writes, sort and top-k, concatenation, and copies into a
slice); elementwise and reduction chains fuse into their producers.

Peak bytes: every storage an op makes is counted from the op until its
last reference goes (a weak reference to the storage, whose Python object
lives as long as the storage does: views, autograd's saved tensors and
DTensors' local blocks keep it), so ``peak`` is the most the tracked
tensors held at once, the step's inputs included. ``peak_held`` breaks
the peak down by what made each storage held then: ``"inputs"``, or the
phase and the op (``"forward mm"``, ``"backward all_gather_into_tensor"``,
``"no-grad add"``: the forward under grad mode, the backward with a
checkpoint's recompute, and what runs without grad mode, the optimizer or
a serve step).

A ``DTensor`` op is let through (``NotImplemented``), so the mode counts
the local ops it runs on this rank's shards, and the collectives they
need, instead of the global op. DTensor works out an op's output
placements the first time it meets them by running the op on fake tensors
(and caches the answer); those runs are not counted, so a count does not
depend on what the process ran before.
"""
from __future__ import annotations

import functools
import weakref

import torch
from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

_ELEMENTWISE_COST = 1.0

#: ops that hit HBM even after fusion (matmul operands/results, gathers,
#: KV-cache updates); pure elementwise/reduce chains fuse into producers
HBM_OPS = {
    aten.mm, aten.bmm, aten.addmm, aten.baddbmm,
    aten.index, aten._unsafe_index, aten.gather, aten.index_select,
    aten.embedding, aten.embedding_dense_backward,
    aten.index_put, aten.index_put_, aten._index_put_impl_,
    aten.scatter, aten.scatter_, aten.scatter_add, aten.scatter_add_,
    aten.index_add, aten.index_add_,
    aten.sort, aten.topk, aten.cat,
    aten.slice_scatter, aten.select_scatter,
}

#: ops that compute nothing (besides views): allocation, aliasing
_FREE_OPS = {aten.detach, aten._unsafe_view, aten.empty, aten.empty_like,
             aten.empty_strided, aten.lift_fresh, aten.alias}

#: the functional collectives DTensor's redistributions run, by the
#: reference's HLO names
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(func, args) -> int:
    """The group size of a functional collective: its ``group_size``
    argument, or the size of the group its ``group_name`` names."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for arg, value in zip(func._schema.arguments, args):
        if arg.name == "group_size":
            return int(value)
        if arg.name == "group_name":
            return _resolve_process_group(value).size()
    raise ValueError(f"{func}: no group in its arguments")


class StepCounter(TorchDispatchMode):
    """Counts FLOPs and HBM bytes of the ops run inside it, records every
    collective as (kind, output bytes, group size), and tracks the bytes
    held: ``inputs`` (the tensors of ``track``), ``live`` and ``peak``,
    and ``peak_held``, the bytes held at the peak by what made them."""

    def __init__(self, track=()) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: list[tuple[str, int, int]] = []
        self.live = self.peak = 0
        self.held: dict[str, int] = {}
        self.peak_held: dict[str, int] = {}
        self._refs: dict[int, weakref.ref] = {}
        for t in _tensors(track):
            self._hold(t._local_tensor if isinstance(t, DTensor) else t,
                       "inputs")
        self.inputs = self.live

    def _hold(self, t: torch.Tensor, by: str) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        n = st.nbytes()
        self._refs[key] = weakref.ref(st, functools.partial(self._free, key,
                                                            n, by))
        self.live += n
        self.held[by] = self.held.get(by, 0) + n
        if self.live > self.peak:
            self.peak = self.live
            self.peak_held = dict(self.held)

    def _free(self, key: int, n: int, by: str, _ref) -> None:
        self._refs.pop(key, None)
        self.live -= n
        self.held[by] -= n

    def __enter__(self):
        self._fake_on_entry = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake_on_entry:
            return out          # DTensor's sharding propagation
        packet = func._overloadpacket
        phase = ("backward" if torch._C._current_graph_task_id() != -1
                 else "forward" if torch.is_grad_enabled() else "no-grad")
        for t in _tensors(out):
            self._hold(t, f"{phase} {packet.__name__}")
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVE_OPS.get(packet.__name__)
            if kind is not None:
                self.collectives.append((kind, sum(map(_nbytes,
                                                       _tensors(out))),
                                         _group_size(func, args)))
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif not func.is_view and packet not in _FREE_OPS:
            self.flops += _ELEMENTWISE_COST * sum(
                t.numel() for t in _tensors(out))
        if packet in HBM_OPS or (packet is aten.copy_ and args[0]._is_view()):
            self.bytes += sum(map(_nbytes, _tensors((args, kwargs))))
            self.bytes += sum(map(_nbytes, _tensors(out)))
        return out


def step_cost(fn, *args) -> tuple[float, float]:
    """(flops, bytes) of ``fn(*args)`` as it runs on this rank (the whole
    step where nothing is sharded)."""
    with StepCounter() as counter:
        fn(*args)
    return counter.flops, counter.bytes

