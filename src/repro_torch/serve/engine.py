"""Continuous-batching serving engine (counterpart of
``repro/serve/engine.py``).

A slot-based contiguous cache with a free-slot allocator and per-slot
valid lengths: K/V of (L, n_slots, max_len, H_kv, hd) for the dense LM,
SSM states of (L, n_slots, ...) for mamba2, and both for the hybrid, whose
states are (groups, per_group, n_slots, ...). Continuous batching admits
new requests into free slots between decode steps; one decode step always
runs over all slots (idle slots are masked by their length, their index
keeps advancing and their states keep stepping, as in the reference).

The cache is updated in place: an admitted request is prefilled straight
into its slot of every leaf (the model names each leaf's slot axis), which
is zeroed first, so the slot ends up as the reference's one-slot mini
cache spliced into the big one.

The decode step is compiled, as the reference jits it: on the card a
CUDA graph (``repro_torch.graphs``) over static inputs, the params, a
``(n_slots, 1)`` token buffer and the cache, with the greedy argmax of
every row inside it; on the CPU the same function runs eagerly. A step
reads the device once, for the chosen tokens and the slots' lengths
together. Rows that sample draw from the step's logits outside the graph.
The prefill stays eager: one per request, at its exact length.
"""
from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.graphs import CompiledStep
from repro_torch.models.common import tree_leaves, tree_map

_req_ids = itertools.count()


def greedy_step(model, params: dict, tokens: torch.Tensor, cache: dict
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step over every slot, in place: the model writes the
    cache's leaves, and the advanced ``index`` is copied into the cache's
    own. Returns (logits (n_slots, V), the greedy token of every row then
    every slot's index, as one int64 vector of 2 * n_slots)."""
    logits, new = model.decode(params, tokens, cache)
    cache["index"].copy_(new["index"])
    last = logits[:, -1]
    return last, torch.cat([last.argmax(dim=-1), cache["index"].long()])


@dataclass
class Request:
    prompt: np.ndarray                  # (T,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0            # 0 => greedy (deterministic -> CAS!)
    tenant: str = "default"
    req_id: int = field(default_factory=lambda: next(_req_ids))
    # filled by the engine:
    generated: list[int] = field(default_factory=list)
    slot: int | None = None
    done: bool = False


class ServingEngine:
    """One persistent executor lane: weights stay resident on the model's
    device, requests from any tenant stream through."""

    def __init__(self, model, params, *, n_slots: int = 8,
                 max_len: int = 1024, seed: int = 0) -> None:
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.cache = model.init_cache(n_slots, max_len)
        self.tokens = torch.zeros((n_slots, 1), dtype=torch.int64,
                                  device=self.device)
        #: the last decode step's logits (n_slots, V); on the card a view
        #: of the graph's output, overwritten by the next step
        self.logits: torch.Tensor | None = None
        self._decode = CompiledStep(functools.partial(greedy_step, model),
                                    self.device)
        self.free_slots = list(range(n_slots))
        self.active: dict[int, Request] = {}       # slot -> request
        self.waiting: list[Request] = []
        # sampled decoding only; not held to token parity with JAX
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.steps = 0
        self.tokens_generated = 0

    # ------------------------------------------------------------- admit --
    def submit(self, req: Request) -> int:
        self.waiting.append(req)
        return req.req_id

    def _prefill(self, prompt: np.ndarray, slot: int) -> torch.Tensor:
        """Exact-length prefill of one request into ``slot``: the slot's
        slice of every cache leaf is zeroed, the prompt's K/V and states
        written into it, and the slot's length set to T. Returns the last
        position's logits (1, V)."""
        T = len(prompt)
        if not 0 < T <= self.max_len:
            raise ValueError(f"prompt length {T} not in [1, {self.max_len}]")
        axes = self.model.cache_slot_axes()
        mini = tree_map(lambda leaf, axis: leaf.narrow(axis, slot, 1),
                        {name: self.cache[name] for name in axes}, axes)
        for leaf in tree_leaves(mini):
            leaf.zero_()
        mini["index"] = torch.zeros((1,), dtype=torch.int32,
                                    device=self.device)
        tokens = torch.as_tensor(np.asarray(prompt, np.int64),
                                 device=self.device).reshape(1, T)
        logits, _ = self.model.prefill(self.params, {"tokens": tokens}, mini)
        self.cache["index"][slot] = T
        return logits[:, -1]

    def _admit(self) -> None:
        while self.waiting and self.free_slots:
            req = self.waiting.pop(0)
            slot = self.free_slots.pop(0)
            logits = self._prefill(req.prompt, slot)
            req.generated.append(self._sample(logits, [req])[0])
            req.slot = slot
            self.active[slot] = req

    # ------------------------------------------------------------- decode --
    def _sample(self, logits: torch.Tensor, reqs: list[Request | None]
                ) -> list[int]:
        """Next token for each row of ``logits`` (n, V): greedy argmax for
        all rows in one pass, a draw for rows whose request samples."""
        return self._draws(logits, reqs, logits.argmax(dim=-1).tolist())

    def _draws(self, logits: torch.Tensor, reqs: list[Request | None],
               out: list[int]) -> list[int]:
        """``out`` with each row whose request samples replaced by a draw
        from its row of ``logits`` with the engine's generator."""
        for i, req in enumerate(reqs):
            if req is not None and req.temperature > 0.0:
                probs = torch.softmax(logits[i].float() / req.temperature, -1)
                out[i] = int(torch.multinomial(probs, 1,
                                               generator=self.generator))
        return out

    def _feed(self) -> None:
        """Each active slot's last token into the static token buffer
        (idle slots read 0)."""
        toks = np.zeros((self.n_slots, 1), np.int64)
        for slot, req in self.active.items():
            toks[slot, 0] = req.generated[-1]
        self.tokens.copy_(torch.from_numpy(toks), non_blocking=True)

    def step(self) -> list[Request]:
        """One engine iteration: admit -> one batched decode -> retire.
        Returns requests completed this step."""
        self._admit()
        if not self.active:
            return []
        self._feed()
        self.logits, picked = self._decode(self.params, self.tokens,
                                           self.cache)
        self.steps += 1
        picked = picked.tolist()        # the step's one device-to-host read
        index = picked[self.n_slots:]
        nxt = self._draws(self.logits, [self.active.get(s) for s in
                                        range(self.n_slots)],
                          picked[:self.n_slots])
        finished = []
        for slot, req in list(self.active.items()):
            req.generated.append(nxt[slot])
            self.tokens_generated += 1
            limit = (len(req.generated) >= req.max_new_tokens
                     or index[slot] >= self.max_len - 1)
            if limit:
                req.done = True
                finished.append(req)
                del self.active[slot]
                self.free_slots.append(slot)
        return finished

    def run(self, requests: list[Request]) -> list[Request]:
        """Serve a closed batch of requests to completion (test harness)."""
        for r in requests:
            self.submit(r)
        done: list[Request] = []
        while self.waiting or self.active:
            done.extend(self.step())
        return done

    @property
    def occupancy(self) -> float:
        return len(self.active) / self.n_slots
