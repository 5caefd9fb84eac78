"""TorchExecutor: the fabric's workers running real PyTorch compute.

The port's counterpart of ``repro/core/jax_executor.py``. The virtual-time
SimExecutor answers "what would this cost on an H100 fleet"; this executor
runs the operators: generation, scoring and eval through the
continuous-batching ``ServingEngine`` (the ``decode_attention`` kernel on
every decode step), SFT/DPO/PPO through the train step (the flash attention
kernels forward and backward). Both are compiled, as the reference jits
them: on the card CUDA graphs, the engines' through ``ServingEngine`` and
the train step through ``make_training``, whose state every train op
loads its own start into. Durations are measured wall clock, after
``torch.cuda.synchronize()`` on a card; outputs are deterministic functions
of the inputs (greedy decode, seeded data), so dedup, speculation and CAS
semantics hold bit for bit.

One runtime per fabric. H_task (``identity.py``) names the model, the
params and the inputs, not the runtime, so a JAX worker and a torch worker
would share one result index across outputs that differ in their float
bits: a fabric's workers all run this executor or all run the reference's.

One executor instance plays the role of the container image: per-worker
runtime state (a ``ServingEngine`` per worker id) mirrors the worker's
resident-model set. By default the model is the reference executor's tiny
config (``reduced(n_layers=2, d_model=64, vocab_size=256, d_ff=128)``);
``full_width=True`` takes the published config unchanged. It runs on the
card unless ``device="cpu"`` is given, and raises without one.
"""
from __future__ import annotations

import pickle
import time
from collections import defaultdict
from typing import Callable

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.common import tree_map
from repro_torch.models.transformer import build_model
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import make_training

from .dag import OpType
from .identity import digest
from .worker import DispatchBatch, ExecResult, Executor, Worker


class TorchExecutor(Executor):
    """``params`` (serving weights), ``train_init`` (the params every train
    op starts from) and ``batches`` (``DataConfig`` -> an object with
    ``batch(step)``) replace the executor's own draws: without them it
    inits from ``torch.Generator(device).manual_seed(seed)``, each train op
    from ``manual_seed(1)``, and trains on ``SyntheticLM``. Parity tests
    fill them with the reference's ``jax.random`` draws, which torch cannot
    redraw."""

    def __init__(self, *, arch: str = "smollm-135m", seed: int = 0,
                 train_steps_per_op: int = 3, gen_tokens: int = 8,
                 full_width: bool = False, device: str | torch.device = "cuda",
                 params: dict | None = None, train_init: dict | None = None,
                 batches: Callable[[DataConfig], object] | None = None
                 ) -> None:
        cfg = get_config(arch)
        if not full_width:
            cfg = cfg.reduced(n_layers=2, d_model=64, vocab_size=256,
                              d_ff=128)
        self.cfg = cfg
        self.model = build_model(cfg, device=device)   # raises without a card
        self.device = self.model.device
        self.params = params if params is not None else self.model.init(
            torch.Generator(device=self.device).manual_seed(seed))
        self.train_init = train_init
        self.batches = batches or (
            lambda dcfg: SyntheticLM(dcfg, device=self.device))
        self.train_steps_per_op = train_steps_per_op
        self.gen_tokens = gen_tokens
        self._train_state, self._train_step = make_training(
            self.model, OptimizerConfig(peak_lr=1e-3, warmup=2),
            torch.Generator(device=self.device).manual_seed(1))
        # every op starts from these params and a zeroed optimizer state
        if self.train_init is None:
            self.train_init = tree_map(torch.clone,
                                       self._train_state["params"])
        self._engines: dict[str, ServingEngine] = {}   # worker_id -> engine
        #: wall ms of each executed batch, by op type value
        self.op_ms: dict[str, list[float]] = defaultdict(list)

    # ------------------------------------------------------------------
    def _prompt_from(self, hashes: tuple[str, ...], length: int = 12
                     ) -> np.ndarray:
        # stable across processes (python's hash() is randomized)
        seed = int(digest("prompt", *hashes)[:8], 16)
        rng = np.random.default_rng(seed)
        return rng.integers(0, self.cfg.vocab_size, length).astype(np.int32)

    def _engine_for(self, worker: Worker) -> ServingEngine:
        eng = self._engines.get(worker.worker_id)
        if eng is None:
            eng = ServingEngine(self.model, self.params, n_slots=4,
                                max_len=256)
            self._engines[worker.worker_id] = eng
        return eng

    def _fresh_train_state(self) -> dict:
        """The compiled step's own state, set to ``train_init`` and a
        zeroed optimizer state: never new tensors, which the step's graph
        does not read."""
        state = self._train_state
        self._train_step.load({"params": self.train_init,
                               "opt": tree_map(torch.zeros_like,
                                               state["opt"])})
        return state

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def execute(self, batch: DispatchBatch, worker: Worker, cas) -> ExecResult:
        self._sync()
        t0 = time.perf_counter()
        spec = batch.groups[0].spec
        cold = bool(spec.model_id) and not worker.is_hot_for(spec.h_model)
        outputs = []
        if spec.op_type in (OpType.GENERATE, OpType.SCORE, OpType.EVAL):
            eng = self._engine_for(worker)
            reqs = [Request(self._prompt_from(g.input_hashes),
                            max_new_tokens=self.gen_tokens, temperature=0.0)
                    for g in batch.groups]
            done = {r.req_id: r for r in eng.run(list(reqs))}
            for r in reqs:
                outputs.append(pickle.dumps(
                    {"op": spec.op_type.value,
                     "tokens": done[r.req_id].generated}))
        elif spec.op_type in (OpType.SFT, OpType.DPO, OpType.PPO):
            state = self._fresh_train_state()
            data = self.batches(DataConfig(
                self.cfg.vocab_size, 32, 4,
                seed=int(digest("data", spec.name)[:6], 16)))
            losses = []
            for i in range(self.train_steps_per_op):
                state, m = self._train_step(state, data.batch(i))
                losses.append(float(m["loss"]))
            for g in batch.groups:
                outputs.append(pickle.dumps(
                    {"op": spec.op_type.value, "losses": losses,
                     "inputs": g.input_hashes}))
        else:   # TOOL / DATA_PREP / AGGREGATE: deterministic transform
            for g in batch.groups:
                payload = [cas.get_bytes(h)[:64] for h in g.input_hashes
                           if h in cas]
                outputs.append(pickle.dumps(
                    {"op": spec.op_type.value,
                     "digest": [bytes(p) for p in payload]}))
        self._sync()
        dur = time.perf_counter() - t0
        self.op_ms[spec.op_type.value].append(dur * 1e3)
        load_s = 0.15 if cold else 0.0     # weight upload for a tiny model
        return ExecResult(outputs=outputs, duration_s=dur, load_s=load_s,
                          flops=0.0)
