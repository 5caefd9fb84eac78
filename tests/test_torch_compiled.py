"""The port's compiled steps (``repro_torch.graphs``) against the reference.

On the card the engine's decode step and ``make_training``'s train step are
CUDA graphs. Here the graph logic runs on the CPU with a stand-in for
``torch.cuda.CUDAGraph`` and ``torch.cuda.graph``: the stand-in records
every ATen op the captured function runs (a ``TorchDispatchMode``) and a
replay runs those ops again over the same tensors, writing each fresh
result into the tensor the capture made, and runs no Python, as a CUDA
graph does. So a replay that reads a tensor nobody refreshed, or a counter
only Python moves, shows here as it would on the card. Through it:

- reduced dense and mamba2 engines give the JAX engine's greedy streams
  and ``index`` step by step (mid-flight admission, slot reuse, an idle
  slot past ``max_len``), and the same logits bit for bit as the eager
  engine; a replay whose token buffer was not refreshed is caught; a call
  over another cache or shape raises; the launch counters advance by the
  captured delta at each replay;
- ``make_training`` holds the reference's ``make_training`` over three
  steps on three batches (the tolerances of
  ``test_torch_train.py::test_three_optimizer_steps_match_jax``), a step
  that trains on a stale batch is caught, another state or batch shape
  raises, and a compress hook's residual is carried in place;
- ``TorchExecutor`` runs two train ops in a row, each from its own start,
  with the eager step's losses.
"""
import contextlib
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves

from repro.configs import get_config as ref_get_config
from repro.models.transformer import build_model as ref_build_model
from repro.serve import engine as ref_engine
from repro.train import optimizer as ref_opt
from repro.train.data import DataConfig as RefDataConfig
from repro.train.data import SyntheticLM as RefSyntheticLM
from repro.train.train_step import make_training as ref_make_training
from repro_torch import graphs
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import ref
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.transformer import DenseLM, build_model
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.train import optimizer
from repro_torch.train.train_step import build_train_step, make_training
from repro_torch.weights import dense_params_from_flat, ssm_params_from_flat

MAX_LEN = 16


def flat_params(params) -> dict:
    """A JAX param pytree as a flat dict of numpy arrays keyed by path."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in leaves}


# ------------------------------------------------------------- stand-in --
def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class _Recorder(TorchDispatchMode):
    """Every ATen op run while open, with its arguments and results. A
    capture on the card executes nothing, so the op runs (its results give
    the shapes the captured code goes on with), and every tensor from
    before the capture that an op writes gets its contents back when the
    recorder closes."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.fresh = set()        # storages that ops of the capture made
        self.saved = {}           # storage -> (storage, its contents before)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._local_scalar_dense.default:
            raise RuntimeError("a host read inside a captured step")
        for i, arg in enumerate(func._schema.arguments):
            t = args[i] if i < len(args) else kwargs.get(arg.name)
            if isinstance(t, torch.Tensor) and arg.alias_info is not None \
                    and arg.alias_info.is_write and \
                    _storage(t) not in self.fresh | set(self.saved):
                self.saved[_storage(t)] = (t.untyped_storage(),
                                           t.untyped_storage().clone())
        out = func(*args, **kwargs)
        held = _storages((args, kwargs))
        self.fresh |= _storages(out) - held
        self.ops.append((func, args, kwargs, out, held))
        return out

    def restore(self):
        for storage, before in self.saved.values():
            storage.copy_(before)


def _storages(tree) -> set:
    return {_storage(t) for t in pytree_leaves(tree)
            if isinstance(t, torch.Tensor)}


class FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: ``replay`` runs the recorded
    ops again over the recorded tensors. A result that shares no storage
    with the op's inputs (a fresh tensor, not a view or an in-place
    result) is copied into the tensor the capture made, where later ops
    and the caller read it."""

    made = []

    def __init__(self):
        self.ops = None
        self.replays = 0
        FakeGraph.made.append(self)

    def replay(self):
        # the ops run where the recorder saw them, below autograd
        with torch._C._AutoDispatchBelowADInplaceOrView():
            for func, args, kwargs, out, held in self.ops:
                new = func(*args, **kwargs)
                for o, n in zip(pytree_leaves(out), pytree_leaves(new)):
                    if isinstance(o, torch.Tensor) and \
                            _storage(o) not in held:
                        assert o.shape == n.shape, (func, o.shape, n.shape)
                        o.copy_(n)
        self.replays += 1


@contextlib.contextmanager
def fake_capture(graph, **kw):
    recorder = _Recorder()
    with recorder:
        yield
    recorder.restore()
    graph.ops = recorder.ops


@pytest.fixture
def recorded(monkeypatch):
    """CPU steps captured by the stand-in (the graph logic of the card)."""
    FakeGraph.made = []
    monkeypatch.setattr(graphs, "graphed", lambda device: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)
    return FakeGraph.made


# -------------------------------------------------------------- engines --
ENGINES = {"smollm-135m": (dict(n_layers=2, d_model=64, vocab_size=128,
                                d_ff=128), dense_params_from_flat),
           "mamba2-1.3b": ({}, ssm_params_from_flat)}


@pytest.fixture(scope="module", params=sorted(ENGINES))
def served(request):
    arch = request.param
    overrides, bridge = ENGINES[arch]
    ref_model = ref_build_model(ref_get_config(arch).reduced(**overrides))
    ref_params = ref_model.init(jax.random.key(7))
    cfg = get_config(arch).reduced(**overrides)
    params = bridge(flat_params(ref_params), cfg, "cpu")
    return build_model(cfg, device="cpu"), params, ref_model, ref_params


def traffic(drive, vocab: int) -> None:
    """Three slots of ``MAX_LEN``: two short requests and one that runs to
    the end; a request admitted mid-flight into a freed slot; slot 2 idle
    until its index is past ``max_len``; then a late request into it."""
    rng = np.random.default_rng(4)
    prompt = lambda n: rng.integers(0, vocab, n).astype(np.int32)
    drive.submit(prompt(3), 2)                     # slot 0, short
    drive.submit(prompt(2), 100)                   # slot 1, to max_len
    drive.submit(prompt(3), 2)                     # slot 2, short
    drive.step()
    drive.step()
    drive.submit(prompt(2), 100)                   # mid-flight, slot 0
    while drive.eng.active:
        drive.step()
    assert drive.eng.cache["index"][2] > MAX_LEN
    late = drive.submit(prompt(5), 4)              # lands in slot 2
    drive.drain()
    assert late.slot == 2


class Lockstep:
    """The port's engine and the JAX engine driven in lockstep: every step
    finishes the same requests with the same tokens and the same slot
    lengths; each step's logits are kept."""

    def __init__(self, served, eager: bool = False):
        model, params, ref_model, ref_params = served
        self.eng = ServingEngine(model, params, n_slots=3, max_len=MAX_LEN)
        if eager:
            self.eng._decode = self.eng._decode.fn
        self.ref = ref_engine.ServingEngine(ref_model, ref_params,
                                            n_slots=3, max_len=MAX_LEN)
        self.reqs = []
        self.logits = []

    def submit(self, prompt, max_new_tokens):
        req = Request(prompt.copy(), max_new_tokens=max_new_tokens)
        ref_req = ref_engine.Request(prompt.copy(),
                                     max_new_tokens=max_new_tokens)
        self.reqs.append((req, ref_req))
        self.eng.submit(req)
        self.ref.submit(ref_req)
        return req

    def step(self):
        steps = self.eng.steps
        done = self.eng.step()
        if self.eng.steps > steps:
            self.logits.append(self.eng.logits.clone())
        ref_done = self.ref.step()
        assert [r.generated for r in done] == \
            [r.generated for r in ref_done]
        assert self.eng.cache["index"].tolist() == \
            np.asarray(self.ref.cache["index"]).tolist()

    def drain(self):
        while self.eng.waiting or self.eng.active:
            self.step()
        assert not (self.ref.waiting or self.ref.active)
        for req, ref_req in self.reqs:
            assert (req.generated, req.slot) == \
                (ref_req.generated, ref_req.slot)


def test_graphed_engine_matches_the_reference(served, recorded):
    """Replays give the JAX engine's streams and lengths at every step,
    and the eager engine's logits bit for bit."""
    eager = Lockstep(served, eager=True)
    traffic(eager, served[0].cfg.vocab_size)
    run = Lockstep(served)
    traffic(run, served[0].cfg.vocab_size)
    step = run.eng._decode
    assert len(recorded) == 1 and recorded[0].ops
    assert step.calls == run.eng.steps and \
        step.replays == recorded[0].replays == run.eng.steps - 1
    assert len(run.logits) == len(eager.logits) == run.eng.steps
    for got, want in zip(run.logits, eager.logits):
        assert torch.equal(got, want)


def same_logits(got: list, want: list) -> None:
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"decode step {i + 1} differs"


def test_a_stale_token_buffer_is_caught(served, recorded, monkeypatch):
    """One replay whose token buffer was not refreshed (at a step whose
    tokens differ from the last step's) gives other logits than the eager
    engine, and the step-by-step comparison fails."""
    eager = Lockstep(served, eager=True)
    traffic(eager, served[0].cfg.vocab_size)
    run = Lockstep(served)
    feed, planted = run.eng._feed, []

    def stale():
        want = [run.eng.active[s].generated[-1] if s in run.eng.active
                else 0 for s in range(run.eng.n_slots)]
        if not planted and run.eng.steps >= 2 and \
                want != run.eng.tokens[:, 0].tolist():
            planted.append(run.eng.steps + 1)
            return
        feed()

    monkeypatch.setattr(run.eng, "_feed", stale)
    with pytest.raises(AssertionError):
        traffic(run, served[0].cfg.vocab_size)
    assert planted and planted[0] > 2        # a replay, not the capture
    with pytest.raises(AssertionError, match=f"step {planted[0]} differs"):
        same_logits(run.logits, eager.logits[:len(run.logits)])


def test_a_call_over_other_tensors_raises(served, recorded):
    model, params = served[:2]
    eng = ServingEngine(model, params, n_slots=3, max_len=MAX_LEN)
    eng.run([Request(np.arange(1, 4, dtype=np.int32), max_new_tokens=4)])
    assert eng._decode.replays == 2
    other = model.init_cache(3, MAX_LEN)
    for args in ((eng.params, eng.tokens, other),
                 (eng.params, torch.zeros((4, 1), dtype=torch.int64),
                  eng.cache),
                 (eng.params, eng.tokens.int(), eng.cache)):
        with pytest.raises(ValueError, match="tensors of its first call"):
            eng._decode(*args)


def counting(fn, counter):
    def counted(*args, **kw):
        counter.launches += 1
        return fn(*args, **kw)
    return counted


def test_counters_advance_by_the_captured_delta(recorded):
    """The decode kernel's counter reads layers x steps after a run in
    which every step but the first replayed (no Python ran there)."""
    cfg = get_config("smollm-135m").reduced(n_layers=3, d_model=64,
                                            vocab_size=128, d_ff=128)
    model = DenseLM(cfg, device="cpu", decode_attention=counting(
        ref.decode_attention_ref, dk.decode_attention))
    params = model.init(torch.Generator().manual_seed(0))
    eng = ServingEngine(model, params, n_slots=2, max_len=MAX_LEN)
    before = dk.decode_attention.launches
    eng.run([Request(np.arange(1, 5, dtype=np.int32), max_new_tokens=7)])
    assert eng._decode.replays == eng.steps - 1 == 5
    assert dk.decode_attention.launches - before == cfg.n_layers * eng.steps


# ------------------------------------------------------------ training --
OPTIMIZERS = {
    # as tests/test_torch_train.py::OPTIMIZERS
    "adamw": dict(name="adamw", peak_lr=3e-3, warmup=2, total_steps=10,
                  weight_decay=0.1, eps=1e-4),
    "adafactor": dict(name="adafactor", peak_lr=3e-3, warmup=2,
                      total_steps=10, weight_decay=0.1, momentum=True),
}
SEQ, BATCH = 32, 4


@pytest.fixture(scope="module")
def trained():
    ref_model = ref_build_model(ref_get_config("smollm-135m").reduced())
    cfg = get_config("smollm-135m").reduced()
    return ref_model, build_model(cfg, device="cpu")


def ref_batch(step):
    data = RefSyntheticLM(RefDataConfig(512, SEQ, BATCH, seed=3))
    return {k: np.asarray(v) for k, v in data.batch(step).items()}


def three_steps(trained, name, stale=False):
    """The reference's ``make_training`` and the port's from the same
    params, three steps on three batches; raises where they part."""
    ref_model, model = trained
    # its default key(0): a typed key has no truth value for its ``or``
    ref_state, ref_step = ref_make_training(
        ref_model, ref_opt.OptimizerConfig(**OPTIMIZERS[name]))
    state, step = make_training(model, optimizer.OptimizerConfig(
        **OPTIMIZERS[name]))
    params = dense_params_from_flat(flat_params(ref_state["params"]),
                                    model.cfg, "cpu")
    step.load({"params": params,
               "opt": tree_map(torch.zeros_like, state["opt"])})
    losses = []
    for i in range(3):
        batch = ref_batch(i)
        ref_state, ref_m = ref_step(
            ref_state, {k: jnp.asarray(v) for k, v in batch.items()})
        got, m = step(state, {k: torch.from_numpy(v.copy())
                              for k, v in batch.items()})
        assert got is state
        if stale and i == 0:               # later steps keep batch 0
            step._fill = lambda batch: None
        losses.append(float(m["loss"]))
        np.testing.assert_allclose(losses[-1], float(ref_m["loss"]),
                                   rtol=2e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=2e-4)
    assert int(state["opt"]["step"]) == 3
    for got, want in zip(tree_leaves(state["params"]),
                         jax.tree_util.tree_leaves(ref_state["params"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   atol=2e-5, rtol=2e-5)
    return step, losses


@pytest.mark.parametrize("graph", ["eager", "recorded"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_make_training_matches_the_reference(trained, name, graph, request):
    if graph == "recorded":
        request.getfixturevalue("recorded")
    step, losses = three_steps(trained, name)
    assert len(set(losses)) == 3
    assert step.compiled.replays == (2 if graph == "recorded" else 0)


def test_a_stale_batch_is_caught(trained, recorded):
    """Steps 2 and 3 replayed over batch 0 part from the reference."""
    with pytest.raises(AssertionError):
        three_steps(trained, "adamw", stale=True)


def test_the_step_owns_its_state(trained):
    _, model = trained
    state, step = make_training(model)
    batch = {k: torch.from_numpy(v.copy()) for k, v in ref_batch(0).items()}
    step(state, batch)
    other = {"params": tree_map(torch.clone, state["params"]),
             "opt": state["opt"]}
    with pytest.raises(ValueError, match="owns its state"):
        step(other, batch)
    with pytest.raises(ValueError, match="buffers"):
        step(state, {k: v[:2] for k, v in batch.items()})


def test_a_compress_residual_is_carried_in_place(trained, recorded):
    """A compress hook's residual, a new tensor each step, is copied into
    the state's own, which replays then read: it counts the steps."""
    _, model = trained

    def hook(grads, residual):
        return grads, (torch.zeros(()) if residual is None else residual) + 1

    state, step = make_training(model, compress=hook)
    for i in range(3):
        got, _ = step(state, {k: torch.from_numpy(v.copy())
                              for k, v in ref_batch(i).items()})
        assert got is state
    assert step.compiled.replays == 2
    assert float(state["compress_residual"]) == 3.0


# ------------------------------------------------------------- executor --
def train_batch(name: str):
    """A one-group SFT batch of op ``name`` for the port's executor."""
    from repro_torch.core import cost_model, dag, worker
    spec = dag.OperatorSpec(name, dag.OpType.SFT, "llama-3.2-1b",
                            inputs=["x"])
    group = worker.ExecutionGroup(h_task="0" * 20, h_exec=spec.h_exec(),
                                  spec=spec, input_hashes=("a" * 20,))
    batch = worker.DispatchBatch(batch_id=0, h_exec=spec.h_exec(),
                                 groups=[group], worker_id="w-0",
                                 admitted_at=0.0)
    w = worker.Worker("w-0", cost_model.DEVICE_CLASSES["rtx4090-24g"],
                      now=0.0)
    return batch, w


@pytest.mark.parametrize("graph", ["eager", "recorded"])
def test_executor_runs_two_train_ops(graph, request):
    """Two train ops in a row on one executor: each starts from the
    executor's initial params with a zeroed optimizer, and publishes the
    losses of the eager step on a fresh state."""
    from repro_torch.core.cas import CAS
    from repro_torch.core.identity import digest
    from repro_torch.core.torch_executor import TorchExecutor
    from repro_torch.train.data import DataConfig, SyntheticLM
    if graph == "recorded":
        request.getfixturevalue("recorded")
    executor = TorchExecutor(seed=0, device="cpu")
    init = tree_map(torch.clone, executor.train_init)
    for name in ("sft-a", "sft-b"):
        out = executor.execute(*train_batch(name), CAS())
        published = pickle.loads(out.outputs[0])["losses"]
        params = tree_map(torch.clone, init)
        opt = optimizer.build_optimizer(optimizer.OptimizerConfig(
            peak_lr=1e-3, warmup=2))
        state = {"params": params, "opt": opt.init(params)}
        step = build_train_step(executor.model, opt)
        data = SyntheticLM(DataConfig(executor.cfg.vocab_size, 32, 4,
                                      seed=int(digest("data", name)[:6],
                                               16)))
        want = []
        for i in range(executor.train_steps_per_op):
            state, m = step(state, data.batch(i))
            want.append(float(m["loss"]))
        assert published == want
    assert executor._train_step.compiled.replays == \
        (5 if graph == "recorded" else 0)
