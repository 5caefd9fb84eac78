"""The port's continuous-batching engine against the reference's.

The four scenarios of ``tests/test_serve_engine.py`` on the same weights
and prompts (the reference initialises, ``repro_torch.weights`` carries
them across): each scenario's own checks hold on the port, and every greedy
token stream is identical to the JAX engine's. A fifth scenario keeps a slot
idle for more than ``max_len`` decode steps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.models.transformer import build_model as ref_build_model
from repro.serve import engine as ref_engine
from repro_torch.configs import get_config
from repro_torch.models.transformer import build_model
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.weights import dense_params_from_flat

OVERRIDES = dict(n_layers=2, d_model=64, vocab_size=128, d_ff=128)


def flat_params(params) -> dict:
    """A JAX param pytree as a flat dict of numpy arrays keyed by path."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in leaves}


@pytest.fixture(scope="module")
def served():
    ref_model = ref_build_model(ref_get_config("smollm-135m")
                                .reduced(**OVERRIDES))
    ref_params = ref_model.init(jax.random.key(0))
    cfg = get_config("smollm-135m").reduced(**OVERRIDES)
    model = build_model(cfg, device="cpu")
    params = dense_params_from_flat(flat_params(ref_params), cfg, "cpu")
    return model, params, ref_model, ref_params


class Pair:
    """The port's engine and the reference's, driven in lockstep."""

    def __init__(self, served, **kw):
        model, params, ref_model, ref_params = served
        self.eng = ServingEngine(model, params, **kw)
        self.ref = ref_engine.ServingEngine(ref_model, ref_params, **kw)
        self.reqs = {}

    def submit(self, prompt, max_new_tokens, **kw):
        req = Request(prompt.copy(), max_new_tokens=max_new_tokens, **kw)
        self.reqs[req.req_id] = (req, ref_engine.Request(
            prompt.copy(), max_new_tokens=max_new_tokens, **kw))
        self.eng.submit(req)
        self.ref.submit(self.reqs[req.req_id][1])
        return req

    def step(self):
        done = self.eng.step()
        ref_done = self.ref.step()
        assert [r.generated for r in done] == \
            [r.generated for r in ref_done]
        assert self.eng.cache["index"].tolist() == \
            np.asarray(self.ref.cache["index"]).tolist()
        return done

    def drain(self):
        done = []
        while self.eng.waiting or self.eng.active:
            done.extend(self.step())
        assert not (self.ref.waiting or self.ref.active)
        for req, ref_req in self.reqs.values():
            assert req.generated == ref_req.generated
            assert req.slot == ref_req.slot
        return done


def greedy_reference(model, params, prompt, n_new):
    """Sequential single-request decode on the port (oracle)."""
    cache = model.init_cache(1, 512)
    logits, cache = model.prefill(
        params, {"tokens": torch.as_tensor(prompt)[None, :]}, cache)
    out = [int(torch.argmax(logits[0, -1]))]
    for _ in range(n_new - 1):
        logits, cache = model.decode(
            params, torch.tensor([[out[-1]]], dtype=torch.int32), cache)
        out.append(int(torch.argmax(logits[0, -1])))
    return out


def test_batched_equals_sequential(served):
    model, params = served[:2]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, size=n).astype(np.int32)
               for n in (5, 9, 13)]
    pair = Pair(served, n_slots=4, max_len=512)
    reqs = [pair.submit(p, 6) for p in prompts]
    pair.drain()
    for req, p in zip(reqs, prompts):
        assert req.generated == greedy_reference(model, params, p, 6)


def test_admission_mid_flight(served):
    model, params = served[:2]
    rng = np.random.default_rng(1)
    pair = Pair(served, n_slots=2, max_len=256)
    r1 = pair.submit(rng.integers(0, 128, 7).astype(np.int32), 12)
    r2 = pair.submit(rng.integers(0, 128, 5).astype(np.int32), 12)
    pair.step()
    # both slots busy; a third tenant's request arrives mid-decode
    r3 = pair.submit(rng.integers(0, 128, 4).astype(np.int32), 4,
                     tenant="tenant-B")
    done = pair.drain()
    assert {r.req_id for r in done} == {r1.req_id, r2.req_id, r3.req_id}
    assert r3.generated == greedy_reference(model, params, r3.prompt, 4)


def test_slot_reuse_many_requests(served):
    model, params = served[:2]
    rng = np.random.default_rng(2)
    pair = Pair(served, n_slots=2, max_len=128)
    reqs = [pair.submit(rng.integers(0, 128, 4 + i % 3).astype(np.int32), 3)
            for i in range(7)]
    assert len(pair.drain()) == 7
    assert len(pair.eng.free_slots) == 2          # all slots returned
    for r in reqs:
        assert r.generated == greedy_reference(model, params, r.prompt, 3)


def test_greedy_is_deterministic(served):
    p = np.random.default_rng(3).integers(0, 128, 6).astype(np.int32)

    def once():
        pair = Pair(served, n_slots=2, max_len=128)
        req = pair.submit(p, 5)
        pair.drain()
        return req.generated

    assert once() == once()      # deterministic -> publishable by content hash


def test_idle_slot_runs_past_max_len(served):
    """Slot 2 idles while the other slots serve for more than ``max_len``
    steps; its index runs past the end (its cache writes clamp to the last
    row), and it still serves a request exactly like the reference after."""
    max_len = 16
    rng = np.random.default_rng(4)
    prompt = lambda n: rng.integers(0, 128, n).astype(np.int32)
    pair = Pair(served, n_slots=3, max_len=max_len)
    pair.submit(prompt(3), 2)                      # slot 0, short
    pair.submit(prompt(2), 100)                    # slot 1, to max_len
    pair.submit(prompt(3), 2)                      # slot 2, short
    pair.step()
    pair.step()
    assert sorted(pair.eng.free_slots) == [0, 2]
    pair.submit(prompt(2), 100)                    # slot 0 again
    while pair.eng.active:
        pair.step()
    assert pair.eng.free_slots[0] == 2
    assert pair.eng.cache["index"][2] > max_len
    late = pair.submit(prompt(5), 4)               # lands in slot 2
    pair.drain()
    assert late.slot == 2
