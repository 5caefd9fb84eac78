"""The port's continuous-batching engine against the reference's for the
SSM (reduced mamba2) and hybrid (reduced zamba2) families.

The reference initialises the weights and ``repro_torch.weights`` carries
them across. Both engines are driven in lockstep: every step finishes the
same requests with the same greedy tokens and the same slot lengths. The
reduced chunk is 16, so prompts have at most 16 tokens or a multiple of 16
(the reference asserts on any other length, and the port raises).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax

from repro.configs import get_config as ref_get_config
from repro.models.transformer import build_model as ref_build_model
from repro.serve import engine as ref_engine
from repro_torch.configs import get_config
from repro_torch.models.transformer import build_model
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.weights import hybrid_params_from_flat, ssm_params_from_flat

ARCHS = {"mamba2-1.3b": ssm_params_from_flat,
         "zamba2-2.7b": hybrid_params_from_flat}


def flat_params(params) -> dict:
    """A JAX param pytree as a flat dict of numpy arrays keyed by path."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in leaves}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def served(request):
    arch = request.param
    ref_model = ref_build_model(ref_get_config(arch).reduced())
    ref_params = ref_model.init(jax.random.key(11))
    cfg = get_config(arch).reduced()
    params = ARCHS[arch](flat_params(ref_params), cfg, "cpu")
    return build_model(cfg, device="cpu"), params, ref_model, ref_params


class Pair:
    """The port's engine and the reference's, driven in lockstep."""

    def __init__(self, served, **kw):
        model, params, ref_model, ref_params = served
        self.eng = ServingEngine(model, params, **kw)
        self.ref = ref_engine.ServingEngine(ref_model, ref_params, **kw)
        self.reqs = []

    def submit(self, prompt, max_new_tokens):
        req = Request(prompt.copy(), max_new_tokens=max_new_tokens)
        ref_req = ref_engine.Request(prompt.copy(),
                                     max_new_tokens=max_new_tokens)
        self.reqs.append((req, ref_req))
        self.eng.submit(req)
        self.ref.submit(ref_req)
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
        while self.eng.waiting or self.eng.active:
            self.step()
        assert not (self.ref.waiting or self.ref.active)
        for req, ref_req in self.reqs:
            assert req.generated == ref_req.generated
            assert req.slot == ref_req.slot


def greedy_reference(model, params, prompt, n_new):
    """Sequential single-request decode on the port (oracle)."""
    cache = model.init_cache(1, 64)
    logits, cache = model.prefill(
        params, {"tokens": torch.as_tensor(prompt)[None, :]}, cache)
    out = [int(torch.argmax(logits[0, -1]))]
    for _ in range(n_new - 1):
        logits, cache = model.decode(
            params, torch.tensor([[out[-1]]], dtype=torch.int32), cache)
        out.append(int(torch.argmax(logits[0, -1])))
    return out


def test_streams_equal_the_jax_engine(served):
    """Three slots: two requests (one of a single chunk, one of two), an
    idle slot stepping its state on token 0, then a request of 32 tokens
    admitted mid-flight into it, a one-token prompt (the decode branch) and
    slot reuse after."""
    model, params = served[:2]
    rng = np.random.default_rng(0)
    prompt = lambda n: rng.integers(0, 512, n).astype(np.int32)
    pair = Pair(served, n_slots=3, max_len=64)
    first = pair.submit(prompt(7), 6)
    pair.submit(prompt(16), 9)
    pair.step()
    pair.step()
    assert len(pair.eng.active) == 2                  # slot 2 idles
    late = pair.submit(prompt(32), 5)
    pair.step()
    assert late.slot == 2
    pair.submit(prompt(1), 4)
    pair.submit(prompt(12), 3)
    pair.drain()
    assert len(pair.eng.free_slots) == 3
    for req in (first, late):
        assert req.generated == greedy_reference(model, params, req.prompt,
                                                 req.max_new_tokens)


def test_greedy_is_deterministic(served):
    p = np.random.default_rng(3).integers(0, 512, 10).astype(np.int32)

    def once():
        pair = Pair(served, n_slots=2, max_len=32)
        req = pair.submit(p, 5)
        pair.drain()
        return req.generated

    assert once() == once()      # deterministic -> publishable by content hash
