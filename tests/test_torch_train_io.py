"""The port's post-training losses against the reference's, its data
pipeline, its CAS checkpoints, and resume through ``launch.train``.

DPO, PPO and reward-model losses run on reduced smollm-135m in fp32 with
the reference's weights and the same numpy inputs (2e-5). The rest holds
the port to the reference's contracts: the stream is a pure function of
(seed, step, host), blobs are named by the reference's content hash and
deduplicated, and a resumed run equals an uninterrupted one bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.core import cas as ref_cas
from repro.core.identity import content_hash as ref_content_hash
from repro.models.transformer import build_model as ref_build_model
from repro.train import losses as ref_losses
from repro.train.data import preference_batch as ref_preference_batch
from repro_torch.configs import get_config
from repro_torch.core.cas import CAS, DiskCAS, content_hash
from repro_torch.launch import train
from repro_torch.models.common import tree_leaves
from repro_torch.models.transformer import build_model
from repro_torch.train import losses
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.data import DataConfig, SyntheticLM, preference_batch
from repro_torch.train.optimizer import OptimizerConfig, build_optimizer
from repro_torch.weights import dense_params_from_flat

TOL = dict(rtol=2e-5, atol=2e-5)


def flat_params(params) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in leaves}


@pytest.fixture(scope="module")
def models():
    ref_model = ref_build_model(ref_get_config("smollm-135m").reduced())
    model = build_model(get_config("smollm-135m").reduced(), device="cpu")
    ref_params = [ref_model.init(jax.random.key(s)) for s in (5, 6)]
    params = [dense_params_from_flat(flat_params(p), model.cfg, "cpu")
              for p in ref_params]
    return ref_model, ref_params, model, params


def both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})


def test_dpo_and_reward_losses_match_jax(models):
    ref_model, (rp, rp_ref), model, (p, p_ref) = models
    jb, tb = both({k: np.asarray(v) for k, v in
                   ref_preference_batch(512, 24, 3, step=1).items()})
    np.testing.assert_allclose(
        float(losses.dpo_loss(model, p, p_ref, tb, beta=0.5)),
        float(ref_losses.dpo_loss(ref_model, rp, rp_ref, jb, beta=0.5)),
        **TOL)
    np.testing.assert_allclose(
        float(losses.reward_model_loss(model, p, tb)),
        float(ref_losses.reward_model_loss(ref_model, rp, jb)), **TOL)


@pytest.mark.parametrize("ent_coef", [0.0, 0.01])
def test_ppo_and_sft_losses_match_jax(models, ent_coef):
    ref_model, (rp, _), model, (p, _) = models
    rng = np.random.default_rng(2)
    B, T = 3, 20
    batch = {"tokens": rng.integers(0, 512, (B, T)).astype(np.int32),
             "labels": rng.integers(0, 512, (B, T)).astype(np.int32),
             "old_logprobs": (-6.2 + 0.3 * rng.standard_normal((B, T))
                              ).astype(np.float32),
             "advantages": rng.standard_normal((B, T)).astype(np.float32),
             "mask": (rng.random((B, T)) > 0.3).astype(np.float32)}
    jb, tb = both(batch)
    np.testing.assert_allclose(
        float(losses.ppo_loss(model, p, tb, ent_coef=ent_coef)),
        float(ref_losses.ppo_loss(ref_model, rp, jb, ent_coef=ent_coef)),
        **TOL)
    sft = {"tokens": batch["tokens"], "labels": batch["labels"],
           "loss_mask": batch["mask"]}
    jb, tb = both(sft)
    np.testing.assert_allclose(float(losses.sft_loss(model, p, tb)),
                               float(ref_losses.sft_loss(ref_model, rp, jb)),
                               **TOL)


def test_synthetic_lm_is_stateless_and_shardable():
    data = SyntheticLM(DataConfig(vocab_size=1000, seq_len=16,
                                  global_batch=8, seed=4))
    a, b = data.batch(3), data.batch(3)
    for k in ("tokens", "labels", "loss_mask"):
        assert a[k].dtype == torch.int32 and a[k].shape == (8, 16)
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["tokens"], data.batch(4)["tokens"])
    assert int(a["tokens"].max()) < 1000 and int(a["loss_mask"].min()) == 1
    # the reference's formula over base draws seeded by (seed, step, host)
    base = np.random.default_rng((4, 3, 0)).integers(0, 97, (8, 17))
    np.testing.assert_array_equal(a["tokens"].numpy(),
                                  (base[:, :-1] * 31 + base[:, 1:]) % 1000)
    np.testing.assert_array_equal(
        a["labels"].numpy(), (base[:, 1:] * 31 + (base[:, 1:] + 1) % 97) % 1000)
    shards = [data.batch(3, host_id=h, n_hosts=2) for h in (0, 1)]
    assert all(s["tokens"].shape == (4, 16) for s in shards)
    assert not torch.equal(shards[0]["tokens"], shards[1]["tokens"])
    assert torch.equal(shards[1]["labels"],
                       data.batch(3, host_id=1, n_hosts=2)["labels"])
    pref = preference_batch(512, 16, 2, step=5)
    assert torch.equal(pref["chosen_labels"],
                       torch.roll(pref["chosen"], -1, dims=1))
    assert float(pref["chosen_mask"][:, :4].sum()) == 0.0
    assert float(pref["chosen_mask"][:, 4:].min()) == 1.0


def small_state(model):
    opt = build_optimizer(OptimizerConfig())
    params = model.init(torch.Generator().manual_seed(0))
    params["embed"] = params["embed"].to(torch.bfloat16)
    return {"params": params, "opt": opt.init(params)}


@pytest.mark.parametrize("backend", ["memory", "disk"])
def test_checkpoint_round_trips_and_dedups(models, tmp_path, backend):
    _, _, model, _ = models
    cas = CAS() if backend == "memory" else DiskCAS(str(tmp_path))
    ckpt = Checkpointer(cas, "run-a")
    state = small_state(model)
    m1 = ckpt.save(state, step=7, extra={"arch": "smollm-135m"})
    restored, step, extra = ckpt.restore()
    assert (step, extra) == (7, {"arch": "smollm-135m"})
    assert restored["params"]["layers"]._fields == ("attn", "mlp", "norm1",
                                                    "norm2")
    leaves, back = tree_leaves(state), tree_leaves(restored)
    assert len(leaves) == len(back)
    for a, b in zip(leaves, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # one leaf changes: only it and the manifest are new blobs
    written, hits = cas.bytes_written, cas.dedup_hits
    state["params"]["final_norm"] = state["params"]["final_norm"] * 2
    m2 = ckpt.save(state, step=8)
    assert cas.dedup_hits - hits == len(leaves) - 1
    assert cas.bytes_written - written < 20_000
    assert ckpt.latest == m2 != m1 and m1 in cas
    assert torch.equal(ckpt.restore(m1)[0]["params"]["final_norm"],
                       torch.ones(model.cfg.d_model))


def test_cas_names_and_layout_are_the_references(tmp_path):
    data = b"\x00leaf bytes\xff"
    assert content_hash(data) == ref_content_hash(data)
    mine = DiskCAS(str(tmp_path))
    key = mine.put_bytes(data)
    mine.set_ref("checkpoint/x", key)
    theirs = ref_cas.DiskCAS(str(tmp_path))
    assert theirs.get_bytes(key) == data
    assert theirs.get_ref("checkpoint/x") == key


def run_train(tmp_path, cas, *extra):
    return train.main(["--reduced", "--device", "cpu", "--seq", "32",
                       "--batch", "4", "--steps", "6", "--ckpt-every", "3",
                       "--log-every", "0", "--cas", str(tmp_path / cas),
                       *extra])


def test_resume_latest_reproduces_an_uninterrupted_run(tmp_path):
    full = run_train(tmp_path, "a")
    first = run_train(tmp_path, "b", "--steps", "3")
    resumed = run_train(tmp_path, "b", "--resume", "latest")
    assert full["losses"][:3] == first["losses"]
    assert full["losses"][3:] == resumed["losses"]
    assert full["grad_norms"][3:] == resumed["grad_norms"]
    assert resumed["manifest"] == full["manifest"]   # bit-identical state


def assert_same_tree(got, want):
    """Same containers and NamedTuple classes, leaves equal bit for bit."""
    assert type(got) is type(want)
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.uint8) if got.dtype ==
                           torch.bfloat16 else got, want.view(torch.uint8)
                           if want.dtype == torch.bfloat16 else want)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_same_tree(a, b)
    else:
        assert got == want


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-moe-a2.7b",
                                  "mamba2-1.3b", "zamba2-2.7b"])
def test_train_state_round_trips_bit_identically(arch):
    """Dense, MoE, SSM and hybrid train states, after one AdamW step so the
    moments are set, restore with every NamedTuple and leaf as saved."""
    from repro_torch.train.train_step import (build_train_step,
                                              init_train_state)
    model = build_model(get_config(arch).reduced(), device="cpu")
    opt = build_optimizer(OptimizerConfig(warmup=1))
    state = init_train_state(model, opt, torch.Generator().manual_seed(0))
    data = SyntheticLM(DataConfig(model.cfg.vocab_size, 16, 2, seed=1))
    state, _ = build_train_step(model, opt)(state, data.batch(0))
    ckpt = Checkpointer(CAS(), arch)
    mhash = ckpt.save(state, step=1, extra={"arch": arch})
    restored, step, extra = ckpt.restore()
    assert (step, extra) == (1, {"arch": arch})
    assert_same_tree(restored, state)
    assert ckpt.save(restored, step=1, extra={"arch": arch}) == mhash


def test_checkpoint_refuses_an_unregistered_namedtuple():
    import collections
    ckpt = Checkpointer(CAS())
    for name in ("Pair", "DenseLayer"):     # unknown, and a name clash
        cls = collections.namedtuple(name, "a b")
        with pytest.raises(TypeError, match="unregistered NamedTuple"):
            ckpt.save({"p": cls(torch.zeros(2), torch.ones(2))}, step=0)
    assert ckpt.latest is None


def test_resume_latest_for_an_ssm_run(tmp_path):
    def run(cas, *extra):
        return train.main(["--arch", "mamba2-1.3b", "--reduced", "--device",
                           "cpu", "--seq", "32", "--batch", "2",
                           "--log-every", "0", "--ckpt-every", "1",
                           "--cas", str(tmp_path / cas), *extra])
    full = run("a", "--steps", "3")
    run("b", "--steps", "2")
    resumed = run("b", "--steps", "3", "--resume", "latest")
    assert resumed["losses"] == full["losses"][2:]
    assert resumed["manifest"] == full["manifest"]
