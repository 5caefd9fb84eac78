"""The port's ``TorchExecutor`` against the reference's ``JaxExecutor``, and
the paper's RLHF workflow on the port's fabric.

On the CPU, with the reference's draws bridged to the port (the serving
weights from ``key(0)``, each train op's start from ``key(1)``, the train
batches from its ``SyntheticLM``): one batch of each op type, built from
the same spec and input hashes with each package's own classes. Served
payloads (GENERATE, SCORE, EVAL) and the CPU ops' payloads (TOOL,
DATA_PREP, AGGREGATE) are byte-identical; SFT, DPO and PPO losses agree at
the tolerance of ``tests/test_torch_train.py`` (2e-4), with the same
inputs. ``launch.rlhf`` runs the four RLHF tenants to the example's
assertions, and every served payload it publishes equals its prompt run
alone. The ``gpu`` case runs the executor on the card; JAX is imported only
inside the CPU cases (the machine with the card has none).
"""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.core.torch_executor import TorchExecutor
from repro_torch.launch import rlhf
from repro_torch.weights import dense_params_from_flat

TRAIN_TOL = dict(rtol=2e-4, atol=2e-4)
OP_TYPES = ["generate", "score", "eval", "sft", "dpo", "ppo", "tool",
            "data_prep", "aggregate"]
TRAINING = {"sft", "dpo", "ppo"}


def flat_params(jax, params) -> dict:
    """A JAX param pytree as a flat dict of numpy arrays keyed by path."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in leaves}


@pytest.fixture(scope="module")
def executors():
    """(JaxExecutor, TorchExecutor on the CPU with the JAX draws)."""
    jax = pytest.importorskip("jax")
    from repro.core.jax_executor import JaxExecutor
    from repro.train.data import DataConfig as RefDataConfig
    from repro.train.data import SyntheticLM as RefSyntheticLM

    class RefBatches:
        def __init__(self, dcfg):
            self.data = RefSyntheticLM(RefDataConfig(
                dcfg.vocab_size, dcfg.seq_len, dcfg.global_batch,
                seed=dcfg.seed))

        def batch(self, step):
            return {k: torch.from_numpy(np.array(v))
                    for k, v in self.data.batch(step).items()}

    ref = JaxExecutor(seed=0)
    cfg = get_config("smollm-135m").reduced(n_layers=2, d_model=64,
                                            vocab_size=256, d_ff=128)
    bridge = lambda p: dense_params_from_flat(flat_params(jax, p), cfg, "cpu")
    port = TorchExecutor(seed=0, device="cpu", params=bridge(ref.params),
                         train_init=bridge(ref.model.init(jax.random.key(1))),
                         batches=RefBatches)
    assert port.cfg == cfg
    return ref, port


def one_batch(pkg: str, op_type: str, cas_blobs: list[bytes]):
    """(batch, worker, cas) of one op type from package ``pkg``'s classes:
    three groups, the CPU ops' inputs in the CAS (one hash absent)."""
    from importlib import import_module
    dag, worker, cas_mod, cost = (import_module(f"{pkg}.core.{m}") for m in
                                  ("dag", "worker", "cas", "cost_model"))
    cas = cas_mod.CAS()
    keys = [cas.put_bytes(b) for b in cas_blobs]
    t = dag.OpType(op_type)
    model = "" if t.value in ("tool", "data_prep", "aggregate") \
        else "llama-3.2-1b"
    spec = dag.OperatorSpec(f"{op_type}-op", t, model, inputs=["x"])
    inputs = [(keys[0],), (keys[1], keys[2]), (keys[0], "f" * 20)]
    groups = [worker.ExecutionGroup(h_task=f"{i:020x}", h_exec=spec.h_exec(),
                                    spec=spec, input_hashes=h)
              for i, h in enumerate(inputs)]
    batch = worker.DispatchBatch(batch_id=0, h_exec=spec.h_exec(),
                                 groups=groups, worker_id="w-0",
                                 admitted_at=0.0)
    w = worker.Worker("w-0", cost.DEVICE_CLASSES["rtx4090-24g"], now=0.0)
    return batch, w, cas


@pytest.mark.parametrize("op_type", OP_TYPES)
def test_payloads_match_the_jax_executor(executors, op_type):
    blobs = [b"artifact-%d " % i * 20 for i in range(3)]
    results = [ex.execute(*one_batch(pkg, op_type, blobs))
               for ex, pkg in zip(executors, ("repro", "repro_torch"))]
    ref, port = results
    assert len(port.outputs) == len(ref.outputs) == 3
    assert (port.load_s, port.flops, port.failed) == \
        (ref.load_s, ref.flops, ref.failed)
    assert port.duration_s > 0
    if op_type not in TRAINING:
        assert port.outputs == ref.outputs         # byte-identical
        return
    for got, want in zip(port.outputs, ref.outputs):
        got, want = pickle.loads(got), pickle.loads(want)
        assert got["op"] == want["op"] == op_type
        assert got["inputs"] == want["inputs"]
        assert len(got["losses"]) == 3
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   **TRAIN_TOL)


def test_launch_rlhf_runs_the_four_tenants(capsys):
    result = rlhf.main(["--reduced", "--device", "cpu"])
    assert result["workflows"] == 4
    assert result["dedup_savings"] > 0
    assert result["executions"] > 0
    assert set(result["median_op_ms"]) >= {"sft", "generate", "score",
                                           "ppo", "eval"}
    assert "[fabric]" in capsys.readouterr().out


def test_rlhf_lineage_and_published_payloads():
    executor = TorchExecutor(seed=0, device="cpu")
    eng = rlhf.run_fabric(executor)
    s = rlhf.check(eng)
    assert s["tasks"] == 4 and s["dedup_savings"] > 0
    rows = [row for dag in eng.dags.values() for row in dag.lineage]
    assert len(rows) == 4 * 6                   # every op of every DAG
    executed = [row.h_task for row in rows if row.executed]
    assert len(executed) == len(set(executed)) == len({r.h_task
                                                       for r in rows})
    for row in rows:
        assert eng.result_index[row.h_task] == row.output_hash
    assert rlhf.check_alone(eng, executor) >= 4


def test_executor_and_launch_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for make in (lambda: TorchExecutor(), lambda: rlhf.main([]),
                 lambda: rlhf.main(["--reduced"])):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


@pytest.mark.gpu
def test_rlhf_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the executor runs the CUDA kernels")
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    counters = (dk.decode_attention, fk.flash_attention_fwd,
                fk.flash_attention_bwd)
    for fn in counters:
        fn.launches = 0
    executor = TorchExecutor(seed=0)
    eng = rlhf.run_fabric(executor)
    rlhf.check(eng)
    assert all(fn.launches > 0 for fn in counters)
    assert rlhf.check_alone(eng, executor) >= 4
