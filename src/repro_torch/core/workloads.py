"""Test workloads (§5.1): Group A (agentic inference, 5 DAG topologies) and
Group B (A + SFT/DPO/PPO post-training pipelines), with the paper's datasets
(GSM8K / MMLU / TruthfulQA) represented as shared prompt pools.

Every workflow is built as a *declarative spec document* and compiled through
``repro_torch.fabric.spec`` — the same validation/compilation path tenants use when
they POST workflows to the FabricService. Named templates (rlhf, distill,
agent-loop, batch-eval) cover the common shapes; the remaining topologies are
inline documents.

Cross-tenant overlap is the whole point: tenants iterate on variants of the
same base models over overlapping data, so SFT stages and reward/eval passes
collide by H_task (dedup) or by H_exec (batching) exactly as §2 describes.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass

from .dag import WorkflowDAG

BASE_MODELS = ["llama-3.2-1b", "llama-3.2-3b", "llama-3.1-8b"]
REWARD_MODELS = ["reward-1b", "reward-3b"]
DATASETS = ["gsm8k", "mmlu", "truthfulqa"]


@dataclass
class WorkloadCfg:
    seed: int = 0
    n_tenants: int = 8
    #: probability a workflow reuses a "popular" shared prompt shard
    overlap: float = 0.6
    n_prompt_shards: int = 12
    max_batch: int = 24


class WorkloadGen:
    def __init__(self, cfg: WorkloadCfg | None = None) -> None:
        self.cfg = cfg or WorkloadCfg()
        self.rng = random.Random(self.cfg.seed)

    # ------------------------------------------------------------------
    def _prompt_shard(self, dataset: str) -> str:
        """Zipf-ish shared shards: hot shards collide across tenants."""
        if self.rng.random() < self.cfg.overlap:
            k = min(int(self.rng.paretovariate(1.2)), 3)   # hot few
        else:
            k = self.rng.randrange(self.cfg.n_prompt_shards)
        return f"{dataset}/shard-{k}"

    def _tenant(self) -> str:
        return f"tenant-{self.rng.randrange(self.cfg.n_tenants)}"

    def _mb(self) -> dict:
        return {"max_batch": self.cfg.max_batch}

    def _compile(self, doc: dict, kind: str) -> WorkflowDAG:
        # deferred import: core stays importable without the fabric service
        # layer; by the time workloads are generated everything is loaded
        from repro_torch.fabric.spec import compile_spec
        doc.setdefault("metadata", {})["kind"] = kind
        return compile_spec(doc)

    @staticmethod
    def _template(name: str, **params) -> dict:
        from repro_torch.fabric.spec import render_template
        return render_template(name, **params)

    # --------------------------- Group A topologies -----------------------
    # NOTE: rng draws happen in the same order as the seed implementation
    # (models, dataset, shard, ..., tenant last) so that a given seed
    # reproduces the exact §5.1 workload trace the benchmarks were
    # validated against.
    def reasoning_chain(self) -> WorkflowDAG:
        m = self.rng.choice(BASE_MODELS)
        d = self.rng.choice(DATASETS)
        shard = self._prompt_shard(d)
        doc = self._template("agent-loop", tenant=self._tenant(), model=m,
                             shard=shard, rounds=1,
                             max_batch=self.cfg.max_batch)
        return self._compile(doc, "reasoning_chain")

    def rag(self) -> WorkflowDAG:
        m = self.rng.choice(BASE_MODELS)
        d = self.rng.choice(DATASETS)
        shard = self._prompt_shard(d)
        rm = self.rng.choice(REWARD_MODELS)
        doc = {
            "tenant": self._tenant(),
            "ops": [
                {"name": "retrieve", "op_type": "tool", "inputs": [shard],
                 "resource_class": "cpu"},
                {"name": "generate", "op_type": "generate", "model_id": m,
                 "params": self._mb(), "inputs": ["@retrieve"],
                 "tokens_in": 2048, "tokens_out": 768},
                {"name": "judge", "op_type": "score", "model_id": rm,
                 "params": self._mb(), "inputs": ["@generate"],
                 "tokens_in": 1024, "tokens_out": 8,
                 "resource_class": "gpu.small"},
            ],
        }
        return self._compile(doc, "rag")

    def multi_agent(self) -> WorkflowDAG:
        m1, m2 = self.rng.sample(BASE_MODELS, 2)
        shard = self._prompt_shard(self.rng.choice(DATASETS))
        doc = {
            "tenant": self._tenant(),
            "ops": [
                {"name": "agent_a", "op_type": "generate", "model_id": m1,
                 "params": self._mb(), "inputs": [shard],
                 "tokens_in": 1024, "tokens_out": 1024},
                {"name": "agent_b", "op_type": "generate", "model_id": m2,
                 "params": self._mb(), "inputs": [shard],
                 "tokens_in": 1024, "tokens_out": 1024},
                {"name": "merge", "op_type": "aggregate",
                 "inputs": ["@agent_a", "@agent_b"], "resource_class": "cpu"},
                {"name": "final", "op_type": "generate", "model_id": m1,
                 "params": self._mb(), "inputs": ["@merge"],
                 "tokens_in": 2048, "tokens_out": 768},
            ],
        }
        return self._compile(doc, "multi_agent")

    def reflection(self) -> WorkflowDAG:
        m = self.rng.choice(BASE_MODELS)
        rm = self.rng.choice(REWARD_MODELS)
        shard = self._prompt_shard(self.rng.choice(DATASETS))
        doc = {
            "tenant": self._tenant(),
            "ops": [
                {"name": "draft", "op_type": "generate", "model_id": m,
                 "params": self._mb(), "inputs": [shard],
                 "tokens_in": 1024, "tokens_out": 1024},
                {"name": "critique", "op_type": "score", "model_id": rm,
                 "params": self._mb(), "inputs": ["@draft"],
                 "tokens_in": 896, "tokens_out": 64,
                 "resource_class": "gpu.small"},
                {"name": "revise", "op_type": "generate", "model_id": m,
                 "params": self._mb(), "inputs": ["@draft", "@critique"],
                 "tokens_in": 1024, "tokens_out": 384},
            ],
        }
        return self._compile(doc, "reflection")

    def map_reduce(self) -> WorkflowDAG:
        m = self.rng.choice(BASE_MODELS)
        ops = [{"name": "prep", "op_type": "data_prep",
                "inputs": [self._prompt_shard(self.rng.choice(DATASETS))],
                "resource_class": "cpu"}]
        for i in range(3):
            ops.append({"name": f"map_{i}", "op_type": "generate",
                        "model_id": m, "params": self._mb(),
                        "inputs": ["@prep", f"slice-{i}"],
                        "tokens_in": 1280, "tokens_out": 768})
        ops.append({"name": "reduce", "op_type": "aggregate",
                    "inputs": [f"@map_{i}" for i in range(3)],
                    "resource_class": "cpu"})
        return self._compile({"tenant": self._tenant(), "ops": ops},
                             "map_reduce")

    GROUP_A = ("reasoning_chain", "rag", "multi_agent", "reflection",
               "map_reduce")

    def sample_group_a(self) -> WorkflowDAG:
        return getattr(self, self.rng.choice(self.GROUP_A))()

    # --------------------------- Group B pipelines ------------------------
    def sft_pipeline(self) -> WorkflowDAG:
        m = self.rng.choice(BASE_MODELS)
        d = self.rng.choice(DATASETS)
        shard = self._prompt_shard(d)
        lora = self.rng.random() < 0.6
        doc = {
            "tenant": self._tenant(),
            "ops": [
                {"name": "prep", "op_type": "data_prep", "inputs": [shard],
                 "resource_class": "cpu"},
                # tenants fine-tuning the same base on the same shard collide
                {"name": "sft", "op_type": "sft", "model_id": m,
                 "params": {"lora": lora, "lr": 1e-5, "epochs": 1,
                            "max_batch": 12},
                 "inputs": ["@prep"], "train_tokens": 6_000_000},
                {"name": "eval", "op_type": "eval", "model_id": m,
                 "params": {"max_batch": 12},
                 "inputs": ["@sft", f"{d}/holdout"],
                 "tokens_in": 2048, "tokens_out": 128},
            ],
        }
        return self._compile(doc, "sft")

    def dpo_pipeline(self) -> WorkflowDAG:
        m = self.rng.choice(BASE_MODELS)
        d = self.rng.choice(DATASETS)
        shard = self._prompt_shard(d)
        doc = {
            "tenant": self._tenant(),
            "ops": [
                {"name": "prep", "op_type": "data_prep", "inputs": [shard],
                 "resource_class": "cpu"},
                {"name": "pairs", "op_type": "generate", "model_id": m,
                 "params": {"max_batch": 12}, "inputs": ["@prep"],
                 "tokens_in": 1024, "tokens_out": 1536},
                {"name": "dpo", "op_type": "dpo", "model_id": m,
                 "params": {"beta": 0.1, "lr": 5e-6, "max_batch": 12},
                 "inputs": ["@pairs"], "train_tokens": 4_000_000},
                {"name": "eval", "op_type": "eval", "model_id": m,
                 "params": {"max_batch": 12},
                 "inputs": ["@dpo", f"{d}/holdout"],
                 "tokens_in": 2048, "tokens_out": 128},
            ],
        }
        return self._compile(doc, "dpo")

    def ppo_pipeline(self) -> WorkflowDAG:
        m = self.rng.choice(BASE_MODELS)
        rm = self.rng.choice(REWARD_MODELS)
        d = self.rng.choice(DATASETS)
        shard = self._prompt_shard(d)
        doc = {
            "tenant": self._tenant(),
            "ops": [
                {"name": "rollout", "op_type": "generate", "model_id": m,
                 "params": {"max_batch": 12}, "inputs": [shard],
                 "tokens_in": 1024, "tokens_out": 1536},
                # reward inference over overlapping batches: prime dedup target
                {"name": "reward", "op_type": "score", "model_id": rm,
                 "params": {"max_batch": 12}, "inputs": ["@rollout"],
                 "tokens_in": 1024, "tokens_out": 8,
                 "resource_class": "gpu.small"},
                {"name": "collect", "op_type": "aggregate",
                 "inputs": ["@rollout", "@reward"], "resource_class": "cpu"},
                {"name": "ppo", "op_type": "ppo", "model_id": m,
                 "params": {"clip": 0.2, "lr": 1e-6, "max_batch": 12},
                 "inputs": ["@collect"], "train_tokens": 2_400_000,
                 "tokens_in": 512, "tokens_out": 128},
                {"name": "eval", "op_type": "eval", "model_id": m,
                 "params": {"max_batch": 12},
                 "inputs": ["@ppo", f"{d}/holdout"],
                 "tokens_in": 2048, "tokens_out": 128},
            ],
        }
        return self._compile(doc, "ppo")

    def rlhf_full(self) -> WorkflowDAG:
        """SFT -> rollout -> reward -> PPO -> eval (Fig. 2's full loop)."""
        m = self.rng.choice(BASE_MODELS)
        rm = self.rng.choice(REWARD_MODELS)
        d = self.rng.choice(DATASETS)
        shard = self._prompt_shard(d)
        doc = self._template("rlhf", tenant=self._tenant(), model=m,
                             reward_model=rm, shard=shard,
                             holdout=f"{d}/holdout")
        return self._compile(doc, "rlhf")

    def distill_pipeline(self) -> WorkflowDAG:
        d = self.rng.choice(DATASETS)
        doc = self._template(
            "distill", tenant=self._tenant(),
            teacher="llama-3.1-8b",
            student=self.rng.choice(BASE_MODELS[:2]),
            shard=self._prompt_shard(d), holdout=f"{d}/holdout")
        return self._compile(doc, "distill")

    def batch_eval(self) -> WorkflowDAG:
        d = self.rng.choice(DATASETS)
        doc = self._template(
            "batch-eval", tenant=self._tenant(),
            model=self.rng.choice(BASE_MODELS),
            shards=[self._prompt_shard(d) for _ in range(3)],
            max_batch=self.cfg.max_batch)
        return self._compile(doc, "batch_eval")

    #: the paper's Group B mix (§5.1) — distill_pipeline / batch_eval are
    #: extra fabric-template builders, deliberately NOT in the sampler so a
    #: given seed reproduces the exact workload trace the benchmarks report
    GROUP_B_EXTRA = ("sft_pipeline", "dpo_pipeline", "ppo_pipeline",
                     "rlhf_full")

    def sample_group_b(self) -> WorkflowDAG:
        # Group B = Group A workflows + the four post-training pipelines
        kind = self.rng.choice(self.GROUP_A + self.GROUP_B_EXTRA)
        return getattr(self, kind)()

    # --------------------------- arrival process --------------------------
    def arrivals(self, n: int, *, rate0_qpm: float = 6.0,
                 rate1_qpm: float = 0.6, horizon_s: float = 3600.0,
                 ) -> list[float]:
        """Exponentially decaying Poisson arrivals 6 -> 0.6 qpm (§5.2),
        generated by thinning."""
        tau = horizon_s / math.log(rate0_qpm / rate1_qpm)
        lam_max = rate0_qpm / 60.0
        out: list[float] = []
        t = 0.0
        while len(out) < n:
            t += self.rng.expovariate(lam_max)
            # decays 6 -> 0.6 qpm over the horizon, then holds at the floor
            lam_t = max(rate1_qpm, rate0_qpm * math.exp(-t / tau)) / 60.0
            if self.rng.random() < lam_t / lam_max:
                out.append(t)
        return out

    def make_workload(self, group: str, n: int, **arrival_kw,
                      ) -> list[tuple[float, WorkflowDAG]]:
        times = self.arrivals(n, **arrival_kw)
        sample = self.sample_group_a if group == "A" else self.sample_group_b
        return [(t, sample()) for t in times]
