"""Post-training objectives (counterpart of ``repro/train/losses.py``):
SFT (causal LM), DPO, PPO-clip and a Bradley–Terry reward-model loss, the
objectives behind the fabric's SFT/DPO/PPO operators."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def token_logprobs(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """Per-token log p(label). logits: (B,T,V), labels: (B,T) -> (B,T)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None]).squeeze(-1)
    return gold - logz


def _logits(model, params, tokens: torch.Tensor) -> torch.Tensor:
    h = model._trunk(params, model._embed(params, tokens))
    return h @ params["lm_head"].to(model.cfg.compute_dtype)


def sft_loss(model, params, batch) -> torch.Tensor:
    """Next-token prediction on (tokens, labels[, loss_mask])."""
    return model.loss_fn(params, batch)


def dpo_loss(model, params, ref_params, batch, *, beta: float = 0.1
             ) -> torch.Tensor:
    """Direct Preference Optimization (Rafailov et al. 2023).
    batch: chosen/rejected token+label pairs with response masks."""
    def seq_lp(p, toks, labs, mask):
        lp = token_logprobs(_logits(model, p, toks), labs)
        return torch.sum(lp * mask, dim=-1)

    pc = seq_lp(params, batch["chosen"], batch["chosen_labels"],
                batch["chosen_mask"])
    pr = seq_lp(params, batch["rejected"], batch["rejected_labels"],
                batch["rejected_mask"])
    rc = seq_lp(ref_params, batch["chosen"], batch["chosen_labels"],
                batch["chosen_mask"])
    rr = seq_lp(ref_params, batch["rejected"], batch["rejected_labels"],
                batch["rejected_mask"])
    margin = beta * ((pc - rc) - (pr - rr))
    return -torch.mean(F.logsigmoid(margin))


def ppo_loss(model, params, batch, *, clip: float = 0.2,
             vf_coef: float = 0.0, ent_coef: float = 0.0) -> torch.Tensor:
    """Clipped-surrogate PPO policy loss over rollout tokens.
    batch: tokens, labels (actions), old_logprobs, advantages, mask."""
    logits = _logits(model, params, batch["tokens"])
    lp = token_logprobs(logits, batch["labels"])
    ratio = torch.exp(lp - batch["old_logprobs"])
    adv = batch["advantages"]
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - clip, 1 + clip) * adv
    mask = batch["mask"].float()
    pg = -torch.sum(torch.minimum(unclipped, clipped) * mask) / \
        torch.clamp_min(torch.sum(mask), 1.0)
    if ent_coef:
        p = torch.softmax(logits.float(), dim=-1)
        ent = -torch.sum(p * torch.log(p + 1e-9), dim=-1)
        pg = pg - ent_coef * torch.sum(ent * mask) / torch.clamp_min(
            torch.sum(mask), 1.0)
    return pg


def reward_model_loss(model, params, batch) -> torch.Tensor:
    """Bradley–Terry pairwise loss; reward = final hidden state projected
    through lm_head[:, 0] (a cheap scalar head reusing existing weights)."""
    cd = model.cfg.compute_dtype

    def score(toks):
        h = model._trunk(params, model._embed(params, toks))
        return (h[:, -1] @ params["lm_head"].to(cd))[:, 0].float()

    s_c = score(batch["chosen"])
    s_r = score(batch["rejected"])
    return -torch.mean(F.logsigmoid(s_c - s_r))
