"""kimi-k2-1t-a32b — [moe] 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8 — trillion-param MoE (paper-table)
[arXiv:2501.kimi2; unverified]. Expert width 2048; active ~32B/tok."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163840, head_dim=112,
    n_experts=384, top_k=8, n_shared_experts=1,
    moe_impl="ep",   # a2a expert parallelism (weights never move)
)
