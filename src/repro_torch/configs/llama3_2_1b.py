"""llama-3.2-1b — the paper's own workload base model (§5.1)
[arXiv:2407.21783]. 16L d_model=2048 32H (GQA kv=8) d_ff=8192."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab_size=128256, head_dim=64, rope_theta=500000.0,
)
