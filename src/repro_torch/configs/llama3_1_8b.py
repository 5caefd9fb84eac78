"""llama-3.1-8b — the paper's largest workload model (§5.1)
[arXiv:2407.21783]. 32L d_model=4096 32H (GQA kv=8) d_ff=14336."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.1-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128, rope_theta=500000.0,
)
