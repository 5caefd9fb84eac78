"""llava-next-34b — [vlm] 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling; vision frontend is a STUB — input_specs()
provides patch embeddings (B, 576, d) [hf:llava-hf; unverified]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000, head_dim=128, n_patches=576,
)
