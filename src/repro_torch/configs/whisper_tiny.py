"""whisper-tiny — [audio] enc-dec backbone, 4L d_model=384 6H (kv=6)
d_ff=1536 vocab=51865; conv/audio frontend is a STUB — input_specs()
provides precomputed frame embeddings (B, 1500, d) [arXiv:2212.04356]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, n_enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865, head_dim=64, enc_len=1500,
)
