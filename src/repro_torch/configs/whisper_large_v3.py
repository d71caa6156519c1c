"""whisper-large-v3 [audio enc-dec]: conv frontend is a STUB — input_specs
provides 1500 precomputed frame embeddings; shapes apply to the decoder
[arXiv:2212.04356]. 20 heads % 16 TP != 0 -> context-sharded attention."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=64, n_enc_layers=32, n_dec_layers=32,
    d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab=51866, enc_ctx=1500,
)
