"""pixtral-12b [vlm]: pixtral-ViT frontend is a STUB — input_specs provides
precomputed patch+token embeddings; backbone is the mistral-nemo decoder
[hf:mistralai/Pixtral-12B-2409]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072,
    embed_inputs=True,
)
