"""starcoder2-3b [dense]: GQA kv=2, RoPE [arXiv:2402.19173; hf].
24 heads % 16 TP != 0 -> context-sharded attention (DESIGN.md Sec. 5)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, head_dim=128,
    d_ff=12288, vocab=49152,
)
