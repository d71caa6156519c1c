"""stablelm-12b [dense]: GQA kv=8 [hf:stabilityai/stablelm-2-12b]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=160,
    d_ff=13824, vocab=100352,
)
