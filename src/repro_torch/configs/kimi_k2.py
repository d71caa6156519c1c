"""kimi-k2-1t-a32b [moe]: trillion-param MoE, 384 experts top-8 + 1 shared
[arXiv:2501.kimi2 paper-table]. Adafactor optimizer for state memory at the
1T scale (DESIGN.md Sec. 5); HSS-balanced expert dispatch applies."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab=163840,
    n_experts=384, top_k=8, d_ff_expert=2048, n_shared_experts=1,
    optimizer="adafactor",
)
