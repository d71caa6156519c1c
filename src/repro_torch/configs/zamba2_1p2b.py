"""zamba2-1.2b [hybrid]: Mamba2 backbone + single shared attention block
applied periodically (parameter reuse) [arXiv:2411.15242; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    shared_attn_period=7,          # 6 shared-block applications over 38 layers
    attn_window=4096,              # sliding window keeps 500k decode bounded
    subquadratic=True,
)
