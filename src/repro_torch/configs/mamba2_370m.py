"""mamba2-370m [ssm]: attention-free SSD (state-space duality)
[arXiv:2405.21060]. HSS technique applies via the data pipeline only
(DESIGN.md Sec. 5 arch-applicability)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    subquadratic=True,
)
