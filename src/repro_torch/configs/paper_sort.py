"""The paper's own workload: distributed sort configurations (Section 7),
on the port's HSSConfig and ExchangeConfig."""
import dataclasses

from repro_torch.core.common import HSSConfig
from repro_torch.core.exchange import ExchangeConfig


@dataclasses.dataclass(frozen=True)
class SortWorkload:
    name: str
    keys_per_shard: int
    distribution: str = "UNIF"
    eps: float = 0.05
    hss: HSSConfig = HSSConfig(eps=0.05)
    exchange: ExchangeConfig = ExchangeConfig()


WEAK_SCALING = SortWorkload("weak_scaling", keys_per_shard=2_000_000)
SMOKE = SortWorkload("smoke", keys_per_shard=4096)
