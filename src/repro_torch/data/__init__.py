"""repro_torch.data — input pipelines (counterpart of repro.data).

distributions: the paper's Figure 5 key distributions (sort workloads).
synthetic:     deterministic synthetic token streams and document lengths.
partition:     HSS-based global length bucketing for packed batching.
"""
from repro_torch.data.distributions import DISTRIBUTIONS, make_distribution
from repro_torch.data.synthetic import SyntheticTokens

__all__ = ["DISTRIBUTIONS", "make_distribution", "SyntheticTokens"]
