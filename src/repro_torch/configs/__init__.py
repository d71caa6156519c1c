"""Assigned architecture configs (--arch <id>) + input-shape sets.

Each module defines CONFIG (the exact published configuration) and the
registry provides reduced smoke variants for CPU tests. The paper's own
workload (distributed sorting) is configs/paper_sort.py.
"""
from repro_torch.configs.registry import (ARCH_IDS, get_config, smoke_config)
from repro_torch.configs.shapes import SHAPES, Shape, cells, long_ctx_eligible

__all__ = ["ARCH_IDS", "SHAPES", "Shape", "cells", "get_config",
           "long_ctx_eligible", "smoke_config"]
