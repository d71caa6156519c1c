"""The model stack's serving path (counterpart of `repro.models`):
configs, parameters, layers, MoE, SSD, the assembled forward and its
prefill and decode steps."""
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import (abstract_params, init_params,
                                       params_from_reference)

__all__ = ["ArchConfig", "abstract_params", "init_params",
           "params_from_reference"]
