"""Optimizers, schedules, clipping and gradient compression (counterpart
of repro.optim)."""
from repro_torch.optim.optimizers import (Optimizer, adafactor, adamw,
                                          make_optimizer, state_from_reference)
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.compress import (CompressorState, error_feedback_int8,
                                        init_compressor)

__all__ = ["Optimizer", "adamw", "adafactor", "make_optimizer",
           "cosine_schedule", "clip_by_global_norm", "global_norm",
           "CompressorState", "error_feedback_int8", "init_compressor",
           "state_from_reference"]
