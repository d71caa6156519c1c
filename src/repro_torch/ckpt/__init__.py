"""Checkpoints (counterpart of repro.ckpt)."""
from repro_torch.ckpt.checkpoint import (AsyncCheckpointer, latest_step,
                                         latest_steps, restore, save)

__all__ = ["AsyncCheckpointer", "latest_step", "latest_steps", "restore",
           "save"]
