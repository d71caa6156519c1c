"""repro_torch.runtime — chaos tooling and the serving layer's fault
tolerance (counterpart of repro.runtime).

Lazily exported (PEP 562), as the reference's package is: `chaos` is
stdlib and numpy only, `ft` (StepTimer, SupervisedExecutor) stdlib only.
The reference's TrainSupervisor waits for the model stack's port.
"""
import importlib

_LAZY = {
    "StepTimer": "repro_torch.runtime.ft",
    "SupervisedExecutor": "repro_torch.runtime.ft",
    "FaultPlan": "repro_torch.runtime.chaos",
    "InjectedFault": "repro_torch.runtime.chaos",
    "ExecutorDeath": "repro_torch.runtime.chaos",
}

__all__ = ["ExecutorDeath", "FaultPlan", "InjectedFault", "StepTimer",
           "SupervisedExecutor", "chaos"]


def __getattr__(name: str):
    if name == "chaos":
        return importlib.import_module("repro_torch.runtime.chaos")
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(
            f"module 'repro_torch.runtime' has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(__all__)
