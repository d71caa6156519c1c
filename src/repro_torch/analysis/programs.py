"""The shipped shard programs, as callables the analysis runs (counterpart
of repro.analysis.programs).

The reference traces its programs with ShapeDtypeStructs: no data, no
execution. The port's collectives are calls that run, so each function
here returns ``(fn, args)`` with real keys (seeded UNIF int32, on
`device`), and the lint and the tests run ``fn(*args)`` under
`repro_torch.parallel.comm.recording`. Each program is the one the front
door runs: `Partitioner.sharded_batched` (or `splitters_batched`, or
`topk_program`) over a fresh `Comm(p)` and the (p, B, n_local) shard
rows, with injected draws (`uniform`, (j, n) -> (p, n), as
`repro_torch.sort.sort` takes them; default `host_draws`, seeded NumPy
draws that are the same on every device, so a run on the card makes the
same calls and rounds as one on the CPU). Multistage takes its
(r1, r2) grid from `spec.stages` or `driver.factor_stages(p)`.

Every exchange runs on every device here: the ragged one is an index
gather (`Comm.ragged_all_to_all`), so unlike the reference (whose CPU jax
lacks `ragged_all_to_all`), nothing is skipped.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.common import round_up
from repro_torch.parallel.comm import Comm
from repro_torch.sort import driver
from repro_torch.sort.api import resolve_device
from repro_torch.sort.partitioners import ShardCtx, get_partitioner
from repro_torch.sort.semisort import topk_program
from repro_torch.sort.spec import SortSpec

__all__ = [
    "available_exchanges",
    "host_draws",
    "program_keys",
    "partitioner_program",
    "splitters_program",
    "make_topk_program",
]


def available_exchanges() -> Tuple[str, ...]:
    """Every exchange strategy, in the reference's order."""
    return ("dense", "dense_spill", "ragged", "allgather")


def program_keys(p: int, n_local: int, batch: Optional[int] = None,
                 seed: int = 0, device="cuda") -> torch.Tensor:
    """Seeded distinct UNIF int32 keys as (p, n_local) shard rows, or
    (B, p, n_local) for a batch, on `device` (a CUDA device with no card
    raises)."""
    b = 1 if batch is None else batch
    rng = np.random.default_rng(seed)
    keys = np.stack([rng.permutation(p * n_local) for _ in range(b)])
    keys = (keys.astype(np.int64) * 7919 - 2 ** 30).astype(np.int32)
    keys = keys.reshape((b, p, n_local))
    return torch.from_numpy(keys if batch is not None else keys[0]).to(
        resolve_device(device))


def _rows(x: torch.Tensor, batch: Optional[int]) -> torch.Tensor:
    """(p, n_local) or (B, p, n_local) -> the engine's (p, B, n_local)."""
    return (x[:, None] if batch is None else x.transpose(0, 1)).contiguous()


def host_draws(p: int, seed: int = 0):
    """(j, n) -> (p, n) float32 U[0, 1) draws from a NumPy generator
    seeded by (seed, j, n): the same numbers on every device."""
    memo: dict = {}

    def draws(j, n):
        if (j, n) not in memo:
            memo[j, n] = np.random.default_rng((seed, j, n)).random(
                (p, n), dtype=np.float32)
        return memo[j, n]
    return draws


def _ctx(spec: SortSpec, p: int, comm: Comm, device, uniform) -> ShardCtx:
    draws = driver._draws(uniform or host_draws(p, spec.seed), p,
                          spec.seed, device)
    return ShardCtx(spec=spec, comm=comm, uniform=draws)


def _spec(algo: str, exchange: str, p: int, device,
          spec: Optional[SortSpec]) -> SortSpec:
    return spec or SortSpec(algorithm=algo, exchange=exchange, shards=p,
                            device=str(device))


def partitioner_program(algo: str, *, exchange: str = "dense",
                        batch: Optional[int] = None, p: int = 8,
                        n_local: int = 128, spec: Optional[SortSpec] = None,
                        device="cuda", uniform=None, seed: int = 0):
    """The full shard pipeline (local sort -> splitters -> exchange) of one
    partitioner. ``batch=None`` is the single-request program (B = 1),
    an int the batched one. Returns ``(fn, (keys,))``."""
    part = get_partitioner(algo)
    spec = _spec(algo, exchange, p, device, spec)

    def program(x):
        comm = Comm(p)
        return part.sharded_batched(
            _rows(x, batch), _ctx(spec, p, comm, x.device, uniform))

    program.__name__ = f"{algo}+{spec.resolved_exchange()}"
    return program, (program_keys(p, n_local, batch, seed, device),)


def splitters_program(algo: str, *, batch: Optional[int] = None, p: int = 8,
                      n_local: int = 128, spec: Optional[SortSpec] = None,
                      device="cuda", uniform=None, seed: int = 0):
    """Splitter determination only (no exchange): the phase the per-round
    contracts constrain. The rows are sorted inline first, as
    `Partitioner.sharded_batched` does."""
    part = get_partitioner(algo)
    spec = _spec(algo, "dense", p, device, spec)

    def program(x):
        comm = Comm(p)
        rows = torch.sort(_rows(x, batch), dim=-1).values
        return part.splitters_batched(
            rows, _ctx(spec, p, comm, x.device, uniform))[0]

    program.__name__ = f"splitters:{algo}"
    return program, (program_keys(p, n_local, batch, seed, device),)


def make_topk_program(*, k: int = 10, batch: Optional[int] = None,
                      p: int = 8, n_local: int = 128, device="cuda",
                      kernel_policy: str = "auto", seed: int = 0):
    """The top-k pruning program (`top_k`'s shard program), plus its
    pruned width c: the operand the contract pins its one all_gather to.
    Returns ``(fn, (keys,), c)``."""
    c = min(round_up(k, 8), n_local)

    def program(x):
        return topk_program(_rows(x, batch), Comm(p), c=c, k=k,
                            kernel_policy=kernel_policy)

    program.__name__ = "top_k"
    return program, (program_keys(p, n_local, batch, seed, device),), c
