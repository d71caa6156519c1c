"""Sample sort baselines (paper Sections 3.1-3.2).

Counterpart of `repro.core.sample_sort`, in the batched forms the
reference's partitioners run (repro/sort/partitioners.py:91-108,
268-325). Two splitter-determination schemes for the three-phase
skeleton:

  * random sampling  (Blelloch et al.; Theorem 3.1: O(p log N / eps)
    sample), one Bernoulli round;
  * regular sampling (Shi & Schaeffer's PSRS; Theorem 3.2: s = p/eps
    evenly spaced keys a shard), deterministic.

Shards lead, (p, B, n_local): the sampled positions are drawn once per
shard and shared by every request of a batch, so a batched result equals
the per-request loop. Every sort goes through the kernel dispatch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.common import hi_sentinel, round_up
from repro_torch.kernels import dispatch
from repro_torch.parallel.comm import Comm
from repro_torch.runtime.syncs import to_device


def default_total_sample(p: int, n_local: int, eps: float) -> int:
    """Theorem 3.1's random-sampling sample size: O(p log N / eps)."""
    return max(p, int(2 * p * math.log2(max(n_local * p, 2)) / eps))


def default_regular_s(p: int, eps: float) -> int:
    """Theorem 3.2's regular-sampling per-shard sample size: s = p/eps."""
    return max(2, int(p / eps))


def sample_sort(x, shards: int = 8, method: str = "random", seed: int = 0,
                total_sample: int | None = None, s: int | None = None,
                eps: float = 0.05, ex_cfg=None, kernel_policy: str = "auto",
                *, device="cuda", uniform=None):
    """Legacy entry point (counterpart of core/sample_sort.py:93): sample
    sort of a 1-D array over `shards` emulated shards, "random" or
    "regular" splitters, as a SortResult (repro_torch.core.hss; a shim
    over `driver.run_batched` at B = 1). `uniform` is the (j, n) -> (p,
    n) draws; random sampling takes draw 0 once."""
    from repro_torch.core.exchange import ExchangeConfig, exchange_batched
    from repro_torch.core.hss import _driver
    from repro_torch.sort.partitioners import null_stats_batched

    if method not in ("random", "regular"):
        raise ValueError(method)
    ex_cfg = ex_cfg or ExchangeConfig(kernel_policy=kernel_policy)

    def sort_fn(rows, comm, draws):
        p, batch, n_local = rows.shape
        local_sorted = dispatch.local_sort(rows, policy=kernel_policy)
        if method == "random":
            keys, ovf = random_sample_splitters(
                local_sorted, comm=comm,
                total_sample=total_sample or default_total_sample(
                    p, n_local, eps),
                u=draws(0, n_local), kernel_policy=kernel_policy)
        else:
            keys = regular_sample_splitters(
                local_sorted, comm=comm, s=s or default_regular_s(p, eps),
                kernel_policy=kernel_policy)
            ovf = torch.zeros((batch,), dtype=torch.int32,
                              device=rows.device)
        out, n_valid, ex_ovf = exchange_batched(
            local_sorted, keys, comm=comm, cfg=ex_cfg, eps=eps)
        return (out, n_valid, keys, torch.zeros_like(keys, dtype=torch.int32),
                ovf + ex_ovf, null_stats_batched(batch, device=rows.device))

    return _driver(sort_fn, x, shards=shards, seed=seed, device=device,
                   uniform=uniform,
                   local_sort_fn=dispatch.local_sort_fn(kernel_policy))


def sample_cap(total_sample: int, p: int) -> int:
    """A shard's sample buffer: three times its expected share. It does
    not scale with `capacity_scale`, as in the reference."""
    return round_up(max(8, int(3.0 * total_sample / p)), 8)


def bernoulli_sample_rows(local_sorted: torch.Tensor, prob: float, cap: int,
                          u: torch.Tensor, kernel_policy: str = "auto"):
    """Bernoulli-sample each (shard, request) row of (p, B, n_local) into
    a sorted, sentinel-padded (p, B, min(cap, n_local)) buffer. The
    sampled positions (u < prob, u (p, n_local)) are the shard's for
    every request (repro/sort/partitioners.py:73-85). Returns (vals,
    n_hit (p,))."""
    # prob meets u in u's precision, as the reference's weakly typed
    # Python float does (float64 draws under jax x64)
    mask = u < to_device(prob, u.dtype, u.device)
    n_hit = mask.sum(dim=-1, dtype=torch.int32)
    vals = torch.where(mask[:, None, :], local_sorted,
                       hi_sentinel(local_sorted.dtype))
    vals = dispatch.local_sort(vals, policy=kernel_policy)[..., :cap]
    return vals, n_hit


def gather_rows(vals: torch.Tensor, comm: Comm) -> torch.Tensor:
    """all_gather (p, B, cap) sample buffers once -> each request's
    (B, p*cap) concatenation, shard order."""
    g = comm.all_gather(vals)
    return g.transpose(0, 1).reshape(vals.shape[1], -1)


def random_sample_splitters(local_sorted: torch.Tensor, *, comm: Comm,
                            total_sample: int, u: torch.Tensor,
                            kernel_policy: str = "auto"):
    """p-1 splitters of each request = evenly spaced keys of a Bernoulli
    sample of target size `total_sample`. local_sorted (p, B, n_local)
    sorted rows, u (p, n_local) the shards' draws -> (keys (B, p-1),
    overflow (B,): sampled keys past a shard's buffer, a harmless count
    the overflow counter carries as the reference's does)."""
    p, batch, n_local = local_sorted.shape
    cap = sample_cap(total_sample, p)
    prob = min(1.0, total_sample / float(n_local * p))
    vals, n_hit = bernoulli_sample_rows(local_sorted, prob, cap, u,
                                        kernel_policy)
    overflow = comm.psum(torch.clamp(n_hit - cap, min=0))
    probes = dispatch.local_sort(gather_rows(vals, comm),
                                 policy=kernel_policy)
    n_valid = comm.psum(torch.clamp(n_hit, max=cap))
    idx = torch.arange(1, p, dtype=torch.int32,
                       device=local_sorted.device) * n_valid // p
    return probes[:, idx.long()], overflow.expand(batch)


def regular_sample_splitters(local_sorted: torch.Tensor, *, comm: Comm,
                             s: int, kernel_policy: str = "auto"):
    """PSRS: s evenly spaced keys of each sorted shard row; the splitters
    are evenly spaced in each request's merged p*s sample. local_sorted
    (p, B, n_local) -> keys (B, p-1)."""
    p, batch, n_local = local_sorted.shape
    dev = local_sorted.device
    idx = (torch.arange(1, s + 1, dtype=torch.int64, device=dev)
           * n_local) // (s + 1)
    probes = dispatch.local_sort(gather_rows(local_sorted[..., idx], comm),
                                 policy=kernel_policy)
    sidx = torch.arange(1, p, dtype=torch.int64, device=dev) * (s * p) // p
    return probes[:, sidx]
