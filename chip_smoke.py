#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check every kernel.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Phases, in order; any failure raises and the script exits non-zero:

  1. the card: `nvidia-smi --query-gpu=name,power.limit` of device 0;
  2. build: compiles src/repro_torch/kernels/csrc/sort_kernels.cu with nvcc
     (the kernels are built from the checkout's sources, nothing else);
  3. kernels: each hand-written kernel (K1-K4) against its plain PyTorch
     version on the card, at the shapes the main path gives it, exactly
     (torch.equal), then timed by CUDA events beside its plain version,
     its bound and, where one PyTorch call computes the same function, that
     call (`library_ms`, a yardstick only);
  4. slice: `repro_torch.sort.sort` with 8 shards, eps 0.05 and the default
     "auto" policy on WEAK_SCALING (16,000,000 UNIF int32 keys,
     repro/configs/paper_sort.py:18 at p = 8), 16,000,000 standard-normal
     float32 keys, and 16,000,003 uint32 keys (ragged n). Each must equal
     np.sort of its input with overflow 0 and max(counts) <= (1+eps)N/p + 1,
     must have launched every kernel (launch counts set to 0 just before
     the call and read just after), and must give the same shards and
     counts as the same call under kernel_policy="torch";
  5. times: the warm end-to-end sort of the 16M int32 keys (median of 5,
     host clock around torch.cuda.synchronize()) under both policies, and
     a torch.profiler breakdown of one warm sort.

Every measurement line is one JSON object carrying the card's name and
power limit. The line before the last is the card line; the kernels line
comes before it; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = "src/repro_torch/kernels/csrc/sort_kernels.cu"

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3; INT32 at 33.5 TOPS (half
# the 67 TFLOP/s float32 rate outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12

P, EPS = 8, 0.05
N_WEAK = 16_000_000          # WEAK_SCALING: 2,000,000 keys per shard
N_LOCAL = N_WEAK // P
ROW = 1 << 21                # the local sort's power-of-two row
PROBES = 256                 # p x sample cap (32) per round


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def emit(obj: dict):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True).stdout.strip()
    if not out:
        fail("nvidia-smi reported no card")
    return out.splitlines()[0]


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call by CUDA events over `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, int_ops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and int32
    operations over the int32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(torch, card):
    from repro_torch.kernels.bitonic_sort import kernel as BK
    from repro_torch.kernels.histogram import kernel as HK
    from repro_torch.kernels.merge import kernel as MK

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def keys(shape):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                             device="cuda", dtype=torch.int32)

    def runs(rows, n, run):
        return torch.sort(keys((rows, n)).view(rows, n // run, run),
                          dim=-1).values.view(rows, n)

    def check(name, got, want):
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if not torch.equal(got, want):
            fail(f"{name} disagrees with its plain version (max err {err})")
        return err

    n = P * ROW
    x = keys((P, ROW))
    seg = BK.SMEM_MAX_SEG
    paired = runs(P, ROW, seg // 2)
    sorted_rows = torch.sort(keys((P, N_LOCAL)), dim=-1).values
    probes = torch.sort(keys((1, PROBES)), dim=-1).values
    probes = probes.expand(P, -1).contiguous()
    log_b = 10                      # block 1024
    rows = []

    def row(name, replaces, err, fn, plain, library, bytes_moved, ops):
        ms = time_ms(torch, fn, reps=20)
        plain_ms = time_ms(torch, plain, reps=3, warmup=1)
        lib_ms = None if library is None else time_ms(torch, library, reps=20)
        bound_ms, bound_by = bound(bytes_moved, ops)
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms})

    # K1: the shard sort's first stage, (8, 2^21) rows, 1024-key blocks
    err = check("bitonic_sort_blocks", BK.sort_blocks(x, 1024),
                BK.sort_blocks_plain(x, 1024))
    row("bitonic_sort_blocks", "src/repro/kernels/bitonic_sort/kernel.py:83",
        err, lambda: BK.sort_blocks(x, 1024),
        lambda: BK.sort_blocks_plain(x, 1024),
        lambda: torch.sort(x.view(-1, 1024), dim=-1),
        2 * 4 * n, 2 * (n // 2) * log_b * (log_b + 1) // 2)

    # K2: both flags, on the largest on-chip segment of the cascade
    err = 0
    for reverse in (True, False):
        err = max(err, check(
            f"bitonic_merge_smem(reverse={reverse})",
            BK.bitonic_merge_smem(paired, seg, reverse),
            BK.bitonic_merge_plain(paired, seg, reverse)))
    row("bitonic_merge_smem",
        "src/repro/kernels/bitonic_sort/kernel.py:117, "
        "src/repro/kernels/merge/kernel.py:71",
        err, lambda: BK.bitonic_merge_smem(paired, seg, True),
        lambda: BK.bitonic_merge_plain(paired, seg, True),
        lambda: torch.sort(paired.view(-1, seg), dim=-1),
        2 * 4 * n, 2 * (n // 2) * (seg.bit_length() - 1))

    # K3: the local sort's largest distance (2^20), both relayouts
    d = ROW // 2
    err = 0
    for flip in (True, False):
        err = max(err, check(
            f"strided_compare_exchange(flip={flip})",
            MK.strided_compare_exchange(x, d, flip),
            MK.strided_compare_exchange_plain(x, d, flip)))
    row("strided_compare_exchange", "src/repro/kernels/merge/kernel.py:49",
        err, lambda: MK.strided_compare_exchange(x, d, True),
        lambda: MK.strided_compare_exchange_plain(x, d, True),
        None, 2 * 4 * n, n)

    # K4: one HSS round's histogram, 8 x 2,000,000 sorted keys x 256 probes
    err = check("probe_rank_count", HK.probe_rank_count(sorted_rows, probes),
                HK.probe_ranks_plain(sorted_rows, probes))
    row("probe_rank_count", "src/repro/kernels/histogram/kernel.py:35",
        err, lambda: HK.probe_rank_count(sorted_rows, probes),
        lambda: HK.probe_ranks_plain(sorted_rows, probes),
        lambda: torch.searchsorted(sorted_rows, probes, side="left"),
        4 * (sorted_rows.numel() + 2 * probes.numel()),
        2 * sorted_rows.numel() * PROBES)
    return rows


def cascade_line(torch, card):
    """The local sort as a whole (K1 + K2 + K3) against torch.sort."""
    from repro_torch.kernels import dispatch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (P, N_LOCAL), generator=gen,
                      device="cuda", dtype=torch.int32)
    got = dispatch.local_sort(x, policy="kernel")
    if not torch.equal(got, torch.sort(x, dim=-1).values):
        fail("the kernel local sort disagrees with torch.sort")
    emit({"measure": "local_sort_cascade", "shape": [P, N_LOCAL],
          "kernel_ms": time_ms(torch, lambda: dispatch.local_sort(
              x, policy="kernel"), reps=10),
          "library_ms": time_ms(torch, lambda: torch.sort(x, dim=-1),
                                reps=10),
          "card": card})


def slice_inputs(np):
    from repro_torch.data.distributions import make_distribution

    yield "weak_scaling_int32", make_distribution("UNIF", N_WEAK, seed=0)
    yield "normal_float32", np.random.default_rng(1).standard_normal(
        N_WEAK).astype(np.float32)
    # below 2^32 - 1: the uint32 sentinel would force 31-bit tagging
    yield "ragged_uint32", np.random.default_rng(2).integers(
        0, 2 ** 32 - 1, N_WEAK + 3, dtype=np.uint32)


def slice_phase(torch, np, card):
    from repro_torch.kernels import cuda
    from repro_torch.sort import SortSpec, sort

    spec = SortSpec(shards=P, eps=EPS)
    main_launches = None
    for name, x in slice_inputs(np):
        cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sort(x, spec)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = dict(cuda.launches)
        if main_launches is None:
            main_launches = launches
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            fail(f"{name}: kernels never launched: {missing}")
        got = out.gather()
        if not np.array_equal(got, np.sort(x)):
            fail(f"{name}: gather() differs from np.sort")
        overflow = int(out.overflow)
        counts = out.counts.cpu().numpy()
        limit = (1 + EPS) * x.shape[0] / P + 1
        if overflow != 0 or counts.max() > limit:
            fail(f"{name}: overflow {overflow}, max count {counts.max()} "
                 f"(limit {limit})")
        ref = sort(x, dataclasses.replace(spec, kernel_policy="torch"))
        same = (torch.equal(out.shards.view(torch.int32),
                            ref.shards.view(torch.int32))
                and torch.equal(out.counts, ref.counts))
        if not same:
            fail(f"{name}: kernel and torch policies disagree")
        emit({"measure": "slice", "input": name, "n": int(x.shape[0]),
              "dtype": str(x.dtype), "overflow": overflow,
              "max_count": int(counts.max()), "limit": limit,
              "rounds_used": int(out.stats.rounds_used),
              "tagged": out.indices is not None, "launches": launches,
              "first_call_s": cold_s, "policies_agree": True, "card": card})
    return main_launches


def timing_phase(torch, np, card):
    from repro_torch.data.distributions import make_distribution
    from repro_torch.sort import SortSpec, sort

    x = make_distribution("UNIF", N_WEAK, seed=0)
    for policy in ("auto", "torch"):
        spec = SortSpec(shards=P, eps=EPS, kernel_policy=policy)
        sort(x, spec)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sort(x, spec)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        emit({"measure": "sort_e2e_warm", "input": "weak_scaling_int32",
              "policy": policy, "median_ms": statistics.median(times),
              "runs_ms": times, "card": card})

    spec = SortSpec(shards=P, eps=EPS)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        sort(x, spec)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in events)
    emit({"measure": "sort_profile", "input": "weak_scaling_int32",
          "device_us_total": total,
          "top": [{"name": e.key[:80], "device_us": e.self_device_time_total,
                   "calls": e.count} for e in events[:15]],
          "card": card})


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"chip_smoke: needs numpy and torch ({exc})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import cuda
    except ImportError as exc:
        print(f"chip_smoke: run it from the repository root ({exc})",
              file=sys.stderr)
        return 2

    card = card_line()
    emit({"measure": "toolchain", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "card": card})

    t0 = time.perf_counter()
    path = cuda.build(force=True)
    cuda.library()
    emit({"measure": "build", "seconds": time.perf_counter() - t0,
          "library": str(path), "card": card})

    rows = kernel_phase(torch, card)
    cascade_line(torch, card)
    launches = slice_phase(torch, np, card)
    for r in rows:
        r["launches"] = launches[r["name"]]
    timing_phase(torch, np, card)

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
