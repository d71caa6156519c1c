"""Sorting as a service on the PyTorch/CUDA port, end to end: the async
serving layer (repro_torch.serve) batching concurrent sort requests, the
length bucketing by HSS, then the same bucketing managing a small model's
decode batches: the paper's partitioning inside a serving system.

    PYTHONPATH=src python examples/torch_sort_service.py              # card
    PYTHONPATH=src python examples/torch_sort_service.py --device cpu \\
        --requests 8
"""
import argparse
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import smoke_config
    from repro_torch.data.partition import bucket_lengths
    from repro_torch.launch.serve import serve_bucketed
    from repro_torch.serve import ServiceConfig, ServiceRunner
    from repro_torch.sort import SortSpec

    print("== sort-as-a-service: dynamic batching over the batched engine ==")
    rng = np.random.default_rng(0)
    spec = SortSpec(exchange="allgather", tag=False, device=args.device)
    config = ServiceConfig(max_batch=8, max_delay_ms=5.0)
    n = 8 * 64
    inputs = [rng.permutation(4 * n)[:n].astype(np.int32)
              for _ in range(args.requests)]
    with ServiceRunner(spec=spec, config=config) as runner:
        with ThreadPoolExecutor(8) as pool:          # 8 concurrent clients
            results = list(pool.map(runner.submit, inputs))
        for x, got in zip(inputs, results):
            np.testing.assert_array_equal(got, np.sort(x))
        snap = runner.metrics()
        print(f"  served {snap['served']} requests in {snap['batches']} "
              "batches")
        for key, b in snap["buckets"].items():
            print(f"  bucket {key}: mean occupancy "
                  f"{b['mean_occupancy']:.1f}, flushes {b['flush_reasons']}, "
                  f"p50 {b['latency_ms']['p50']:.1f} ms")
        cache = snap["exec_cache"]
        print(f"  exec cache: {cache['hits']} hits / {cache['misses']} "
              "misses")

    print("== HSS request bucketing ==")
    req_lens = rng.lognormal(4.5, 0.8, size=512).clip(8, 512).astype(np.int32)
    shards, _ = bucket_lengths(req_lens, n_shards=4,
                               spec=SortSpec(device=args.device))
    for i, s in enumerate(shards):
        print(f"  bucket {i}: {s.size:4d} requests, len range "
              f"[{req_lens[s].min() if s.size else 0}, "
              f"{req_lens[s].max() if s.size else 0}]")

    print("== bucketed decode (mamba2-family smoke model) ==")
    cfg = smoke_config("mamba2-370m")
    lens = rng.lognormal(3.0, 0.4, size=16).clip(8, 48).astype(np.int32)
    results, totals = serve_bucketed(cfg, prompt_lens=lens, gen=8,
                                     n_buckets=2, device=args.device)
    for ids, stats in results:
        print(f"  bucket of {ids.size:2d} reqs, prompt pad waste "
              f"{stats['pad_frac'] * 100:4.1f}%, "
              f"prefill {stats['prefill_s'] * 1e3:.1f} ms, "
              f"decode {stats['decode_s'] * 1e3:.1f} ms")
    print(f"  totals: {totals}")


if __name__ == "__main__":
    main()
