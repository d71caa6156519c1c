"""Quickstart on the PyTorch/CUDA port: distributed Histogram Sort with
Sampling over 8 emulated shards on one card.

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --n 65536
"""
import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 20, help="keys to sort")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import repro_torch.sort as tsort

    # any numeric dtype (floats included), arbitrary distribution
    x = np.random.default_rng(0).permutation(args.n).astype(np.int32)
    spec = tsort.SortSpec(algorithm="hss", eps=0.05, device=args.device)
    result = tsort.sort(x, spec)

    out = result.gather()
    assert np.array_equal(np.sort(x), out)
    p = result.shards.shape[0]
    print(f"sorted {x.size} keys across {p} shards on {args.device}")
    print(f"  histogram rounds used : {int(result.stats.rounds_used)}")
    print(f"  samples per round     : {result.stats.sample_count.tolist()}")
    print(f"  gamma (interval union): {result.stats.gamma_size.tolist()}")
    print(f"  per-shard loads       : {result.counts.tolist()}  "
          f"(cap {(1 + 0.05) * x.size / p:.0f})")
    print(f"  exchange overflow     : {int(result.overflow)} (0 == exact)")

    # the same input through a baseline partitioner: one spec field
    baseline = tsort.sort(x, tsort.SortSpec(
        algorithm="sample_regular", eps=0.2, out_slack=1.3,
        device=args.device))
    assert np.array_equal(baseline.gather(), out)
    print(f"sample_regular agrees; loads {baseline.counts.tolist()}")


if __name__ == "__main__":
    main()
