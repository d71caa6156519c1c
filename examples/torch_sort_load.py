"""Load generator for the PyTorch/CUDA port's sort-as-a-service HTTP front
end.

With no --base the script serves in this process (a ServiceRunner behind
`repro_torch.serve.http.make_server` on 127.0.0.1, a free port). Or start
a server yourself:

    PYTHONPATH=src python -m repro_torch.serve.http --port 8080

and drive it:

    PYTHONPATH=src python examples/torch_sort_load.py \\
        --base http://127.0.0.1:8080 --requests 128 --concurrency 16

Prints client-side latency percentiles and the server's /metrics view of
the same window (batch occupancy, flush reasons, cache counts).
"""
import argparse
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def post(base, route, payload, timeout=120):
    req = urllib.request.Request(
        base + route, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="sort service load generator")
    ap.add_argument("--base", default=None,
                    help="a running server (default: serve in this process)")
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--sizes", default="256,384",
                    help="comma-separated request lengths to mix")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the in-process server's device: cuda (default; "
                         "raises without a card) or cpu")
    args = ap.parse_args(argv)

    server = runner = None
    if args.base is None:
        from repro_torch.serve import ServiceConfig, ServiceRunner
        from repro_torch.serve.http import make_server
        from repro_torch.sort import SortSpec
        runner = ServiceRunner(spec=SortSpec(exchange="allgather", tag=False,
                                             device=args.device),
                               config=ServiceConfig(max_batch=8))
        server = make_server(runner, port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        host, port = server.server_address[:2]
        args.base = f"http://{host}:{port}"
        print(f"in-process server at {args.base}")

    sizes = [int(s) for s in args.sizes.split(",")]
    rng = np.random.default_rng(args.seed)
    inputs = [rng.permutation(4 * sizes[i % len(sizes)])
              [:sizes[i % len(sizes)]].astype(np.int32)
              for i in range(args.requests)]
    lat, codes = [], {}

    def one(x):
        t0 = time.perf_counter()
        status, body = post(args.base, "/v1/sort",
                            {"keys": x.tolist(), "dtype": "int32"})
        lat.append(time.perf_counter() - t0)
        codes[status] = codes.get(status, 0) + 1
        if status == 200:
            np.testing.assert_array_equal(
                np.asarray(body["sorted"], np.int32), np.sort(x))

    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(args.concurrency) as pool:
            list(pool.map(one, inputs))
        wall = time.perf_counter() - t0
        ms = sorted(1e3 * t for t in lat)
        print(f"{args.requests} requests, c={args.concurrency}: "
              f"{args.requests / wall:.0f} req/s, status codes {codes}")
        print(f"client latency ms: p50={ms[len(ms) // 2]:.1f} "
              f"p99={ms[min(len(ms) - 1, int(0.99 * len(ms)))]:.1f} "
              f"max={ms[-1]:.1f}")
        snap = json.loads(urllib.request.urlopen(
            args.base + "/metrics", timeout=30).read())
        print(f"server: served={snap['served']} batches={snap['batches']} "
              f"rejected={snap['rejected']}")
        for key, b in snap["buckets"].items():
            print(f"  bucket {key}: occupancy {b['mean_occupancy']:.1f}, "
                  f"flushes {b['flush_reasons']}, cache {b['cache']}")
        if codes != {200: args.requests}:
            raise SystemExit(f"requests failed: status codes {codes}")
    finally:
        if server is not None:
            server.shutdown()
            runner.close()


if __name__ == "__main__":
    main()
