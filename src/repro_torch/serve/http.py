"""A thin stdlib-only HTTP front end over `SortService` (counterpart of
repro.serve.http; DESIGN.md Sec. 7.4).

    PYTHONPATH=src python -m repro_torch.serve.http --port 8080 \
        --exchange allgather --max-batch 8 --max-delay-ms 5 --device cuda

Endpoints (JSON in, JSON out):

  POST /v1/sort     {"keys": [...], "dtype": "int32", "timeout_ms": 100,
                     "spec": {"algorithm": "hss", ...}}  -> {"sorted": [...]}
  POST /v1/argsort  same body                        -> {"indices": [...]}
  POST /v1/sort_kv  + "values": [...]          -> {"keys": ..., "values": ...}
  POST /v1/semisort same body as /v1/sort      -> {"grouped": [...]}
                    (equal keys contiguous; no total-order promise)
  POST /v1/top_k    + "k": 10          -> {"top": [...]} (descending, len k)
  GET  /metrics     MetricsRegistry snapshot (per bucket, and the cache)
  POST /metrics/reset
  GET  /healthz     breaker-board health: {"health": "ok"|"degraded"|
                    "tripped", "breakers": {...}, "executor": {...}};
                    200 while the service can serve (ok or degraded,
                    degraded meaning open breakers are bypassed onto the
                    per-request path), 503 once tripped (an open breaker
                    AND a failing degraded path).

Status mapping of the typed service errors: Overloaded -> 429,
DeadlineExceeded -> 504, ServiceClosed -> 503, bad request -> 400.
Backpressure responses (429/503) carry a Retry-After header so clients
pace their retries.

`ThreadingHTTPServer` gives one thread per connection; every handler
blocks on `ServiceRunner.submit`, so concurrency here is exactly the
concurrent-caller pressure the dynamic batcher coalesces. The front end
is deliberately minimal: it exists so that the batching and admission
layer can be load-tested end to end (repro_torch.serve.smoke) without a
web framework.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from repro_torch.serve.errors import (
    DeadlineExceeded, Overloaded, ServiceClosed)
from repro_torch.serve.service import ServiceConfig, ServiceRunner
from repro_torch.sort import SortSpec

# spec fields a request may override (kernel_policy: auto | kernel |
# torch); the placement (shards, device) stays server-side
SPEC_FIELDS = ("algorithm", "eps", "rounds", "sample_per_shard", "adaptive",
               "total_sample", "s", "exchange", "pair_factor", "out_slack",
               "on_overflow", "max_overflow_retries",
               "verify", "on_verify_failure", "imbalance_slo",
               "stable", "tag", "seed", "kernel_policy")

_ROUTES = {"/v1/sort": "sort", "/v1/argsort": "argsort",
           "/v1/sort_kv": "sort_kv", "/v1/semisort": "semisort",
           "/v1/top_k": "top_k"}


class BadRequest(ValueError):
    pass


def _parse_keys(body: dict) -> np.ndarray:
    keys = body.get("keys")
    if not isinstance(keys, list) or not keys:
        raise BadRequest("'keys' must be a non-empty list")
    dtype = body.get("dtype")
    if dtype is None:
        dtype = ("float32" if any(isinstance(k, float) for k in keys)
                 else "int32")
    try:
        return np.asarray(keys, dtype=np.dtype(dtype))
    except (TypeError, ValueError) as e:
        raise BadRequest(f"bad keys/dtype: {e}") from e


def _parse_spec(body: dict, base: SortSpec) -> SortSpec | None:
    overrides = body.get("spec")
    if overrides is None:
        return None
    if not isinstance(overrides, dict):
        raise BadRequest("'spec' must be an object")
    unknown = set(overrides) - set(SPEC_FIELDS)
    if unknown:
        raise BadRequest(f"unknown spec fields {sorted(unknown)}; "
                         f"allowed: {list(SPEC_FIELDS)}")
    try:
        return dataclasses.replace(base, **overrides)
    except (TypeError, ValueError) as e:
        raise BadRequest(f"bad spec: {e}") from e


def make_handler(runner: ServiceRunner, *, verbose: bool = False):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            if verbose:
                super().log_message(fmt, *args)

        def _reply(self, code: int, payload: dict,
                   retry_after: float | None = None) -> None:
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            if retry_after is not None:
                self.send_header("Retry-After",
                                 str(max(1, int(round(retry_after)))))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                health = runner.health()
                if health["health"] == "tripped":
                    cooldown = runner.service.config.breaker_cooldown_s
                    self._reply(503, health, retry_after=cooldown)
                else:
                    self._reply(200, health)
            elif self.path == "/metrics":
                self._reply(200, runner.metrics())
            else:
                self._reply(404, {"error": f"no such route {self.path}"})

        def do_POST(self):
            if self.path == "/metrics/reset":
                runner.reset_metrics()
                self._reply(200, {"ok": True})
                return
            kind = _ROUTES.get(self.path)
            if kind is None:
                self._reply(404, {"error": f"no such route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(body, dict):
                    raise BadRequest("body must be a JSON object")
                x = _parse_keys(body)
                spec = _parse_spec(body, runner.service.spec)
                timeout_ms = body.get("timeout_ms")
                values = None
                if kind == "sort_kv":
                    values = np.asarray(body.get("values"))
                param = None
                if kind == "top_k":
                    param = body.get("k")
                    if not isinstance(param, int):
                        raise BadRequest("'k' must be an integer")
                result = runner.submit(
                    x, kind=kind, values=values, spec=spec, param=param,
                    timeout=None if timeout_ms is None else timeout_ms / 1e3)
            except (BadRequest, ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
            except Overloaded as e:
                # pace retries to roughly one flush interval
                backoff = runner.service.config.max_delay_ms / 1e3
                self._reply(429, {"error": str(e), "queued": e.queued,
                                  "in_flight": e.in_flight},
                            retry_after=backoff)
            except DeadlineExceeded as e:
                self._reply(504, {"error": str(e)})
            except ServiceClosed as e:
                self._reply(503, {"error": str(e)}, retry_after=5)
            except Exception as e:   # batch-level failure
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            else:
                if kind == "sort":
                    self._reply(200, {"sorted": result.tolist()})
                elif kind == "argsort":
                    self._reply(200, {"indices": result.tolist()})
                elif kind == "semisort":
                    self._reply(200, {"grouped": result.tolist()})
                elif kind == "top_k":
                    self._reply(200, {"top": result.tolist()})
                else:
                    k, v = result
                    self._reply(200, {"keys": k.tolist(),
                                      "values": v.tolist()})

    return Handler


def make_server(runner: ServiceRunner, *, host: str = "127.0.0.1",
                port: int = 0, verbose: bool = False) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; port 0 picks a free one
    (`server.server_address[1]` is the bound port)."""
    server = ThreadingHTTPServer((host, port),
                                 make_handler(runner, verbose=verbose))
    server.daemon_threads = True
    return server


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="sort-as-a-service front end")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--algorithm", default="hss")
    ap.add_argument("--exchange", default="dense",
                    choices=["dense", "dense_spill", "ragged", "allgather"])
    ap.add_argument("--on-overflow", default="raise",
                    choices=["raise", "retry", "spill"])
    ap.add_argument("--verify", default="off",
                    choices=["off", "cheap", "full"],
                    help="device-side postcondition audit tier")
    ap.add_argument("--on-verify-failure", default="raise",
                    choices=["raise", "retry", "fallback"])
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--max-queue-depth", type=int, default=256)
    ap.add_argument("--max-in-flight", type=int, default=2)
    ap.add_argument("--timeout-ms", type=float, default=None,
                    help="default per-request deadline")
    ap.add_argument("--shards", type=int, default=8,
                    help="p, the number of emulated shards")
    ap.add_argument("--device", default="cuda",
                    help="where the sorts run (cuda raises without a card)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    spec = SortSpec(algorithm=args.algorithm, exchange=args.exchange,
                    on_overflow=args.on_overflow, verify=args.verify,
                    on_verify_failure=args.on_verify_failure,
                    shards=args.shards, device=args.device)
    config = ServiceConfig(
        max_batch=args.max_batch, max_delay_ms=args.max_delay_ms,
        max_queue_depth=args.max_queue_depth,
        max_in_flight=args.max_in_flight,
        default_timeout_s=(None if args.timeout_ms is None
                           else args.timeout_ms / 1e3))
    with ServiceRunner(spec=spec, config=config) as runner:
        server = make_server(runner, host=args.host, port=args.port,
                             verbose=args.verbose)
        host, port = server.server_address[:2]
        print(f"sort service listening on http://{host}:{port} "
              f"(algorithm={args.algorithm}, exchange={args.exchange}, "
              f"max_batch={args.max_batch}, shards={args.shards}, "
              f"device={args.device})")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()


if __name__ == "__main__":
    main()
