"""Serving entry point: prefill + batched greedy decode with a KV/SSM-state cache.

Counterpart of `repro.launch.serve`, on one device (the card unless
`--device cpu`):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --smoke --batch 4 --prompt-len 32 --gen 16 --device cpu

`serve_bucketed` adds request length-bucketing on top: a variable-length
request queue is partitioned into contiguous-length buckets through the
port's sort front door (`repro_torch.data.partition.bucket_lengths`: HSS
length bucketing, DESIGN.md Section 4.2; on the card the sort runs the
hand-written kernels) so each serving batch pads only to its own
bucket's max length.

`--sort-service` instead launches the sort-as-a-service HTTP front end
(repro_torch.serve.http); all other flags pass through:

    PYTHONPATH=src python -m repro_torch.launch.serve --sort-service --port 8080
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.common import round_up
from repro_torch.models.params import init_params
from repro_torch.models.steps import make_prefill_step, make_serve_step
from repro_torch.parallel.ctx import local_ctx
from repro_torch.sort.api import resolve_device

#: Devices a serving process runs on (the reference's len(jax.devices())).
N_DEVICES = 1


def _clock(dev: torch.device) -> float:
    """The host clock once the device has finished its queued work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def seeded_params(cfg, seed: int, device):
    """init_params from a generator on `device` seeded with `seed`."""
    dev = resolve_device(device)
    return init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                       dev)


def serve_batch(cfg, *, batch: int, prompt_len: int, gen: int, ctx=None,
                seed: int = 0, params=None, device="cuda"):
    """Prefill `batch` random prompts of `prompt_len` tokens (drawn from
    np.random.default_rng(seed), as the reference draws them) and decode
    `gen` tokens greedily. Returns (tokens (batch, gen) int32 NumPy,
    stats: prefill_s, decode_s, tok_per_s)."""
    dev = resolve_device(device)
    ctx = ctx or local_ctx()
    if params is None:
        params = seeded_params(cfg, seed, dev)
    rng = np.random.default_rng(seed)
    max_seq = prompt_len + gen

    prefill = make_prefill_step(cfg, ctx, max_seq)
    decode = make_serve_step(cfg, ctx)

    prompts = rng.integers(0, cfg.vocab, size=(batch, prompt_len)).astype(np.int32)
    b = {"tokens": torch.from_numpy(prompts).to(dev)}
    if cfg.family == "encdec":
        b["enc"] = _bf16(rng.standard_normal((batch, cfg.enc_ctx,
                                              cfg.d_model)), dev)
    if cfg.embed_inputs:
        b["embeds"] = _bf16(rng.standard_normal((batch, prompt_len,
                                                 cfg.d_model)), dev)

    t0 = _clock(dev)
    logits, cache = prefill(params, b)
    out = [torch.argmax(logits[:, :cfg.vocab], dim=-1).to(torch.int32)]
    t1 = _clock(dev)
    for t in range(gen - 1):
        tok = out[-1][:, None]
        if cfg.embed_inputs:  # vlm decode consumes embeddings (stub frontend)
            tok = torch.zeros((batch, 1, cfg.d_model), dtype=torch.bfloat16,
                              device=dev)
        logits, cache = decode(params, cache, tok, prompt_len + t)
        out.append(torch.argmax(logits[:, :cfg.vocab], dim=-1).to(torch.int32))
    toks = torch.stack(out, dim=1).cpu().numpy()
    t2 = _clock(dev)
    return toks, {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                  "tok_per_s": batch * (gen - 1) / max(t2 - t1, 1e-9)}


def _bf16(a: np.ndarray, dev) -> torch.Tensor:
    """float64 draws as bfloat16, as the reference's jnp.asarray(a,
    jnp.bfloat16) rounds them."""
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).to(dev)


def serve_bucketed(cfg, *, prompt_lens, gen: int, n_buckets: int = 0,
                   ctx=None, seed: int = 0, len_multiple: int = 8,
                   sort_spec=None, device="cuda"):
    """Serve a variable-length request queue in length-homogeneous buckets.

    prompt_lens: (n_requests,) prompt lengths. The queue is partitioned into
    contiguous-length, near-equal buckets by the distributed sort
    (repro_torch.data.partition.bucket_lengths); each bucket is served as
    one batch padded to the bucket's max length (rounded up to
    `len_multiple`, the SSM chunk size), which is what bounds the padding
    waste. `n_buckets` defaults to min(N_DEVICES, n_requests // 8), one
    bucket on one card. Returns per-bucket (request_ids, stats) plus
    totals. `sort_spec` overrides the bucketing SortSpec (by default the
    reference's: HSS, eps 0.05, the allgather exchange, on `device`).
    """
    from repro_torch.data.partition import bucket_lengths
    from repro_torch.sort import SortSpec
    dev = resolve_device(device)
    prompt_lens = np.asarray(prompt_lens).astype(np.int32)
    n_buckets = n_buckets or min(N_DEVICES, max(1, prompt_lens.size // 8))
    spec = sort_spec or SortSpec(algorithm="hss", eps=0.05,
                                 exchange="allgather", device=str(dev))
    buckets, _ = bucket_lengths(prompt_lens, n_shards=n_buckets, seed=seed,
                                spec=spec)
    ctx = ctx or local_ctx()
    params = seeded_params(cfg, seed, dev)            # shared by all buckets
    results, tok_total, t_total = [], 0, 0.0
    for ids in buckets:
        if not ids.size:
            continue
        plen = round_up(int(prompt_lens[ids].max()), len_multiple)
        toks, stats = serve_batch(cfg, batch=ids.size, prompt_len=plen,
                                  gen=gen, ctx=ctx, seed=seed, params=params,
                                  device=dev)
        stats["pad_frac"] = 1.0 - float(prompt_lens[ids].sum()) / (ids.size
                                                                   * plen)
        results.append((ids, stats))
        tok_total += toks.size
        t_total += stats["prefill_s"] + stats["decode_s"]
    totals = {"buckets": len(results), "tokens": tok_total,
              "total_s": t_total}
    return results, totals


def main(argv=None):
    import sys
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--sort-service" in argv:
        # sort-as-a-service front end (repro_torch.serve.http): every other
        # flag is passed through
        from repro_torch.serve.http import main as http_main
        return http_main([a for a in argv if a != "--sort-service"])
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--bucket", type=int, default=0, metavar="N_REQUESTS",
                    help="serve N lognormal-length requests via HSS "
                         "length bucketing instead of one uniform batch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.bucket:
        lens = np.random.default_rng(0).lognormal(
            3.5, 0.6, size=args.bucket).clip(8, 128).astype(np.int32)
        results, totals = serve_bucketed(cfg, prompt_lens=lens, gen=args.gen,
                                         device=args.device)
        for ids, stats in results:
            print(f"bucket of {ids.size:4d} reqs: "
                  f"{ {k: round(v, 3) for k, v in stats.items()} }")
        print(totals)
        return
    toks, stats = serve_batch(cfg, batch=args.batch,
                              prompt_len=args.prompt_len, gen=args.gen,
                              device=args.device)
    print("generated shape:", toks.shape)
    print({k: round(v, 3) for k, v in stats.items()})


if __name__ == "__main__":
    main()
