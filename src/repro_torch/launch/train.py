"""Training driver: config -> train step -> supervised loop (counterpart
of repro.launch.train), on one device (the card unless `--device cpu`):

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
        --smoke --steps 4 --device cpu [--ckpt-dir DIR]

The loop runs under the fault-tolerance supervisor when a checkpoint
directory is given: checkpoint and restart, straggler flagging,
asynchronous saves; the data pipeline is cursor-seekable, so a restart
resumes mid-stream deterministically. The step updates the parameters and
the optimizer state in place; the loop reads the loss on the host once a
step, for its history.

The port runs on one device (`launch.serve.N_DEVICES`), so `train` keeps
the local (1, 1) ctx unless the caller passes one: a dp > 1 ctx runs the
same step with the MoE dispatch cut for that layout (`ParallelCtx`), as
the reference's `host_mesh_ctx` runs dp = its device count.
`--production-mesh` (with `--multi-pod`) builds the production layout
through `launch.mesh`, emulated on the one device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.launch.mesh import make_ctx, make_production_mesh
from repro_torch.launch.serve import _bf16, seeded_params
from repro_torch.models.steps import make_train_step
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.parallel.ctx import local_ctx
from repro_torch.runtime.ft import TrainSupervisor
from repro_torch.sort.api import resolve_device


def train(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: str | None,
          lr: float = 3e-4, save_every: int = 50, ctx=None, seed: int = 0,
          log_every: int = 10, on_metrics=None, device="cuda"):
    """Train `cfg` from seeded weights for `steps` steps of (batch, seq)
    synthetic tokens. Returns ((params, opt_state), the loss history)."""
    dev = resolve_device(device)
    ctx = ctx or local_ctx()
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                           seed=seed)
    opt = make_optimizer(cfg.optimizer)
    params = seeded_params(cfg, seed, dev)
    opt_state = opt.init(params)
    step_fn = make_train_step(
        cfg, ctx, opt, cosine_schedule(lr, max(steps // 20, 1), steps))

    history = []

    def one_step(step, state):
        params, opt_state = state
        tokens, labels = data.batch(step)
        b = {"tokens": torch.from_numpy(tokens).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
        if cfg.family == "encdec":
            rng = np.random.default_rng(step)
            b["enc"] = _bf16(rng.standard_normal((batch, cfg.enc_ctx,
                                                  cfg.d_model)), dev)
        if cfg.embed_inputs:
            rng = np.random.default_rng(step)
            b["embeds"] = _bf16(rng.standard_normal((batch, seq,
                                                     cfg.d_model)), dev)
        params, opt_state, metrics = step_fn(params, opt_state, b)
        return (params, opt_state), metrics

    def metrics_cb(step, metrics, slow):
        loss = float(metrics["loss"])
        history.append(loss)
        if on_metrics:
            on_metrics(step, metrics, slow)
        elif step % log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}"
                  f"{' [straggler]' if slow else ''}", flush=True)

    if ckpt_dir:
        sup = TrainSupervisor(ckpt_dir, save_every=save_every, device=dev)
        state = sup.run((params, opt_state), steps, one_step,
                        on_metrics=metrics_cb)
    else:
        state = (params, opt_state)
        for s in range(steps):
            state, m = one_step(s, state)
            metrics_cb(s, m, False)
    return state, history


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def cli_ctx(cfg, args):
    """The ctx the CLI asks for: the production layout with
    --production-mesh, else None (train's local ctx)."""
    if not args.production_mesh:
        return None
    mesh = make_production_mesh(multi_pod=args.multi_pod)
    return make_ctx(cfg, mesh, multi_pod=args.multi_pod)


def main(argv=None):
    args = parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    t0 = time.time()
    _, history = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                       ckpt_dir=args.ckpt_dir, lr=args.lr,
                       ctx=cli_ctx(cfg, args), device=args.device)
    print(f"done: {args.steps} steps in {time.time()-t0:.1f}s; "
          f"loss {history[0]:.3f} -> {history[-1]:.3f}")


if __name__ == "__main__":
    main()
