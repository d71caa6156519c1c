"""HSS inside the LM stack on the PyTorch/CUDA port: capacity-bounded MoE
expert dispatch.

Token -> expert dispatch is the paper's partitioning problem (DESIGN.md
Sec. 4): N tokens split across expert shards under a static (1+eps)
capacity. This example routes a batch through the port's dispatch over an
emulated dp x tp grid (`ParallelCtx(dp_size, tp_size)`: each dp group's
all_to_all among its tp expert shards, each capacity cut for one shard's
tokens) at several capacity factors and shows the drop/balance trade-off,
then the pure-sort view: balanced re-partitioning of the expert ids
through `repro_torch.sort` (the duplicate-heavy ids are tagged, and the
returned indices are the token routing).

    PYTHONPATH=src python examples/torch_moe_routing.py              # card
    PYTHONPATH=src python examples/torch_moe_routing.py --device cpu \
        --tokens 64
"""
import argparse
import dataclasses

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=1024,
                    help="tokens a sequence (2 sequences)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import torch

    import repro_torch.sort as tsort
    from repro_torch.configs import smoke_config
    from repro_torch.models.moe import moe_ffn
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.sort.api import resolve_device

    dev = resolve_device(args.device)
    ctx = ParallelCtx(dp_size=args.dp, tp_size=args.tp)
    cfg = dataclasses.replace(smoke_config("phi3.5-moe-42b-a6.6b"),
                              n_experts=8, top_k=2, d_model=128,
                              d_ff_expert=256, dtype="float32")
    rng = np.random.default_rng(0)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert

    def draw(shape, scale):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    params = {"router": draw((d, E), 0.3), "w1": draw((E, d, f), 0.05),
              "w3": draw((E, d, f), 0.05), "w2": draw((E, f, d), 0.05)}
    x = draw((2, args.tokens, d), 1.0)
    assignments = x.shape[0] * x.shape[1] * cfg.top_k

    print(f"== dispatch over dp {ctx.dp_size} x tp {ctx.tp_size} "
          "(capacity-bounded, the MoE fast path) ==")
    for cf in (1.0, 1.5, 3.0):
        c = dataclasses.replace(cfg, moe_capacity_factor=cf)
        y, aux = moe_ffn(x, params, c, ctx)
        assert torch.isfinite(y).all()
        print(f"  capacity_factor={cf:<4} dropped {int(aux['dropped']):4d} "
              f"of {assignments} assignments")

    print("== pure-sort view: HSS over the expert ids ==")
    logits = x.reshape(-1, d).cpu().numpy() @ params["router"].cpu().numpy()
    eids = np.argsort(-logits, axis=-1)[:, :cfg.top_k].reshape(-1).astype(
        np.int32)
    n = eids.size
    res = tsort.sort(eids, tsort.SortSpec(eps=0.05, exchange="allgather",
                                          stable=True, device=args.device))
    p = res.shards.shape[0]
    print(f"  tokens per shard after HSS partition: {res.counts.tolist()}")
    print(f"  (1+eps) cap: {(1 + 0.05) * n / p:.0f}; overflow="
          f"{int(res.overflow)}; rounds={int(res.stats.rounds_used)}")
    print(f"  routed token ids, shard 0 head: {res.indices[0, :6].tolist()}")


if __name__ == "__main__":
    main()
