"""Perf hillclimbing harness (counterpart of repro.launch.hillclimb).

Each experiment = (cell, config/ctx override) -> the dry run's reckoning
(`launch.dryrun.cell_figures`) -> roofline terms; results append to
experiments/hillclimb_torch.json, so the hypothesis -> change ->
before/after log is machine-checkable.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --exp kimi_base

The roofline constants are an H100 SXM5's, from NVIDIA's H100 Tensor
Core GPU datasheet: 989.4 TFLOP/s of dense bf16, 3.35 TB/s of HBM3,
450 GB/s a direction of NVLink 4 between the 8 cards of a node, and
50 GB/s a direction of a 400 Gb/s NDR InfiniBand link between nodes. The
collective term uses the inter-node rate: the production mesh's 16-wide
model axis spans two 8-card nodes (`launch/mesh`), so each of its ring
collectives crosses the network, whose slowest link sets the ring's
pace, and the data axes are wider still. The chip count is the mesh's.
The collective bytes are the dry run's reckoning (`launch/dryrun`'s
docstring); a record's `not_reckoned` names what it leaves out for the
cell's ctx.
"""
import argparse
import dataclasses
import json
import os

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import cell_figures
from repro_torch.launch.mesh import make_ctx, make_production_mesh
from repro_torch.models.flops import model_flops

PEAK = 989.4e12          # dense bf16 FLOP/s
HBM = 3.35e12            # bytes/s
COLLECTIVE = 50e9        # bytes/s a direction of 400 Gb/s NDR, between nodes


def measure(arch, shape_name, cfg_changes=None, ctx_changes=None):
    cfg = get_config(arch)
    if cfg_changes:
        cfg = dataclasses.replace(cfg, **cfg_changes)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=False)
    ctx = make_ctx(cfg, mesh, multi_pod=False)
    if ctx_changes:
        ctx = dataclasses.replace(ctx, **ctx_changes)
    mem, cal = cell_figures(cfg, shape, ctx)
    chips = mesh.size
    useful = model_flops(cfg, shape.kind, shape.seq_len,
                         shape.global_batch) / chips
    kindmult = 3.0 if shape.kind == "train" else 1.0
    mem_lo = (kindmult * mem["argument_bytes"] + mem["output_bytes"]) / HBM
    terms = {"compute_s": cal["flops"] / PEAK,
             "collective_s": cal["coll_total"] / COLLECTIVE,
             "memory_s_lower": mem_lo}
    dom = max(terms, key=terms.get)
    return {
        "arch": arch, "shape": shape_name,
        "cfg_changes": {k: str(v) for k, v in (cfg_changes or {}).items()},
        "ctx_changes": {k: str(v) for k, v in (ctx_changes or {}).items()},
        "dp": ctx.dp_size, "tp": ctx.tp_size, "n_chips": chips,
        "not_reckoned": (["context-parallel K/V gathers"]
                         if ctx.tp_size > 1 and not ctx.shard_heads else []),
        "peak_gb": mem["peak_live_bytes"] / 1e9,
        "flops_per_dev_tf": cal["flops"] / 1e12,
        "coll_gb": cal["coll_total"] / 1e9,
        "coll_mix_gb": {k: round(v / 1e9, 2) for k, v in cal["coll"].items()
                        if v > 1e8},
        "hbm_gb": cal["bytes"] / 1e9,
        "memory_s_upper": round(cal["bytes"] / HBM, 4),
        **{k: round(v, 4) for k, v in terms.items()},
        "dominant": dom,
        "useful_s": round(useful / PEAK, 4),
        "roofline_frac": round((useful / PEAK) / max(terms.values()), 4),
    }


EXPERIMENTS = {
    # --- kimi-k2 train_4k (worst peak + most collective-bound) ---
    "kimi_base": ("kimi-k2-1t-a32b", "train_4k", None, None),
    "kimi_f8_gather": ("kimi-k2-1t-a32b", "train_4k",
                       {"moe_gather_dtype": "float8_e4m3fn"}, None),
    "kimi_no_seqpar": ("kimi-k2-1t-a32b", "train_4k", None,
                       {"seq_parallel": False}),
    "kimi_f8_noseqpar": ("kimi-k2-1t-a32b", "train_4k",
                         {"moe_gather_dtype": "float8_e4m3fn"},
                         {"seq_parallel": False}),
    "kimi_megatron_sp": ("kimi-k2-1t-a32b", "train_4k", None,
                         {"tp_seq_collectives": True}),
    "kimi_ctxpar": ("kimi-k2-1t-a32b", "train_4k",
                    {"moe_gather_dtype": "float8_e4m3fn"},
                    {"shard_heads": False, "rules_extra": (("tp", None),)}),
    "kimi_ctxpar_a2a8": ("kimi-k2-1t-a32b", "train_4k",
                         {"moe_gather_dtype": "float8_e4m3fn",
                          "moe_a2a_dtype": "float8_e4m3fn"},
                         {"shard_heads": False, "rules_extra": (("tp", None),)}),
    "kimi_f8_msp": ("kimi-k2-1t-a32b", "train_4k",
                    {"moe_gather_dtype": "float8_e4m3fn"},
                    {"tp_seq_collectives": True}),
    "kimi_cf1": ("kimi-k2-1t-a32b", "train_4k",
                 {"moe_capacity_factor": 1.0,
                  "moe_gather_dtype": "float8_e4m3fn"}, None),
    "kimi_decode": ("kimi-k2-1t-a32b", "decode_32k", None, None),
    # --- granite-34b train_4k (most collective-bound dense) ---
    "granite_base": ("granite-34b", "train_4k", None, None),
    "granite_no_seqpar": ("granite-34b", "train_4k", None,
                          {"seq_parallel": False}),
    "granite_megatron_sp": ("granite-34b", "train_4k", None,
                            {"tp_seq_collectives": True}),
    "granite_pure_fsdp": ("granite-34b", "train_4k", None,
                          {"dp_axes": ("data", "model"), "tp_axis": None,
                           "seq_parallel": False}),
    "granite_chunk2k": ("granite-34b", "train_4k", {"attn_chunk": 2048}, None),
    "stablelm_pure_fsdp": ("stablelm-12b", "train_4k", None,
                           {"dp_axes": ("data", "model"), "tp_axis": None,
                            "seq_parallel": False}),
    # --- zamba2 long_500k (worst roofline fraction) ---
    "zamba_long_base": ("zamba2-1.2b", "long_500k", None, None),
    "zamba_long_window2k": ("zamba2-1.2b", "long_500k",
                            {"attn_window": 2048}, None),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", required=True)
    ap.add_argument("--out", default="experiments/hillclimb_torch.json")
    args = ap.parse_args(argv)
    arch, shape, cfgc, ctxc = EXPERIMENTS[args.exp]
    rec = measure(arch, shape, cfgc, ctxc)
    rec["exp"] = args.exp
    hist = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            hist = json.load(f)
    hist = [h for h in hist if h.get("exp") != args.exp] + [rec]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(hist, f, indent=1)
    print(json.dumps(rec, indent=1))

if __name__ == "__main__":
    main()
