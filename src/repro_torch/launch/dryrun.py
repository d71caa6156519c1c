"""Multi-pod dry run: every (arch x shape x mesh) cell's real step, run
on the `meta` device under the emulated production ctx, with its memory,
cost and collectives reckoned (counterpart of repro.launch.dryrun).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both \\
        --out experiments/dryrun_torch.json [--jobs 6]

Each cell builds the real step (`make_train_step`, `make_prefill_step`,
`make_serve_step`) from `abstract_params` and the optimizer's state on
`meta` (shapes and dtypes, no storage): every op the steps run, the
flash attention's backward and the counting dispatch included, has a
meta shape rule, so no FakeTensorMode is needed. The ctx's dp x tp
grid is emulated (`ParallelCtx`): a run computes the global tensors on one
"device" and allocates nothing. A meta op costs the host tens of
microseconds whatever its size, and a 32k-token prefill runs 528 flash
blocks a layer, so no cell's step runs whole: as the reference
calibrates its costs, the step runs once for each of the config's 1- and
2-layer variants (`_calib_variants`; a third isolates the hybrid's shared
block) and a whole-step figure is A + (L-1)(B-A). There is no compiler,
so every figure is a reckoning, not a compiler's:

  memory (per device)
    argument_bytes  the sum over the whole config's arguments
                    (parameters, optimizer state, batch; cache, tokens
                    and pos for decode) of each leaf's shard
                    (`launch.specs.Sharding.shard_shape`, which raises
                    where a sharded dimension does not divide: the port's
                    "compile success"), but for the leaves the step never
                    reads, which jit prunes (a decode step's encoder
                    weights; an SSM's position);
    output_bytes    the same over the outputs (`full_outputs`), in the
                    reference's output shardings (train: the parameters'
                    and state's, the metrics replicated; prefill and
                    decode: logits (dp, tp) and the cache's), plus the
                    output tuple's 8-byte pointer an output that XLA's
                    figure counts;
    alias_bytes     the outputs that are argument tensors (the train
                    step updates the parameters and state in place, the
                    decode step the cache: the reference's donations);
    temp_bytes      the high-water of the live `meta` storage a run
                    creates, its outputs left out (a TorchDispatchMode
                    follows each new storage until it is freed),
                    calibrated, divided by the chips: the global
                    emulation's temporaries shared out evenly;
    peak_live_bytes argument + output + temp - alias, the reference's sum.
  calibrated (per device):
    flops           `torch.utils.flop_counter.FlopCounterMode` over the
                    step, divided by the chips;
    bytes           the input plus output bytes of every aten op that is
                    not a view (each tensor once an op), divided by the
                    chips;
    coll            bytes a device moves, by the reference's kinds, with
                    its ring multipliers (all-gather and all-to-all x 1,
                    all-reduce x 2, reduce-scatter x the group size):
                    (a) every `Comm` record of the emulated collectives
                    (the MoE all_to_alls, psums and pmeans), each a
                    per-shard operand; (b) from `param_pspecs`, what the
                    reference gets from GSPMD: each parameter shard
                    all-gathered over its data axes in every forward
                    (twice in a train step under remat "block": the
                    recompute gathers again; never for the expert weights
                    of a decode step, which stay where they are stored;
                    in `moe_gather_dtype` for the expert weights where
                    the config sets it, as the reference pins the cast to
                    the sharded layout),
                    and in a train step each gradient reduce-scattered
                    over the data axes it is sharded on (all-reduced when
                    it is replicated over them); (c) the tensor-parallel
                    activation collectives GSPMD adds (Megatron's), op by
                    op (`_Activations`), a = the bytes of one dp shard's
                    activation (the global tensor / dp, or whole when the
                    batch does not split): a product with a weight whose
                    tp-sharded dimension it sums over (wo, w2, wout,
                    shared_w2; the vocab-sharded embedding lookup) leaves
                    partial sums, all-reduced (2a) or, with seq_parallel
                    and tp_seq_collectives, reduce-scattered (a) into the
                    sequence-sharded residual; with seq_parallel (not in
                    decode) a product with a weight whose output columns
                    are tp-sharded (wq, w1, wz, lm_head ...) first
                    all-gathers its input's sequence (a, once an input);
                    without seq_parallel the MoE path's output, which the
                    reference's shard_map leaves sequence-sharded, is
                    all-gathered (a). (a) and (c) count each forward op
                    and each op of the remat recompute (torch's, which
                    stops at the last tensor the backward needs); in a
                    train step each forward collective has its transpose
                    in the backward, the same bytes (all-gather and
                    reduce-scatter swap, the others their own). Not
                    reckoned: the context-parallel attention's K/V
                    gathers (shard_heads False).
The XLA figures the reference prints (HLO collective bytes, temp bytes)
are its compiler's choices, so only the argument, output and alias bytes
and the `model` block are held to the reference's.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import math
import multiprocessing
import os
import time
import itertools
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, long_ctx_eligible
from repro_torch.configs.shapes import Shape
from repro_torch.launch.mesh import make_ctx, make_production_mesh
from repro_torch.launch.specs import (_dp_or_none, _ns, abstract_cache,
                                      batch_specs, cache_pspecs, decode_specs,
                                      param_shardings, tree_named)
from repro_torch.models.flops import active_params, model_flops, total_params
from repro_torch.models.lm import _hybrid_segments, tree_leaves
from repro_torch.models.params import abstract_params, param_pspecs
from repro_torch.models.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.parallel.comm import recording
from repro_torch.parallel.ctx import PSpec, map_specs

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "ragged-all-to-all")
#: each Comm collective as the reference's HLO kind, and the bytes a
#: device moves per operand byte (ring algorithms, repro/launch/dryrun.py)
_KIND = {"all_gather": ("all-gather", 1.0), "psum": ("all-reduce", 2.0),
         "pmean": ("all-reduce", 2.0), "all_to_all": ("all-to-all", 1.0),
         "ppermute": ("collective-permute", 1.0),
         "ragged_all_to_all": ("ragged-all-to-all", 1.0)}
#: the backward's collective for each forward one (each moves the same
#: bytes); the others are their own transposes
_TRANSPOSE = {"all-gather": "reduce-scatter", "reduce-scatter": "all-gather"}


@dataclasses.dataclass
class Step:
    """A cell's step: fn(*args) with each argument's shardings, the
    outputs' shardings (a function of the outputs) and the ctx.
    `int_read` lists the argument leaves (by index) that the port passes
    as Python ints and the step reads (decode's position)."""

    fn: object
    args: tuple
    shardings: tuple
    out_shardings: object
    ctx: object
    int_read: tuple = ()


def build_step(cfg, shape: Shape, ctx) -> Step:
    """The cell's real step over abstract (`meta`) arguments."""
    params = abstract_params(cfg)
    psh = param_shardings(cfg, ctx)
    if shape.kind == "train":
        opt = make_optimizer(cfg.optimizer)
        opt_state = opt.init(params)
        opt_sh = tree_named(ctx, opt.state_pspecs(param_pspecs(cfg, ctx)))
        bs, bsh = batch_specs(cfg, shape, ctx)
        fn = make_train_step(cfg, ctx, opt,
                             cosine_schedule(3e-4, 2000, 100_000))
        rep = _ns(ctx, PSpec())
        return Step(fn, (params, opt_state, bs), (psh, opt_sh, bsh),
                    lambda out: (psh, opt_sh, {k: rep for k in out[2]}),
                    ctx)
    dp = _dp_or_none(ctx, shape.global_batch)
    logits_sh = _ns(ctx, PSpec(dp, ctx.tp_axis))
    csh = tree_named(ctx, cache_pspecs(cfg, ctx, shape.global_batch))
    if shape.kind == "prefill":
        bs, bsh = batch_specs(cfg, shape, ctx)
        fn = make_prefill_step(cfg, ctx, shape.seq_len)
        return Step(fn, (params, bs), (psh, bsh),
                    lambda out: (logits_sh, csh), ctx)
    if shape.kind == "decode":
        (cache, tokens, pos), (csh, tsh, possh) = decode_specs(cfg, shape,
                                                               ctx)
        serve = make_serve_step(cfg, ctx)
        last = shape.seq_len - 1
        args = (params, cache, tokens, pos)
        # the step takes its position as an int (pos is the reference's
        # abstract 0-d argument); attention reads it, an SSM does not
        return Step(lambda params, cache, tokens, pos: serve(
            params, cache, tokens, last), args, (psh, csh, tsh, possh),
            lambda out: (logits_sh, csh), ctx,
            int_read=(len(tree_leaves(args)) - 1,) if cfg.n_heads else ())
    raise ValueError(shape.kind)


def _pairs(values, shardings):
    """(tensor, Sharding) over two trees of the same structure."""
    vals = tree_leaves(values)
    shards = []
    map_specs(shards.append, shardings)
    if len(vals) != len(shards):
        raise ValueError(f"{len(vals)} leaves against {len(shards)} "
                         "shardings")
    return list(zip(vals, shards))


def _shard_bytes(pairs) -> int:
    return sum(sh.shard_bytes(t) for t, sh in pairs)


def _phase() -> str:
    """"fwd" outside autograd's backward; within it, "recompute" under
    grad mode (the checkpoint's rerun of a layer), else "bwd"."""
    if torch._C._current_graph_task_id() == -1:
        return "fwd"
    return "recompute" if torch.is_grad_enabled() else "bwd"


class _Activations:
    """(c) of the module docstring: the tensor-parallel activation
    collectives GSPMD adds around the parameters sharded over the tp
    axis, seen op by op. `weights` maps a parameter's storage to the
    stride and size of its tp-sharded dimension, or to "router"."""

    def __init__(self, cfg, shape: Shape, ctx, params):
        specs = _flat(param_pspecs(cfg, ctx))
        self.weights = {}
        for path, t in _flat(params).items():
            if path.endswith("/router"):
                self.weights[id(t.untyped_storage())] = "router"
                continue
            dims = [i for i in range(len(specs[path]))
                    if ctx.tp_axis in specs[path].axes(i)]
            if dims:
                self.weights[id(t.untyped_storage())] = (
                    t.stride(dims[0]), t.shape[dims[0]])
        b = shape.global_batch
        self.dp = ctx.dp_size if b % ctx.dp_size == 0 and b >= ctx.dp_size \
            else 1
        self.seq = ctx.seq_parallel and shape.kind != "decode"
        self.scatter = self.seq and ctx.tp_seq_collectives
        self.moe_gather = not ctx.seq_parallel and shape.kind != "decode"
        self.gathered: set = set()      # (phase, id(storage)) gathered
        self.events: list = []          # (kind, bytes, phase)

    def _gather(self, x, phase):
        st = x.untyped_storage()
        key = (phase, id(st))
        if key not in self.gathered:
            self.gathered.add(key)
            weakref.finalize(st, self.gathered.discard, key)
            self.events.append(("all-gather", _nbytes(x) / self.dp, phase))

    def _reduce(self, out, phase):
        if self.scatter:
            self.events.append(("reduce-scatter", _nbytes(out) / self.dp,
                                phase))
        else:
            self.events.append(("all-reduce", 2.0 * _nbytes(out) / self.dp,
                                phase))

    def see(self, func, args, out, phase):
        if func is torch.ops.aten.mm.default:
            x, w = args
        elif func is torch.ops.aten.index.Tensor:
            x, w = None, args[0]
        else:
            return
        role = self.weights.get(id(w.untyped_storage()))
        if role is None:
            return
        if role == "router":
            if self.moe_gather:
                self._gather(x, phase)
        elif w.stride(0) == role[0] and w.shape[0] == role[1]:
            self._reduce(out, phase)    # the tp dim summed: partial sums
        elif x is not None and self.seq and w.stride(1) == role[0] and \
                w.shape[1] == role[1]:
            self._gather(x, phase)      # tp-sharded columns: whole rows


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class _Reckoner(TorchDispatchMode):
    """Follows every storage the ops create (a weak reference to each, so
    a freed storage leaves the count), in a timeline of allocations and
    frees, and sums each op's input and output bytes (views move none).
    Storages of `external` tensors (the arguments) are not followed.
    Each op is in a phase (`_phase`): the `Comm` events appended to
    `comm_events` take the phase of the op after them, and `activations`
    (an `_Activations`) sees every op outside the backward's own."""

    def __init__(self, external=(), comm_events=None, activations=None):
        super().__init__()
        self.known = {id(t.untyped_storage()): t.untyped_storage()
                      for t in external}
        self.live: dict = {}            # id(storage) -> its token
        self.timeline: list = []        # (token, +bytes or -bytes)
        self.tokens = itertools.count()
        self.bytes = 0
        self.read: set = set()          # id(storage) of arguments read
        self.comm_events = comm_events if comm_events is not None else []
        self.comm_phases: list = []
        self.activations = activations

    def _free(self, key, token, nbytes):
        if self.live.get(key) == token:
            del self.live[key]
        self.timeline.append((token, -nbytes))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        phase = _phase()
        self.comm_phases += [phase] * (len(self.comm_events)
                                       - len(self.comm_phases))
        out = func(*args, **(kwargs or {}))
        if self.activations is not None and phase != "bwd":
            self.activations.see(func, args, out, phase)
        for t in _pytree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor) and \
                    id(t.untyped_storage()) in self.known:
                self.read.add(id(t.untyped_storage()))
        alias = func._schema.returns[0].alias_info \
            if func._schema.returns else None
        if alias is None or alias.is_write:
            seen = {}
            for t in _pytree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    seen[id(t)] = t.numel() * t.element_size()
            self.bytes += sum(seen.values())
        for t in _pytree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self.known or key in self.live:
                continue
            token = next(self.tokens)
            self.live[key] = token
            self.timeline.append((token, st.nbytes()))
            weakref.finalize(st, self._free, key, token, st.nbytes())
        return out

    def high_water(self, outputs) -> int:
        """The most bytes live at once of the storages followed, those of
        `outputs` left out (they are the step's outputs, not its
        temporaries)."""
        skip = {self.live.get(id(t.untyped_storage())) for t in outputs}
        now = high = 0
        for token, delta in self.timeline:
            if token not in skip:
                now += delta
                high = max(high, now)
        return high


def _fsdp_coll(cfg, shape: Shape, ctx) -> dict:
    """(b) of the module docstring: the parameter gathers and gradient
    reductions over the data axes, per device, from param_pspecs."""
    out = dict.fromkeys(COLLECTIVES, 0.0)
    if ctx.dp_size == 1:
        return out
    specs = _flat(param_pspecs(cfg, ctx))
    gathers = 2 if shape.kind == "train" and cfg.remat != "none" else 1
    narrow = getattr(torch, cfg.moe_gather_dtype).itemsize \
        if cfg.moe_gather_dtype else None
    for path, t in _flat(abstract_params(cfg)).items():
        spec = specs[path]
        shard = _ns(ctx, spec).shard_bytes(t)
        group = math.prod(ctx.mesh.shape[a] for i in range(len(spec))
                          for a in spec.axes(i) if a in ctx.dp_axes)
        expert = "/moe/w" in path and "shared" not in path
        if group > 1 and not (expert and shape.kind == "decode"):
            wire = shard
            if expert and narrow:       # gathered in moe_gather_dtype
                wire = shard * narrow // t.element_size()
            out["all-gather"] += gathers * wire * group
        if shape.kind == "train":
            if group > 1:
                out["reduce-scatter"] += shard * group
            else:
                out["all-reduce"] += 2.0 * shard
    return out


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        flat = {}
        for k, v in tree.items():
            flat.update(_flat(v, f"{prefix}{k}/"))
        return flat
    return {prefix[:-1]: tree}


def _measure(cfg, shape: Shape, ctx) -> dict:
    """One run of the cell's step on `meta`: flops, bytes, collective
    bytes and the temporaries' high-water, per device, and the outputs."""
    step = build_step(cfg, shape, ctx)
    chips = ctx.mesh.size
    args = tree_leaves(step.args)
    acts = _Activations(cfg, shape, ctx, step.args[0]) \
        if ctx.tp_size > 1 else None
    with recording() as events, FlopCounterMode(display=False) as flops, \
            _Reckoner(args, events, acts) as rk:
        out = step.fn(*step.args)
    read = [i in step.int_read or id(t.untyped_storage()) in rk.read
            for i, t in enumerate(args)]
    # events after the last op are the forward's
    phases = rk.comm_phases + ["fwd"] * (len(events) - len(rk.comm_phases))
    moved = list(acts.events) if acts is not None else []
    for e, phase in zip(events, phases):
        if e.kind == "call":
            kind, mult = _KIND[e.record.collective]
            moved.append((kind, mult * e.record.nbytes, phase))
    coll = _fsdp_coll(cfg, shape, ctx)
    for kind, nbytes, phase in moved:
        if phase == "bwd":
            continue
        coll[kind] += nbytes
        if phase == "fwd" and shape.kind == "train":
            coll[_TRANSPOSE.get(kind, kind)] += nbytes
    return {"flops": flops.get_total_flops() / chips,
            "bytes": rk.bytes / chips,
            "temp": rk.high_water(tree_leaves(out)) / chips,
            "coll": coll, "coll_total": sum(coll.values()), "out": out,
            "read": read}


def _calib_variants(cfg):
    """Small config variants for exact per-layer deltas (the reference's:
    a third variant isolates the hybrid's shared block)."""
    dc = dataclasses
    if cfg.family == "hybrid":
        return [dc.replace(cfg, n_layers=1, shared_attn_period=1),
                dc.replace(cfg, n_layers=2, shared_attn_period=2),
                dc.replace(cfg, n_layers=2, shared_attn_period=1)]
    if cfg.family == "encdec":
        return [dc.replace(cfg, n_enc_layers=1, n_dec_layers=1, n_layers=2),
                dc.replace(cfg, n_enc_layers=2, n_dec_layers=2, n_layers=4)]
    return [dc.replace(cfg, n_layers=1), dc.replace(cfg, n_layers=2)]


def _lincomb(base, deltas):
    """base + sum(w_i * d_i) elementwise over the metric dicts."""
    out = {}
    for key in ("flops", "bytes", "temp", "coll_total"):
        out[key] = max(0.0, base[key] + sum(w * d[key] for w, d in deltas))
    out["coll"] = {k: max(0.0, base["coll"][k] + sum(
        w * d["coll"][k] for w, d in deltas)) for k in base["coll"]}
    return out


def _sub(a, b):
    out = {k: a[k] - b[k] for k in ("flops", "bytes", "temp", "coll_total")}
    out["coll"] = {k: a["coll"][k] - b["coll"][k] for k in a["coll"]}
    return out


def calibrated_costs(cfg, shape: Shape, ctx, measured=None) -> dict:
    """Whole-step per-device figures from the variants' runs (`measured`,
    else run here)."""
    ms = measured or [_measure(v, shape, ctx) for v in _calib_variants(cfg)]
    if cfg.family == "hybrid":
        n_seg = len(_hybrid_segments(cfg))
        return _lincomb(ms[0], [(cfg.n_layers - 1, _sub(ms[1], ms[0])),
                                (n_seg - 1, _sub(ms[2], ms[1]))])
    if cfg.family == "encdec":
        return _lincomb(ms[0], [(cfg.n_enc_layers - 1, _sub(ms[1], ms[0]))])
    return _lincomb(ms[0], [(cfg.n_layers - 1, _sub(ms[1], ms[0]))])


def full_outputs(step: Step, cfg, shape: Shape, small_out):
    """The whole step's outputs, from a variant's (`small_out`): train
    gives the parameters and state it was given (updated in place) and
    the metrics; prefill the logits and a new cache of the whole config;
    decode the logits and the cache it was given (updated in place)."""
    if shape.kind == "train":
        return step.args[0], step.args[1], small_out[2]
    if shape.kind == "prefill":
        return small_out[0], abstract_cache(cfg, shape.global_batch,
                                            shape.seq_len, step.ctx)
    return small_out[0], step.args[1]


def memory(step: Step, outputs, temp: float, read) -> dict:
    """The per-device memory (the module docstring) of `step` with these
    outputs and temporaries; `read[i]` says whether the step reads
    argument leaf i (jit prunes an argument its step never reads)."""
    arg_pairs = [pair for pair, r in zip(_pairs(step.args, step.shardings),
                                         read) if r]
    out_pairs = _pairs(outputs, step.out_shardings(outputs))
    mine = {id(t) for t in tree_leaves(step.args)}
    argument = _shard_bytes(arg_pairs)
    # the reference's figure counts the output tuple's table too: one
    # 8-byte buffer pointer an output
    output = _shard_bytes(out_pairs) + 8 * len(out_pairs)
    alias = _shard_bytes([(t, sh) for t, sh in out_pairs if id(t) in mine])
    temp = int(temp)
    return {"argument_bytes": argument, "output_bytes": output,
            "temp_bytes": temp, "alias_bytes": alias,
            "peak_live_bytes": argument + output + temp - alias}


def cell_figures(cfg, shape: Shape, ctx) -> tuple:
    """(memory, calibrated) of one cell under `ctx`."""
    step = build_step(cfg, shape, ctx)
    ms = [_measure(v, shape, ctx) for v in _calib_variants(cfg)]
    calib = calibrated_costs(cfg, shape, ctx, ms)
    mem = memory(step, full_outputs(step, cfg, shape, ms[0]["out"]),
                 calib.pop("temp"), ms[0]["read"])
    return mem, calib


def model_block(cfg, shape: Shape, n_chips: int) -> dict:
    return {"params_total": total_params(cfg),
            "params_active": active_params(cfg),
            "model_flops_global": model_flops(cfg, shape.kind, shape.seq_len,
                                              shape.global_batch),
            "n_chips": n_chips}


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """The reference's record of one cell on its production mesh."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(s) for s in mesh.axis_sizes)}
    if shape_name == "long_500k" and not long_ctx_eligible(cfg):
        rec["status"] = "SKIP(full-attention)"
        return rec
    t0 = time.time()
    ctx = make_ctx(cfg, mesh, multi_pod=multi_pod)
    mem, calib = cell_figures(cfg, shape, ctx)
    rec.update({"status": "OK", "calib_s": round(time.time() - t0, 1),
                "memory": mem, "calibrated": calib,
                "model": model_block(cfg, shape, mesh.size)})
    return rec


def _cell_record(key) -> dict:
    """run_cell of (arch, shape, multi_pod), a failure recorded."""
    arch, shape, multi = key
    try:
        return run_cell(arch, shape, multi)
    except Exception as e:  # record the failure, keep going
        return {"arch": arch, "shape": shape,
                "mesh": "2x16x16" if multi else "16x16",
                "status": f"FAIL({type(e).__name__})",
                "error": str(e)[:2000],
                "trace": traceback.format_exc()[-2000:]}


def run_cells(keys, jobs: int = 1):
    """Each (arch, shape, multi_pod) cell's record, in completion order;
    `jobs` > 1 runs the cells in that many worker processes (the runs are
    host work on `meta`)."""
    if jobs <= 1:
        for key in keys:
            yield _cell_record(key)
        return
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(jobs, mp_context=ctx) as pool:
        futures = [pool.submit(_cell_record, key) for key in keys]
        for f in concurrent.futures.as_completed(futures):
            yield f.result()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="single arch id (default all)")
    ap.add_argument("--shape", default=None, help="single shape (default all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch.json")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (default 1: in this process)")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status", "").startswith(("OK", "SKIP"))}

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    keys = [(arch, shape, multi) for multi in meshes for arch in archs
            for shape in shapes
            if (arch, shape, "2x16x16" if multi else "16x16") not in done]
    for rec in run_cells(keys, args.jobs):
        key = (rec["arch"], rec["shape"], rec["mesh"])
        results = [r for r in results
                   if (r["arch"], r["shape"], r["mesh"]) != key]
        results.append(rec)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[dryrun] {key} -> {rec['status']}", flush=True)

    ok = sum(r["status"] == "OK" for r in results)
    skip = sum(r["status"].startswith("SKIP") for r in results)
    fail = sum(r["status"].startswith("FAIL") for r in results)
    print(f"[dryrun] done: {ok} OK, {skip} SKIP, {fail} FAIL")
    return 0 if fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
