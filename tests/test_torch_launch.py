"""The launch layer against the reference (`repro.launch.mesh`, `specs`,
`dryrun`, `hillclimb`, `train`'s CLI): the parameter specs, AdamW's and
Adafactor's state specs, the batch, cache and decode specs of the ten
smoke configs at the four shapes, equal to the reference's as tuples on a
(2, 4) ("data", "model") mesh and a (2, 2, 2) ("pod", "data", "model")
multi-pod mesh of Auto axes; `make_ctx` on the production meshes; the dry
run's per-device argument, output and alias bytes equal to the
reference's `memory_analysis()` to the byte (Phi-3.5-MoE, granite-34b,
mamba2-370m, zamba2 and whisper under train, prefill and decode at
global_batch 8, seq_len 64 on (2, 4)), its collective bytes by kind
printed beside the reference's XLA figures (XLA chooses its own, so they
are not asserted); the `model` block; one `hillclimb.measure` at smoke
size; `--production-mesh` parsing.
"""
import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, PartitionSpec as P

import repro.configs as rconfigs
import repro.launch.mesh as rmesh
import repro.launch.specs as rspecs
import repro.models.flops as rflops
import repro.models.params as rparams
import repro.optim as roptim
import repro_torch.configs as tconfigs
import repro_torch.launch.dryrun as tdry
import repro_torch.launch.hillclimb as thill
import repro_torch.launch.specs as tspecs
import repro_torch.launch.train as ttrain
import repro_torch.models.params as tparams
import repro_torch.optim as toptim
from repro_torch.launch import make_ctx, make_production_mesh
from repro_torch.parallel.ctx import Mesh, PSpec

MESHES = {"single": (("data", "model"), (2, 4)),
          "multi": (("pod", "data", "model"), (2, 2, 2))}


def _flat(tree, is_leaf, prefix=""):
    """{path: leaf} over dicts (sorted) and tuples, `is_leaf` leaves."""
    if is_leaf(tree):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = sorted(tree.items())
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, is_leaf, f"{prefix}/{k}"))
    return out


def ref_specs(tree):
    flat = _flat(tree, lambda x: isinstance(x, P) or x is None)
    return {k: tuple(v) if v is not None else None for k, v in flat.items()}


def port_specs(tree):
    flat = _flat(tree, lambda x: isinstance(x, PSpec) or x is None)
    return {k: tuple(v) if v is not None else None for k, v in flat.items()}


def both_ctx(arch, mesh_name):
    """(port cfg, reference cfg, port ctx, reference ctx) of `arch`'s
    smoke config under launch.mesh.make_ctx on the named mesh."""
    names, sizes = MESHES[mesh_name]
    multi = mesh_name == "multi"
    ref_mesh = jax.make_mesh(sizes, names, axis_types=(AxisType.Auto,) * 3
                             if multi else (AxisType.Auto,) * 2,
                             devices=jax.devices()[:8])
    cfg, ref_cfg = tconfigs.smoke_config(arch), rconfigs.smoke_config(arch)
    return (cfg, ref_cfg, make_ctx(cfg, Mesh(names, sizes), multi_pod=multi),
            rmesh.make_ctx(ref_cfg, ref_mesh, multi_pod=multi))


def assert_abstract_equal(got: dict, want: dict, what):
    """meta tensors against ShapeDtypeStructs, leaf for leaf."""
    assert sorted(got) == sorted(want), what
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), (what, k)
        assert str(got[k].dtype).removeprefix("torch.") == \
            np.dtype(want[k].dtype).name, (what, k)


def shard_specs(tree, is_port):
    if is_port:
        return {k: tuple(v.spec) for k, v in _flat(
            tree, lambda x: isinstance(x, tspecs.Sharding)).items()}
    return {k: tuple(v.spec) for k, v in _flat(
        tree, lambda x: isinstance(x, jax.sharding.NamedSharding)).items()}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_specs_equal_the_reference(arch, mesh_name):
    cfg, ref_cfg, ctx, ref_ctx = both_ctx(arch, mesh_name)
    pspecs = tparams.param_pspecs(cfg, ctx)
    ref_pspecs = rparams.param_pspecs(ref_cfg, ref_ctx)
    assert port_specs(pspecs) == ref_specs(ref_pspecs)
    for name in ("adamw", "adafactor"):
        got = toptim.make_optimizer(name).state_pspecs(pspecs)
        want = roptim.make_optimizer(name).state_pspecs(ref_pspecs)
        assert port_specs(got) == ref_specs(want), name
    for shape_name in tconfigs.SHAPES:
        shape, ref_shape = (tconfigs.SHAPES[shape_name],
                            rconfigs.SHAPES[shape_name])
        b = shape.global_batch
        assert port_specs(tspecs.cache_pspecs(cfg, ctx, b)) == \
            ref_specs(rspecs.cache_pspecs(ref_cfg, ref_ctx, b)), shape_name
        if shape.kind == "decode":
            got, got_sh = tspecs.decode_specs(cfg, shape, ctx)
            want, want_sh = rspecs.decode_specs(ref_cfg, ref_shape, ref_ctx)
            flat = lambda tr, leaf: _flat(tr, leaf)
            assert_abstract_equal(
                flat(got, lambda x: isinstance(x, torch.Tensor)),
                flat(want, lambda x: hasattr(x, "shape")), shape_name)
            assert shard_specs(got_sh, True) == shard_specs(want_sh, False)
        else:
            got, got_sh = tspecs.batch_specs(cfg, shape, ctx)
            want, want_sh = rspecs.batch_specs(ref_cfg, ref_shape, ref_ctx)
            assert_abstract_equal(got, want, shape_name)
            assert shard_specs(got_sh, True) == shard_specs(want_sh, False)


class _LogicalMesh:
    """The reference's make_ctx reads only `mesh.shape`: a stand-in for
    its 256- and 512-device production meshes."""

    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("multi", [False, True])
def test_make_ctx_on_the_production_meshes(multi):
    mesh = make_production_mesh(multi_pod=multi)
    assert mesh.size == (512 if multi else 256)
    for arch in tconfigs.ARCH_IDS:
        cfg, ref_cfg = tconfigs.get_config(arch), rconfigs.get_config(arch)
        ctx = make_ctx(cfg, mesh, multi_pod=multi)
        ref = rmesh.make_ctx(ref_cfg, _LogicalMesh(mesh.shape),
                             multi_pod=multi)
        assert (ctx.dp_size, ctx.tp_size) == (32 if multi else 16, 16)
        assert (ctx.dp_size, ctx.tp_size) == (ref.dp_size, ref.tp_size)
        assert ctx.shard_heads == cfg.heads_shardable(16) == ref.shard_heads
        assert ctx.rules_extra == ref.rules_extra
        assert ctx.rules() == ref.rules()
        assert (("tp_kv", None) in ctx.rules_extra) == \
            bool(cfg.n_kv_heads and cfg.n_kv_heads % 16)
    # hillclimb's pure-FSDP experiments: every axis a data axis, tp 1
    ctx = make_ctx(tconfigs.get_config("granite-34b"), mesh, multi_pod=multi)
    pure = dataclasses.replace(ctx, dp_axes=ctx.dp_axes + ("model",),
                               tp_axis=None)
    assert (pure.dp_size, pure.tp_size) == (mesh.size, 1)
    assert pure.spec("fsdp", "tp")[1] is None


def test_sharding_refuses_an_indivisible_layout():
    sh = tspecs.Sharding(Mesh(("data", "model"), (2, 4)),
                         PSpec("data", "model"))
    assert sh.shard_shape((8, 12)) == (4, 3)
    with pytest.raises(ValueError):
        sh.shard_shape((8, 6))
    with pytest.raises(ValueError):
        sh.shard_shape((8,))


DRY = ("phi3.5-moe-42b-a6.6b", "granite-34b", "mamba2-370m", "zamba2-1.2b",
       "whisper-large-v3")


def _reference_cell(ref_cfg, ref_ctx, ref_shape):
    import repro.launch.dryrun as rdry   # sets XLA_FLAGS: jax is up already

    jfn, args = rdry.build_step(ref_cfg, ref_shape, ref_ctx)
    compiled = jfn.lower(*args).compile()
    return compiled.memory_analysis(), rdry.collective_bytes(
        compiled.as_text())["bytes"]


def _whisper_resharded(cfg, ctx):
    """The reference's compiler lays whisper's encoder position table
    (enc_pos/w) and its two moments out over ("model", "data") in the
    train step's outputs where their inputs are (None, "data"): those
    outputs alias nothing and hold a quarter of the bytes. -> (output
    bytes, alias bytes) the port's reckoning has more."""
    t = tparams.abstract_params(cfg)["enc_pos"]["w"]
    spec = tparams.param_pspecs(cfg, ctx)["enc_pos"]["w"]
    size = 2 + 4 + 4          # bf16 weight, float32 m and v
    kept = tspecs.Sharding(ctx.mesh, spec).shard_bytes(t) // 2
    moved = tspecs.Sharding(ctx.mesh, PSpec("model", "data")).shard_bytes(
        t) // 2
    return (kept - moved) * size, kept * size


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", DRY)
def test_dryrun_memory_equals_the_reference(arch, kind):
    cfg, ref_cfg, ctx, ref_ctx = both_ctx(arch, "single")
    shape = dataclasses.replace(tconfigs.SHAPES[kind], global_batch=8,
                                seq_len=64)
    ref_shape = dataclasses.replace(rconfigs.SHAPES[kind], global_batch=8,
                                    seq_len=64)
    ma, ref_coll = _reference_cell(ref_cfg, ref_ctx, ref_shape)
    mem, calib = tdry.cell_figures(cfg, shape, ctx)
    out_extra = alias_extra = 0
    if arch.startswith("whisper") and kind == "train_4k":
        out_extra, alias_extra = _whisper_resharded(cfg, ctx)
    assert mem["argument_bytes"] == ma.argument_size_in_bytes
    assert mem["output_bytes"] - out_extra == ma.output_size_in_bytes
    assert mem["alias_bytes"] - alias_extra == ma.alias_size_in_bytes
    assert mem["peak_live_bytes"] == (mem["argument_bytes"]
                                      + mem["output_bytes"]
                                      + mem["temp_bytes"]
                                      - mem["alias_bytes"])
    # collectives: XLA's own choices, printed beside the port's reckoning
    port = {k: v for k, v in calib["coll"].items() if v}
    print(f"\n{arch} {kind}: port calibrated {port}; reference XLA "
          f"(scanned once) {dict((k, v) for k, v in ref_coll.items() if v)}; "
          f"temp port {mem['temp_bytes']} reference "
          f"{ma.temp_size_in_bytes}")
    assert calib["flops"] > 0 and calib["bytes"] > 0


@pytest.mark.parametrize("changes,kinds", [
    ({}, {"all-gather": 1, "all-reduce": 2}),
    ({"tp_seq_collectives": True}, {"all-gather": 1, "reduce-scatter": 1}),
    ({"seq_parallel": False}, {"all-reduce": 2})])
def test_dryrun_reckons_the_tensor_parallel_activations(changes, kinds):
    """granite-34b's smoke prefill on (2, 4): every attention and MLP
    block and the embedding leave partial sums over tp (2 L + 1
    reductions of one dp shard's activation, a), and under seq_parallel
    every block and the lm_head gather their input's sequence first
    (2 L + 1 gathers of a); decode reduces only. The FSDP gathers (b) are
    taken out."""
    cfg = tconfigs.smoke_config("granite-34b")
    ctx = dataclasses.replace(make_ctx(cfg, Mesh(("data", "model"),
                                                 (2, 4))), **changes)
    n = 2 * cfg.n_layers + 1
    for kind, tokens in (("prefill_32k", 64), ("decode_32k", 1)):
        shape = dataclasses.replace(tconfigs.SHAPES[kind], global_batch=8,
                                    seq_len=64)
        a = 8 // 2 * tokens * cfg.d_model * 2          # bf16
        got = tdry.calibrated_costs(cfg, shape, ctx)["coll"]
        fsdp = tdry._fsdp_coll(cfg, shape, ctx)
        want = {k: n * m * a for k, m in kinds.items()} \
            if kind == "prefill_32k" else {"all-reduce": 2 * n * a}
        assert {k: v - fsdp[k] for k, v in got.items() if v != fsdp[k]} \
            == want, kind


def test_model_block_equals_the_reference():
    for arch in tconfigs.ARCH_IDS:
        cfg, ref_cfg = tconfigs.get_config(arch), rconfigs.get_config(arch)
        for name, shape in tconfigs.SHAPES.items():
            want = {"params_total": rflops.total_params(ref_cfg),
                    "params_active": rflops.active_params(ref_cfg),
                    "model_flops_global": rflops.model_flops(
                        ref_cfg, shape.kind, shape.seq_len,
                        shape.global_batch),
                    "n_chips": 256}
            assert tdry.model_block(cfg, shape, 256) == want, (arch, name)


def test_dryrun_skips_full_attention_at_500k():
    rec = tdry.run_cell("granite-34b", "long_500k", False)
    assert rec["status"] == "SKIP(full-attention)"


def test_hillclimb_measure_at_smoke_size(monkeypatch):
    small = {k: dataclasses.replace(v, global_batch=8, seq_len=64)
             for k, v in tconfigs.SHAPES.items()}
    monkeypatch.setattr(thill, "get_config", tconfigs.smoke_config)
    monkeypatch.setattr(thill, "SHAPES", small)
    monkeypatch.setattr(thill, "make_production_mesh",
                        lambda multi_pod=False: Mesh(("data", "model"),
                                                     (2, 4)))
    arch, shape, cfgc, ctxc = thill.EXPERIMENTS["kimi_f8_gather"]
    rec = thill.measure(arch, shape, cfgc, ctxc)
    assert (rec["dp"], rec["tp"], rec["n_chips"]) == (2, 4, 8)
    assert rec["dominant"] in ("compute_s", "collective_s", "memory_s_lower")
    assert rec["flops_per_dev_tf"] > 0 and rec["coll_gb"] > 0
    assert rec["peak_gb"] > 0 and rec["roofline_frac"] >= 0
    assert rec["cfg_changes"] == {"moe_gather_dtype": "float8_e4m3fn"}
    assert rec["not_reckoned"] == []
    # the sequence-parallel fields and the fp8 expert gather are
    # reckoned: each moves the collectives
    base = thill.measure(*thill.EXPERIMENTS["kimi_base"])
    assert rec["coll_gb"] < base["coll_gb"]
    for exp in ("kimi_no_seqpar", "kimi_megatron_sp"):
        assert thill.measure(*thill.EXPERIMENTS[exp])["coll_gb"] != \
            base["coll_gb"], exp
    # an H100 SXM5's datasheet figures, no TPU's
    assert (thill.PEAK, thill.HBM, thill.COLLECTIVE) == \
        (989.4e12, 3.35e12, 50e9)


def test_no_tpu_constant_in_the_port():
    src = pathlib.Path(tparams.__file__).resolve().parents[1]
    for path in src.rglob("*.py"):
        text = path.read_text()
        for word in ("197e12", "819e9", "256 chips", "512 chips"):
            assert word not in text, (path, word)


def test_production_mesh_flags():
    args = ttrain.parse_args(["--arch", "granite-34b", "--production-mesh",
                              "--multi-pod"])
    cfg = tconfigs.get_config("granite-34b")
    ctx = ttrain.cli_ctx(cfg, args)
    assert (ctx.dp_size, ctx.tp_size, ctx.dp_axes) == (32, 16,
                                                      ("pod", "data"))
    assert ctx == make_ctx(cfg, make_production_mesh(multi_pod=True),
                           multi_pod=True)
    single = ttrain.cli_ctx(cfg, ttrain.parse_args(
        ["--arch", "granite-34b", "--production-mesh"]))
    assert (single.dp_size, single.tp_size) == (16, 16)
    assert ttrain.cli_ctx(cfg, ttrain.parse_args(["--arch", "x"])) is None
