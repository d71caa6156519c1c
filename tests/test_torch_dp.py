"""Data parallelism above one replica against the reference: the port's
ParallelCtx(dp_size=2, tp_size=4) beside the reference's ParallelCtx over
an Auto (2, 4) ("data", "model") mesh of host devices, for Phi-3.5-MoE's
and kimi-k2's smoke configs in float32: `moe_ffn` on the big-T path (the
batch in dp groups, each capacity cut for t_global / (dp * tp) tokens,
the all_to_all within each group) and the decode path (each expert's
d_ff over the dp shards, drops divided by dp), `forward`, `lm_loss` with
its gradients and one train step, at atol = rtol = 1e-5 with the drops
equal; prefill and cached decode at dp 2 x tp 2 where the forward drops
assignments and where it drops none; then the port's `launch.train.train` at dp 8 against
`repro.launch.train.train` on the reference's (8, 1) host layout (its
`host_mesh_ctx` with Auto axes) from the reference's parameters: the loss
histories at 1e-5. The reference runs jitted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm as rlm
import repro.models.moe as rmoe
import repro.models.steps as rsteps
import repro_torch.launch.train as ttrain
import repro_torch.models.lm as tlm
import repro_torch.models.moe as tmoe
import repro_torch.models.steps as tsteps
from repro_torch.parallel.comm import recording
from repro_torch.parallel.ctx import ParallelCtx
from test_torch_train import _port_step, _stepped, assert_step_equal
from repro_torch.models.params import params_from_reference
from torch_parity import model_both, model_ctx, to_numpy, train_batch
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

TOL = dict(rtol=1e-5, atol=1e-5)
PHI, KIMI = "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"
DP, TP = 2, 4


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def layer0(params):
    return jax.tree.map(lambda a: a[0], params["layers"]["moe"])


@pytest.mark.parametrize("arch", [PHI, KIMI])
@pytest.mark.parametrize("b,s,cf", [(4, 16, 0.5), (48, 1, 0.25)])
def test_moe_ffn_at_dp2_tp4(arch, b, s, cf):
    """Big-T (s = 16) and decode (s = 1) paths, each at a capacity factor
    below 1 that drops assignments (the smoke configs' 4.0 drops none:
    forward, loss and the train step below run it)."""
    cfg, ref_cfg, params, ref_params = model_both(arch,
                                                  moe_capacity_factor=cf)
    ctx, ref_ctx = model_ctx(TP, dp=DP)
    x = (np.random.default_rng(b * 10 + s).standard_normal(
        (b, s, cfg.d_model)) * 0.5).astype(np.float32)
    ry, raux = jax.jit(lambda x, p: rmoe.moe_ffn(x, p, ref_cfg, ref_ctx))(
        x, layer0(ref_params))
    y, aux = tmoe.moe_ffn(t(x), layer0(params), cfg, ctx)
    np.testing.assert_allclose(to_numpy(y), np.asarray(ry), **TOL)
    np.testing.assert_allclose(to_numpy(aux["router_mean_prob"]),
                               np.asarray(raux["router_mean_prob"]), **TOL)
    assert int(aux["dropped"]) == int(raux["dropped"]) > 0


def test_grid_collectives_and_drops_at_dp1_and_dp2():
    """At a low capacity, at dp 1 and dp 2 (each capacity cut for half the
    tokens), the drops equal the reference's, and each collective of the
    grid is one call whose record is one shard's operand."""
    cfg, ref_cfg, params, ref_params = model_both(PHI,
                                                  moe_capacity_factor=0.5)
    x = (np.random.default_rng(3).standard_normal(
        (4, 16, cfg.d_model)) * 0.5).astype(np.float32)
    drops = {}
    for dp in (1, 2):
        ctx, ref_ctx = model_ctx(TP, dp=dp)
        _, raux = jax.jit(lambda x, p: rmoe.moe_ffn(x, p, ref_cfg, ref_ctx))(
            x, layer0(ref_params))
        with recording() as events:
            _, aux = tmoe.moe_ffn(t(x), layer0(params), cfg, ctx)
        drops[dp] = (int(aux["dropped"]), int(raux["dropped"]))
        calls = [e.record for e in events if e.kind == "call"]
        assert [c.collective for c in calls] == \
            ["all_to_all"] * 3 + ["pmean", "psum"]
        assert calls[0].shape[0] == TP                  # per-shard operand
        assert {c.axis for c in calls[3:]} == \
            {"model" if dp == 1 else "data,model"}
    assert drops[1][0] == drops[1][1] > 0 and drops[2][0] == drops[2][1] > 0


def test_big_path_needs_the_batch_to_split():
    cfg, _, params, _ = model_both(PHI)
    x = torch.zeros((3, 16, cfg.d_model))
    with pytest.raises(ValueError, match="dp=2"):
        tmoe.moe_ffn(x, {k: v[0] for k, v in params["layers"]["moe"].items()},
                     cfg, ParallelCtx(dp_size=2, tp_size=4))


@pytest.mark.parametrize("arch", [PHI, KIMI])
def test_forward_loss_and_gradients_at_dp2_tp4(arch):
    cfg, ref_cfg, params, ref_params = model_both(arch)
    ctx, ref_ctx = model_ctx(TP, dp=DP)
    batch = train_batch(cfg, 2, 32, seed=5)

    def ref_loss(p, b):
        logits, _, _ = rlm.forward(p, b["tokens"], ref_cfg, ref_ctx)
        return rlm.lm_loss(logits, b["labels"], ref_cfg), logits

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want_loss, want_logits), want_grads = jax.jit(
        jax.value_and_grad(ref_loss, has_aux=True))(ref_params, jb)
    ps = tlm.tree_map(lambda p: p.clone().requires_grad_(True), params)
    logits, _, _ = tlm.forward(ps, t(batch["tokens"]), cfg, ctx)
    loss = tlm.lm_loss(logits, t(batch["labels"]), cfg)
    loss.backward()
    np.testing.assert_allclose(to_numpy(logits.detach()),
                               np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **TOL)
    want = tlm.tree_paths(jax.tree.map(np.asarray, want_grads))
    for path, p in tlm.tree_paths(ps).items():
        np.testing.assert_allclose(p.grad.numpy(), want[path], err_msg=path,
                                   **TOL)


@pytest.mark.parametrize("arch", [PHI, KIMI])
def test_train_step_at_dp2_tp4(arch):
    s = _stepped(arch, tp=TP, dp=DP)
    assert_step_equal(_port_step(s), s["want"], s["cfg"])


@pytest.mark.parametrize("cf", [1.0, 16.0])
def test_decode_against_forward_at_dp2_tp2(cf, monkeypatch):
    """chip_smoke's dp 2 x tp 2 decode check (2 layers, float32, a
    64-token forward, a 32-token prefill, 3 cached decode steps) at smoke
    width: the port's prefill and decode logits hold the reference's at
    1e-5 at either capacity factor. At 1.0 the forward drops assignments
    (each grid shard's capacity is cut for its own t_local, 32 tokens in
    the forward, 16 in the prefill) and the reference's own decode differs
    from its forward by more than the check's 1e-3; at 16.0 nothing drops
    and the reference's decode is within 1e-3 of its forward."""
    cfg, ref_cfg, params, ref_params = model_both(PHI, n_layers=2,
                                                  moe_capacity_factor=cf)
    ctx, ref_ctx = model_ctx(2, dp=2)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32)
    drops = []
    real_ffn = tmoe.moe_ffn

    def moe_ffn(x, p, cfg, ctx):
        y, aux = real_ffn(x, p, cfg, ctx)
        drops.append(int(aux["dropped"]))
        return y, aux

    monkeypatch.setattr(tmoe, "moe_ffn", moe_ffn)
    full, _, _ = tlm.forward(params, t(toks), cfg, ctx)
    want_full, _, _ = jax.jit(lambda p, x: rlm.forward(
        p, x, ref_cfg, ref_ctx))(ref_params, toks)
    np.testing.assert_allclose(to_numpy(full), np.asarray(want_full), **TOL)
    forward_drops = sum(drops)

    got, cache = tsteps.make_prefill_step(cfg, ctx, 64)(
        params, {"tokens": t(toks[:, :32])})
    want, rcache = jax.jit(rsteps.make_prefill_step(ref_cfg, ref_ctx, 64))(
        ref_params, {"tokens": toks[:, :32]})
    got, want = [to_numpy(got)], [np.asarray(want)]
    serve = tsteps.make_serve_step(cfg, ctx)
    rserve = jax.jit(rsteps.make_serve_step(ref_cfg, ref_ctx))
    for pos in range(32, 35):
        logits, cache = serve(params, cache, t(toks[:, pos:pos + 1]), pos)
        rlogits, rcache = rserve(ref_params, rcache, toks[:, pos:pos + 1],
                                 pos)
        got.append(to_numpy(logits))
        want.append(np.asarray(rlogits))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    ref_diff = max(float(np.abs(w - np.asarray(want_full)[:, pos]).max())
                   for w, pos in zip(want, range(31, 35)))
    if cf == 1.0:
        assert forward_drops > 0 and ref_diff > 1e-3
    else:
        assert forward_drops == 0 and ref_diff < 1e-3


def test_launch_train_at_dp8_holds_the_reference(monkeypatch):
    """launch.train.train at dp 8 (tp 1) against the reference's trainer
    on its (8, 1) host layout, both from the reference's init_params:
    four steps' losses at 1e-5, the MoE drops of the dp groups equal."""
    import repro.launch.train as rtrain

    cfg, ref_cfg, _, _ = model_both(PHI, moe_capacity_factor=0.5)
    ctx, ref_ctx = model_ctx(1, dp=8)
    kw = dict(steps=4, batch=8, seq=16, ckpt_dir=None, lr=1e-3, seed=3)
    want_drops, got_drops = [], []
    _, want = rtrain.train(ref_cfg, ctx=ref_ctx, on_metrics=lambda s, m, _:
                           want_drops.append(int(m["moe_dropped"])), **kw)

    def reference_params(cfg, seed, device):
        from repro.models.params import init_params
        return params_from_reference(jax.tree.map(np.asarray, init_params(
            ref_cfg, jax.random.key(seed))), device)

    monkeypatch.setattr(ttrain, "seeded_params", reference_params)
    _, got = ttrain.train(cfg, ctx=ctx, device="cpu",
                          on_metrics=lambda s, m, _: got_drops.append(
                              int(m["moe_dropped"])), **kw)
    np.testing.assert_allclose(got, want, **TOL)
    assert got_drops == want_drops and max(want_drops) > 0


def test_ctx_grid_comm_and_specs():
    ctx = ParallelCtx(dp_size=2, tp_size=4)
    assert (ctx.dp_size, ctx.tp_size, ctx.mesh.shape) == \
        (2, 4, {"data": 2, "model": 4})
    comm = ctx.comm()
    x = torch.arange(8 * 4 * 3).reshape(8, 4, 3)
    y = comm.all_to_all(x)
    for g in range(2):
        for s in range(4):
            for d in range(4):
                assert torch.equal(y[g * 4 + d, s], x[g * 4 + s, d])
    assert torch.equal(comm.psum(x), x.sum(0))
    assert tuple(ctx.spec("fsdp", "tp", None)) == ("data", "model", None)
    pure = dataclasses.replace(ctx, dp_axes=("data", "model"), tp_axis=None)
    assert (pure.dp_size, pure.tp_size) == (8, 1)
    assert tuple(pure.spec("fsdp", "tp")) == (("data", "model"), None)
