"""The model stack's training path against the reference
(`repro.models.layers`' custom-VJP flash attention, `repro.models.lm`,
`repro.models.steps.make_train_step`, `repro.optim`): the flash
Function's dq, dk and dv against `jax.grad` through the reference's
chunked and context-parallel attentions; for all ten smoke configs in
float32, `backward()` through `forward`, one `make_train_step` from the
reference's parameters and optimizer state (loss, grad_norm, lr,
moe_dropped, the new parameters and moments), and four steps on one batch
lowering the loss; remat "block" against "none"; the MoE train step at
an emulated tp = 4. Inputs are NumPy draws from a seed; the reference
runs jitted on an Auto-axes mesh (`torch_parity.model_ctx`), each train
step compiled once (a module-scoped fixture). Tolerances are atol = rtol
= 1e-5 unless a comparison says otherwise and why.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as rlayers
import repro.models.steps as rsteps
import repro.optim as roptim
import repro_torch.models.layers as tlayers
import repro_torch.models.lm as tlm
import repro_torch.models.steps as tsteps
import repro_torch.optim as toptim
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.launch.serve import seeded_params
from repro_torch.parallel.ctx import local_ctx
from torch_parity import model_both, model_ctx, to_numpy, train_batch
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 32                  # S is twice the smoke configs' attn_chunk
#: warmup 0: the first step's learning rate is the base rate, not 0
SCHEDULE = (1e-3, 0, 10)


def t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _qkv(rng, hq, hkv, s=64, d=16):
    return [rng.standard_normal((2, s, h, d)).astype(np.float32)
            for h in (hq, hkv, hkv)]


def _grads_both(ref_fn, port_fn, q, k, v):
    """d/d(q, k, v) of sum(out^2) through the reference and the port."""
    want = jax.jit(jax.grad(lambda *a: (ref_fn(*a) ** 2).sum(),
                            argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = t(q, True), t(k, True), t(v, True)
    (port_fn(tq, tk, tv) ** 2).sum().backward()
    return (tq.grad, tk.grad, tv.grad), want


@pytest.mark.parametrize("causal,window,hq,hkv", [
    (True, 0, 6, 2), (False, 0, 6, 2), (True, 24, 4, 2), (True, 0, 4, 4),
    (False, 24, 8, 1)])
def test_flash_grads_equal_the_reference_custom_vjp(causal, window, hq, hkv):
    q, k, v = _qkv(np.random.default_rng(hq * 10 + hkv), hq, hkv)
    kw = dict(causal=causal, chunk=16, window=window)
    got, want = _grads_both(
        lambda *a: rlayers.attention_chunked(*a, **kw),
        lambda *a: tlayers.attention_chunked(*a, **kw), q, k, v)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("window", [0, 24])
def test_seqpar_grads_equal_the_reference_at_tp4(window):
    q, k, v = _qkv(np.random.default_rng(7), 4, 2)
    ctx, ref_ctx = model_ctx(4, shard_heads=False)
    kw = dict(causal=True, chunk=8, window=window)
    got, want = _grads_both(
        lambda *a: rlayers.attention_seqpar(*a, ctx=ref_ctx, **kw),
        lambda *a: tlayers.attention_seqpar(*a, ctx=ctx, **kw), q, k, v)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def _batch(cfg, seed=0):
    return train_batch(cfg, B, S, seed)


def _stepped(arch, tp=1, dp=1):
    """One reference train step (jitted) from init_params(key(0)) at the
    (dp, tp) layout, and everything the port needs to take the same
    step."""
    cfg, ref_cfg, params, ref_params = model_both(arch)
    ctx, ref_ctx = model_ctx(tp, dp=dp)
    batch = _batch(cfg)
    ropt = roptim.make_optimizer(ref_cfg.optimizer)
    rstate = ropt.init(ref_params)
    state = toptim.state_from_reference(jax.tree.map(np.asarray, rstate),
                                        device="cpu")
    step = jax.jit(rsteps.make_train_step(
        ref_cfg, ref_ctx, ropt, roptim.cosine_schedule(*SCHEDULE)))
    want = jax.tree.map(np.asarray, step(
        ref_params, rstate, {k: jnp.asarray(v) for k, v in batch.items()}))
    return dict(cfg=cfg, ctx=ctx, params=params, state=state, batch=batch,
                want=want)


@pytest.fixture(scope="module", params=ARCH_IDS)
def stepped(request):
    return _stepped(request.param)


def _port_step(s):
    opt = toptim.make_optimizer(s["cfg"].optimizer)
    step = tsteps.make_train_step(s["cfg"], s["ctx"], opt,
                                  toptim.cosine_schedule(*SCHEDULE))
    batch = {k: torch.from_numpy(v) for k, v in s["batch"].items()}
    return step(s["params"], s["state"], batch)


def assert_step_equal(got, want, cfg):
    """The port's (params, state, metrics) against the reference's."""
    params, state, metrics = got
    w_params, w_state, w_metrics = want
    assert sorted(metrics) == sorted(w_metrics)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(metrics[k].numpy(), w_metrics[k],
                                   err_msg=k, **TOL)
    if "moe_dropped" in w_metrics:
        assert metrics["moe_dropped"].dtype == torch.int32
        assert int(metrics["moe_dropped"]) == int(w_metrics["moe_dropped"])
    assert int(state["count"]) == int(w_state["count"]) == 1
    lr = float(w_metrics["lr"])
    w_m, w_p = tlm.tree_paths(w_state["m"]), tlm.tree_paths(w_params)
    for path, p in tlm.tree_paths(params).items():
        got_p = p.float().numpy()
        want_p = np.asarray(w_p[path], np.float32)
        if cfg.optimizer == "adamw":
            # AdamW's first step is m_hat / (sqrt(v_hat) + eps) = g / (|g| +
            # 1e-8): where |g| is near eps, float32 rounding of g moves the
            # step by up to 1 and the parameter by up to lr. Those entries
            # (|g| = 10 |m| <= 1e-6) are held to the step's bound, 2.5 lr;
            # the rest, and the moments everywhere, to 1e-5.
            live = np.abs(np.asarray(w_m[path], np.float32)) > 1e-7
            np.testing.assert_allclose(got_p[live], want_p[live],
                                       err_msg=path, **TOL)
            np.testing.assert_allclose(got_p[~live], want_p[~live],
                                       rtol=0, atol=2.5 * lr, err_msg=path)
        else:
            np.testing.assert_allclose(got_p, want_p, err_msg=path, **TOL)
    for part in ("m", "v"):
        w_x = tlm.tree_paths(w_state[part])
        for path, x in tlm.tree_paths(state[part]).items():
            want_x = np.asarray(w_x[path])
            got_x = x.float().numpy()
            # relative to the leaf's scale: v = 0.05 g^2 is far below 1e-5
            scale = float(np.abs(want_x.astype(np.float32)).max())
            atol, rtol = 1e-5 * max(scale, 1e-30), 1e-5
            if x.dtype == torch.bfloat16:
                # Adafactor's first moment, bf16. It normalises each entry
                # by its row's and column's scale, so an entry of a row
                # whose gradients are all tiny carries their float32
                # rounding (1e-3 relative and more) into m: held to one
                # bf16 ulp of the leaf's largest magnitude
                atol, rtol = 2 ** -8 * scale, 0
            assert str(x.dtype).removeprefix("torch.") == want_x.dtype.name
            np.testing.assert_allclose(got_x, want_x.astype(np.float32),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{part}/{path}")


def test_train_step_equals_the_reference(stepped):
    assert_step_equal(_port_step(stepped), stepped["want"], stepped["cfg"])


def test_backward_through_forward(stepped):
    """The smallest case of ROADMAP queue 3 item 25 (the in-place flash
    carry): logsumexp(forward).mean().backward() at S over attn_chunk;
    every parameter gets a finite gradient."""
    cfg, params = stepped["cfg"], tlm.tree_map(
        lambda p: p.clone().requires_grad_(True), stepped["params"])
    batch = {k: torch.from_numpy(v) for k, v in stepped["batch"].items()}
    logits, _, _ = tlm.forward(params, tsteps.batch_inputs(batch, cfg), cfg,
                               stepped["ctx"])
    torch.logsumexp(logits.float(), dim=-1).mean().backward()
    for path, p in tlm.tree_paths(params).items():
        assert p.grad is not None and torch.isfinite(p.grad).all(), path


def _port_model(arch):
    """The smoke config in float32 and the port's seeded weights."""
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    return cfg, seeded_params(cfg, 0, "cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_four_steps_on_one_batch_lower_the_loss(arch):
    """The reference's test_train_step_decreases_loss, on the port."""
    cfg, params = _port_model(arch)
    opt = toptim.make_optimizer(cfg.optimizer)
    state = opt.init(params)
    step = tsteps.make_train_step(cfg, local_ctx(), opt,
                                  toptim.cosine_schedule(1e-3, 2, 100))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1).items()}
    losses = []
    for _ in range(4):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert float(metrics["grad_norm"]) > 0
    assert int(state["count"]) == 4


@pytest.mark.parametrize("arch", ["granite-34b", "phi3.5-moe-42b-a6.6b",
                                  "zamba2-1.2b", "whisper-large-v3"])
def test_remat_block_gives_the_gradients_of_none(arch, monkeypatch):
    cfg, params = _port_model(arch)
    ctx = local_ctx()
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2).items()}
    real = tlm.checkpoint
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tlm, "checkpoint", counted)

    def grads(remat):
        c = dataclasses.replace(cfg, remat=remat)
        ps = tlm.tree_map(lambda p: p.clone().requires_grad_(True), params)
        logits, _, _ = tlm.forward(ps, tsteps.batch_inputs(batch, c), c, ctx)
        tlm.lm_loss(logits, batch["labels"], c).backward()
        return [p.grad for p in tlm.tree_leaves(ps)]

    with_remat = grads("block")
    n_block = len(calls)
    without = grads("none")
    layers = cfg.n_enc_layers + cfg.n_dec_layers if cfg.family == "encdec" \
        else cfg.n_layers
    assert n_block == layers and len(calls) == n_block
    for a, b in zip(with_remat, without):
        assert torch.equal(a, b)


def test_moe_train_step_at_tp4():
    """Phi-3.5-MoE's smoke config at an emulated tp = 4 (one expert a
    shard, the big-T all_to_all dispatch) against the reference on an Auto
    (1, 4) mesh."""
    s = _stepped("phi3.5-moe-42b-a6.6b", tp=4)
    assert_step_equal(_port_step(s), s["want"], s["cfg"])


def test_lm_loss_equals_the_reference():
    import repro.configs as rconfigs
    import repro.models.lm as rlm
    rng = np.random.default_rng(3)
    cfg = smoke_config("granite-34b")
    ref_cfg = rconfigs.smoke_config("granite-34b")
    logits = rng.standard_normal((2, 8, cfg.padded_vocab)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    labels[1, ::3] = -1
    got = tlm.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels), cfg)
    want = rlm.lm_loss(jnp.asarray(logits), jnp.asarray(labels), ref_cfg)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **TOL)
    none = np.full_like(labels, -1)
    assert float(tlm.lm_loss(torch.from_numpy(logits),
                             torch.from_numpy(none), cfg)) == 0.0
