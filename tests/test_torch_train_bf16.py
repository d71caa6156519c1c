"""The training path in bfloat16 against the reference (`repro.models.steps.
make_train_step`, `repro.optim`), for a dense config (AdamW) and two MoE
configs (AdamW; Adafactor with its bf16 first moment), smoke widths with
the dtype set to bfloat16 on both sides.

bf16 does not give the reference's bits: XLA keeps float32 inside its
fused ops where torch rounds each op's output to bf16, so two correct
implementations part by bf16 roundings. Each comparison says what it is
held to instead:

- the clipped gradients of one step are held to the float32 gradients of
  the same bf16 weights, each leaf no further off than twice the
  reference's own bf16 gradients are (leaf by leaf, relative to the
  leaf's largest float32 magnitude), or one bf16 ulp of that magnitude;
- four train steps under launch/train.train's schedule for 4 steps at lr
  3e-4 (as chip_smoke.py's phase 27 trains Phi-3.5-MoE): loss and
  grad_norm within one bf16 ulp (rtol 2^-7) of the reference's each step,
  lr at 1e-6 and moe_dropped exact, both losses lower after the 4 steps
  than before them; the parameters within one bf16 ulp of their value
  plus 2 lr summed over the steps (Adam's normalised step is of order 1,
  so where a gradient near zero takes the other sign the two runs part
  by up to 2 lr a step).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.steps as rsteps
import repro.optim as roptim
import repro_torch.models.lm as tlm
import repro_torch.models.steps as tsteps
import repro_torch.optim as toptim
from torch_parity import model_both, model_ctx, train_batch
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

ARCHS = ["granite-34b", "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"]
B, S, STEPS = 2, 32, 4        # S is twice the smoke configs' attn_chunk
#: launch/train.train's schedule for 4 steps at lr 3e-4
SCHEDULE = (3e-4, 1, STEPS)
BF16_ULP = 2 ** -7


def _numpy(tree):
    return tlm.tree_paths(jax.tree.map(np.asarray, tree))


def _float32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if a.dtype == jnp.bfloat16 else a, tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_gradients_are_as_close_to_float32_as_the_reference(arch):
    cfg, ref_cfg, params, ref_params = model_both(arch, dtype="bfloat16")
    ctx, ref_ctx = model_ctx(1)
    batch = train_batch(cfg, B, S)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # an optimizer whose update returns the clipped gradients
    ref_grab = roptim.Optimizer(init=None, state_pspecs=None,
                                update=lambda g, s, p, lr: (g, s))
    zero = lambda count: count * 0.0
    state = {"count": jnp.zeros((), jnp.int32)}

    def ref_grads(c, p, b):
        step = jax.jit(rsteps.make_train_step(c, ref_ctx, ref_grab, zero))
        return _numpy(step(p, state, b)[0])

    want = ref_grads(dataclasses.replace(ref_cfg, dtype="float32"),
                     _float32(ref_params), _float32(jbatch))
    ref = ref_grads(ref_cfg, ref_params, jbatch)
    grab = types.SimpleNamespace(update=lambda g, s, p, lr: (g, s))
    step = tsteps.make_train_step(cfg, ctx, grab, lambda c: c * 0.0)
    got = tlm.tree_paths(step(params, {"count": torch.zeros(
        (), dtype=torch.int32)}, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})[0])
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].dtype == torch.bfloat16, path
        scale = float(np.abs(w).max())
        port_err = float(np.abs(got[path].float().numpy() - w).max())
        ref_err = float(np.abs(ref[path].astype(np.float32) - w).max())
        assert port_err <= max(2 * ref_err, BF16_ULP * scale), (
            path, port_err / scale, ref_err / scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_steps_track_the_reference(arch):
    cfg, ref_cfg, params, ref_params = model_both(arch, dtype="bfloat16")
    ctx, ref_ctx = model_ctx(1)
    batch = train_batch(cfg, B, S)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    ropt = roptim.make_optimizer(ref_cfg.optimizer)
    rstate = ropt.init(ref_params)
    state = toptim.state_from_reference(jax.tree.map(np.asarray, rstate),
                                        device="cpu")
    ref_step = jax.jit(rsteps.make_train_step(
        ref_cfg, ref_ctx, ropt, roptim.cosine_schedule(*SCHEDULE)))
    step = tsteps.make_train_step(cfg, ctx,
                                  toptim.make_optimizer(cfg.optimizer),
                                  toptim.cosine_schedule(*SCHEDULE))
    lr_sum, losses = 0.0, []
    for i in range(STEPS):
        ref_params, rstate, want = ref_step(ref_params, rstate, jbatch)
        params, state, got = step(params, state, tbatch)
        assert sorted(got) == sorted(want)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=BF16_ULP, err_msg=f"{k} {i}")
        np.testing.assert_allclose(float(got["lr"]), float(want["lr"]),
                                   rtol=1e-6, err_msg=f"lr {i}")
        if "moe_dropped" in want:
            assert int(got["moe_dropped"]) == int(want["moe_dropped"]), i
        lr_sum += float(want["lr"])
        losses.append((float(got["loss"]), float(want["loss"])))
    # at smoke width both fall under this schedule (phase 27's Phi at full
    # width rises: PERF.md)
    assert losses[-1][0] < losses[0][0] and losses[-1][1] < losses[0][1]
    assert int(state["count"]) == STEPS
    want_p = _numpy(ref_params)
    for path, p in tlm.tree_paths(params).items():
        assert p.dtype == torch.bfloat16, path
        w = want_p[path].astype(np.float32)
        np.testing.assert_array_less(
            np.abs(p.float().numpy() - w),
            BF16_ULP * np.abs(w) + 2 * lr_sum + 1e-12, err_msg=path)


def test_bf16_embedding_gradient_of_repeated_tokens_equals_the_reference():
    """A token that fills 41 % of the batch (as the synthetic stream's
    Zipf marginal makes id 1): the embedding's gradient is a scatter-add
    into the bf16 table on both sides, which stops growing once the row
    is 2^8 times a contribution. The port gives the reference's bits,
    saturation included; float32 keeps the sum."""
    rng = np.random.default_rng(0)
    n, vocab, d = 8192, 64, 8
    tokens = np.where(rng.random(n) < 0.41, 1,
                      rng.integers(0, vocab, n)).astype(np.int32)
    g = (rng.standard_normal((n, d)) * 1e-3 + 1e-3).astype(np.float32)
    w = rng.standard_normal((vocab, d)).astype(np.float32)

    def ref(dtype):
        loss = lambda w: jnp.sum(
            jnp.take(w, tokens, axis=0).astype(jnp.float32) * g)
        return np.asarray(jax.grad(loss)(jnp.asarray(w, dtype)), np.float32)

    def port(dtype):
        t = torch.tensor(w, dtype=dtype, requires_grad=True)
        h = tlm.embed({"embed": {"w": t}}, torch.from_numpy(tokens),
                      types.SimpleNamespace(dtype="float32"), None)
        (h * torch.from_numpy(g)).sum().backward()
        return t.grad.float().numpy()

    np.testing.assert_array_equal(port(torch.bfloat16), ref(jnp.bfloat16))
    np.testing.assert_allclose(port(torch.float32), ref(jnp.float32),
                               rtol=1e-5, atol=1e-5)
    exact = np.zeros((vocab, d))
    np.add.at(exact, tokens, g.astype(np.float64))
    assert np.abs(port(torch.bfloat16)[1] - exact[1]).min() > 1.0
