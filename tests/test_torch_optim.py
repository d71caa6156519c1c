"""The port's optimizers against the reference (`repro.optim`): AdamW and
Adafactor over several steps on random trees of float32 and bf16 leaves
(1-D, 2-D and 3-D: Adafactor's factored and unfactored branches), the
state carried by `state_from_reference` bit for bit, `global_norm` and
`clip_by_global_norm`, `cosine_schedule` at steps 0..120 around warmup and
total (the counter a tensor), `error_feedback_int8` and `topk_sparsify`
with their carried error; and the reference's own `tests/test_substrate.py`
behaviours mirrored (a quadratic minimised, the factored state's shapes,
error feedback's bounded residual). float32 at atol = rtol = 1e-5.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.optim as roptim
import repro.optim.compress as rcompress
import repro_torch.optim as toptim
import repro_torch.optim.compress as tcompress
from repro_torch.models.lm import tree_leaves, tree_map
from torch_parity import assert_tree_close
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

TOL = dict(rtol=1e-5, atol=1e-5)
#: bf16 leaves: the update runs in float32 and rounds once to bf16, so a
#: float32 difference at a rounding tie moves a leaf by one bf16 ulp
BF16_TOL = dict(rtol=2 ** -8, atol=1e-5)
SHAPES = {"w": (8, 16), "b": (16,), "experts": (3, 8, 12), "scale": (5,)}


def _tree(rng, bf16=("experts", "scale")):
    """{name: NumPy array}; the `bf16` leaves as ml_dtypes bfloat16."""
    out = {}
    for k, shape in SHAPES.items():
        a = rng.standard_normal(shape).astype(np.float32)
        out[k] = a.astype(ml_dtypes.bfloat16) if k in bf16 else a
    return {"layer": {k: out[k] for k in ("w", "experts")},
            "b": out["b"], "scale": out["scale"]}


def _port(tree):
    return toptim.state_from_reference(tree, device="cpu")


def _close(got, want, what=""):
    """Trees leaf by leaf: float32 at TOL, bf16 at one bf16 ulp."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _close(got[k], want[k], f"{what}/{k}")
        return
    w = np.asarray(want)
    tol = BF16_TOL if w.dtype == ml_dtypes.bfloat16 else TOL
    assert str(got.dtype).removeprefix("torch.") == w.dtype.name, what
    np.testing.assert_allclose(got.float().numpy(), w.astype(np.float32),
                               err_msg=what, **tol)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_updates_equal_the_reference_over_steps(name):
    rng = np.random.default_rng(0)
    ropt, topt = roptim.make_optimizer(name), toptim.make_optimizer(name)
    params = _tree(rng)
    rparams = jax.tree.map(jnp.asarray, params)
    rstate = ropt.init(rparams)
    tparams = _port(params)
    tstate = topt.init(tparams)
    _close(tstate, jax.tree.map(np.asarray, rstate), "init")
    update = jax.jit(ropt.update)
    sched = (roptim.cosine_schedule(1e-2, 1, 4),
             toptim.cosine_schedule(1e-2, 1, 4))
    for step in range(4):
        grads = _tree(rng)
        lr_ref = sched[0](rstate["count"])
        rparams, rstate = update(jax.tree.map(jnp.asarray, grads), rstate,
                                 rparams, lr_ref)
        before = tree_leaves(tparams) + tree_leaves(tstate)
        out = topt.update(_port(grads), tstate, tparams,
                          sched[1](tstate["count"]))
        # in place: the same tensors come back
        assert out[0] is tparams and out[1] is tstate
        assert all(a is b for a, b in zip(before, tree_leaves(tparams)
                                          + tree_leaves(tstate)))
        _close(tparams, jax.tree.map(np.asarray, rparams), f"params {step}")
        _close(tstate, jax.tree.map(np.asarray, rstate), f"state {step}")
    assert int(tstate["count"]) == 4 and tstate["count"].dtype == torch.int32


def test_state_from_reference_is_bit_exact():
    rng = np.random.default_rng(1)
    rstate = jax.tree.map(np.asarray, roptim.make_optimizer("adafactor").init(
        jax.tree.map(jnp.asarray, _tree(rng))))
    rstate["m"] = _tree(rng, bf16=tuple(SHAPES))
    got = _port(rstate)
    assert got["m"]["b"].dtype == torch.bfloat16
    assert got["count"].dtype == torch.int32 and got["count"].ndim == 0
    assert np.array_equal(got["m"]["layer"]["w"].view(torch.int16).numpy(),
                          rstate["m"]["layer"]["w"].view(np.int16))
    assert_tree_close(got["v"], rstate["v"], rtol=0, atol=0)


def test_global_norm_and_clip_equal_the_reference():
    rng = np.random.default_rng(2)
    grads = _tree(rng)
    for max_norm in (1.0, 1e3):
        want, wnorm = roptim.clip_by_global_norm(
            jax.tree.map(jnp.asarray, grads), max_norm)
        got, norm = toptim.clip_by_global_norm(_port(grads), max_norm)
        np.testing.assert_allclose(norm.numpy(), np.asarray(wnorm), **TOL)
        _close(got, jax.tree.map(np.asarray, want), f"clip {max_norm}")
    np.testing.assert_allclose(
        toptim.global_norm(_port(grads)).numpy(),
        np.asarray(roptim.global_norm(jax.tree.map(jnp.asarray, grads))),
        **TOL)


def test_clip_by_global_norm():
    """The reference's test, on the port."""
    g = {"w": torch.full((10,), 100.0)}
    clipped, norm = toptim.clip_by_global_norm(g, 1.0)
    assert float(norm) > 100
    assert abs(float(toptim.global_norm(clipped)) - 1.0) < 1e-5


@pytest.mark.parametrize("warmup,total,min_ratio", [(10, 100, 0.1),
                                                    (0, 50, 0.0),
                                                    (1, 120, 0.3)])
def test_cosine_schedule_equals_the_reference(warmup, total, min_ratio):
    ref = roptim.cosine_schedule(3e-4, warmup, total, min_ratio)
    port = toptim.cosine_schedule(3e-4, warmup, total, min_ratio)
    steps = np.arange(121, dtype=np.int32)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(steps)))
    got = torch.stack([port(torch.tensor(s, dtype=torch.int32))
                       for s in steps])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-12)
    assert float(port(torch.tensor(0, dtype=torch.int32))) == float(ref(0))


def test_cosine_schedule_shape():
    """The reference's test, on the port."""
    lr = toptim.cosine_schedule(1e-3, warmup=10, total=100)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1e-3) < 1e-9
    assert float(lr(100)) < float(lr(50)) < float(lr(10))


@pytest.mark.parametrize("kind", ["error_feedback_int8", "topk_sparsify"])
def test_compression_equals_the_reference(kind):
    rng = np.random.default_rng(3)
    grads0 = {"a": rng.standard_normal((64,)).astype(np.float32),
              "b": {"w": rng.standard_normal((16, 8)).astype(np.float32)}}
    rstate = rcompress.init_compressor(jax.tree.map(jnp.asarray, grads0))
    tstate = tcompress.init_compressor(_port(grads0))
    rfn, tfn = getattr(rcompress, kind), getattr(tcompress, kind)
    for step in range(3):
        grads = jax.tree.map(lambda g: g * (1 + 0.3 * step), grads0)
        want, rstate = rfn(jax.tree.map(jnp.asarray, grads), rstate)
        got, tstate = tfn(_port(grads), tstate)
        assert isinstance(tstate, tcompress.CompressorState)
        _close(got, jax.tree.map(np.asarray, want), f"{kind} {step}")
        _close(tstate.error, jax.tree.map(np.asarray, rstate.error),
               f"{kind} error {step}")
    if kind == "topk_sparsify":   # the k-th largest magnitude is kept
        assert int((got["a"] != 0).sum()) == max(1, int(64 * 0.01))


def test_error_feedback_compression_converges():
    """The reference's test, on the port: the residual stays bounded by one
    quantization step."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal((256,)).astype(np.float32))}
    state = toptim.init_compressor(g)
    acc_true, acc_comp = np.zeros(256), np.zeros(256)
    for i in range(20):
        gi = {"w": g["w"] * (1 + 0.01 * i)}
        comp, state = toptim.error_feedback_int8(gi, state)
        acc_true += gi["w"].numpy()
        acc_comp += comp["w"].numpy()
    resid = np.abs(acc_true - acc_comp).max()
    assert resid < float(g["w"].abs().max()) / 127 * 2


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_minimizes_quadratic(name):
    """The reference's test, on the port."""
    rng = np.random.default_rng(0)
    opt = toptim.make_optimizer(name, weight_decay=0.0)
    params = {"a": {"w": torch.from_numpy(
        rng.standard_normal((8, 16)).astype(np.float32))},
        "b": torch.from_numpy(rng.standard_normal((16,)).astype(np.float32))}
    state = opt.init(params)
    losses = []
    for _ in range(60):
        leaves = tree_leaves(params)
        loss = sum(torch.sum((x - 1) ** 2) for x in leaves)
        grads = tree_map(lambda x: 2 * (x - 1), params)
        params, state = opt.update(grads, state, params, 0.05)
        losses.append(float(loss))
    assert losses[-1] < 0.05 * losses[0]


def test_adafactor_state_is_factored():
    """The reference's test, on the port."""
    state = toptim.make_optimizer("adafactor").init(
        {"w": torch.zeros((32, 64))})
    assert state["v"]["w"]["r"].shape == (32,)
    assert state["v"]["w"]["c"].shape == (64,)
    assert sum(x.numel() for x in tree_leaves(state["v"])) == 32 + 64
    assert state["m"]["w"].dtype == torch.bfloat16


def test_exports_match_the_reference():
    assert sorted(set(toptim.__all__) - {"state_from_reference"}) == sorted(
        roptim.__all__)
    with pytest.raises(ValueError):
        toptim.make_optimizer("sgd")
    assert not hasattr(toptim.Optimizer, "state_pspecs")
