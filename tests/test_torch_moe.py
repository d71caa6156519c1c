"""The MoE layer against the reference (`repro.models.moe`): `moe_ffn`'s
big-T (all_to_all dispatch) and small-T (local experts + psum) paths at
tp 1 and at an emulated tp 4, against the reference's shard_map on Auto
(1, 1) and (1, 4) meshes; outputs at atol = rtol = 1e-5, the routed
expert ids and the drop counts equal (also at capacity factor 0.5, where
tokens drop); exactly tied router logits route as jax.lax.top_k does;
the bf16 all_to_all wire at 1e-2; kimi-k2's shared expert through
`moe_block`; the port's collective log of one call.
"""

import jax
import numpy as np
import pytest
import torch

import repro.models.moe as rmoe
import repro_torch.models.moe as tmoe
from repro_torch.parallel.comm import recording
from torch_parity import model_both, model_ctx, to_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
PHI = "phi3.5-moe-42b-a6.6b"


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def layer0(params):
    return jax.tree.map(lambda a: a[0], params["layers"]["moe"])


def ref_moe(fn, x, p, ref_cfg, ref_ctx):
    """The reference's moe_ffn or moe_block, jitted (its shard_map runs
    op by op, slowly, outside jit)."""
    return jax.jit(lambda x, p: fn(x, p, ref_cfg, ref_ctx))(x, p)


def moe_both(arch, x, tp, **changes):
    """(port (y, aux), reference (y, aux)) of moe_ffn on x (B, S, d)."""
    cfg, ref_cfg, params, ref_params = model_both(arch, **changes)
    ctx, ref_ctx = model_ctx(tp)
    want = ref_moe(rmoe.moe_ffn, x, layer0(ref_params), ref_cfg, ref_ctx)
    got = tmoe.moe_ffn(t(x), layer0(params), cfg, ctx)
    return got, want


def tokens(cfg_d, b, s, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, cfg_d)) * 0.5).astype(np.float32)


def assert_moe_equal(got, want, tol=TOL):
    (y, aux), (ry, raux) = got, want
    np.testing.assert_allclose(to_numpy(y), np.asarray(ry), **tol)
    np.testing.assert_allclose(to_numpy(aux["router_mean_prob"]),
                               np.asarray(raux["router_mean_prob"]), **TOL)
    assert int(aux["dropped"]) == int(raux["dropped"])
    assert aux["dropped"].dtype == torch.int32


@pytest.mark.parametrize("tp", [1, 4])
@pytest.mark.parametrize("b,s", [(2, 16), (4, 8), (3, 1), (1, 1)])
def test_moe_ffn_big_and_small_paths(tp, b, s):
    x = tokens(64, b, s, seed=b * 10 + s)
    got, want = moe_both(PHI, x, tp)
    assert_moe_equal(got, want)


@pytest.mark.parametrize("tp", [1, 4])
@pytest.mark.parametrize("s", [16, 1])
def test_moe_ffn_drops_at_low_capacity(tp, s):
    x = tokens(64, 4, s, seed=7)
    got, want = moe_both(PHI, x, tp, moe_capacity_factor=0.5)
    assert_moe_equal(got, want)
    if s > 1:
        assert int(want[1]["dropped"]) > 0


def test_route_expert_ids_and_ties():
    cfg, ref_cfg, params, ref_params = model_both(PHI)
    rng = np.random.default_rng(3)
    flat = rng.standard_normal((32, cfg.d_model)).astype(np.float32)
    wr = np.asarray(layer0(ref_params)["router"]).copy()
    for w in (np.concatenate([wr[:, :1], np.repeat(wr[:, 1:2], 3, axis=1)],
                             axis=1), wr,
              np.repeat(wr[:, :1], cfg.n_experts, axis=1)):
        gates, eids, probs = tmoe._route(t(flat), t(w), cfg.top_k)
        rg, re, rp = rmoe._route(flat, w, cfg.top_k)
        np.testing.assert_array_equal(eids.numpy(), np.asarray(re))
        np.testing.assert_allclose(gates.numpy(), np.asarray(rg), **TOL)
        np.testing.assert_allclose(probs.numpy(), np.asarray(rp), **TOL)
    # all experts tied: every token picks experts 0 and 1, as top_k does
    np.testing.assert_array_equal(eids.numpy(), np.tile([0, 1], (32, 1)))


@pytest.mark.parametrize("tp", [1, 4])
@pytest.mark.parametrize("s", [16, 1])
def test_moe_ffn_with_tied_router_logits(tp, s):
    """Experts 1..3 share one router column: their logits tie exactly on
    every token, and the routed ids (so the outputs) follow the lower id."""
    cfg, ref_cfg, params, ref_params = model_both(PHI)
    ref_p = dict(layer0(ref_params))
    wr = np.asarray(ref_p["router"]).copy()
    wr[:, 2:] = wr[:, 1:2]
    ref_p["router"] = wr
    p = dict(layer0(params))
    p["router"] = t(wr)
    x = tokens(cfg.d_model, 2, s, seed=11)
    ctx, ref_ctx = model_ctx(tp)
    assert_moe_equal(tmoe.moe_ffn(t(x), p, cfg, ctx),
                     ref_moe(rmoe.moe_ffn, x, ref_p, ref_cfg, ref_ctx))


@pytest.mark.parametrize("tp", [1, 4])
def test_moe_a2a_dtype_bf16(tp):
    x = tokens(64, 2, 16, seed=12)
    got, want = moe_both(PHI, x, tp, moe_a2a_dtype="bfloat16")
    assert_moe_equal(got, want, tol=dict(rtol=1e-2, atol=1e-2))


@pytest.mark.parametrize("s", [16, 1])
def test_kimi_shared_expert_block(s):
    cfg, ref_cfg, params, ref_params = model_both("kimi-k2-1t-a32b")
    assert cfg.n_shared_experts == 1
    ctx, ref_ctx = model_ctx(1)
    x = tokens(cfg.d_model, 2, s, seed=13)
    y, aux = tmoe.moe_block(t(x), layer0(params), cfg, ctx)
    ry, raux = ref_moe(rmoe.moe_block, x, layer0(ref_params), ref_cfg,
                       ref_ctx)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    assert int(aux["dropped"]) == int(raux["dropped"])


def _reference_collectives(x, ref_params, ref_cfg, ref_ctx):
    jaxpr = jax.make_jaxpr(lambda x, p: rmoe.moe_ffn(x, p, ref_cfg, ref_ctx))(
        x, layer0(ref_params))
    names = []

    def walk(jp):
        for eqn in jp.eqns:
            names.append(eqn.primitive.name)
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)
    walk(jaxpr.jaxpr)
    return [n for n in names if n in ("all_to_all", "psum", "pmean")]


@pytest.mark.parametrize("tp", [1, 4])
def test_comm_log_of_one_call(tp):
    cfg, ref_cfg, params, ref_params = model_both(PHI)
    ctx, ref_ctx = model_ctx(tp)
    for s, want in ((16, ["all_to_all"] * 3 + ["pmean", "psum"]),
                    (1, ["psum", "pmean", "psum"])):
        x = tokens(cfg.d_model, 2, s, seed=14)
        with recording() as events:
            tmoe.moe_ffn(t(x), layer0(params), cfg, ctx)
        calls = [e.record for e in events if e.kind == "call"]
        assert [c.collective for c in calls] == want
        assert {c.axis for c in calls} == {"model"}
        # the reference's body: the same all_to_alls; its pmean is a psum
        ref = _reference_collectives(x, ref_params, ref_cfg, ref_ctx)
        assert ref == [n if n != "pmean" else "psum" for n in want]
        if s > 1:
            cap1 = calls[0].shape[1]
            assert calls[0].shape == (tp, cap1, cfg.d_model)   # rows out
            assert calls[1].shape == (tp, cap1, 1)             # ids out
            assert calls[1].dtype == "int32"
            assert calls[2].shape == (tp, cap1, cfg.d_model)   # outputs back
