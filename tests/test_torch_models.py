"""The model stack's building blocks against the reference (`repro.models`,
`repro.configs`): every config field of the ten architectures and their
smoke variants, the shapes and cells, the analytic FLOPs; the parameter
layout, `params_from_reference` (bf16 bit for bit) and the seeded
`init_params`; the layers (`rmsnorm`, `rope`, the full, chunked flash,
context-parallel and decode attentions, the cache's clamped writes) and
the SSD blocks (`causal_conv` with its cache, `ssd_chunked`,
`mamba_block` prefill and decode). Inputs are NumPy draws from a seed;
the reference runs on an Auto-axes mesh (`torch_parity.model_ctx`);
float32 comparisons hold at atol = rtol = 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.models.flops as rflops
import repro.models.layers as rlayers
import repro.models.params as rparams
import repro.models.ssm as rssm
import repro_torch.configs as tconfigs
import repro_torch.models.flops as tflops
import repro_torch.models.layers as tlayers
import repro_torch.models.params as tparams
import repro_torch.models.ssm as tssm
from repro.configs.paper_sort import SMOKE as REF_SMOKE
from repro_torch.configs.paper_sort import SMOKE
from repro_torch.parallel.ctx import ParallelCtx, local_ctx
from torch_parity import (assert_tree_close, model_both, model_ctx,
                          to_numpy)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = rconfigs.ARCH_IDS


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **tol)


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    assert tconfigs.ARCH_IDS == rconfigs.ARCH_IDS
    for get in ("get_config", "smoke_config"):
        cfg = getattr(tconfigs, get)(arch)
        ref = getattr(rconfigs, get)(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        for prop in ("padded_vocab", "d_inner", "ssm_heads", "q_dim",
                     "kv_dim"):
            assert getattr(cfg, prop) == getattr(ref, prop), prop
        for tp in (1, 2, 4, 16):
            assert cfg.heads_shardable(tp) == ref.heads_shardable(tp)
        assert cfg.param_count() == ref.param_count()


def test_shapes_cells_and_paper_workload():
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in rconfigs.SHAPES.items()}
    assert tconfigs.cells(ARCHS) == rconfigs.cells(ARCHS)
    for arch in ARCHS:
        assert tconfigs.long_ctx_eligible(tconfigs.get_config(arch)) == \
            rconfigs.long_ctx_eligible(rconfigs.get_config(arch))
    assert dataclasses.asdict(SMOKE) == dataclasses.asdict(REF_SMOKE)


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_equal_the_reference(arch):
    cfg, ref = tconfigs.get_config(arch), rconfigs.get_config(arch)
    assert tflops.active_params(cfg) == rflops.active_params(ref)
    assert tflops.total_params(cfg) == rflops.total_params(ref)
    for shape in rconfigs.SHAPES.values():
        assert tflops.model_flops(cfg, shape.kind, shape.seq_len,
                                  shape.global_batch) == \
            rflops.model_flops(ref, shape.kind, shape.seq_len,
                               shape.global_batch)
        assert tflops.attention_flops(cfg, shape.seq_len) == \
            rflops.attention_flops(ref, shape.seq_len)


# -------------------------------------------------------------- params
@pytest.mark.parametrize("arch", ARCHS)
def test_layout_and_abstract_params_equal_the_reference(arch):
    for get in ("get_config", "smoke_config"):
        cfg = getattr(tconfigs, get)(arch)
        ref = getattr(rconfigs, get)(arch)
        got, want = tparams.arch_layout(cfg), rparams.arch_layout(ref)
        assert list(got) == list(want)
        for path in want:
            assert dataclasses.asdict(got[path]) == \
                dataclasses.asdict(want[path]), path
        abstract = jax.tree.leaves_with_path(rparams.abstract_params(ref))
        mine = tparams.abstract_params(cfg)
        for kpath, leaf in abstract:
            node = mine
            for k in kpath:
                node = node[k.key]
            assert node.device.type == "meta"
            assert tuple(node.shape) == leaf.shape
            assert str(node.dtype).removeprefix("torch.") == leaf.dtype.name


@pytest.mark.parametrize("arch", ["mamba2-370m", "starcoder2-3b",
                                  "zamba2-1.2b"])
def test_params_from_reference_round_trips(arch):
    ref_cfg = rconfigs.smoke_config(arch)          # bf16 weights, f32 SSM
    ref = jax.tree.map(np.asarray, rparams.init_params(ref_cfg,
                                                       jax.random.key(3)))
    got = tparams.params_from_reference(ref, device="cpu")
    leaves = jax.tree.leaves_with_path(ref)
    dtypes = set()
    for kpath, want in leaves:
        node = got
        for k in kpath:
            node = node[k.key]
        dtypes.add(want.dtype.name)
        if want.dtype == ml_dtypes.bfloat16:
            assert node.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                node.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(node.numpy(), want)
    assert "bfloat16" in dtypes


def test_bf16_leaf_carries_bit_for_bit():
    want = (np.random.default_rng(0).standard_normal((5, 7)) * 1e3).astype(
        ml_dtypes.bfloat16)
    got = tparams.tensor_from_numpy(want, device="cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


@pytest.mark.parametrize("arch", ["mamba2-370m", "kimi-k2-1t-a32b"])
def test_init_params_is_seeded(arch):
    cfg = tconfigs.smoke_config(arch)
    one = tparams.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    two = tparams.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    other = tparams.init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    flat = [(a, b, c) for a, b, c in zip(*(
        jax.tree.leaves(x) for x in (one, two, other)))]
    assert len(flat) == len(tparams.arch_layout(cfg))
    assert all(torch.equal(a, b) for a, b, _ in flat)
    assert not all(torch.equal(a, c) for a, _, c in flat)
    layout = tparams.arch_layout(cfg)
    a_log = one["layers"]["mamba"]["A_log"] if arch.startswith("mamba") \
        else None
    if a_log is not None:
        assert a_log.dtype == torch.float32
        assert float(a_log.min()) >= 0.0 and float(a_log.max()) < np.log(16)
    w = one["lm_head"]["w"]
    assert w.dtype == getattr(torch, cfg.dtype)
    assert layout["lm_head/w"].shape == tuple(w.shape)


def test_ctx_is_the_reference_layout():
    ctx, ref = model_ctx(1)
    assert ctx.rules() == ref.rules() and local_ctx() == ctx
    assert (ctx.dp_size, ctx.tp_size) == (ref.dp_size, ref.tp_size)
    ctx4, ref4 = model_ctx(4, shard_heads=False)
    assert ctx4.rules() == ref4.rules() and ctx4.tp_size == 4
    ctx2, ref2 = model_ctx(4, dp=2)
    assert ctx2.rules() == ref2.rules()
    assert (ctx2.dp_size, ctx2.tp_size) == (ref2.dp_size, ref2.tp_size) == \
        (2, 4)
    assert ParallelCtx(dp_size=2) == ParallelCtx(dp_size=2, tp_size=1)


# -------------------------------------------------------------- layers
def _qkv(rng, b, s, hq, hkv, d, skv=None):
    skv = skv or s
    return (rng.standard_normal((b, s, hq, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32))


def test_rmsnorm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    close(tlayers.rmsnorm(t(x), t(w), 1e-5), rlayers.rmsnorm(x, w, 1e-5))
    pos = np.arange(12) + 5
    close(tlayers.rope(t(x), t(pos), 1e4), rlayers.rope(x, pos, 1e4))
    close(tlayers.rope(t(x), t(np.stack([pos, pos + 3])), 5e5),
          rlayers.rope(x, np.stack([pos, pos + 3]), 5e5))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 24])
def test_attention_full_and_chunked(causal, window):
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, 64, 4, 2, 16)
    want_full = rlayers.attention_full(q, k, v, causal=causal, window=window)
    close(tlayers.attention_full(t(q), t(k), t(v), causal=causal,
                                 window=window), want_full)
    want = rlayers.attention_chunked(q, k, v, causal=causal, chunk=16,
                                     window=window)
    close(tlayers.attention_chunked(t(q), t(k), t(v), causal=causal,
                                    chunk=16, window=window), want)
    # the dispatch takes the chunked path at s > chunk
    close(tlayers.attention(t(q), t(k), t(v), causal=causal, chunk=16,
                            window=window), want)
    # and cross-attention shapes (skv != s) the full one
    q2, k2, v2 = _qkv(rng, 2, 8, 4, 4, 16, skv=20)
    close(tlayers.attention(t(q2), t(k2), t(v2), causal=False, chunk=16),
          rlayers.attention(q2, k2, v2, causal=False, chunk=16))


@pytest.mark.parametrize("window", [0, 24])
def test_attention_seqpar_at_tp4(window):
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 2, 64, 4, 2, 16)
    ctx, ref_ctx = model_ctx(4, shard_heads=False)
    want = rlayers.attention(q, k, v, causal=True, chunk=8, ctx=ref_ctx,
                             window=window)
    got = tlayers.attention(t(q), t(k), t(v), causal=True, chunk=8, ctx=ctx,
                            window=window)
    close(got, want)
    close(tlayers.attention_seqpar(t(q), t(k), t(v), causal=True, chunk=8,
                                   ctx=ctx, window=window),
          rlayers.attention_seqpar(q, k, v, causal=True, chunk=8,
                                   ctx=ref_ctx, window=window))


@pytest.mark.parametrize("window", [0, 6])
def test_decode_attention(window):
    rng = np.random.default_rng(3)
    q, kc, vc = _qkv(rng, 2, 1, 4, 2, 16, skv=24)
    for p in (0, 9, 23):
        pos = np.array([p])
        close(tlayers.decode_attention(t(q), t(kc), t(vc), t(pos),
                                       window=window),
              rlayers.decode_attention(q, kc, vc, pos, window=window))
    for ring in (3, 30):
        close(tlayers.decode_attention(t(q), t(kc), t(vc), t(np.array([ring])),
                                       ring_pos=ring),
              rlayers.decode_attention(q, kc, vc, np.array([ring]),
                                       ring_pos=ring))


@pytest.mark.parametrize("start", [0, 5, 9, 10, 40])
def test_update_slice_clamps_like_dynamic_update_slice(start):
    rng = np.random.default_rng(4)
    full = rng.standard_normal((2, 10, 3)).astype(np.float32)
    upd = rng.standard_normal((2, 2, 3)).astype(np.float32)
    want = jax.lax.dynamic_update_slice_in_dim(full, upd, start, axis=1)
    got = tlayers.update_slice(t(full.copy()), t(upd), start, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch,tp", [("starcoder2-3b", 1),
                                     ("granite-20b", 4),
                                     ("whisper-large-v3", 4)])
def test_attn_block_and_mlp_block(arch, tp):
    cfg, ref_cfg, params, ref_params = model_both(arch)
    name = "dec_layers" if cfg.family == "encdec" else "layers"
    attn = "self_attn" if cfg.family == "encdec" else "attn"
    lp = jax.tree.map(lambda a: a[0], ref_params[name])
    tlp = jax.tree.map(lambda a: a[0], params[name])
    ctx, ref_ctx = model_ctx(tp, shard_heads=cfg.heads_shardable(tp)
                             and arch != "whisper-large-v3")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    pos = np.arange(32)
    want, want_kv = rlayers.attn_block(x, lp[attn], positions=pos,
                                       cfg=ref_cfg, ctx=ref_ctx)
    got, kv = tlayers.attn_block(t(x), tlp[attn], positions=t(pos), cfg=cfg,
                                 ctx=ctx)
    close(got, want)
    assert_tree_close(kv, want_kv, **TOL)
    close(tlayers.mlp_block(t(x), tlp["mlp"], cfg, ctx),
          rlayers.mlp_block(x, lp["mlp"], ref_cfg, ref_ctx))
    if cfg.family == "encdec":
        enc = rng.standard_normal((2, cfg.enc_ctx, cfg.d_model)).astype(
            np.float32)
        want, _ = rlayers.attn_block(x, lp["cross_attn"], positions=pos,
                                     cfg=ref_cfg, ctx=ref_ctx,
                                     kv_override=enc)
        got, _ = tlayers.attn_block(t(x), tlp["cross_attn"],
                                    positions=t(pos), cfg=cfg, ctx=ctx,
                                    kv_override=t(enc))
        close(got, want)


# ----------------------------------------------------------------- ssm
def test_causal_conv_with_cache():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    cache = rng.standard_normal((2, 3, 5)).astype(np.float32)
    for c in (None, cache):
        want, want_c = rssm.causal_conv(x, w, c)
        got, got_c = tssm.causal_conv(t(x), t(w), None if c is None
                                      else t(c))
        close(got, want)
        close(got_c, want_c)
    # one token at a time through the rolling cache
    want, _ = rssm.causal_conv(x, w)
    c = torch.zeros((2, 3, 5))
    for i in range(9):
        y, c = tssm.causal_conv(t(x[:, i:i + 1]), t(w), c)
        close(y, np.asarray(want)[:, i:i + 1])


@pytest.mark.parametrize("l,chunk,g", [(32, 8, 1), (48, 16, 2), (8, 8, 1)])
def test_ssd_chunked(l, chunk, g):
    rng = np.random.default_rng(7)
    b, h, p, n = 2, 4, 8, 16
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (b, l, h)).astype(np.float32)
    A_log = np.log(rng.uniform(1, 4, (h,))).astype(np.float32)
    B = rng.standard_normal((b, l, g, n)).astype(np.float32)
    C = rng.standard_normal((b, l, g, n)).astype(np.float32)
    D = rng.standard_normal((h,)).astype(np.float32)
    want_y, want_s = rssm.ssd_chunked(x, dt, A_log, B, C, D, chunk=chunk)
    got_y, got_s = tssm.ssd_chunked(t(x), t(dt), t(A_log), t(B), t(C), t(D),
                                    chunk=chunk)
    close(got_y, want_y)
    close(got_s, want_s)


def test_mamba_block_prefill_and_decode():
    cfg, ref_cfg, params, ref_params = model_both("mamba2-370m")
    lp = jax.tree.map(lambda a: a[0], ref_params["layers"]["mamba"])
    tlp = jax.tree.map(lambda a: a[0], params["layers"]["mamba"])
    ctx, ref_ctx = model_ctx(1)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    want, _ = rssm.mamba_block(x, lp, ref_cfg, ref_ctx)
    got, _ = tssm.mamba_block(t(x), tlp, cfg, ctx)
    close(got, want)
    # prefill with a cache, then three O(1) decode steps
    rc = rssm.init_ssm_cache(ref_cfg, 2, jnp.float32)
    tc = tssm.init_ssm_cache(cfg, 2, torch.float32, device="cpu")
    want, rc = rssm.mamba_block(x, lp, ref_cfg, ref_ctx, cache=rc)
    got, tc = tssm.mamba_block(t(x), tlp, cfg, ctx, cache=tc)
    close(got, want)
    assert_tree_close(tc, rc, **TOL)
    for i in range(3):
        xi = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, rc = rssm.mamba_block(xi, lp, ref_cfg, ref_ctx, cache=rc)
        got, tc = tssm.mamba_block(t(xi), tlp, cfg, ctx, cache=tc)
        close(got, want)
        assert_tree_close(tc, rc, **TOL)
