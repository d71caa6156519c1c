"""The model stack's serving path against the reference (`repro.models.lm`,
`repro.models.steps`, `repro.launch.serve`): for all ten smoke configs in
float32, `forward`'s logits, and `make_prefill_step` plus three
`make_serve_step`s (logits and every cache tensor at atol = rtol = 1e-4,
greedy tokens equal; the third step decodes into the cache's last slot);
the hybrid ring buffer decoding past its window; a decode past the end
of the cache (both packages clamp the write to the last slot);
`serve_batch`'s tokens for the dense, moe and ssm families and
`serve_bucketed`'s buckets and padding, with the reference's bucketing
draws injected; the entry points' default device is the card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as rserve
import repro.models.lm as rlm
import repro.models.steps as rsteps
import repro_torch.data.partition as tpart
import repro_torch.launch.serve as tserve
import repro_torch.models.lm as tlm
import repro_torch.models.params as tparams
import repro_torch.models.ssm as tssm
import repro_torch.models.steps as tsteps
import repro_torch.sort as tsort
from repro.sort import SortSpec as RefSortSpec
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.parallel.ctx import local_ctx
from repro_torch.sort import SortSpec
from torch_parity import (assert_tree_close, auto_mesh, model_both,
                          model_ctx, reference_draws, to_numpy)

TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 32


def batch_both(cfg, s, seed=0):
    """(port batch, reference batch) of the family's inputs."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)}
    if cfg.family == "encdec":
        b["enc"] = rng.standard_normal((B, cfg.enc_ctx, cfg.d_model)).astype(
            np.float32)
    if cfg.embed_inputs:
        b["embeds"] = rng.standard_normal((B, s, cfg.d_model)).astype(
            np.float32)
    return {k: torch.from_numpy(v) for k, v in b.items()}, \
        {k: jnp.asarray(v) for k, v in b.items()}


def step_input(batch, cfg, t):
    """The decode step's input at position t: a token, or an embedding."""
    if cfg.embed_inputs:
        return batch["embeds"][:, t:t + 1]
    return batch["tokens"][:, t:t + 1]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_prefill_and_decode(arch):
    cfg, ref_cfg, params, ref_params = model_both(arch)
    ctx, ref_ctx = model_ctx(1)
    tb, rb = batch_both(cfg, S)
    want, _, _ = jax.jit(lambda p, b: rlm.forward(
        p, rsteps.batch_inputs(b, ref_cfg), ref_cfg, ref_ctx))(ref_params, rb)
    got, _, _ = tlm.forward(params, tsteps.batch_inputs(tb, cfg), cfg, ctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    s0, steps = S // 2, 3
    max_seq = s0 + steps              # the last step writes the last slot
    pre = {k: (v[:, :s0] if k in ("tokens", "embeds") else v)
           for k, v in tb.items()}
    rpre = {k: (v[:, :s0] if k in ("tokens", "embeds") else v)
            for k, v in rb.items()}
    want, rcache = jax.jit(rsteps.make_prefill_step(ref_cfg, ref_ctx,
                                                    max_seq))(ref_params, rpre)
    got, cache = tsteps.make_prefill_step(cfg, ctx, max_seq)(params, pre)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_tree_close(cache, rcache, what="prefill cache", **TOL)
    serve = tsteps.make_serve_step(cfg, ctx)
    rserve_step = jax.jit(rsteps.make_serve_step(ref_cfg, ref_ctx))
    for t in range(s0, s0 + steps):
        want, rcache = rserve_step(ref_params, rcache, step_input(rb, cfg, t),
                                   t)
        got, cache = serve(params, cache, step_input(tb, cfg, t), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert_tree_close(cache, rcache, what=f"cache at {t}", **TOL)
        np.testing.assert_array_equal(
            torch.argmax(got[:, :cfg.vocab], dim=-1).numpy(),
            np.asarray(jnp.argmax(want[:, :cfg.vocab], axis=-1)))


def test_hybrid_ring_cache_decodes_past_its_window():
    """zamba2's window-16 ring: decode across two wraps against the
    reference's steps, and near the teacher-forced forward."""
    cfg, ref_cfg, params, ref_params = model_both("zamba2-1.2b")
    assert cfg.attn_window == 16
    ctx, ref_ctx = model_ctx(1)
    s_all, s0 = 64, 32
    tb, rb = batch_both(cfg, s_all, seed=1)
    full, _, _ = tlm.forward(params, tb["tokens"], cfg, ctx)
    _, cache = tsteps.make_prefill_step(cfg, ctx, s_all)(
        params, {"tokens": tb["tokens"][:, :s0]})
    _, rcache = jax.jit(rsteps.make_prefill_step(ref_cfg, ref_ctx, s_all))(
        ref_params, {"tokens": rb["tokens"][:, :s0]})
    assert cache["shared_kv"][0].shape[2] == cfg.attn_window
    serve = tsteps.make_serve_step(cfg, ctx)
    rserve_step = jax.jit(rsteps.make_serve_step(ref_cfg, ref_ctx))
    for t in range(s0, s0 + 20):
        want, rcache = rserve_step(ref_params, rcache,
                                   rb["tokens"][:, t:t + 1], t)
        got, cache = serve(params, cache, tb["tokens"][:, t:t + 1], t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got.numpy(), full[:, t].numpy(),
                                   rtol=0.15, atol=0.15)
    assert_tree_close(cache, rcache, **TOL)


def test_decode_past_the_cache_end_clamps_like_the_reference():
    """pos = max_seq: dynamic_update_slice clamps the write into the last
    slot; the port's update_slice does the same."""
    cfg, ref_cfg, params, ref_params = model_both("granite-20b")
    ctx, ref_ctx = model_ctx(1)
    tb, rb = batch_both(cfg, S, seed=2)
    max_seq = 20
    _, cache = tsteps.make_prefill_step(cfg, ctx, max_seq)(
        params, {"tokens": tb["tokens"][:, :16]})
    _, rcache = jax.jit(rsteps.make_prefill_step(ref_cfg, ref_ctx, max_seq))(
        ref_params, {"tokens": rb["tokens"][:, :16]})
    serve = tsteps.make_serve_step(cfg, ctx)
    rserve_step = jax.jit(rsteps.make_serve_step(ref_cfg, ref_ctx))
    for t in (19, 20, 23):
        want, rcache = rserve_step(ref_params, rcache,
                                   rb["tokens"][:, t:t + 1], t)
        got, cache = serve(params, cache, tb["tokens"][:, t:t + 1], t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert_tree_close(cache, rcache, **TOL)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "phi3.5-moe-42b-a6.6b",
                                  "mamba2-370m"])
def test_serve_batch_tokens_equal_the_reference(arch):
    cfg, ref_cfg, params, ref_params = model_both(arch)
    _, ref_ctx = model_ctx(1)
    want, _ = rserve.serve_batch(ref_cfg, batch=3, prompt_len=16, gen=5,
                                 ctx=ref_ctx, seed=4, params=ref_params)
    got, stats = tserve.serve_batch(cfg, batch=3, prompt_len=16, gen=5,
                                    seed=4, params=params, device="cpu")
    assert got.dtype == np.int32 and got.shape == (3, 5)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert set(stats) == {"prefill_s", "decode_s", "tok_per_s"}


def test_serve_bucketed_buckets_equal_the_reference(monkeypatch):
    cfg, ref_cfg, _, _ = model_both("starcoder2-3b")
    _, ref_ctx = model_ctx(1)
    lens = np.random.default_rng(0).lognormal(3.5, 0.6, size=64).clip(
        8, 128).astype(np.int32)
    n_buckets, seed = 4, 0
    ref_spec = RefSortSpec(algorithm="hss", eps=0.05, exchange="allgather",
                           seed=seed, mesh=auto_mesh(n_buckets), stable=True)
    want, want_totals = rserve.serve_bucketed(
        ref_cfg, prompt_lens=lens, gen=3, n_buckets=n_buckets, ctx=ref_ctx,
        seed=seed, sort_spec=ref_spec)
    monkeypatch.setattr(tpart, "sort", functools.partial(
        tsort.sort, uniform=reference_draws(ref_spec, n_buckets, lens.size)))
    got, totals = tserve.serve_bucketed(
        cfg, prompt_lens=lens, gen=3, n_buckets=n_buckets, seed=seed,
        sort_spec=SortSpec(algorithm="hss", eps=0.05, exchange="allgather",
                           device="cpu"), device="cpu")
    assert len(got) == len(want) == totals["buckets"]
    assert totals["tokens"] == want_totals["tokens"] == lens.size * 3
    for (ids, stats), (rids, rstats) in zip(got, want):
        np.testing.assert_array_equal(ids, rids)
        assert stats["pad_frac"] == rstats["pad_frac"]
    flat = np.concatenate([ids for ids, _ in got])
    np.testing.assert_array_equal(np.sort(flat), np.arange(lens.size))
    assert np.all(np.diff(lens[flat]) >= 0)


def test_serve_bucketed_default_is_one_bucket_a_device():
    cfg = smoke_config("starcoder2-3b")
    lens = np.random.default_rng(1).integers(8, 64, size=24)
    got, totals = tserve.serve_bucketed(cfg, prompt_lens=lens, gen=2,
                                        device="cpu")
    assert totals["buckets"] == tserve.N_DEVICES == 1
    np.testing.assert_array_equal(np.sort(got[0][0]), np.arange(24))
    assert got[0][1]["pad_frac"] == 1.0 - lens.sum() / (24 * 64)


def test_entry_points_default_to_the_card(monkeypatch):
    cfg = smoke_config("mamba2-370m")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve_batch(cfg, batch=1, prompt_len=8, gen=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve_bucketed(cfg, prompt_lens=[8, 16], gen=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.seeded_params(cfg, 0, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "mamba2-370m", "--smoke"])
    ctx = local_ctx()
    for call in (lambda: tparams.init_params(cfg, torch.Generator()),
                 lambda: tlm.init_cache(cfg, 1, 8, ctx),
                 lambda: tssm.init_ssm_cache(cfg, 1, torch.float32),
                 lambda: tparams.tensor_from_numpy(np.zeros(3)),
                 lambda: tparams.params_from_reference({"w": np.zeros(3)})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tlm.init_cache(cfg, 1, 8, ctx, device="cpu")["state"].is_cpu
    assert to_numpy(tserve.serve_batch(cfg, batch=1, prompt_len=8, gen=2,
                                       device="cpu")[0]).shape == (1, 2)
