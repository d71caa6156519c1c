"""The port's checkpoints, train supervisor and training driver against
the reference (`repro.ckpt`, `repro.runtime.ft.TrainSupervisor`,
`repro.launch.train`): save, restore, gc and async round trips; the
manifest and the files equal to the reference's for the same tree; the
port restoring the reference's float32 and bf16 checkpoints bit for bit
(the reference's own restore fails on bf16) and the reference restoring
the port's float32 one; the supervisor restarting from its checkpoint
after an injected failure; `launch.train.train` with a checkpoint
directory and one injected failure ending where an uninterrupted run
ends; the training entry points default to the card.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.ckpt as rckpt
import repro_torch.ckpt as tckpt
import repro_torch.launch.train as ttrain
import repro_torch.optim as toptim
from repro_torch.configs import smoke_config
from repro_torch.models.lm import tree_leaves, tree_paths
from repro_torch.models.params import params_from_reference
from repro_torch.runtime.ft import TrainSupervisor
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _tree(seed=0):
    """A train-state-shaped tree: (params, optimizer state), float32 and
    bf16 leaves, a 0-d int32 counter."""
    rng = np.random.default_rng(seed)
    params = {"layers": {"w": rng.standard_normal((3, 4, 5)).astype(
                  np.float32),
                         "norm": rng.standard_normal((3, 5)).astype(
                             ml_dtypes.bfloat16)},
              "embed": {"w": rng.standard_normal((7, 5)).astype(
                  ml_dtypes.bfloat16)}}
    state = {"m": {"w": rng.standard_normal((4,)).astype(np.float32)},
             "count": np.asarray(3, np.int32)}
    return params, state


def _port(tree):
    return tuple(params_from_reference(t, device="cpu") for t in tree)


def _ref(tree):
    return jax.tree.map(jnp.asarray, tree)


def assert_bits_equal(got, want):
    """Two trees of tensors (or a tensor tree and a NumPy tree), leaf by
    path: same paths, dtypes, shapes and bits."""
    g, w = tree_paths(got), tree_paths(want)
    assert sorted(g) == sorted(w)
    for key, a in g.items():
        b = w[key]
        if not isinstance(b, torch.Tensor):
            b = params_from_reference(np.asarray(b), device="cpu")
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), key


def test_save_restore_roundtrip(tmp_path):
    tree = _port(_tree())
    d = str(tmp_path)
    tckpt.save(d, 10, tree, extra={"next_step": 10})
    tckpt.save(d, 20, tree, extra={"next_step": 20})
    assert tckpt.latest_step(d) == 20 and tckpt.latest_steps(d) == [10, 20]
    like = _port(_tree(seed=1))
    got, extra = tckpt.restore(d, 20, like, device="cpu")
    assert extra == {"next_step": 20}
    assert isinstance(got, tuple)
    assert_bits_equal(got, tree)


def test_restore_looks_leaves_up_by_key(tmp_path):
    tree = _port(_tree())
    tckpt.save(str(tmp_path), 1, tree)
    params, state = _port(_tree(seed=2))
    like = ({k: params[k] for k in reversed(list(params))},
            {"count": state["count"], "m": state["m"]})
    got, _ = tckpt.restore(str(tmp_path), 1, like, device="cpu")
    assert list(got[0]) == list(like[0]) and list(got[1]) == list(like[1])
    assert_bits_equal(got, tree)


def test_restore_writes_into_the_given_tensors(tmp_path):
    """A restore copies into `like`'s own tensors, so it allocates no
    second copy of the state; a leaf that is not a tensor (the reference's
    NumPy tree) gives a new tensor."""
    tree = _port(_tree())
    tckpt.save(str(tmp_path), 1, tree)
    like = _port(_tree(seed=4))
    ptrs = [t.data_ptr() for t in tree_leaves(like)]
    got, _ = tckpt.restore(str(tmp_path), 1, like, device="cpu")
    assert all(a is b for a, b in zip(tree_leaves(got), tree_leaves(like)))
    assert [t.data_ptr() for t in tree_leaves(got)] == ptrs
    assert_bits_equal(like, tree)
    got, _ = tckpt.restore(str(tmp_path), 1, _tree(seed=4), device="cpu")
    assert all(isinstance(t, torch.Tensor) for t in tree_leaves(got))
    assert_bits_equal(got, tree)


@pytest.mark.parametrize("like", [torch.zeros(3),
                                  torch.zeros(2, dtype=torch.bfloat16)],
                         ids=["shape", "dtype"])
def test_restore_refuses_a_leaf_it_cannot_write_into(tmp_path, like):
    tckpt.save(str(tmp_path), 1, {"x": torch.zeros(2)})
    with pytest.raises(ValueError, match="restore: leaf 'x'"):
        tckpt.restore(str(tmp_path), 1, {"x": like}, device="cpu")


def test_gc_keeps_the_latest(tmp_path):
    tree = _port(_tree())
    for s in (1, 2, 3, 4, 5):
        tckpt.save(str(tmp_path), s, tree, keep=2)
    assert tckpt.latest_steps(str(tmp_path)) == [4, 5]
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_5"]


def test_async_checkpointer_snapshots_before_an_update(tmp_path):
    ck = tckpt.AsyncCheckpointer(str(tmp_path))
    tree = _port(_tree())
    want = _port(_tree())
    ck.save(5, tree, extra={"next_step": 5})
    tree[0]["layers"]["w"].add_(1.0)          # an in-place step after it
    ck.wait()
    assert tckpt.latest_step(str(tmp_path)) == 5
    got, _ = tckpt.restore(str(tmp_path), 5, tree, device="cpu")
    assert_bits_equal(got, want)


def test_manifest_and_files_equal_the_reference(tmp_path):
    tree = _tree()
    rdir, tdir = tmp_path / "ref", tmp_path / "port"
    rckpt.save(str(rdir), 3, _ref(tree), extra={"next_step": 3})
    tckpt.save(str(tdir), 3, _port(tree), extra={"next_step": 3})
    names = sorted(os.listdir(rdir / "step_3"))
    assert sorted(os.listdir(tdir / "step_3")) == names
    assert "0__layers__norm.npy" in names and "1__count.npy" in names
    for name in names:
        assert (rdir / "step_3" / name).read_bytes() == \
            (tdir / "step_3" / name).read_bytes(), name
    # NumPy leaves (the reference's bf16 ones too) write the same files
    tckpt.save(str(tmp_path / "numpy"), 3, tree, extra={"next_step": 3})
    for name in names:
        assert (rdir / "step_3" / name).read_bytes() == \
            (tmp_path / "numpy" / "step_3" / name).read_bytes(), name
    manifest = json.loads((tdir / "step_3" / "manifest.json").read_text())
    assert manifest["leaves"]["0/embed/w"] == {"shape": [7, 5],
                                               "dtype": "bfloat16"}
    assert manifest["leaves"]["1/count"] == {"shape": [], "dtype": "int32"}


def test_port_restores_the_reference_checkpoint_bit_for_bit(tmp_path):
    tree = _tree()
    rckpt.save(str(tmp_path), 7, _ref(tree), extra={"next_step": 7})
    got, extra = tckpt.restore(str(tmp_path), 7, _port(_tree(seed=3)),
                               device="cpu")
    assert extra == {"next_step": 7}
    assert got[0]["embed"]["w"].dtype == torch.bfloat16
    assert_bits_equal(got, tree)
    # the reference cannot read its own bf16 leaves back (ROADMAP queue 3
    # item 24)
    with pytest.raises(TypeError):
        rckpt.restore(str(tmp_path), 7, _ref(tree))


def test_reference_restores_the_port_float32_checkpoint(tmp_path):
    params, state = _tree()
    tree = ({"w": params["layers"]["w"]}, state)
    tckpt.save(str(tmp_path), 2, _port(tree), extra={"next_step": 2})
    got, extra = rckpt.restore(str(tmp_path), 2, _ref(tree))
    assert extra == {"next_step": 2}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def test_supervisor_restarts_from_checkpoint(tmp_path):
    """The reference's test, on the port: every step executed exactly once
    after the restore."""
    sup = TrainSupervisor(str(tmp_path), save_every=2, max_restarts=2,
                          async_save=False, device="cpu")
    crashed = {"done": False}

    def step_fn(step, state):
        if step == 5 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected node failure")
        return {"x": state["x"] + 1}, {"loss": 0.0}

    final = sup.run({"x": torch.zeros(())}, 8, step_fn)
    assert sup.restarts == 1
    assert float(final["x"]) == 8


def test_supervisor_restores_into_the_state_it_was_given(tmp_path):
    """An in-place step, as the train step: the restart writes step 2's
    checkpoint back into the initial state's own tensor, so the device
    holds one copy of the state, and every step runs once after it."""
    sup = TrainSupervisor(str(tmp_path), save_every=2, async_save=False,
                          device="cpu")
    x = torch.zeros(3)
    ptr = x.data_ptr()
    crashed, same = [], []

    def step_fn(step, state):
        same.append(state["x"] is x)
        state["x"].add_(1)
        if step == 3 and not crashed:
            crashed.append(step)
            raise RuntimeError("injected node failure")
        return state, {}

    final = sup.run({"x": x}, 6, step_fn)
    assert sup.restarts == 1 and all(same) and len(same) == 8
    assert final["x"] is x and final["x"].data_ptr() == ptr
    assert torch.equal(x, torch.full((3,), 6.0))


def test_supervisor_raises_a_failure_before_the_first_checkpoint(tmp_path):
    """The port's step updates its state in place, so there is no initial
    state to restart from before a checkpoint (ROADMAP queue 3 item 26)."""
    sup = TrainSupervisor(str(tmp_path), save_every=4, device="cpu")

    def step_fn(step, state):
        if step == 1:
            raise RuntimeError("injected node failure")
        return state, {}

    with pytest.raises(RuntimeError, match="injected"):
        sup.run({"x": torch.zeros(())}, 8, step_fn)
    assert sup.restarts == 1


def test_train_resumes_to_the_uninterrupted_state(tmp_path):
    """train() with a checkpoint every 2 steps and one failure after step
    3 (raised from on_metrics, inside the supervised loop): the supervisor
    restores step 2's checkpoint and ends where an uninterrupted run
    ends, bit for bit (the CPU step is deterministic)."""
    cfg = smoke_config("granite-34b")
    kw = dict(steps=6, batch=1, seq=16, lr=1e-3, seed=0, device="cpu")
    (params, state), history = ttrain.train(cfg, ckpt_dir=None, **kw)
    seen = []

    def on_metrics(step, metrics, slow):
        seen.append(step)
        if step == 3 and seen.count(3) == 1:
            raise RuntimeError("injected node failure")

    (rparams, rstate), rhistory = ttrain.train(
        cfg, ckpt_dir=str(tmp_path), save_every=2, on_metrics=on_metrics,
        **kw)
    assert seen == [0, 1, 2, 3, 2, 3, 4, 5]
    assert rhistory[:4] + rhistory[6:] == history[:4] + history[4:]
    assert rhistory[4:6] == history[2:4]
    assert_bits_equal((rparams, rstate), (params, state))
    assert tckpt.latest_steps(str(tmp_path)) == [2, 4, 6]


def test_train_cli_runs_on_the_cpu(capsys):
    ttrain.main(["--arch", "mamba2-370m", "--smoke", "--steps", "2",
                 "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert "done: 2 steps" in capsys.readouterr().out


def test_training_entry_points_default_to_the_card(monkeypatch, tmp_path):
    cfg = smoke_config("mamba2-370m")
    tckpt.save(str(tmp_path), 1, {"x": torch.zeros(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
            lambda: ttrain.train(cfg, steps=1, batch=1, seq=8, ckpt_dir=None),
            lambda: ttrain.main(["--arch", "mamba2-370m", "--smoke"]),
            lambda: tckpt.restore(str(tmp_path), 1, {"x": torch.zeros(2)}),
            lambda: toptim.state_from_reference({"count": np.zeros((),
                                                                   np.int32)}),
            lambda: TrainSupervisor(str(tmp_path))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    got, _ = tckpt.restore(str(tmp_path), 1, {"x": torch.zeros(2)},
                           device="cpu")
    assert got["x"].is_cpu
