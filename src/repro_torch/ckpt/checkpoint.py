"""Atomically committed checkpoints of tensor trees (counterpart of
repro.ckpt.checkpoint), in the reference's layout.

Layout: <dir>/step_<N>/ holding one .npy per tree leaf, under the
reference's path-encoded file name (dict keys and tuple indices joined by
"/", then "/" -> "__"), plus manifest.json ({"step", "leaves": {key:
{"shape", "dtype"}}, "extra"}). Writes go to step_<N>.tmp and are
committed by an atomic rename, so a crashed save never shadows the
previous good checkpoint, which the restart supervisor
(repro_torch.runtime.ft.TrainSupervisor) relies on; `keep` bounds the
committed steps.

bfloat16 leaves are written as the reference writes them: two-byte words
under the descr '<V2' (what np.save gives an ml_dtypes bfloat16 array),
with the manifest dtype "bfloat16", so no ml_dtypes is needed. `restore`
reads each leaf by its key, reinterprets it by the manifest's dtype and
copies it into the matching tensor of the tree it is given; the
reference's own restore cannot read its bf16 leaves back (ROADMAP queue 3
item 24). The reference's `shardings=` (elastic re-sharding onto
a mesh) has no counterpart on one device.

AsyncCheckpointer takes the device-to-host snapshot synchronously and
writes the files on a worker thread; `wait()` joins it before the next
save or at shutdown.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.models.lm import tree_map, tree_paths
from repro_torch.models.params import tensor_from_numpy
from repro_torch.sort.api import resolve_device

#: np.save's header for an ml_dtypes bfloat16 array.
_BF16_DESCR = "<V2"


def _rebuild(like, values, prefix=()):
    if isinstance(like, dict):
        return {k: _rebuild(v, values, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, values, prefix + (str(i),))
                          for i, v in enumerate(like))
    return values["/".join(prefix)]


def _fname(key: str) -> str:
    return key.replace("/", "__") + ".npy"


def _cpu(leaf, copy: bool = False) -> torch.Tensor:
    """The leaf (a tensor, or an array NumPy takes: the reference's bf16
    too) as a CPU tensor; `copy` always copies (a snapshot: the caller may
    update the leaf in place)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=copy)
    return tensor_from_numpy(leaf, "cpu")


def _write(path: str, t: torch.Tensor) -> str:
    """One leaf as .npy; returns its manifest dtype."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": _BF16_DESCR, "fortran_order": False,
                    "shape": tuple(t.shape)})
            f.write(t.view(torch.int16).numpy().tobytes())
        return "bfloat16"
    arr = t.numpy()
    np.save(path, arr)
    return str(arr.dtype)


def _read(path: str, dtype: str) -> torch.Tensor:
    """One leaf as a CPU tensor of its manifest dtype."""
    arr = np.load(path)
    if dtype == "bfloat16":
        # two-byte words (np.load gives them as void '|V2')
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def save(ckpt_dir: str, step: int, tree, *, extra: dict | None = None,
         keep: int = 3):
    """Synchronous checkpoint save with atomic commit."""
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for key, leaf in tree_paths(tree).items():
        t = _cpu(leaf)
        dtype = _write(os.path.join(tmp, _fname(key)), t)
        manifest["leaves"][key] = {"shape": list(t.shape), "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(latest_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def latest_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = latest_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like, *, device="cuda"):
    """Restore into `like`, leaves looked up by key. Returns (tree, the
    manifest's extra).

    A tensor leaf of `like` must lie on `device` with the saved shape and
    dtype: the saved values are copied into it, so a restore allocates
    nothing on the device (the train step updates its state in place, as
    the reference donates it, and the supervisor restores into that same
    state). Any other leaf (a NumPy array, say) gives a new tensor on
    `device`."""
    dev = resolve_device(device)
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    values = {}
    for key, leaf in tree_paths(like).items():
        saved = _read(os.path.join(d, _fname(key)),
                      manifest["leaves"][key]["dtype"])
        if not isinstance(leaf, torch.Tensor):
            values[key] = saved.to(dev)
            continue
        if leaf.device.type != dev.type or leaf.dtype != saved.dtype or \
                leaf.shape != saved.shape:
            raise ValueError(
                f"restore: leaf {key!r} is {leaf.dtype} {tuple(leaf.shape)} "
                f"on {leaf.device}; step {step} saved {saved.dtype} "
                f"{tuple(saved.shape)} to restore onto {dev}")
        with torch.no_grad():
            values[key] = leaf.copy_(saved)
    return _rebuild(like, values), manifest["extra"]


class AsyncCheckpointer:
    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None

    def save(self, step: int, tree, extra: dict | None = None):
        self.wait()
        # synchronous device-to-host snapshot; the file I/O on a thread
        snap = tree_map(lambda v: _cpu(v, copy=True), tree)
        self._thread = threading.Thread(
            target=save, args=(self.ckpt_dir, step, snap),
            kwargs={"extra": extra, "keep": self.keep}, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
