"""Build, load and launch the hand-written CUDA kernels.

The kernels live in `csrc/sort_kernels.cu` behind a plain C interface.
`library()` compiles that source with nvcc for sm_90a into a shared library
on first use and loads it with ctypes (no PyTorch headers, so the build
takes seconds). The library is cached under `build/cuda/` at the repository
root (git-ignored), keyed by a hash of the source, so an edited source
builds anew; ptxas's report of each kernel's registers, stack and spills
(`-Xptxas -v`) is kept beside it (`ptxas_log()`). Nothing here runs at
import: the CPU tests import every module and have no nvcc.

`launch(name, dtype, *args)` calls one C launcher on PyTorch's current
stream, raises when it returns a CUDA error, and adds one to its kernel's
count in `launches` — the count a run reads to show that its main path
went through the kernels. `KERNELS` records each kernel's key dtypes,
counters and launchers. For int64 keys `launch` picks the launcher's
`_i64` twin and counts under `<kernel>.i64` (`WIDE`), so a run shows which
key width its searches, merges, samples and sends ran at. K2 serves two
Pallas sites, so it is counted apart by role: `bitonic_merge_smem.reverse`
(a pair merge, merge_adjacent) and `bitonic_merge_smem.tail` (an HBM
pass's tail, merge_bitonic_blocks). Which hot spot runs which kernel is
`kernels.dispatch.ROUTES`. `empty_launch`, a kernel that does nothing, is
there to time the floor of a launch and counts under no kernel.
Wrappers validate device, dtype, shape and contiguity before they call it;
a build, load or launch failure raises `KernelError`, it never falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from collections import Counter
from pathlib import Path
from typing import NamedTuple

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "sort_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "cuda"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C signature of each launcher (the trailing c_void_p is the stream). A
#: kernel that takes int64 keys too has an `_i64` twin of each of its
#: launchers with the same arguments, which `library()` binds.
SIGNATURES = {
    "bitonic_sort_blocks": (_P, _P, _L, _I, _P),
    "bitonic_merge_smem": (_P, _P, _L, _I, _I, _P),
    "strided_compare_exchange": (_P, _P, _L, _L, _I, _P),
    "probe_rank_count": (_P, _P, _P, _L, _L, _I, _P),
    "probe_rank_search": (_P, _P, _P, _L, _L, _I, _P),
    "merge_path_pairs": (_P, _P, _P, _P, _L, _I, _L, _L, _I, _P),
    "sample_compact_count": (_P, _P, _P, _P, _P, _I, _I, _P, _P, _L, _L, _L,
                             _I, _P),
    "sample_compact_emit": (_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                            _L, _L, _L, _I, _I, _I, _P),
    "dense_send": (_P, _P, _P, _P, _I, _L, _L, _L, _P),
    "empty_launch": (_P,),
}

KEYS_32_64 = (torch.int32, torch.int64)


class Kernel(NamedTuple):
    """One kernel: the key dtypes it takes, the roles it counts apart
    (`<kernel>.<role>`), its launchers (none: the one of its name) and
    whether a sort path launches it."""
    dtypes: tuple = (torch.int32,)
    roles: tuple = ()
    launchers: tuple = ()
    main_path: bool = True


KERNELS = {
    "bitonic_sort_blocks": Kernel(),
    "bitonic_merge_smem": Kernel(roles=("reverse", "tail")),
    "strided_compare_exchange": Kernel(),
    "probe_rank_count": Kernel(main_path=False),
    "probe_rank_search": Kernel(KEYS_32_64),
    "merge_path_pairs": Kernel(KEYS_32_64),
    "sample_compact": Kernel(KEYS_32_64, launchers=("sample_compact_count",
                                                    "sample_compact_emit")),
    "dense_send": Kernel(KEYS_32_64),
}
_KERNEL_OF = {fn: name for name, k in KERNELS.items()
              for fn in k.launchers or (name,)}

#: Host functions that launch nothing (`merge_smem_attributes`).
_IP = ctypes.POINTER(ctypes.c_int)
QUERIES = {"merge_smem_attributes": (_I, _IP, _IP, _IP)}

#: The counters of the `_i64` twins' launches.
WIDE = tuple(f"{name}.i64" for name, k in KERNELS.items()
             if torch.int64 in k.dtypes)
#: Launch counters: one per kernel, K2's split by role, then `WIDE`.
COUNTERS = (*(f"{name}.{role}" if role else name
              for name, k in KERNELS.items() for role in k.roles or ("",)),
            *WIDE)
#: Counters of kernels that no sort path launches: the counting K4 serves
#: only `assume_sorted=False`, whose path is `histogram.ops.probe_counts`.
OFF_MAIN_PATH = tuple(name for name, k in KERNELS.items() if not k.main_path)

#: Launches per counter since the last `reset_launches()`.
launches: Counter = Counter()

_lock = threading.Lock()
_lib = None


class KernelError(RuntimeError):
    """A kernel that does not build, load or launch. Callers above the
    wrappers let it through: the serving layer neither retries it nor
    counts it against a bucket's breaker."""


def reset_launches():
    launches.clear()
    launches.update({name: 0 for name in COUNTERS})


reset_launches()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelError("nvcc not found (PATH or CUDA_HOME): the CUDA "
                      "kernels are built from source at first use")


def build(force: bool = False) -> Path:
    """Compile the kernel library if it is not built yet; returns its path.

    Writes to a temporary name and renames, so concurrent builds never
    load a half-written file."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libsort_kernels-{digest}.so"
    if out.exists() and not force:
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".ptxas.log").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def ptxas_log() -> str:
    """ptxas's report (`-Xptxas -v`) from the build of the loaded source."""
    return build().with_suffix(".ptxas.log").read_text()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelError(f"cannot load {path}: {e}") from e
            twins = {f"{fn}_i64": SIGNATURES[fn]
                     for fn, kernel in _KERNEL_OF.items()
                     if torch.int64 in KERNELS[kernel].dtypes}
            for name, argtypes in {**SIGNATURES, **twins,
                                   **QUERIES}.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, dtype: torch.dtype, *args, role: str | None = None):
    """Run launcher `name` over keys of `dtype` (its `_i64` twin for int64
    keys) on the current stream; raise on a CUDA error. The launch counts
    under `<kernel>[.<role>][.i64]`."""
    kernel = _KERNEL_OF[name]
    wide = dtype == torch.int64
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, f"{name}_i64" if wide else name)(*args, stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise KernelError(f"CUDA kernel {name} failed: error {err} ({msg})")
    counter = f"{kernel}.{role}" if role else kernel
    launches[f"{counter}.i64" if wide else counter] += 1


def merge_smem_attributes(seg: int) -> dict:
    """K2's shared-memory form at `seg` keys (2,048..16,384) as the
    runtime holds it: the dynamic shared memory its launcher opted in to
    (`maxDynamicSharedSizeBytes`), its static shared memory and its
    registers. The opt-in is set at the form's first launch."""
    lib = library()
    vals = [ctypes.c_int(0) for _ in range(3)]
    err = lib.merge_smem_attributes(seg, *(ctypes.byref(v) for v in vals))
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise KernelError(f"cudaFuncGetAttributes(K2 seg={seg}) failed: "
                          f"error {err} ({msg})")
    return dict(zip(("max_dynamic_smem", "static_smem", "registers"),
                    (v.value for v in vals)))


def check_keys(x: torch.Tensor, what: str, kernel: str | None = None):
    """The wrappers' key check: a tensor of a key dtype of `kernel`
    (default: `what`) on the CPU (plain version) or on a CUDA device (the
    kernel)."""
    dtypes = KERNELS[kernel or what].dtypes
    if x.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{what}: keys must be {names}, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def check_rows(x: torch.Tensor, what: str, kernel: str | None = None):
    """`check_keys`, and x is (rows, n), contiguous on a CUDA device."""
    check_keys(x, what, kernel)
    if x.dim() != 2:
        raise ValueError(f"{what}: expected (rows, n), got {tuple(x.shape)}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError(f"{what}: CUDA input must be contiguous")
