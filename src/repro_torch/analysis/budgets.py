"""Shared-memory and register budgets of the CUDA kernels on Hopper (the
port's counterpart of repro.analysis.vmem, whose 16 MiB TPU VMEM model
says nothing about this card).

A Hopper thread block may hold at most 227 KB (232,448 bytes) of shared
memory, of which at most 48 KB static; dynamic shared memory above 48 KB
needs the kernel's opt-in (`cudaFuncSetAttribute(...,
cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)`). A thread holds at
most 255 registers and an SM 65,536, so a block of T threads whose launch
bounds ask for M resident blocks gets at most 65,536 / (T * M) registers
a thread. (The CUDA programming guide's table for compute capability
9.0.)

Footprints model each kernel's residency from the constants of
`kernels/csrc/sort_kernels.cu`, read from the source itself:

K1  bitonic_sort_warp_kernel<B>   static tile kSortWarps * 32 * min(B, 32)
                                  ints (16 KB at B = 1,024), 128 threads,
                                  launch bounds (128, 8): 64 registers
K2  bitonic_merge_warp_kernel<S>  none (registers and shuffles), S <= 1,024
K2  bitonic_merge_smem_kernel<S>  dynamic S ints (64 KB at S = 16,384), S/32
                                  threads; the launcher opts in to S*4 bytes
K3  strided_ce(_vec4)_kernel      none
K4  probe_rank_count_kernel       static kProbeTile ints (16 KB), 256 threads
K4s probe_rank_search_kernel<T>   none; T int32 or int64
K5  merge_path_pairs_kernel<T>    static kPathThreads * kPathItems + 4 keys
                                  (15,376 B of int32: a tile, a read-past
                                  slot, the tile's two cuts, a pad to 16
                                  bytes; 30,752 B of int64), 256 threads,
                                  launch bounds (256, 4): 64 registers
K6  sample_count_kernel<T>,       static 3 * kSampleThreads + kSampleThreads
    sample_emit_kernel<T>         / 32 words (3,104 B: a range's two ends
                                  and a bitmap word a thread, a sum a
                                  warp), whatever the key type; 256
                                  threads, launch bounds (256, 4): 64
                                  registers
K7  dense_send_kernel<T>          none (registers only), kSendThreads
                                  threads, launch bounds (256): 255
                                  registers

`check_kernel_budgets()` raises `BudgetError` with the arithmetic on the
first configuration that does not fit. `check_ptxas(footprints, log)`
holds each static footprint to the "bytes smem" of ptxas's `-v` report
and each register count to the model's cap; chip_smoke.py does that on
the card, with the report of the build it runs, and reads K2's opt-in
back from the built library.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Dict, Tuple

__all__ = [
    "BudgetError",
    "KernelFootprint",
    "HOPPER",
    "kernel_constants",
    "sort_block_footprint",
    "merge_footprint",
    "probe_count_footprint",
    "merge_path_footprint",
    "sample_compact_footprints",
    "dense_send_footprint",
    "default_footprints",
    "check_kernel_budgets",
    "ptxas_report",
    "check_ptxas",
]

SOURCE = (Path(__file__).resolve().parents[1] / "kernels" / "csrc"
          / "sort_kernels.cu")

#: Hopper (sm_90) per-block and per-SM limits.
HOPPER = {
    "smem_per_block_optin": 232_448,   # 227 KB
    "smem_static_max": 49_152,         # 48 KB without the opt-in
    "regs_per_thread_max": 255,
    "regs_per_sm": 65_536,
    "threads_per_block_max": 1_024,
}
WORD = 4    # an int32 key; K4s-K7 also take int64 keys (8 bytes)
#: K4s's, K5's, K6's and K7's instantiations: ptxas's template argument ->
#: the config.
KEY_TYPES = {"i": "int32", "l": "int64"}


class BudgetError(AssertionError):
    """A kernel configuration exceeds the Hopper budget."""


def kernel_constants(source: Path = SOURCE) -> Dict[str, int]:
    """The integer `constexpr`s of the kernel source, by name."""
    text = Path(source).read_text()
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", text)}


@dataclasses.dataclass(frozen=True)
class KernelFootprint:
    kernel: str            # "K1", "K2", "K3", "K4", "K4s", "K5"-"K7"
    entry: str             # the __global__ function (ptxas's entry name)
    config: str            # the template argument, or "-"
    threads: int           # threads a block
    static_smem: int       # bytes of __shared__ arrays
    dynamic_smem: int      # bytes asked for at launch
    opt_in: int            # the launcher's MaxDynamicSharedMemorySize
    max_registers: int     # the launch bounds' cap a thread
    formula: str           # the arithmetic, for the failure message

    def check(self) -> "KernelFootprint":
        lim = HOPPER
        name = f"{self.kernel} {self.entry}[{self.config}]"
        if self.threads > lim["threads_per_block_max"]:
            raise BudgetError(f"{name}: {self.threads} threads a block, "
                              f"at most {lim['threads_per_block_max']}")
        if self.static_smem > lim["smem_static_max"]:
            raise BudgetError(
                f"{name} needs {self.static_smem} B of static shared memory "
                f"({self.formula}) but a block may hold "
                f"{lim['smem_static_max']} B statically")
        total = self.static_smem + self.dynamic_smem
        if total > lim["smem_per_block_optin"]:
            raise BudgetError(
                f"{name} needs {total} B of shared memory ({self.formula}) "
                f"but a block may hold {lim['smem_per_block_optin']} B")
        if (total > lim["smem_static_max"]
                and self.opt_in < self.dynamic_smem):
            raise BudgetError(
                f"{name} asks for {self.dynamic_smem} B of dynamic shared "
                f"memory ({self.formula}), above {lim['smem_static_max']} "
                f"B, with an opt-in of {self.opt_in} B")
        regs = self.max_registers
        if regs > lim["regs_per_thread_max"] \
                or regs * self.threads > lim["regs_per_sm"]:
            raise BudgetError(
                f"{name}: {regs} registers x {self.threads} threads over "
                f"the SM's {lim['regs_per_sm']} (or {regs} over "
                f"{lim['regs_per_thread_max']} a thread)")
        return self

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _reg_cap(threads: int, min_blocks: int = 1) -> int:
    return min(HOPPER["regs_per_thread_max"],
               HOPPER["regs_per_sm"] // (threads * min_blocks))


def sort_block_footprint(block: int, c=None) -> KernelFootprint:
    """K1 at `block` keys a sorted block: one warp's chunk of 32 *
    min(block, 32) keys for each of kSortWarps warps, static."""
    c = c or kernel_constants()
    warps = c["kSortWarps"]
    threads = 32 * warps
    keys = 32 * min(block, 32)
    return KernelFootprint(
        "K1", "bitonic_sort_warp_kernel", str(block), threads,
        warps * keys * WORD, 0, 0,
        _reg_cap(threads, 65_536 // (64 * threads)),
        f"{warps}*{keys}*{WORD}")


def merge_footprint(seg: int, c=None) -> KernelFootprint:
    """K2 at `seg` keys a segment: in registers up to 1,024 keys, one
    block of seg/32 threads with the segment in dynamic shared memory
    above (the launcher opts in to exactly its bytes)."""
    c = c or kernel_constants()
    if seg <= 1024:
        threads = c["kWarpKernelThreads"]
        return KernelFootprint("K2", "bitonic_merge_warp_kernel", str(seg),
                               threads, 0, 0, 0, _reg_cap(threads), "0")
    threads = seg // c["kMergeKeys"]
    nbytes = seg * WORD
    return KernelFootprint(
        "K2", "bitonic_merge_smem_kernel", str(seg), threads, 0, nbytes,
        nbytes, _reg_cap(threads, max(1, 1024 // threads)),
        f"{seg}*{WORD}")


def probe_count_footprint(tile: int | None = None, c=None) -> KernelFootprint:
    """K4: one tile of `tile` keys staged in static shared memory."""
    c = c or kernel_constants()
    tile = tile or c["kProbeTile"]
    threads = c["kProbeThreads"]
    return KernelFootprint("K4", "probe_rank_count_kernel", "-",
                           threads, tile * WORD, 0, 0, _reg_cap(threads),
                           f"kProbeTile={tile} * {WORD}")


def merge_path_footprint(c=None, config: str = "int32") -> KernelFootprint:
    """K5 at one key type: one tile of kPathThreads * kPathItems keys in
    static shared memory, with a slot a merge step may read past it, the
    tile's two cuts on the merge path and a slot of padding."""
    c = c or kernel_constants()
    threads = c["kPathThreads"]
    items = c["kPathItems"]
    key = 2 * WORD if config == "int64" else WORD
    return KernelFootprint("K5", "merge_path_pairs_kernel", config, threads,
                           (threads * items + 4) * key, 0, 0,
                           _reg_cap(threads, 4),
                           f"({threads}*{items}+4)*{key}")


def sample_compact_footprints(c=None, config: str = "int32"
                              ) -> Tuple[KernelFootprint, ...]:
    """K6's two launches at one key type: each block holds a range's two
    ends and a membership word a thread, and a partial sum a warp, as
    int32 words whatever the key type."""
    c = c or kernel_constants()
    threads = c["kSampleThreads"]
    words = 3 * threads + threads // 32
    return tuple(KernelFootprint("K6", entry, config, threads, words * WORD,
                                 0, 0, _reg_cap(threads, 4),
                                 f"(3*{threads}+{threads}/32)*{WORD}")
                 for entry in ("sample_count_kernel", "sample_emit_kernel"))


def dense_send_footprint(c=None, config: str = "int32") -> KernelFootprint:
    """K7 at one key type: a copy through registers, no shared memory."""
    c = c or kernel_constants()
    threads = c["kSendThreads"]
    return KernelFootprint("K7", "dense_send_kernel", config, threads, 0, 0,
                           0, _reg_cap(threads), "0")


def default_footprints(c=None) -> Tuple[KernelFootprint, ...]:
    """Every shipped configuration: K1 at each block size 2..1,024, K2 at
    each segment 2..kMaxSmemKeys, K3's two forms, K4, and K4s, K5, K6 and
    K7 at each key type."""
    c = c or kernel_constants()
    out = [sort_block_footprint(1 << j, c) for j in range(1, 11)]
    seg = 2
    while seg <= c["kMaxSmemKeys"]:
        out.append(merge_footprint(seg, c))
        seg *= 2
    for entry in ("strided_ce_kernel", "strided_ce_vec4_kernel"):
        out.append(KernelFootprint("K3", entry, "-", 256, 0, 0, 0,
                                   _reg_cap(256), "0"))
    out.append(probe_count_footprint(c=c))
    threads = c["kSearchThreads"]
    for config in KEY_TYPES.values():
        out.append(KernelFootprint("K4s", "probe_rank_search_kernel", config,
                                   threads, 0, 0, 0, _reg_cap(threads), "0"))
        out.append(merge_path_footprint(c, config))
        out.extend(sample_compact_footprints(c, config))
        out.append(dense_send_footprint(c, config))
    return tuple(out)


def check_kernel_budgets(footprints=None) -> Tuple[KernelFootprint, ...]:
    """Check every shipped configuration; raise BudgetError on the first
    that does not fit."""
    return tuple(fp.check() for fp in (footprints or default_footprints()))


_ENTRY = re.compile(r"(?:entry function|Function properties for) "
                    r"'?(_Z\w+)'?")
#: The source's __global__ functions, as ptxas names them.
ENTRIES = ("bitonic_sort_warp_kernel", "bitonic_merge_warp_kernel",
           "bitonic_merge_smem_kernel", "strided_ce_vec4_kernel",
           "strided_ce_kernel", "probe_rank_count_kernel",
           "probe_rank_search_kernel", "merge_path_pairs_kernel",
           "sample_count_kernel", "sample_emit_kernel", "dense_send_kernel",
           "empty_kernel")


def _entry(mangled: str):
    """(name, template argument or "-") of a mangled kernel name: the
    known name that follows its own length, as the Itanium ABI writes it
    (whatever prefix the compiler gave the anonymous namespace); a size
    argument as its digits, a key type as "int32" or "int64"."""
    for name in ENTRIES:
        tag = f"{len(name)}{name}"
        at = mangled.find(tag)
        if at >= 0:
            arg = re.match(r"I(?:Li(\d+)|([il]))E", mangled[at + len(tag):])
            if arg is None:
                return name, "-"
            return name, arg.group(1) or KEY_TYPES[arg.group(2)]
    return None


def ptxas_report(log: str) -> Dict[Tuple[str, str], dict]:
    """ptxas's `-v` report as {(entry, config): {"registers", "smem",
    "spill_bytes"}}: the entry is the kernel's name, the config its
    template argument (or "-"); spill_bytes the stores and loads ptxas
    reports as spilled."""
    out: Dict[Tuple[str, str], dict] = {}
    current = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            key = _entry(m.group(1))
            current = None if key is None else out.setdefault(
                key, {"registers": None, "smem": 0, "spill_bytes": 0})
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            current["spill_bytes"] = sum(map(int, spill.groups()))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            current["registers"] = int(used.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            current["smem"] = int(smem.group(1)) if smem else 0
    return out


def check_ptxas(footprints, log: str) -> list:
    """Hold each footprint to ptxas's report: the static shared memory
    equal, the registers within the model's cap. Returns one row a
    footprint; raises BudgetError on a mismatch or a missing entry."""
    report = ptxas_report(log)
    rows = []
    for fp in footprints:
        got = report.get((fp.entry, fp.config))
        if got is None or got["registers"] is None:
            raise BudgetError(f"ptxas reports no {fp.entry}[{fp.config}]")
        if got["smem"] != fp.static_smem:
            raise BudgetError(
                f"{fp.kernel} {fp.entry}[{fp.config}]: ptxas reports "
                f"{got['smem']} B of static shared memory, the model "
                f"{fp.static_smem} B ({fp.formula})")
        if got["registers"] > fp.max_registers:
            raise BudgetError(
                f"{fp.kernel} {fp.entry}[{fp.config}]: ptxas allots "
                f"{got['registers']} registers, the cap is "
                f"{fp.max_registers}")
        rows.append({"kernel": fp.kernel, "entry": fp.entry,
                     "config": fp.config, "smem": got["smem"],
                     "registers": got["registers"],
                     "spill_bytes": got["spill_bytes"],
                     "model_smem": fp.static_smem,
                     "max_registers": fp.max_registers})
    return rows
