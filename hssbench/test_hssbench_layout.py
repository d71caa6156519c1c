"""The benchmark's files: every name in BENCHMARK.json is found, every
name and unit keeps to its characters, and nothing under hssbench/
imports jax, the JAX package or benchmarks/."""
import ast
import json
import re
from pathlib import Path

import pytest

from hssbench import harness, traffic

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["hssbench"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert BENCH["command"] == ["python3", "hssbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            yield key, entry["name"]
    for cell in BENCH["workloads"]:
        yield "config", cell["config"]
        yield "traffic", cell["traffic"]
    for cfg in BENCH["configs"]:
        for k in cfg["reduced"]:
            yield "reduced", k


@pytest.mark.parametrize("kind,name", list(_names()))
def test_name_characters(kind, name):
    assert NAME.match(name), (kind, name)


@pytest.mark.parametrize(
    "metric", BENCH["end_to_end"] + BENCH["per_layer"],
    ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200


def test_names_are_unique():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_every_cell_finds_its_files(cell):
    assert cell["chips"] == 1
    assert len(cell["why"]) <= 200 and "\n" not in cell["why"]
    config = harness.load_config(cell["config"])
    assert config["name"] == cell["config"]
    mix = traffic.load_mix(cell["traffic"])
    assert set(mix) == traffic.MIX_KEYS
    assert isinstance(config["keys"], int) and config["keys"] > 0
    e2e = {m["name"] for m in harness.end_to_end_for(BENCH, cell["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert e2e - {"setup_s"} <= set(harness.END_TO_END)
    layers = harness.per_layer_for(BENCH, cell["name"])
    assert layers
    for m in layers:
        assert m["moves"] in e2e
        assert callable(harness.load_reader(m["name"]))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_is_used_and_filed(cfg):
    assert any(c["config"] == cfg["name"] for c in BENCH["workloads"])
    path = harness.ROOT / cfg["file"]
    assert path.parent == harness.CONFIG_DIR and path.exists()
    assert json.loads(path.read_text())["source"] == cfg["source"]


def test_metric_workloads_exist():
    cells = {c["name"] for c in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", [])) <= cells, m["name"]
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def _modules():
    return sorted(p for p in harness.BENCH_DIR.rglob("*.py")
                  if "__pycache__" not in p.parts)


def _top_level_imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _modules(),
                         ids=lambda p: str(p.relative_to(harness.BENCH_DIR)))
def test_no_forbidden_import(path):
    tops = set(_top_level_imports(path))
    assert not tops & set(harness.FORBIDDEN_MODULES), (path, tops)


def test_forbidden_names_are_compared_whole(monkeypatch):
    import types
    # a process of its own: other test files load jax and repro here
    fake = types.SimpleNamespace(modules=dict.fromkeys(
        ("numpy", "repro_torch", "repro_torch.sort", "hssbench.harness")))
    monkeypatch.setattr(harness, "sys", fake)
    assert harness.forbidden_loaded() == []
    fake.modules["repro.sort"] = None
    fake.modules["jax.numpy"] = None
    assert harness.forbidden_loaded() == ["jax", "repro"]


def test_reference_imports_nothing_of_the_port():
    for name in ("reference.py", "distributions.py", "stats.py",
                 "roofline.py"):
        tops = set(_top_level_imports(harness.BENCH_DIR / name))
        assert tops <= {"__future__", "numpy", "torch", "json", "pathlib",
                        "statistics", "hssbench"}, (name, tops)
