"""The port's examples (`examples/torch_*.py`) run on the CPU at their
smallest setting (`--device cpu`); each checks its own output (sorted
keys equal to np.sort, served requests, a falling loss) and raises on a
mismatch."""
import importlib.util
import pathlib

import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"

CASES = {
    "torch_quickstart": ["--n", "65536"],
    "torch_moe_routing": ["--tokens", "64"],
    "torch_sort_service": ["--requests", "8"],
    "torch_sort_load": ["--requests", "16", "--concurrency", "4"],
    "torch_train_lm": ["--steps", "8"],
}


def load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu(name, capsys):
    load(name).main(["--device", "cpu"] + CASES[name])
    out = capsys.readouterr().out
    assert out.strip(), name


def test_examples_default_to_the_card():
    """Without --device each example asks for the card, and raises on a
    machine without one (the CPU is only ever chosen by the caller)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load("torch_quickstart").main(["--n", "1024"])
