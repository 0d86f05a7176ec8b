"""The port's examples (halo2_tpu_torch/examples/) against the reference's
(examples/*.py) at the sizes of test_examples.py, on the CPU: equal
printed output, which carries each MockProver's verdict; for two_chip,
the one that proves (as in test_examples.py), the port's output with the
proof's size equals what the reference's main printed at that size; the
cost model's JSON of proof_size; the layout's dot graph."""

import importlib.util
import json
import os

import pytest
import torch

from halo2_tpu_torch.examples import (circuit_layout, proof_size,
                                      simple_example, two_chip, vector_mul)
from tests._torch_params_cache import own_params_cache  # noqa: F401

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def _reference(name):
    """The reference's example module, under a name of its own (its
    directory goes on sys.path for the examples' own imports)."""
    import sys
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# name -> (port module, keyword arguments of both mains)
CASES = {
    "simple_example": (simple_example, dict(k=6, prove=False)),
    "two_chip": (two_chip, dict(k=6, prove=False)),
    "vector_mul": (vector_mul, dict(k=6, n=8, prove=False)),
}
# What the reference's examples/two_chip.py prints from main(k=6,
# prove=True), the run of tests/test_examples.py (its IPA prove compiles
# for minutes in a fresh JAX cache, so it is not repeated here).
TWO_CHIP_PROVED = "MockProver: satisfied (d = 20)\nproof verified (1440 bytes)\n"


@pytest.mark.parametrize("name", CASES)
def test_example_output_equals_the_reference(name, capsys):
    port, kw = CASES[name]
    _reference(name).main(**kw)
    want = capsys.readouterr().out
    port.main(**kw, device="cpu")
    assert capsys.readouterr().out == want
    assert "MockProver: satisfied" in want


def test_two_chip_proof_equals_the_reference(capsys):
    two_chip.main(k=6, prove=True, device="cpu")
    assert capsys.readouterr().out == TWO_CHIP_PROVED


def test_proof_size_model_equals_the_reference(capsys):
    ref = _reference("proof_size")
    want = ref.from_circuit_to_model_circuit(11, ref.TestCircuit(), "kzg-gwc")
    proof_size.main(k=11)
    out = capsys.readouterr().out
    model = json.loads(out[out.index("{"):out.index("}\n") + 1])
    assert model == want
    for scheme in ("ipa", "kzg-gwc", "kzg-shplonk"):
        size = ref.CircuitCost.measure(11, ref.TestCircuit()).proof_size(
            scheme)
        assert f"{scheme}: ~{size} bytes, verification at least" in out


def test_circuit_layout_equals_the_reference(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    out = str(tmp_path / "layout.png")
    _reference("circuit_layout").main(k=5, out=out)
    want = capsys.readouterr().out
    os.remove(out)
    circuit_layout.main(k=5, out=out)
    assert capsys.readouterr().out == want
    assert os.path.getsize(out) > 0
