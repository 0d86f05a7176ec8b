"""The port's middleware contract against the JAX reference's
(test_middleware.py's setting, SimpleCircuit at K=5 on IPA / Vesta): the
same JSON string for the same circuit, the port reading the reference's
JSON and keygen from it giving the verifying key of a direct keygen, and a
selector refused.  Exact equality."""

import pytest
import torch

from circuits import SimpleCircuit as RefSimple
from halo2_tpu.fields import PASTA_FP as REF_F
from halo2_tpu.frontend import Value as RefValue
from halo2_tpu.frontend.circuit import compile_circuit as ref_compile
from halo2_tpu.middleware import compiled_to_mid as ref_compiled_to_mid
from halo2_tpu_torch.commit import ParamsIPA
from halo2_tpu_torch.curves import VESTA
from halo2_tpu_torch.examples.simple_example import SimpleCircuit
from halo2_tpu_torch.fields import PASTA_FP as F
from halo2_tpu_torch.frontend import Value
from halo2_tpu_torch.frontend.circuit import compile_circuit
from halo2_tpu_torch.frontend.expression import Expression, Selector
from halo2_tpu_torch.middleware import (CompiledCircuitMid, compiled_to_mid,
                                        expr_from_obj, expr_to_obj)
from halo2_tpu_torch.plonk.keygen import keygen
from tests._torch_params_cache import own_params_cache  # noqa: F401

torch.set_num_threads(1)

K = 5


def _compiled():
    circuit = SimpleCircuit(7, Value.known(2), Value.known(3))
    return compile_circuit(F, K, circuit)[0]


def _ref_json() -> str:
    circuit = RefSimple(7, RefValue.known(2), RefValue.known(3))
    return ref_compiled_to_mid(ref_compile(REF_F, K, circuit)[0]).to_json()


def test_json_equals_the_reference():
    assert compiled_to_mid(_compiled()).to_json() == _ref_json()


def test_expression_obj_roundtrip():
    for gate in _compiled().cs.gates:
        for poly in gate.polys:
            back = expr_from_obj(expr_to_obj(poly))
            assert back.identifier() == poly.identifier()
            assert back.degree() == poly.degree()


def test_keygen_from_the_reference_json_equals_direct_keygen():
    mid = CompiledCircuitMid.from_json(_ref_json())
    assert mid.to_json() == _ref_json()
    params = ParamsIPA.new(VESTA, K, device="cpu")
    direct = keygen(F, params, _compiled(), K)
    shipped = keygen(F, params, mid.to_compiled_circuit(), K)
    assert shipped.vk.pinned() == direct.vk.pinned()
    assert shipped.vk.transcript_repr == direct.vk.transcript_repr
    for name in ("fixed_values", "fixed_cosets", "l_active_row"):
        assert torch.equal(getattr(shipped, name), getattr(direct, name))
    assert torch.equal(shipped.permutation.cosets, direct.permutation.cosets)


def test_selector_rejected():
    with pytest.raises(ValueError, match="selector"):
        expr_to_obj(Expression.selector(Selector(0)))
