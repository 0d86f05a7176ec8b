"""The port's public surface against the JAX reference's.

An AST walk of both packages (neither is imported for it) asserts that
every public top-level name, every public method of a public class and
every name a package's __init__ exports, in each module of halo2_tpu, has
a counterpart at the same relative path of halo2_tpu_torch (defined there,
imported into it, or inherited), except the names of NOT_TO_PORT, each
with its reason.  Then one exact-equality case against the reference for
each name the port took over with the sorted MSM's slice: eval_polynomial,
NTT (forward, inverse) and bit_reverse_indices, Field.select / mul_pow2 /
rand_ints, Curve.generator, Blind.random, MSMKZG.combine_with_base,
PreMSM.add_msm / to_msm, Poly.map and ConstraintSystemBack.usable_rows
(keygen_vk is in test_torch_e2e.py, beside the reference's keys)."""

import ast
import os
import random
import types

import numpy as np
import pytest
import torch

from halo2_tpu.commit import Blind as RefBlind
from halo2_tpu.commit.kzg import MSMKZG as RefMSMKZG, PreMSM as RefPreMSM
from halo2_tpu.compat.plonk_api import plonk_api_instance as ref_plonk_api
from halo2_tpu.curves import BN254_G1 as REF_G1, VESTA as REF_VESTA
from halo2_tpu.fields import BN254_FR as REF_FR
from halo2_tpu.frontend import compile_circuit as ref_compile
from halo2_tpu.ntt import NTT as RefNTT
from halo2_tpu.ntt import bit_reverse_indices as ref_bit_reverse
from halo2_tpu.plonk.keygen import ConstraintSystemBack as RefCsBack
from halo2_tpu.poly import eval_polynomial as ref_eval_polynomial
from halo2_tpu.poly.poly import Poly as RefPoly
from halo2_tpu_torch.commit import Blind
from halo2_tpu_torch.commit.kzg import MSMKZG, PreMSM
from halo2_tpu_torch.compat.from_jax import limbs_from_jax
from halo2_tpu_torch.compat.plonk_api import plonk_api_instance
from halo2_tpu_torch.curves import BN254_G1, VESTA
from halo2_tpu_torch.fields import BN254_FR as F
from halo2_tpu_torch.frontend import compile_circuit
from halo2_tpu_torch.ntt import NTT, bit_reverse_indices
from halo2_tpu_torch.plonk import ConstraintSystemBack
from halo2_tpu_torch.poly import eval_polynomial
from halo2_tpu_torch.poly.poly import Poly

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PKG = os.path.join(ROOT, "halo2_tpu")
PORT_PKG = os.path.join(ROOT, "halo2_tpu_torch")

_TPU_LAYOUT = ("the TPU's lane and tile layout (128-lane rows, VMEM "
               "tiles); the port's rows are 18 words and its kernels pick "
               "their own blocks")
_LIMBS = ("16-bit limbs, because the TPU has no 64-bit multiply; the "
          "port's words are 8 x 32 bits (fields/cuda_ops.py NWORDS)")

# Reference names with no counterpart in the port: "path" for a whole
# module, "path::name" for one name, each with its reason.
NOT_TO_PORT = {
    "aot.py": "the JAX trace-export cache; the port's counterpart is "
              "_build.py's nvcc build cache",
    "curves/pallas_ec.py": "the Pallas kernels of kernel B; the port's are "
                           "in curves/cuda_ec.py (ec_add, ec_madd, "
                           "ec_double) and csrc/ec.cu",
    "fields/pallas_ops.py": "the Pallas kernels of kernel A; the port's "
                            "is fields/cuda_ops.py's binop (ADD, SUB, MUL) "
                            "and csrc/field.cu",
    "fields/field.py::NLIMBS": _LIMBS,
    "fields/field.py::LIMB_BITS": _LIMBS,
    "fields/field.py::MASK": _LIMBS,
    "fields/field.py::NBITS": _LIMBS,
    "fields/__init__.py::NLIMBS": _LIMBS,
    "fields/__init__.py::LIMB_BITS": _LIMBS,
    "fields/__init__.py::MASK": _LIMBS,
    "msm/bucket_scan.py::LANES": _TPU_LAYOUT,
    "msm/bucket_scan.py::pad_width": _TPU_LAYOUT,
    "msm/stream_msm.py::ACC_ROWS": _TPU_LAYOUT,
    "msm/stream_msm.py::ACC_ROWS_PK": _TPU_LAYOUT,
    "msm/stream_msm.py::NROWS_PK": _TPU_LAYOUT,
    "msm/stream_msm.py::pack_stream_rows": _TPU_LAYOUT,
    "msm/stream_msm.py::to_stream_layout": _TPU_LAYOUT,
    "msm/stream_msm.py::stream_bucket_sums": _TPU_LAYOUT + "; the port's "
        "bucket sums are stream_buckets (the ordering pass, kernel D or 8, "
        "key_sums)",
    "ntt/fused.py::LANE_TILE": _TPU_LAYOUT,
    "ntt/fused.py::MAX_BASE": _TPU_LAYOUT + "; kernel C's base is "
                              "LOG_MAX_BASE",
    "ntt/ntt.py::fused_min_logn": "the switch between the TPU's two NTT "
                                  "paths; every port transform is the "
                                  "four-step one on kernel C",
    "poly/poly.py::Poly.tree_flatten": "JAX pytree registration",
    "poly/poly.py::Poly.tree_unflatten": "JAX pytree registration",
    "engine.py::TpuMsmEngine": "the TPU engine's name; the port's is "
                               "GpuMsmEngine",
    "engine.py::TpuMsmEngine.get_base_descriptor": "see TpuMsmEngine",
    "engine.py::TpuMsmEngine.msm_with_cached_base": "see TpuMsmEngine",
}


# ----------------------------------------------------------------------
# the AST walk
# ----------------------------------------------------------------------

_TREES: dict = {}


def _tree(path):
    if path not in _TREES:
        with open(path) as f:
            _TREES[path] = ast.parse(f.read())
    return _TREES[path]


def _public(name: str) -> bool:
    return not name.startswith("_")


def reference_names(rel: str) -> set:
    """Public names of one reference module: top-level functions, classes
    and their methods ("Class.method"), assigned names, and for a
    package's __init__ the names it imports (its exports)."""
    out = set()
    for node in _tree(os.path.join(REF_PKG, rel)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            out.add(node.name)
            out.update(f"{node.name}.{m.name}" for m in node.body
                       if isinstance(m, ast.FunctionDef))
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and \
                rel.endswith("__init__.py"):
            out.update(a.asname or a.name for a in node.names)
    return {n for n in out if all(_public(p) for p in n.split("."))}


def _module_file(rel: str, level: int, module) -> str | None:
    """The port file a relative import in `rel` names, or None when it
    leaves the package."""
    if level == 0:
        return None
    parts = os.path.dirname(rel).split(os.sep) if os.path.dirname(rel) \
        else []
    parts = parts[:len(parts) - (level - 1)] if level > 1 else parts
    parts += module.split(".") if module else []
    base = os.path.join(PORT_PKG, *parts)
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(cand):
            return os.path.relpath(cand, PORT_PKG)
    return None


def _binding(rel: str, name: str):
    """(rel, node) of the definition `name` resolves to from port module
    `rel`: a def, a class or an assignment there, or what an import there
    names (followed through the port); (rel, True) for a submodule or a
    name from outside the package; None if unbound."""
    path = os.path.join(PORT_PKG, rel)
    if not os.path.exists(path):
        return None
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and node.name == name:
            return rel, node
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            return rel, node
        if isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name) and node.target.id == name:
            return rel, node
        if isinstance(node, (ast.ImportFrom, ast.Import)):
            for a in node.names:
                if (a.asname or a.name).split(".")[0] != name:
                    continue
                if isinstance(node, ast.Import):
                    return rel, True
                src = _module_file(rel, node.level, node.module)
                if src is None:
                    return rel, True
                sub = _module_file(src, 1, a.name)
                if sub is not None and os.path.basename(src) == \
                        "__init__.py":
                    return sub, True
                return _binding(src, a.name)
    return None


def _has_method(rel: str, cls, method: str) -> bool:
    """Whether class `cls` of port module `rel` defines or inherits
    `method`."""
    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == method:
            return True
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == method
                for t in node.targets):
            return True
    for base in cls.bases:
        if isinstance(base, ast.Name):
            found = _binding(rel, base.id)
            if found and isinstance(found[1], ast.ClassDef) and \
                    _has_method(found[0], found[1], method):
                return True
    return False


def port_has(rel: str, name: str) -> bool:
    head, _, method = name.partition(".")
    found = _binding(rel, head)
    if found is None:
        return False
    if not method:
        return True
    return isinstance(found[1], ast.ClassDef) and \
        _has_method(found[0], found[1], method)


def _reference_modules() -> list:
    out = []
    for root, _, files in os.walk(REF_PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(root, f), REF_PKG))
    return sorted(out)


REF_MODULES = _reference_modules()


@pytest.mark.parametrize("rel", REF_MODULES)
def test_reference_module_has_a_counterpart(rel):
    if rel in NOT_TO_PORT:
        return
    missing = sorted(n for n in reference_names(rel)
                     if f"{rel}::{n}" not in NOT_TO_PORT
                     and not port_has(rel, n))
    assert not missing, f"{rel}: no counterpart in the port for {missing}"


def test_not_to_port_names_are_missing_from_the_port():
    """Each NOT_TO_PORT entry names a module or a name of the reference
    that the port does not have, so the list stays true."""
    for key, reason in NOT_TO_PORT.items():
        assert reason
        rel, _, name = key.partition("::")
        assert rel in REF_MODULES, key
        if name:
            assert name in reference_names(rel), key
            assert not port_has(rel, name), key
        else:
            assert not os.path.exists(os.path.join(PORT_PKG, rel)), key


# ----------------------------------------------------------------------
# the names taken over in this slice, against the reference
# ----------------------------------------------------------------------

def _ints(p: int, n: int, seed: int) -> list:
    rng = random.Random(seed)
    return [0, 1, p - 1] + [rng.randrange(p) for _ in range(n - 3)]


def test_eval_polynomial_matches_reference():
    p = F.p
    coeffs = _ints(p, 37, 1)
    x = random.Random(2).randrange(p)
    ours = eval_polynomial(F, Poly.coeff(F.encode_ints(coeffs, "cpu")),
                           F.encode_int(x, "cpu"))
    theirs = ref_eval_polynomial(REF_FR, RefPoly.coeff(
        REF_FR.encode_ints(coeffs)), REF_FR.encode_int(x))
    assert F.decode_ints(ours[None]) == REF_FR.decode_ints(theirs[None]) == \
        [sum(c * pow(x, i, p) for i, c in enumerate(coeffs)) % p]


def test_ntt_and_bit_reverse_match_reference():
    log_n = 6
    omega = pow(F.root_of_unity, 1 << (F.S - log_n), F.p)
    vals = _ints(F.p, 1 << log_n, 3)
    ours, theirs = NTT(F, log_n, omega, "cpu"), RefNTT(REF_FR, log_n, omega)
    a, ra = F.encode_ints(vals, "cpu"), REF_FR.encode_ints(vals)
    assert F.decode_ints(ours.forward(a)) == \
        REF_FR.decode_ints(theirs.forward(ra))
    assert F.decode_ints(ours.inverse(a)) == \
        REF_FR.decode_ints(theirs.inverse(ra))
    assert bit_reverse_indices(log_n, "cpu").tolist() == \
        ref_bit_reverse(log_n).tolist()


def test_field_select_mul_pow2_rand_ints_match_reference():
    vals = _ints(F.p, 8, 4)
    other = _ints(F.p, 8, 5)
    cond = [True, False] * 4
    a, b = F.encode_ints(vals, "cpu"), F.encode_ints(other, "cpu")
    ra, rb = REF_FR.encode_ints(vals), REF_FR.encode_ints(other)
    assert F.decode_ints(F.select(torch.tensor(cond), a, b)) == \
        REF_FR.decode_ints(REF_FR.select(np.array(cond), ra, rb))
    assert F.decode_ints(F.mul_pow2(a, 5)) == \
        REF_FR.decode_ints(REF_FR.mul_pow2(ra, 5))
    assert F.rand_ints(6, random.Random(6)) == \
        REF_FR.rand_ints(6, random.Random(6))


@pytest.mark.parametrize("shape", [(), (1,), (2, 3)])
def test_curve_generator_matches_reference(shape):
    for C, REF in ((BN254_G1, REF_G1), (VESTA, REF_VESTA)):
        got = C.generator(shape, "cpu")
        assert torch.equal(got, limbs_from_jax(np.asarray(
            REF.generator(shape))))


def test_blind_random_matches_reference():
    assert [Blind.random(F, random.Random(7)).value for _ in range(2)] == \
        [RefBlind.random(REF_FR, random.Random(7)).value for _ in range(2)]
    rng, ref_rng = random.Random(8), random.Random(8)
    assert [Blind.random(F, rng).value for _ in range(3)] == \
        [RefBlind.random(REF_FR, ref_rng).value for _ in range(3)]


def test_msm_kzg_combine_and_pre_msm_match_reference():
    """MSMKZG.combine_with_base, and PreMSM.add_msm / to_msm (from params
    or a curve), on the same terms."""
    params = types.SimpleNamespace(curve=BN254_G1)
    ref_params = types.SimpleNamespace(curve=REF_G1)
    scalars = _ints(F.p, 5, 9)
    pts = [(BN254_G1.gen_x, BN254_G1.gen_y), None] + \
        BN254_G1.to_affine_ints(BN254_G1.generator_mul(
            F.encode_ints([3, 5, 7], "cpu")))
    ours, theirs = MSMKZG(params), RefMSMKZG(ref_params)
    for s, pt in zip(scalars, pts):
        ours.append_term(s, pt)
        theirs.append_term(s, pt)
    ours.combine_with_base(123456789)
    theirs.combine_with_base(123456789)
    assert ours.scalars == theirs.scalars

    def collect(cls, src, curve, from_affine):
        a, b = cls(src), cls(curve)
        for i, (s, pt) in enumerate(zip(scalars, pts)):
            (a if i < 3 else b).append_term(s, from_affine(pt))
        a.add_msm(b)
        m = a.to_msm()
        return a.scalars, a.normalize(), m.scalars, m.bases

    got = collect(PreMSM, params, BN254_G1,
                  lambda pt: BN254_G1.from_affine_ints([pt], "cpu")[0])
    want = collect(RefPreMSM, ref_params, REF_G1,
                   lambda pt: REF_G1.from_affine_ints([pt])[0])
    assert got == want
    assert got[1] == pts


def test_poly_map_and_usable_rows_match_reference():
    vals = _ints(F.p, 4, 10)
    got = Poly.lagrange(F.encode_ints(vals, "cpu")).map(F.neg)
    want = RefPoly.lagrange(REF_FR.encode_ints(vals)).map(REF_FR.neg)
    assert got.basis == want.basis
    assert F.decode_ints(got.values) == REF_FR.decode_ints(want.values)
    k = 5
    cs = compile_circuit(F, k, plonk_api_instance(F)[0])[0].cs
    ref_cs = ref_compile(REF_FR, k, ref_plonk_api(REF_FR)[0])[0].cs
    ours, theirs = ConstraintSystemBack(cs, F.p), RefCsBack(ref_cs, F.p)
    assert ours.usable_rows(1 << k) == theirs.usable_rows(1 << k) == \
        (1 << k) - ours.blinding_factors() - 1
