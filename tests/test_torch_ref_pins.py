"""Reference behaviours held in the port by the SHA-256 of the reference's
proof bytes:

- two circuits in one transcript (tests/test_scale.py, IPA / Vesta k=6);
- unblinded advice columns (tests/test_unblinded.py, KZG / GWC k=4): the
  mul and add circuits' unblinded a and b commitments agree across the two
  proofs, and their blinded out column does not;
- `keygen(..., compress_selectors=False)` on plonk_api (IPA / Vesta k=5),
  and on tests/test_compress_selectors.py's three-selector circuit (IPA /
  Vesta k=6), where the flag changes the proof;
- the V1 floor planner (tests/test_floor_planner_v1.py, IPA / Vesta k=6).

Each port proof must hash to the reference's digest, verify, and be
rejected with a wrong instance.  The reference's proves take minutes to
compile on a CPU, so its digests are pinned; the same case functions below
drive either package and computed them, one case a process:

    JAX_PLATFORMS=cpu python -m tests.test_torch_ref_pins <case>

with <case> one of two_circuits, unblinded, uncompressed, v1, selectors.
"""

import hashlib
import importlib
import random
import sys

import pytest
import torch

from tests._torch_params_cache import own_params_cache  # noqa: F401

torch.set_num_threads(1)

PORT = "halo2_tpu_torch"
REF = "halo2_tpu"

# sha256 of the reference's proofs, from the command in the docstring
REF_PROOF_SHA256 = {
    "two_circuits":  # 4224 bytes
        "f22c175df61cf2dbcc525aa596b76cc833f3a92b91372a8c5bfd8cefe078e144",
    "unblinded_mul":  # 736 bytes
        "801d637232eba6f82779d89c23747a491f97da9c8d3113d9c245765f937bbf83",
    "unblinded_add":  # 736 bytes
        "f699686a7ceec0fd975b0942a2fd57ae9855929e2a3e67cc83f8f4b8cc5925e3",
    "uncompressed":  # 2752 bytes
        "08de8e9cb93e706deda05459ac45af3f6de0fd7c1e9ba2c42a77b51fc974137f",
    "v1":  # 1600 bytes
        "73980b84fed58f25684200d5048115f0863e1e4ab47096127fc87cde72e75a8a",
    "selectors_compressed":  # 1088 bytes
        "556a6646a2af0ec0293ac2f0d574b100d066b0ed624ff4b06e40e25c919e8f19",
    "selectors_uncompressed":  # 1120 bytes
        "c1eeb7d30977f99e732d2bf3cc70e68e598915550d7c5ac9e388cf4aaea6bc69",
}


def _pkg(pkg: str):
    """The modules a case needs, of the reference or of the port, and the
    keywords that put the port's params on the CPU."""
    mods = {name: importlib.import_module(f"{pkg}.{name}") for name in (
        "api", "commit", "curves", "fields", "frontend",
        "frontend.floor_planner_v1", "compat.plonk_api")}
    mods["device"] = {} if pkg == REF else {"device": "cpu"}
    return mods


def _circuits(m):
    """The vector-ops-unblinded.rs circuits (mul and add) and the V1
    floor planner's mul chain, on the frontend of m."""
    fe = m["frontend"]

    class VectorOps(fe.Circuit):
        OP = None

        def __init__(self, a=None, b=None, n_rows=None):
            self.a, self.b = a, b
            self.n_rows = n_rows if n_rows is not None else len(a or [])

        def without_witnesses(self):
            return type(self)(None, None, self.n_rows)

        def configure(self, meta):
            a = meta.unblinded_advice_column()
            b = meta.unblinded_advice_column()
            out = meta.advice_column()
            instance = meta.instance_column()
            meta.enable_equality(out)
            meta.enable_equality(instance)
            q = meta.selector()

            def gate(cells):
                qv = cells.query_selector(q)
                av = cells.query_advice(a, fe.Rotation.cur())
                bv = cells.query_advice(b, fe.Rotation.cur())
                ov = cells.query_advice(out, fe.Rotation.cur())
                lhs = av * bv if self.OP == "mul" else av + bv
                return [qv * (lhs - ov)]

            meta.create_gate(self.OP, gate)
            return {"a": a, "b": b, "out": out, "instance": instance,
                    "q": q}

        def synthesize(self, config, layouter):
            def value(vs, i):
                return fe.Value.unknown() if vs is None else \
                    fe.Value.known(vs[i])

            def fill(region):
                cells = []
                for i in range(self.n_rows):
                    config["q"].enable(region, i)
                    ac = region.assign_advice(config["a"], i,
                                              value(self.a, i))
                    bc = region.assign_advice(config["b"], i,
                                              value(self.b, i))
                    o = (ac.value() * bc.value() if self.OP == "mul"
                         else ac.value() + bc.value())
                    cells.append(region.assign_advice(config["out"], i, o))
                return cells

            for i, cell in enumerate(layouter.assign_region("rows", fill)):
                layouter.constrain_instance(cell.cell, config["instance"], i)

    class Mul(VectorOps):
        OP = "mul"

    class Add(VectorOps):
        OP = "add"

    class V1(fe.Circuit):
        floor_planner = m["frontend.floor_planner_v1"].V1FloorPlanner

        def __init__(self, constant=0, a=None, b=None):
            self.constant = constant
            self.a = fe.Value.unknown() if a is None else fe.Value.known(a)
            self.b = fe.Value.unknown() if b is None else fe.Value.known(b)

        def without_witnesses(self):
            return V1(self.constant)

        def configure(self, meta):
            advice = [meta.advice_column(), meta.advice_column()]
            instance = meta.instance_column()
            constant = meta.fixed_column()
            meta.enable_equality(instance)
            meta.enable_constant(constant)
            for c in advice:
                meta.enable_equality(c)
            s_mul = meta.selector()

            def mul_gate(cells):
                lhs = cells.query_advice(advice[0], fe.Rotation.cur())
                rhs = cells.query_advice(advice[1], fe.Rotation.cur())
                out = cells.query_advice(advice[0], fe.Rotation.next())
                return [cells.query_selector(s_mul) * (lhs * rhs - out)]

            meta.create_gate("mul", mul_gate)
            return {"advice": advice, "instance": instance, "s_mul": s_mul}

        def synthesize(self, config, layouter):
            advice = config["advice"]

            def load(name, value):
                return layouter.assign_region(name, lambda region:
                                              region.assign_advice(
                                                  advice[0], 0, value))

            def mul(name, a_cell, b_cell):
                def closure(region):
                    config["s_mul"].enable(region, 0)
                    a_cell.copy_advice(region, advice[0], 0)
                    b_cell.copy_advice(region, advice[1], 0)
                    return region.assign_advice(
                        advice[0], 1, a_cell.value() * b_cell.value())
                return layouter.assign_region(name, closure)

            a = load("load a", self.a)
            b = load("load b", self.b)
            const = layouter.assign_region("constant", lambda region:
                                           region.assign_advice_from_constant(
                                               advice[0], 0, self.constant))
            ab = mul("a*b", a, b)
            c = mul("c", const, mul("ab*ab", ab, ab))
            layouter.constrain_instance(c.cell, config["instance"], 0)

    class Three(fe.Circuit):
        """Three disjoint simple selectors over one advice column: add 1,
        square, cube."""

        def __init__(self, x=None):
            self.x = fe.Value.unknown() if x is None else fe.Value.known(x)

        def without_witnesses(self):
            return Three()

        def configure(self, meta):
            a = meta.advice_column()
            meta.enable_equality(a)
            instance = meta.instance_column()
            meta.enable_equality(instance)
            sels = (meta.selector(), meta.selector(), meta.selector())

            def gate(sel, fn):
                def build(cells):
                    cur = cells.query_advice(a, fe.Rotation.cur())
                    nxt = cells.query_advice(a, fe.Rotation.next())
                    return [cells.query_selector(sel) * fn(cur, nxt)]
                return build

            meta.create_gate("add1", gate(sels[0], lambda c, n: c + 1 - n))
            meta.create_gate("sq", gate(sels[1], lambda c, n: c * c - n))
            meta.create_gate("cube", gate(sels[2],
                                          lambda c, n: c * c * c - n))
            return {"a": a, "instance": instance, "sels": sels}

        def synthesize(self, config, layouter):
            a = config["a"]

            def step(name, sel, cell, value):
                def closure(region):
                    sel.enable(region, 0)
                    cell.copy_advice(region, a, 0)
                    return region.assign_advice(a, 1, value)
                return layouter.assign_region(name, closure)

            x = layouter.assign_region("load", lambda region:
                                       region.assign_advice(a, 0, self.x))
            s_add, s_sq, s_cube = config["sels"]
            y = step("add1", s_add, x, x.value() + fe.Value.known(1))
            z = step("sq", s_sq, y, y.value() * y.value())
            w = step("cube", s_cube, z, z.value() * z.value() * z.value())
            layouter.constrain_instance(w.cell, config["instance"], 0)

    return Mul, Add, V1, Three


# Each case returns ({name: (proof, instances, wrong instances)}, verifier)
# with verifier(name)(proof, instances) -> bool.

def _ipa_verify(m, params, vk):
    return lambda proof, inst: m["api"].verify(params, vk, proof, inst)


def case_two_circuits(m):
    """Two plonk_api instances in one IPA proof (one pk, the second with
    a = 2 inside the shared lookup table)."""
    F, k = m["fields"].PASTA_FP, 6
    pa = m["compat.plonk_api"]
    c1, i1 = pa.plonk_api_instance(F)
    c2, i2 = pa.PlonkApiCircuit(F.p, 2, c1.lookup_table), [[2]]
    params = m["commit"].ParamsIPA.new(m["curves"].VESTA, k, **m["device"])
    pk = m["api"].keygen(F, params, k, c1)
    proof = m["api"].create_proof(params, pk, [c1, c2], [i1, i2],
                                  random.Random(5))
    return {"two_circuits": (proof, [i1, i2], [i1, [[3]]])}, \
        lambda name: _ipa_verify(m, params, pk.vk)


def _vectors(F, n=6):
    rng = random.Random(7)
    a = [rng.randrange(1, 1000) for _ in range(n)]
    b = [rng.randrange(1, 1000) for _ in range(n)]
    return a, b, [x * y % F.p for x, y in zip(a, b)], \
        [(x + y) % F.p for x, y in zip(a, b)]


def case_unblinded(m):
    """The mul and add circuits on the same unblinded inputs, KZG / GWC,
    proved under different seeds."""
    F, k, c = m["fields"].BN254_FR, 4, m["commit"]
    Mul, Add, _, _ = _circuits(m)
    a, b, mul, add = _vectors(F)
    params = c.ParamsKZG.new(k, **m["device"])
    out, vks = {}, {}
    for name, circ, inst, seed in (("unblinded_mul", Mul(a, b), mul, 1),
                                   ("unblinded_add", Add(a, b), add, 2)):
        pk = m["api"].keygen(F, params, k, circ)
        vks[name] = pk.vk
        proof = m["api"].create_proof(params, pk, [circ], [[inst]],
                                      random.Random(seed),
                                      multiopen_prover_cls=c.ProverGWC)
        wrong = [[[(inst[0] + 1) % F.p] + inst[1:]]]
        out[name] = (proof, [[inst]], wrong)

    return out, lambda name: lambda proof, inst: m["api"].verify(
        params, vks[name], proof, inst,
        multiopen_verifier_cls=c.VerifierGWC,
        strategy_cls=c.SingleStrategyKZG)


def case_uncompressed(m):
    """plonk_api keyed with compress_selectors=False, IPA / Vesta."""
    F, k = m["fields"].PASTA_FP, 5
    circuit, inst = m["compat.plonk_api"].plonk_api_instance(F)
    params = m["commit"].ParamsIPA.new(m["curves"].VESTA, k, **m["device"])
    pk = m["api"].keygen(F, params, k, circuit, compress_selectors=False)
    proof = m["api"].create_proof(params, pk, [circuit], [inst],
                                  random.Random(1))
    return {"uncompressed": (proof, [inst], [[[3]]])}, \
        lambda name: _ipa_verify(m, params, pk.vk)


def case_v1(m):
    """The V1 dual-pass floor planner's mul chain c = const a^2 b^2."""
    F, k = m["fields"].PASTA_FP, 6
    _, _, V1, _ = _circuits(m)
    const, a, b = 7, 5, 9
    c = const * a ** 2 * b ** 2 % F.p
    params = m["commit"].ParamsIPA.new(m["curves"].VESTA, k, **m["device"])
    pk = m["api"].keygen(F, params, k, V1(const))
    proof = m["api"].create_proof(params, pk, [V1(const, a, b)], [[[c]]],
                                  m["commit"].new_rng(3))
    return {"v1": (proof, [[[c]]], [[[c + 1]]])}, \
        lambda name: _ipa_verify(m, params, pk.vk)


def case_selectors(m):
    """Three simple selectors (tests/test_compress_selectors.py's circuit,
    w = ((x + 1)^2)^3), keyed with compress_selectors=True (two fixed
    columns) and False (three): plonk_api above has no simple selector,
    so this is where the flag changes the keys and the proof."""
    F, k = m["fields"].PASTA_FP, 6
    _, _, _, Three = _circuits(m)
    x = 3
    w = ((x + 1) ** 2) ** 3 % F.p
    params = m["commit"].ParamsIPA.new(m["curves"].VESTA, k, **m["device"])
    out, vks = {}, {}
    for name, compress in (("selectors_compressed", True),
                           ("selectors_uncompressed", False)):
        pk = m["api"].keygen(F, params, k, Three(),
                             compress_selectors=compress)
        vks[name] = pk.vk
        proof = m["api"].create_proof(params, pk, [Three(x)], [[[w]]],
                                      m["commit"].new_rng(42))
        out[name] = (proof, [[[w]]], [[[w + 1]]])
    return out, lambda name: _ipa_verify(m, params, vks[name])


CASES = {"two_circuits": case_two_circuits, "unblinded": case_unblinded,
         "uncompressed": case_uncompressed, "v1": case_v1,
         "selectors": case_selectors}


def _held(proofs, verifier):
    """Each proof hashes to the reference's, verifies, and is rejected with
    a wrong instance; verifier(name) checks (proof, instances)."""
    for name, (proof, inst, wrong) in proofs.items():
        check = verifier(name)
        assert hashlib.sha256(proof).hexdigest() == \
            REF_PROOF_SHA256[name], name
        assert check(proof, inst), name
        assert not check(proof, wrong), name


@pytest.mark.parametrize("case", ["two_circuits", "uncompressed", "v1"])
def test_ipa_proof_equals_reference(case):
    _held(*CASES[case](_pkg(PORT)))


def test_uncompressed_selectors_change_the_proof():
    proofs, verifier = case_selectors(_pkg(PORT))
    _held(proofs, verifier)
    assert proofs["selectors_compressed"][0] != \
        proofs["selectors_uncompressed"][0]


def test_unblinded_commitments_match_across_circuits():
    m = _pkg(PORT)
    proofs, verify = case_unblinded(m)
    _held(proofs, verify)
    mul, add = proofs["unblinded_mul"][0], proofs["unblinded_add"][0]
    point = 32            # a compressed BN254 G1 point
    assert mul[:2 * point] == add[:2 * point]        # a and b: unblinded
    assert mul[2 * point:3 * point] != add[2 * point:3 * point]   # out


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    found, _ = CASES[sys.argv[1]](_pkg(REF))
    for name, (proof, _, _) in found.items():
        print(f'"{name}": "{hashlib.sha256(proof).hexdigest()}",  '
              f'# {len(proof)} bytes', flush=True)
