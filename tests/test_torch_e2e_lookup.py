"""lookup_heavy (four 16-bit range lookups per row) at its smallest k,
KZG / SHPLONK / Blake2b, against the JAX reference: equal verifying keys,
byte-identical proofs under random.Random(1) (also with a witness column
of unreduced values >= 2^64), and each package verifying the other's
proof (and rejecting a tampered one).  Split from
test_torch_e2e.py so that test workers share the load.

Then the reference's diagnostic switches on the port: a prove under
HALO2_TPU_SANITY=1 and HALO2_TPU_HOST_LOOKUP=1 (with the debug and step
timing lines on) equal to the reference's proof, the host permute against
the device permute, the sanity tier's failures with the reference's
messages, and the debug, keygen and step-timing lines in the reference's
format and order.  The reference's strings are read from its source as
text."""

import contextlib
import io
import os
import random
import re

import pytest
import torch

from halo2_tpu import api as ref_api
from halo2_tpu.commit import (ParamsKZG as RefParamsKZG,
                              ProverSHPLONK as RefProverSHPLONK,
                              SingleStrategyKZG as RefSingleStrategyKZG,
                              VerifierSHPLONK as RefVerifierSHPLONK)
from halo2_tpu.fields import BN254_FR as REF_F
from halo2_tpu_torch import api
from halo2_tpu_torch.commit import (ParamsKZG, ProverSHPLONK,
                                    SingleStrategyKZG, VerifierSHPLONK)
from halo2_tpu_torch.fields import BN254_FR as F
from halo2_tpu_torch.plonk import prover as port_prover
from halo2_tpu_torch.plonk.lookup_sort import (
    permute_expression_pair, permute_expression_pair_device)

# The plain versions run many small tensor ops: one thread per worker
# is as fast and leaves the other cores to the other test workers.
torch.set_num_threads(1)


def _verify(params, vk, proof, inst) -> bool:
    return api.verify(params, vk, proof, [inst],
                      multiopen_verifier_cls=VerifierSHPLONK,
                      strategy_cls=SingleStrategyKZG)


def _ref_verify(ref, proof) -> bool:
    params, pk, _, inst = ref
    return ref_api.verify(params, pk.vk, proof, [inst],
                          multiopen_verifier_cls=RefVerifierSHPLONK,
                          strategy_cls=RefSingleStrategyKZG)


def _tampered(proof: bytes, at: int) -> bytes:
    bad = bytearray(proof)
    bad[at] ^= 1
    return bytes(bad)


K_LH = 6


@pytest.fixture(scope="module")
def lookup_heavy_pair():
    """(reference, port) x (params, pk, proof, instances) at K_LH."""
    from halo2_tpu.compat.lookup_heavy import (
        lookup_heavy_instance as ref_lookup_heavy)
    from halo2_tpu_torch.compat.lookup_heavy import lookup_heavy_instance
    out = []
    for make, keygen, prove, params in (
            (ref_lookup_heavy, ref_api.keygen, ref_api.create_proof,
             lambda: RefParamsKZG.new(K_LH)),
            (lookup_heavy_instance, api.keygen, api.create_proof,
             lambda: ParamsKZG.new(K_LH, device="cpu"))):
        F_ = REF_F if make is ref_lookup_heavy else F
        circuit, inst, kg_circuit = make(F_, K_LH)
        prm = params()
        pk = keygen(F_, prm, K_LH, kg_circuit)
        proof = prove(prm, pk, [circuit], [inst], random.Random(1),
                      multiopen_prover_cls=(
                          RefProverSHPLONK if make is ref_lookup_heavy
                          else ProverSHPLONK))
        out.append((prm, pk, proof, inst))
    return out


def test_lookup_heavy_matches_reference(lookup_heavy_pair):
    (rp, rpk, rproof, inst), (pp, ppk, pproof, _) = lookup_heavy_pair
    assert ppk.vk.transcript_repr == rpk.vk.transcript_repr
    assert ppk.vk.fixed_commitments == rpk.vk.fixed_commitments
    assert len(ppk.vk.cs.cs.lookups) == 4
    assert pproof == rproof
    assert _verify(pp, ppk.vk, rproof, inst)
    assert _ref_verify((rp, rpk, rproof, inst), pproof)
    assert not _verify(pp, ppk.vk, _tampered(pproof, 64), inst)


def test_unreduced_witness_proof_matches_reference(lookup_heavy_pair,
                                                   monkeypatch):
    """A witness column of values >= 2^64, each the calculator's value plus
    p: commit_phase's encoder reduces that column value by value (every
    other column goes as 64-bit words), and the proof is still the
    reference's byte for byte."""
    from halo2_tpu_torch.compat.lookup_heavy import lookup_heavy_instance
    from halo2_tpu_torch.fields import field
    (_, _, rproof, inst), (pp, ppk, _, _) = lookup_heavy_pair

    class Unreduced(api.WitnessCalculator):
        def calc(self, phase, challenges):
            witness = super().calc(phase, challenges)
            witness[0] = [v + F.p for v in witness[0]]
            return witness

    monkeypatch.setattr(api, "WitnessCalculator", Unreduced)
    circuit, _, _ = lookup_heavy_instance(F, K_LH)
    before = field.encode_counters()
    proof = api.create_proof(pp, ppk, [circuit], [inst], random.Random(1),
                             multiopen_prover_cls=ProverSHPLONK)
    wide = field.encode_counters()["wide"] - before["wide"]
    n, bf = ppk.vk.domain.n, ppk.vk.cs.blinding_factors()
    na = ppk.vk.cs.cs.num_advice_columns
    assert wide == (n - bf - 1) + na * (bf + 1)
    assert proof == rproof


# ----------------------------------------------------------------------
# the diagnostic switches (HALO2_TPU_SANITY, _HOST_LOOKUP, _DEBUG,
# _DEBUG_KEYGEN, _STEP_TIMINGS)
# ----------------------------------------------------------------------

REF_PLONK = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "halo2_tpu", "plonk")

# the reference's step names in its order: keygen.py's _kt calls, and
# prover.py's HALO2_TPU_STEP_TIMINGS prints (commit_phase, then T9-T11)
KEYGEN_STEPS = ["fixed encode+ffts", "fixed commits", "perm cycle merge",
                "sigma values+ffts+commits", "vk hash + lagrange basis"]
PROVER_STEPS = ["[commit_phase] encode", "[commit_phase] msms",
                "[commit_phase] normalize+write", "[commit_phase] set",
                "[T9] permutation_commit", "[T10] lookup_products",
                "[T11] shuffle_products"]
SWITCHES = ("HALO2_TPU_SANITY", "HALO2_TPU_HOST_LOOKUP", "HALO2_TPU_DEBUG",
            "HALO2_TPU_STEP_TIMINGS", "HALO2_TPU_DEBUG_KEYGEN")


def _ref_source(name: str) -> str:
    with open(os.path.join(REF_PLONK, name)) as f:
        return f.read()


def _ref_fstring(fragment: str) -> str:
    """The body of the reference prover's f-string message that holds
    `fragment`, as written there."""
    for line in _ref_source("prover.py").splitlines():
        m = re.search(r'f?"([^"]*)"', line)
        if m and fragment in m.group(1):
            return m.group(1)
    raise AssertionError(f"no message with {fragment!r} in the reference")


@pytest.fixture(scope="module")
def switched(lookup_heavy_pair):
    """The port's keygen, prove and verify at K_LH with every switch set
    to 1, and what each printed."""
    _, (pp, _, _, inst) = lookup_heavy_pair
    from halo2_tpu_torch.compat.lookup_heavy import lookup_heavy_instance
    circuit, _, kg_circuit = lookup_heavy_instance(F, K_LH)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in SWITCHES:
            mp.setenv(name, "1")
        for step, run in (
                ("keygen", lambda: api.keygen(F, pp, K_LH, kg_circuit)),
                ("prove", lambda: api.create_proof(
                    pp, out["keygen"][0], [circuit], [inst],
                    random.Random(1), multiopen_prover_cls=ProverSHPLONK)),
                ("verify", lambda: _verify(pp, out["keygen"][0].vk,
                                           out["prove"][0], inst))):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                got = run()
            out[step] = (got, buf.getvalue())
    return out


def test_sanity_host_lookup_proof_matches_reference(lookup_heavy_pair,
                                                    switched):
    """HALO2_TPU_SANITY=1 + HALO2_TPU_HOST_LOOKUP=1: every sanity check
    passes, (A', S') come from the host permute, and the proof is the
    reference's byte for byte (the checks draw nothing from the RNG)."""
    (_, _, rproof, _), _ = lookup_heavy_pair
    proof, _ = switched["prove"]
    assert proof == rproof
    assert switched["verify"][0] is True


def test_sanity_device_lookup_proof_matches_reference(lookup_heavy_pair,
                                                      monkeypatch):
    """HALO2_TPU_SANITY=1 alone: the device permute, checked against the
    host one on every lookup, gives the reference's proof."""
    (_, _, rproof, inst), (pp, ppk, _, _) = lookup_heavy_pair
    from halo2_tpu_torch.compat.lookup_heavy import lookup_heavy_instance
    circuit, _, _ = lookup_heavy_instance(F, K_LH)
    monkeypatch.setenv("HALO2_TPU_SANITY", "1")
    assert api.create_proof(pp, ppk, [circuit], [inst], random.Random(1),
                            multiopen_prover_cls=ProverSHPLONK) == rproof


def test_debug_lines_agree(switched):
    """HALO2_TPU_DEBUG: the prover's h_poly(x) and the verifier's
    expected_h_eval, in the reference's formats, name the same x and the
    same value."""
    prover = re.findall(r"^\[dbg prover\] x=(0x[0-9a-f]+) "
                        r"h_poly\(x\)=(0x[0-9a-f]+)$",
                        switched["prove"][1], re.M)
    verifier = re.findall(r"^\[dbg verifier\] x=(0x[0-9a-f]+) "
                          r"expected_h_eval=(0x[0-9a-f]+)$",
                          switched["verify"][1], re.M)
    assert len(prover) == 1 and prover == verifier
    assert '"[dbg prover] x={x:#x} h_poly(x)=' in _ref_source("prover.py")
    assert '"[dbg verifier] x={x:#x} expected_h_eval={expected_h_eval:#x}"' \
        in _ref_source("verifier.py")


def test_debug_keygen_lines(switched):
    """HALO2_TPU_DEBUG_KEYGEN=1: the reference's five step lines, in its
    order and format, and keygen's keys unchanged by them."""
    got = re.findall(r"^\[keygen\] (.+): \d+\.\ds$",
                     switched["keygen"][1], re.M)
    assert got == KEYGEN_STEPS
    assert re.findall(r"_kt\('([^']+)'\)", _ref_source("keygen.py")) == \
        KEYGEN_STEPS
    assert 'print(f"[keygen] {name}: {now - _t[0]:.1f}s"' in \
        _ref_source("keygen.py")


def test_step_timing_lines(switched):
    """HALO2_TPU_STEP_TIMINGS=1: the reference's commit_phase split
    (encode, msms, normalize+write, set) once per phase, then T9-T11, in
    its order and format."""
    got = re.findall(r"^    (\[[^\]]+\] .+): \d+\.\d\ds$",
                     switched["prove"][1], re.M)
    assert got == PROVER_STEPS
    ref = re.findall(r'print\(f"    (\[[^\]]+\] [^:]+): ',
                     _ref_source("prover.py"))
    assert ref == PROVER_STEPS


def _permute_inputs(case: str):
    """(input, table) columns of canonical ints over 300 usable rows."""
    rng = random.Random(case)
    n = 300
    values = [0, 1, F.p - 1, 1 << 128, (1 << 255) % F.p] + \
        [rng.randrange(F.p) for _ in range(40)]
    if case == "ties":          # a table of distinct values, many ties
        table = values + [rng.randrange(F.p) for _ in range(n - 45)]
        inp = [rng.choice(values) for _ in range(n)]
    elif case == "table_repeats":   # the table repeats values too
        table = [rng.choice(values) for _ in range(n)]
        inp = [rng.choice(table) for _ in range(n)]
    else:                       # one input value missing from the table
        table = [rng.choice(values[1:]) for _ in range(n)]
        inp = [rng.choice(table) for _ in range(n - 1)] + [values[0]]
    rng.shuffle(inp)
    return inp, table


@pytest.mark.parametrize("case", ["ties", "table_repeats", "not_in_table"])
def test_host_permute_matches_device(case):
    """The host permute (HALO2_TPU_HOST_LOOKUP=1) against the device
    permute on the same compressed columns: equal (A', S'), the pair
    invariant holding on every row; an input missing from the table
    raises, on the host with the reference's message."""
    inp, table = _permute_inputs(case)
    usable = len(inp)
    if case == "not_in_table":
        want = _ref_fstring("not in table").replace(
            "{lk_arg.name}", "range").replace("{v}", "0")
        with pytest.raises(ValueError) as err:
            permute_expression_pair(inp, table, "range")
        assert str(err.value) == want
        with pytest.raises(ValueError):
            permute_expression_pair_device(F, F.encode_ints(inp, "cpu"),
                                           F.encode_ints(table, "cpu"),
                                           usable)
        return
    perm_in, perm_tab = permute_expression_pair(inp, table, "range")
    a_dev, s_dev = permute_expression_pair_device(
        F, F.encode_ints(inp + [7], "cpu"), F.encode_ints(table + [9], "cpu"),
        usable)
    assert F.decode_ints(a_dev) == perm_in == sorted(inp)
    assert F.decode_ints(s_dev) == perm_tab
    assert sorted(perm_tab) == sorted(table)
    assert all(perm_in[i] == perm_tab[i] or perm_in[i] == perm_in[i - 1]
               for i in range(usable))


def test_sanity_broken_grand_product_raises(lookup_heavy_pair, monkeypatch):
    """HALO2_TPU_SANITY=1 with a lookup grand product that no longer
    telescopes (one added to every row of prefix_product): the
    reference's message."""
    _, (pp, ppk, _, inst) = lookup_heavy_pair
    from halo2_tpu_torch.compat.lookup_heavy import lookup_heavy_instance
    circuit, _, _ = lookup_heavy_instance(F, K_LH)
    real = port_prover.prefix_product

    def broken(F_, a):
        out = real(F_, a)
        return F_.add(out, F_.ones(out.shape[:-1], out.device))

    monkeypatch.setattr(port_prover, "prefix_product", broken)
    monkeypatch.setenv("HALO2_TPU_SANITY", "1")
    msg = "lookup grand product does not telescope"
    assert f'"{msg}"' in _ref_source("prover.py")
    with pytest.raises(AssertionError, match=f"^{msg}$"):
        api.create_proof(pp, ppk, [circuit], [inst], random.Random(1),
                         multiopen_prover_cls=ProverSHPLONK)


def test_sanity_unblinded_nonzero_blinding_row_raises(monkeypatch):
    """HALO2_TPU_SANITY=1 on an unblinded advice column (the
    vector-ops-unblinded.rs mul circuit, KZG / GWC k=4) whose witness is
    nonzero on a blinding row: the reference's message; without the
    switch the prover does not look."""
    from halo2_tpu_torch.commit import ProverGWC
    from tests.test_torch_ref_pins import PORT, _circuits, _pkg, _vectors
    k = 4
    Mul = _circuits(_pkg(PORT))[0]
    a, b, mul, _ = _vectors(F)
    params = ParamsKZG.new(k, device="cpu")
    circ = Mul(a, b)
    pk = api.keygen(F, params, k, circ)

    class DirtyBlindingRow(api.WitnessCalculator):
        def calc(self, phase, challenges):
            witness = super().calc(phase, challenges)
            witness[0] = list(witness[0][:-1]) + [1]
            return witness

    monkeypatch.setattr(api, "WitnessCalculator", DirtyBlindingRow)

    def prove():
        return api.create_proof(params, pk, [circ], [[mul]],
                                random.Random(1),
                                multiopen_prover_cls=ProverGWC)

    prove()
    monkeypatch.setenv("HALO2_TPU_SANITY", "1")
    want = _ref_fstring("nonzero blinding rows").replace("{ci}", "0")
    with pytest.raises(AssertionError, match=f"^{re.escape(want)}$"):
        prove()
