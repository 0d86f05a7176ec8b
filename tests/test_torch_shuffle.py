"""Shuffle arguments and a two-phase circuit in the port against the JAX
reference: ShuffleCircuit([1, 2, 3, 4], [4, 3, 2, 1]) and
PhaseCircuit([7, 8, 9]) at K=5 on IPA / Vesta (the reference test's
setting, test_args_e2e.py), and the shuffle circuit on KZG with the GWC
multiopen and the Keccak256 transcript (through ProofConfig).  For each:
equal pinned verifying keys, byte-identical proofs under one
random.Random seed, each package verifying the other's proof (the port's
also through verify_proof_single), and a proof of a non-permutation
witness (for the two-phase circuit: a phase-2 cell off by one) rejected
by both.  Exact equality.  Last, PhaseCircuit on KZG: both packages
refuse to prove it, because its quotient's top piece is zero and commits
to the identity, which is why the KZG chip paths prove
PhaseEqualityCircuit instead."""

import random

import jax
import pytest
import torch

from circuits import PhaseCircuit as RefPhase
from circuits import ShuffleCircuit as RefShuffle
from halo2_tpu.frontend import Value as RefValue
from halo2_tpu.commit import ParamsIPA as RefParamsIPA
from halo2_tpu.config import ProofConfig as RefProofConfig
from halo2_tpu.curves import VESTA as REF_VESTA
from halo2_tpu_torch.commit import ParamsIPA
from halo2_tpu_torch.compat.from_jax import params_kzg_from_jax
from halo2_tpu_torch.compat.shuffle_api import PhaseCircuit, ShuffleCircuit
from halo2_tpu_torch.config import ProofConfig
from halo2_tpu_torch.curves import VESTA
from halo2_tpu_torch.plonk import verify_proof_single
from tests._torch_params_cache import own_params_cache  # noqa: F401

torch.set_num_threads(1)

K = 5
SHUFFLE = ([1, 2, 3, 4], [4, 3, 2, 1])
NOT_SHUFFLE = ([1, 2, 3, 4], [4, 3, 2, 5])
PHASE = [7, 8, 9]
WRONG_ROW = 1
# case -> (circuit, seed of the proof, seed of the bad witness's proof)
CASES = {"shuffle-ipa": ("shuffle", 2, 3), "phase-ipa": ("phase", 4, 7),
         "shuffle-kzg-gwc-keccak": ("shuffle", 5, 6)}


class RefWrongPhase(RefPhase):
    """The reference's PhaseCircuit with the phase-2 cell of WRONG_ROW set
    to a * theta + 1."""

    def synthesize(self, config, layouter):
        theta = layouter.get_challenge(config["theta"])

        def fill(region):
            for i in range(self.n_rows):
                config["q"].enable(region, i)
                av = region.assign_advice(config["a"], i,
                                          RefValue.known(self.values[i]))
                bv = av.value() * theta
                region.assign_advice(config["b"], i,
                                     bv + 1 if i == WRONG_ROW else bv)

        layouter.assign_region("rows", fill)


def _ref_circuit(name, bad=False):
    if name == "shuffle":
        return RefShuffle(*(NOT_SHUFFLE if bad else SHUFFLE))
    return (RefWrongPhase if bad else RefPhase)(PHASE)


def _port_circuit(name, bad=False):
    if name == "shuffle":
        return ShuffleCircuit(*(NOT_SHUFFLE if bad else SHUFFLE))
    return PhaseCircuit(PHASE, wrong_row=WRONG_ROW if bad else None)


@pytest.fixture(scope="module")
def ref():
    """Per case: (config, params, pk, proof, bad witness's proof).  The JIT
    caches are dropped after each case: XLA:CPU segfaults when one process
    holds too many live executables (see tests/conftest.py), and these three
    cases' keygens and proves, with the verifiers after them, were enough to
    kill the test worker in a fresh HOME."""
    ipa = RefProofConfig(k=K, curve="vesta", scheme="ipa")
    kzg = RefProofConfig(k=K, curve="bn254", scheme="kzg-gwc",
                         transcript="keccak256")
    params = {"ipa": RefParamsIPA.new(REF_VESTA, K), "kzg": kzg.params()}
    out = {}
    for case, (name, seed, bad_seed) in CASES.items():
        scheme = "kzg" if "kzg" in case else "ipa"
        cfg, prm = (kzg if scheme == "kzg" else ipa), params[scheme]
        circuit = _ref_circuit(name)
        pk = cfg.keygen(circuit, params=prm)
        proof = cfg.prove(pk, [circuit], [[]], random.Random(seed),
                          params=prm)
        bad = cfg.prove(pk, [_ref_circuit(name, bad=True)], [[]],
                        random.Random(bad_seed), params=prm)
        out[case] = (cfg, prm, pk, proof, bad)
        jax.clear_caches()
    return out


@pytest.fixture(scope="module")
def port(ref):
    ipa = ProofConfig(k=K, curve="vesta", scheme="ipa", device="cpu")
    kzg = ProofConfig(k=K, curve="bn254", scheme="kzg-gwc",
                      transcript="keccak256", device="cpu")
    params = {"ipa": ParamsIPA.new(VESTA, K, device="cpu"),
              "kzg": params_kzg_from_jax(ref["shuffle-kzg-gwc-keccak"][1],
                                         device="cpu")}
    out = {}
    for case, (name, seed, bad_seed) in CASES.items():
        scheme = "kzg" if "kzg" in case else "ipa"
        cfg, prm = (kzg if scheme == "kzg" else ipa), params[scheme]
        circuit = _port_circuit(name)
        pk = cfg.keygen(circuit, params=prm)
        proof = cfg.prove(pk, [circuit], [[]], random.Random(seed),
                          params=prm)
        bad = cfg.prove(pk, [_port_circuit(name, bad=True)], [[]],
                        random.Random(bad_seed), params=prm)
        out[case] = (cfg, prm, pk, proof, bad)
    return out


@pytest.mark.parametrize("case", CASES)
def test_verifying_keys_equal(ref, port, case):
    vk, ref_vk = port[case][2].vk, ref[case][2].vk
    assert vk.pinned() == ref_vk.pinned()
    assert vk.transcript_repr == ref_vk.transcript_repr
    assert vk.domain.extended_k == ref_vk.domain.extended_k


@pytest.mark.parametrize("case", CASES)
def test_proof_bytes_identical(ref, port, case):
    assert port[case][3] == ref[case][3]
    assert port[case][4] == ref[case][4]


@pytest.mark.parametrize("case", CASES)
def test_each_package_verifies_the_other(ref, port, case):
    cfg, params, pk, proof, _ = port[case]
    rcfg, rparams, rpk, rproof, _ = ref[case]
    assert cfg.verify(pk.vk, rproof, [[]], params=params), \
        "the port rejects the reference's proof"
    assert rcfg.verify(rpk.vk, proof, [[]], params=rparams), \
        "the reference rejects the port's proof"
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    assert not cfg.verify(pk.vk, bytes(bad), [[]], params=params), \
        "the port accepts a tampered proof"
    assert not rcfg.verify(rpk.vk, bytes(bad), [[]], params=rparams), \
        "the reference accepts a tampered proof"


@pytest.mark.parametrize("case", CASES)
def test_non_permutation_rejected(ref, port, case):
    """A non-permutation (shuffle) or a phase-2 cell off by one (phase)."""
    cfg, params, pk, _, bad = port[case]
    rcfg, rparams, rpk, _, _ = ref[case]
    assert not cfg.verify(pk.vk, bad, [[]], params=params)
    assert not rcfg.verify(rpk.vk, bad, [[]], params=rparams)


@pytest.mark.parametrize("case", CASES)
def test_verify_proof_single(port, case):
    cfg, params, pk, proof, _ = port[case]
    _, reader, _, verifier, strategy = cfg._classes()
    assert verify_proof_single(params, pk.vk, proof, [[]], reader, verifier,
                               strategy)


def test_phase_circuit_on_kzg_commits_the_identity(ref, port):
    """PhaseCircuit's h has degree below n, so its top piece is zero; KZG
    adds no blind, so that piece commits to the point at infinity, which
    neither package's transcript writes."""
    rcfg, rparams = ref["shuffle-kzg-gwc-keccak"][:2]
    cfg, params = port["shuffle-kzg-gwc-keccak"][:2]
    for c, prm, circuit in ((rcfg, rparams, _ref_circuit("phase")),
                            (cfg, params, _port_circuit("phase"))):
        pk = c.keygen(circuit, params=prm)
        with pytest.raises(ValueError, match="points at infinity"):
            c.prove(pk, [circuit], [[]], random.Random(8), params=prm)
