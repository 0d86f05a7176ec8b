"""lookup_heavy (four 16-bit range lookups per row) at its smallest k,
KZG / SHPLONK / Blake2b, against the JAX reference: equal verifying keys,
byte-identical proofs under random.Random(1), and each package verifying
the other's proof (and rejecting a tampered one).  Split from
test_torch_e2e.py so that test workers share the load."""

import random

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
