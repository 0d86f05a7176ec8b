"""The port's main path — plonk_api at k=5, KZG / SHPLONK / Blake2b — against
the JAX reference: the same SRS, equal verifying keys (also through
keygen_vk, as VK bytes), byte-identical proofs under random.Random(1), also
with the sorted fixed-base MSM (GpuMsmEngine(style="sorted")), and each
package verifying the other's proof (and rejecting a tampered one).
lookup_heavy is in test_torch_e2e_lookup.py."""

import random

import pytest
import torch

from halo2_tpu import api as ref_api
from halo2_tpu.commit import (ParamsKZG as RefParamsKZG,
                              ProverSHPLONK as RefProverSHPLONK,
                              SingleStrategyKZG as RefSingleStrategyKZG,
                              VerifierSHPLONK as RefVerifierSHPLONK)
from halo2_tpu.compat import serde as ref_serde
from halo2_tpu.compat.plonk_api import plonk_api_instance
from halo2_tpu.fields import BN254_FR as REF_F
from halo2_tpu_torch import api
from halo2_tpu_torch.commit import (ParamsKZG, ProverSHPLONK,
                                    SingleStrategyKZG, VerifierSHPLONK)
from halo2_tpu_torch.compat import SerdeFormat, plonk_api, vk_write
from halo2_tpu_torch.compat.from_jax import params_kzg_from_jax
from halo2_tpu_torch.engine import GpuMsmEngine, PlonkEngineConfig
from halo2_tpu_torch.fields import BN254_FR as F
from halo2_tpu_torch.frontend import compile_circuit
from halo2_tpu_torch.msm import CachedMSM
from halo2_tpu_torch.plonk import keygen_vk

# The plain versions run many small tensor ops: one thread per worker
# is as fast and leaves the other cores to the other test workers.
torch.set_num_threads(1)

K = 5


@pytest.fixture(scope="module")
def ref():
    params = RefParamsKZG.new(K)
    circuit, inst = plonk_api_instance(REF_F)
    pk = ref_api.keygen(REF_F, params, K, circuit)
    proof = ref_api.create_proof(params, pk, [circuit], [inst],
                                 random.Random(1),
                                 multiopen_prover_cls=RefProverSHPLONK)
    return params, pk, proof, inst


@pytest.fixture(scope="module")
def port(ref):
    params = params_kzg_from_jax(ref[0], device="cpu")
    circuit, inst = plonk_api.plonk_api_instance(F)
    pk = api.keygen(F, params, K, circuit)
    timings = {}
    proof = api.create_proof(params, pk, [circuit], [inst], random.Random(1),
                             multiopen_prover_cls=ProverSHPLONK,
                             timings=timings)
    return params, pk, proof, timings


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


def test_params_new_matches_reference(ref):
    ours = ParamsKZG.new(K, device="cpu")
    theirs = ref[0]
    assert ours.g_aff == theirs.g_aff
    assert ours.g_lagrange_aff == theirs.g_lagrange_aff
    assert (ours.g2, ours.s_g2, ours.s_secret) == \
        (theirs.g2, theirs.s_g2, theirs.s_secret)
    converted = params_kzg_from_jax(theirs, device="cpu")
    assert torch.equal(converted.g, ours.g)
    assert torch.equal(converted.g_lagrange, ours.g_lagrange)


def test_verifying_key_matches_reference(ref, port):
    vk, ref_vk = port[1].vk, ref[1].vk
    assert vk.transcript_repr == ref_vk.transcript_repr
    assert vk.fixed_commitments == ref_vk.fixed_commitments
    assert vk.permutation.commitments == ref_vk.permutation.commitments
    assert (vk.domain.k, vk.domain.extended_k, vk.cs_degree) == \
        (ref_vk.domain.k, ref_vk.domain.extended_k, ref_vk.cs_degree)


def test_proof_bytes_identical(ref, port):
    assert port[2] == ref[2]
    assert len(port[2]) == 2208
    assert {"lookup_permute [T5-6]", "grand_products [T9-11]",
            "evaluate_h [T13]", "multiopen [T24+]"} <= set(port[3])


def test_each_package_verifies_the_other(ref, port):
    params, pk, proof, _ = port
    inst = ref[3]
    assert _verify(params, pk.vk, ref[2], inst)
    assert _ref_verify(ref, proof)
    for at in (40, len(proof) - 1):
        assert not _verify(params, pk.vk, _tampered(proof, at), inst)
        assert not _ref_verify(ref, _tampered(proof, at))
    assert not _verify(params, pk.vk, proof, [[3]])
    assert not _verify(params, pk.vk, proof[:-32], inst)


def test_keygen_vk_matches_reference(ref, port):
    """keygen_vk's VK, written in every SerdeFormat, equals the
    reference's keygen(...).vk byte for byte."""
    params = port[0]
    circuit, _ = plonk_api.plonk_api_instance(F)
    compiled = compile_circuit(F, K, circuit)[0]
    vk = keygen_vk(F, params, compiled, K)
    for fmt in SerdeFormat:
        assert vk_write(vk, fmt) == ref_serde.vk_write(
            ref[1].vk, ref_serde.SerdeFormat[fmt.name])


def test_sorted_msm_engine_proves_the_same_bytes(port):
    """Under GpuMsmEngine(style="sorted") every commitment runs CachedMSM;
    keygen gives the same VK and the first proof the same bytes as the
    stream engine's, which test_proof_bytes_identical holds to the
    reference's."""
    params, pk, proof, _ = port
    saved = params.engine
    params.set_engine(PlonkEngineConfig.set_msm(
        GpuMsmEngine(style="sorted")))
    try:
        circuit, inst = plonk_api.plonk_api_instance(F)
        spk = api.keygen(F, params, K, circuit)
        assert spk.vk.pinned() == pk.vk.pinned()
        sproof = api.create_proof(params, spk, [circuit], [inst],
                                  random.Random(1),
                                  multiopen_prover_cls=ProverSHPLONK)
        descs = [d for _, d in params.engine.msm_backend._cache.values()]
        assert len(descs) == 2 and all(isinstance(d, CachedMSM)
                                       for d in descs)
    finally:
        params.set_engine(saved)
    assert sproof == proof
