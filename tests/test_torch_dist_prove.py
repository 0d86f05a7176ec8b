"""Meshed keygen and prove on a 4-shard CPU mesh: plonk_api at k=5 (the
smallest k whose four-step splits of k and extended_k a 4-shard mesh
divides), KZG / SHPLONK / Blake2b through ProofConfig(mesh_devices=4) and
IPA / Vesta through PlonkEngineConfig.set_msm(GpuMsmEngine(mesh=m),
mesh=m).  The verifying key equals the unmeshed one; the proof went
through the sharded NTT, the sharded fixed-base MSM and the sharded
permutation product, is byte-identical to the port's unmeshed proof made
in the same test under random.Random(1), verifies and rejects a tampered
byte.  test_torch_e2e.py and test_torch_ipa.py hold that unmeshed proof
equal to the reference's, live; as an extra check the meshed proof's
SHA-256 is also held against the reference's (whose `api.create_proof`
on the same circuit, k, params and seed takes over a minute to compile
here)."""

import hashlib
import random

import pytest
import torch

from halo2_tpu_torch import api
from halo2_tpu_torch.commit import (ParamsIPA, ParamsKZG, SingleStrategyKZG,
                                    VerifierSHPLONK)
from halo2_tpu_torch.compat import plonk_api
from halo2_tpu_torch.config import ProofConfig
from halo2_tpu_torch.curves import VESTA
from halo2_tpu_torch.dist import make_mesh
from halo2_tpu_torch.dist import msm as dist_msm
from halo2_tpu_torch.dist import ntt as dist_ntt
from halo2_tpu_torch.dist import scan as dist_scan
from halo2_tpu_torch.engine import GpuMsmEngine, PlonkEngineConfig
from halo2_tpu_torch.fields import BN254_FR, PASTA_FP
from tests._torch_params_cache import own_params_cache  # noqa: F401

torch.set_num_threads(1)

K = 5
SHARDS = 4
# sha256 of halo2_tpu.api.create_proof(plonk_api, k=5, random.Random(1)):
# KZG on ParamsKZG.new(5) with ProverSHPLONK, IPA on ParamsIPA.new(VESTA, 5)
REF_PROOF_SHA256 = {
    "kzg": "be1e13f7c5e6cc8687bbff5c86f4f1f1a63a9112de7e96371fb13634f5952c5b",
    "ipa": "08de8e9cb93e706deda05459ac45af3f6de0fd7c1e9ba2c42a77b51fc974137f",
}


@pytest.fixture
def sharded_calls(monkeypatch):
    """Calls of the three sharded seams, counted."""
    calls = {"ntt": 0, "msm": 0, "scan": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(dist_ntt.ShardedNTT, "_apply",
                        counting("ntt", dist_ntt.ShardedNTT._apply))
    monkeypatch.setattr(dist_msm.ShardedCachedMSM, "__call__",
                        counting("msm", dist_msm.ShardedCachedMSM.__call__))
    monkeypatch.setattr(dist_scan, "sharded_prefix_product",
                        counting("scan", dist_scan.sharded_prefix_product))
    return calls


def _check(kind, proof, unmeshed, verify, sharded_calls):
    assert all(v > 0 for v in sharded_calls.values()), sharded_calls
    assert proof == unmeshed
    assert hashlib.sha256(proof).hexdigest() == REF_PROOF_SHA256[kind]
    assert verify(proof)
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    assert not verify(bytes(bad))


def test_meshed_kzg_proof_through_proof_config(sharded_calls):
    F = BN254_FR
    params = ParamsKZG.new(K, device="cpu")
    circuit, inst = plonk_api.plonk_api_instance(F)
    cfg = ProofConfig(k=K, mesh_devices=SHARDS, device="cpu")
    one = ProofConfig(k=K, device="cpu")
    pk1 = one.keygen(circuit, params=params)
    unmeshed = one.prove(pk1, [circuit], [inst], random.Random(1),
                         params=params)
    pk = cfg.keygen(circuit, params=params)
    assert pk.vk.domain._mesh is cfg.engine().mesh
    assert pk1.vk.domain._mesh is None
    assert pk.vk.pinned() == pk1.vk.pinned()
    assert pk.vk.transcript_repr == pk1.vk.transcript_repr
    proof = cfg.prove(pk, [circuit], [inst], random.Random(1), params=params)
    _check("kzg", proof, unmeshed,
           lambda p: api.verify(params, pk.vk, p, [inst],
                                multiopen_verifier_cls=VerifierSHPLONK,
                                strategy_cls=SingleStrategyKZG),
           sharded_calls)


def test_meshed_ipa_proof_through_the_engine(sharded_calls):
    F = PASTA_FP
    params = ParamsIPA.new(VESTA, K, device="cpu")
    circuit, inst = plonk_api.plonk_api_instance(F)
    pk1 = api.keygen(F, params, K, circuit)
    unmeshed = api.create_proof(params, pk1, [circuit], [inst],
                                random.Random(1))
    mesh = make_mesh(SHARDS, "cpu")
    engine = PlonkEngineConfig.set_msm(GpuMsmEngine(mesh=mesh), mesh=mesh)
    pk = api.keygen(F, params, K, circuit, engine=engine)
    assert pk.vk.pinned() == pk1.vk.pinned()
    proof = api.create_proof(params, pk, [circuit], [inst],
                             random.Random(1), engine=engine)
    _check("ipa", proof, unmeshed,
           lambda p: api.verify(params, pk.vk, p, [inst]), sharded_calls)
