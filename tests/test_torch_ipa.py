"""IPA over Vesta (the reference's default proving system) in the port
against the JAX reference at k=5 on plonk_api: equal parameters, the Rust
golden pinned verifying key byte for byte, byte-identical proofs under
random.Random(1), and each package verifying the other's proof (and
rejecting a tampered one).  Last, the port's BatchVerifier: the two batch
tests of test_dev_tools.py ported to this circuit, and the reference's
proof accepted in a batch."""

import os
import random
from unittest import mock

import pytest
import torch

from halo2_tpu import api as ref_api
from halo2_tpu.commit.ipa import ParamsIPA as RefParamsIPA
from halo2_tpu.compat.plonk_api import plonk_api_instance
from halo2_tpu.curves.constants import VESTA as REF_VESTA
from halo2_tpu.fields.constants import PASTA_FP as REF_F
from halo2_tpu_torch import api
from halo2_tpu_torch.commit import ParamsIPA
from halo2_tpu_torch.compat import plonk_api
from halo2_tpu_torch.compat.from_jax import params_ipa_from_jax
from halo2_tpu_torch.curves import VESTA
from halo2_tpu_torch.fields import PASTA_FP as F
from halo2_tpu_torch.plonk import BatchVerifier
from halo2_tpu_torch.plonk import batch as batch_mod
from tests._torch_params_cache import own_params_cache  # noqa: F401

# The plain versions run many small tensor ops: one thread per worker
# is as fast and leaves the other cores to the other test workers.
torch.set_num_threads(1)

K = 5
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "plonk_api_pinned_vk_ipa_vesta_k5.txt")


@pytest.fixture(scope="module")
def ref():
    params = RefParamsIPA.new(REF_VESTA, K)
    circuit, inst = plonk_api_instance(REF_F)
    pk = ref_api.keygen(REF_F, params, K, circuit)
    proof = ref_api.create_proof(params, pk, [circuit], [inst],
                                 random.Random(1))
    return params, pk, proof, inst


@pytest.fixture(scope="module")
def port():
    params = ParamsIPA.new(VESTA, K, device="cpu")
    circuit, inst = plonk_api.plonk_api_instance(F)
    pk = api.keygen(F, params, K, circuit)
    proof = api.create_proof(params, pk, [circuit], [inst], random.Random(1))
    return params, pk, proof, inst


def _tampered(proof: bytes, at: int) -> bytes:
    bad = bytearray(proof)
    bad[at] ^= 1
    return bytes(bad)


def test_params_match_reference(ref, port):
    ours, theirs = port[0], ref[0]
    assert ours.g_aff == theirs.g_aff
    assert ours.g_lagrange_aff == theirs.g_lagrange_aff
    assert (ours.w_aff, ours.u_aff) == (theirs.w_aff, theirs.u_aff)
    converted = params_ipa_from_jax(theirs, device="cpu")
    assert torch.equal(converted.g, ours.g)
    assert torch.equal(converted.g_lagrange, ours.g_lagrange)


def test_params_serde_roundtrip(ref, port):
    data = port[0].write()
    assert data == ref[0].write()
    back = ParamsIPA.read(VESTA, data, device="cpu")
    assert torch.equal(back.g, port[0].g)
    assert torch.equal(back.g_lagrange, port[0].g_lagrange)


def test_pinned_vk_matches_rust_golden(port):
    with open(FIXTURE) as f:
        assert port[1].vk.pinned() == f.read()


def test_proof_bytes_identical(ref, port):
    assert port[2] == ref[2]


def test_each_package_verifies_the_other(ref, port):
    params, pk, proof, _ = port
    ref_params, ref_pk, ref_proof, inst = ref
    assert api.verify(params, pk.vk, ref_proof, [inst])
    assert ref_api.verify(ref_params, ref_pk.vk, proof, [inst])
    bad = _tampered(proof, len(proof) // 2)
    assert not api.verify(params, pk.vk, bad, [inst])
    assert not ref_api.verify(ref_params, ref_pk.vk, bad, [inst])
    assert not api.verify(params, pk.vk, proof, [[[3]]])


def test_entry_points_default_to_cuda(ref):
    """Params made without a device land on the card; with no card visible
    they raise instead of running on the CPU."""
    from halo2_tpu_torch.commit import ParamsKZG
    makers = [lambda: ParamsKZG.new(4), lambda: ParamsIPA.new(VESTA, 3),
              lambda: params_ipa_from_jax(ref[0])]
    for make in makers:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


def test_accumulator_strategy_folds_proofs(port):
    """AccumulatorStrategyIPA folds several proofs' MSMs under random
    scalings and checks them once; a wrong opening scalar fails it."""
    from halo2_tpu_torch.commit import AccumulatorStrategyIPA, VerifierIPA
    from halo2_tpu_torch.plonk.verifier import verify_proof
    from halo2_tpu_torch.transcript import Blake2bRead
    params, pk, proof, inst = port
    bad = _tampered(proof, len(proof) - 32)          # the last scalar, f
    for proofs, want in (((proof, proof), True), ((proof, bad), False)):
        strategy = AccumulatorStrategyIPA(params, random.Random(5))
        for pr in proofs:
            t = Blake2bRead(params.curve, pr)
            queries = verify_proof(params, pk.vk, t, [inst], True)
            strategy.process(
                lambda m: VerifierIPA(params).verify_proof(t, queries, m))
        assert strategy.finalize() is want


def _batch(params, vk, proofs, inst, seed=0) -> bool:
    batch = BatchVerifier(random.Random(seed))
    for proof in proofs:
        batch.add_proof([inst], proof)
    return batch.finalize(params, vk)


def test_batch_verifier(port):
    """Two honest proofs pass as a batch; with one tampered, cut short or
    empty (the port's VerifyError), the batch fails."""
    params, pk, proof, inst = port
    circuit, _ = plonk_api.plonk_api_instance(F)
    other = api.create_proof(params, pk, [circuit], [inst], random.Random(12))
    assert _batch(params, pk.vk, [proof, other], inst)
    assert not _batch(params, pk.vk, [proof, _tampered(other, 50)], inst)
    assert not _batch(params, pk.vk, [proof, other[:-32]], inst)
    assert not _batch(params, pk.vk, [proof, b""], inst)


def test_batch_verifier_accepts_the_reference_proof(ref, port):
    params, pk, proof, inst = port
    assert _batch(params, pk.vk, [ref[2], proof, ref[2]], inst, seed=5)


def test_batch_verifier_canceling_errors(port):
    """batch.rs:96-106: the accumulator is rescaled by a fresh random
    factor before each proof's MSM folds in, so two stub guards whose MSMs
    cancel ([s]W and [-s]W) do not pass as a valid batch."""
    params, pk, _, _ = port
    errors = [12345, params.curve.Fr.p - 12345]

    class FakeGuard:
        def __init__(self, scalar):
            self.scalar = scalar

        def use_challenges(self):
            m = params.empty_msm()
            m.append_term(self.scalar, params.w_aff)
            return m

    class FakeVerifier:
        QUERY_INSTANCE = True

        def __init__(self, _params):
            pass

        def verify_proof(self, transcript, queries, msm):
            assert not msm.terms and msm.g_scalars is None
            return FakeGuard(errors.pop(0))

    batch = BatchVerifier(random.Random(7))
    batch.add_proof([], b"")
    batch.add_proof([], b"")
    with mock.patch.object(batch_mod, "VerifierIPA", FakeVerifier), \
            mock.patch.object(batch_mod, "backend_verify_queries",
                              lambda *a, **k: []):
        assert not batch.finalize(params, pk.vk)
