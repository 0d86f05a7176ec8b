"""The public names the port took over from modules it had already
ported, each against the JAX reference: the IPA recursion surface
(GuardIPA.use_g / compute_g / use_g_with_computed, Accumulator),
ParamsKZG.downsize, AccumulatorStrategyKZG, compute_inner_product, the
domain's rotate_lagrange, get_quotient_poly_degree, empty_* and
constant_*, and PlonkEngineConfig.  Exact equality."""

import random

import pytest
import torch

from halo2_tpu.commit import (AccumulatorStrategyKZG as RefAccKZG,
                              Blind as RefBlind, ParamsIPA as RefParamsIPA,
                              ParamsKZG as RefParamsKZG,
                              PolyRef as RefPolyRef,
                              ProverGWC as RefProverGWC,
                              ProverQuery as RefProverQuery,
                              VerifierGWC as RefVerifierGWC,
                              VerifierQuery as RefVerifierQuery)
from halo2_tpu.commit.ipa import (create_opening_proof as ref_open,
                                  verify_opening_proof as ref_verify_open)
from halo2_tpu.curves import BN254_G1 as REF_BN254, VESTA as REF_VESTA
from halo2_tpu.fields import BN254_FR as REF_F
from halo2_tpu.poly import EvaluationDomain as RefDomain
from halo2_tpu.poly import compute_inner_product as ref_inner_product
from halo2_tpu.poly.domain import Rotation as RefRotation
from halo2_tpu.transcript import Blake2bRead as RefRead
from halo2_tpu.transcript import Blake2bWrite as RefWrite
from halo2_tpu_torch.commit import (Accumulator, AccumulatorStrategyKZG,
                                    Blind, ParamsIPA, PolyRef, ProverGWC,
                                    ProverQuery, VerifierGWC, VerifierQuery)
from halo2_tpu_torch.commit.ipa import (create_opening_proof,
                                        verify_opening_proof)
from halo2_tpu_torch.compat.from_jax import params_kzg_from_jax
from halo2_tpu_torch.curves import BN254_G1, VESTA
from halo2_tpu_torch.engine import (GpuMsmEngine, H2cEngine, PlonkEngine,
                                    PlonkEngineConfig)
from halo2_tpu_torch.fields import BN254_FR as F
from halo2_tpu_torch.poly import EvaluationDomain, compute_inner_product
from halo2_tpu_torch.poly import Rotation
from halo2_tpu_torch.poly.poly import Poly
from halo2_tpu_torch.transcript import Blake2bRead, Blake2bWrite
from tests._torch_params_cache import own_params_cache  # noqa: F401

torch.set_num_threads(1)

K = 4
SEEDS = (11, 12)      # the two GWC proofs an accumulator folds


def ipa_opening(curve, params, Blind, open_fn, Write, encode):
    """An IPA opening proof of a random polynomial at a random point:
    (commitment, x, v, proof)."""
    p = curve.Fr.p
    rng = random.Random(3)
    poly_int = [rng.randrange(p) for _ in range(params.n)]
    blind = Blind(rng.randrange(p))
    poly = encode(poly_int)
    comm = params.commit_affine(poly, blind)
    x = rng.randrange(p)
    v = sum(c * pow(x, i, p) for i, c in enumerate(poly_int)) % p
    t = Write(curve)
    open_fn(params, rng, t, poly, blind, x)
    return comm, x, v, t.finalize()


def gwc_proof(params, curve, seed, Blind, PolyRef, ProverQuery, ProverGWC,
              encode, Write):
    """A one-polynomial GWC opening at x: (commitment, x, eval, proof)."""
    p = curve.Fr.p
    rng = random.Random(seed)
    coeffs = [rng.randrange(p) for _ in range(params.n)]
    ref = PolyRef(encode(coeffs), Blind(0))
    x = rng.randrange(p)
    ev = sum(c * pow(x, i, p) for i, c in enumerate(coeffs)) % p
    t = Write(curve)
    ProverGWC(params).create_proof(rng, t, [ProverQuery(x, ref)])
    return params.commit_affine(ref.poly), x, ev, t.finalize()


def accumulate(params, proofs, VerifierQuery, VerifierGWC, Strategy, Read,
               curve, tamper: bool):
    """Fold the GWC proofs into one accumulator (the last one's eval
    tampered if asked) and finalize."""
    strategy = Strategy(params, random.Random(5))
    for i, (comm, x, ev, proof) in enumerate(proofs):
        ev = (ev + (tamper and i == len(proofs) - 1)) % curve.Fr.p
        r = Read(curve, proof)
        q = [VerifierQuery(x, comm, ev)]
        strategy.process(
            lambda msm: VerifierGWC(params).verify_proof(r, q, msm))
    return strategy.finalize()


@pytest.fixture(scope="module")
def ref():
    ipa = RefParamsIPA.new(REF_VESTA, K)
    comm, x, v, proof = ipa_opening(REF_VESTA, ipa, RefBlind, ref_open,
                                    RefWrite, REF_VESTA.Fr.encode_ints)
    msm = ipa.empty_msm()
    msm.append_term(1, comm)
    guard = ref_verify_open(ipa, msm, RefRead(REF_VESTA, proof), x, v)
    g = guard.compute_g()
    _, acc = guard.use_g(g)
    kzg = RefParamsKZG.new(K)
    small = kzg.downsize(K - 1)
    gwc = [gwc_proof(kzg, REF_BN254, s, RefBlind, RefPolyRef, RefProverQuery,
                     RefProverGWC, REF_F.encode_ints, RefWrite)
           for s in SEEDS]
    accumulated = [accumulate(kzg, gwc, RefVerifierQuery, RefVerifierGWC,
                              RefAccKZG, RefRead, REF_BN254, t)
                   for t in (False, True)]
    return dict(ipa_proof=proof, g=g, acc=acc, kzg=kzg,
                small=(small.g_aff, small.g_lagrange_aff), gwc=gwc,
                accumulated=accumulated)


@pytest.fixture(scope="module")
def ipa_guard(ref):
    params = ParamsIPA.new(VESTA, K, device="cpu")
    comm, x, v, proof = ipa_opening(
        VESTA, params, Blind, create_opening_proof, Blake2bWrite,
        lambda c: VESTA.Fr.encode_ints(c, "cpu"))
    assert proof == ref["ipa_proof"]

    def fresh():
        msm = params.empty_msm()
        msm.append_term(1, comm)
        return verify_opening_proof(params, msm, Blake2bRead(VESTA, proof),
                                    x, v)
    return fresh


def test_guard_compute_g_and_use_g_match_reference(ref, ipa_guard):
    assert ipa_guard().use_challenges().check()
    guard = ipa_guard()
    g = guard.compute_g()
    assert g == ref["g"]
    msm, acc = guard.use_g(g)
    assert msm.check()
    assert isinstance(acc, Accumulator)
    assert (acc.g, acc.u_packed) == (ref["acc"].g, ref["acc"].u_packed)
    msm2, acc2 = ipa_guard().use_g_with_computed()
    assert msm2.check() and acc2 == acc
    # a purported G that is not <s, g> fails the check
    wrong, _ = ipa_guard().use_g((VESTA.gen_x, VESTA.gen_y))
    assert not wrong.check()


def test_params_kzg_downsize_matches_reference(ref):
    params = params_kzg_from_jax(ref["kzg"], device="cpu")
    small = params.downsize(K - 1)
    assert (small.k, small.n) == (K - 1, 1 << (K - 1))
    assert (small.g_aff, small.g_lagrange_aff) == ref["small"]
    assert small.s_secret == params.s_secret
    assert params.n == 1 << K


def test_accumulator_strategy_kzg_matches_reference(ref):
    params = params_kzg_from_jax(ref["kzg"], device="cpu")
    proofs = [gwc_proof(params, BN254_G1, s, Blind, PolyRef, ProverQuery,
                        ProverGWC, lambda c: F.encode_ints(c, "cpu"),
                        Blake2bWrite) for s in SEEDS]
    assert proofs == ref["gwc"]
    got = [accumulate(params, proofs, VerifierQuery, VerifierGWC,
                      AccumulatorStrategyKZG, Blake2bRead, BN254_G1, t)
           for t in (False, True)]
    assert got == ref["accumulated"] == [True, False]


@pytest.mark.parametrize("rows", [1, 5, 64])
def test_compute_inner_product_matches_reference(rows):
    rng = random.Random(rows)
    a = [rng.randrange(F.p) for _ in range(rows)]
    b = [rng.randrange(F.p) for _ in range(rows)]
    got = F.decode_int(compute_inner_product(
        F, F.encode_ints(a, "cpu"), F.encode_ints(b, "cpu")))
    want = REF_F.decode_int(ref_inner_product(
        REF_F, REF_F.encode_ints(a), REF_F.encode_ints(b)))
    assert got == want == sum(x * y for x, y in zip(a, b)) % F.p


@pytest.mark.parametrize("j", [3, 5, 9])
def test_domain_helpers_match_reference(j):
    ours = EvaluationDomain(F, j, K, "cpu")
    theirs = RefDomain(REF_F, j, K)
    assert ours.get_quotient_poly_degree() == \
        theirs.get_quotient_poly_degree() == j - 1
    rng = random.Random(j)
    vals = [rng.randrange(F.p) for _ in range(ours.n)]
    for rot in (1, -1, 3, -5):
        got = ours.rotate_lagrange(Poly.lagrange(F.encode_ints(vals, "cpu")),
                                   Rotation(rot))
        assert got.basis == "lagrange"
        want = theirs.rotate_lagrange(REF_F.encode_ints(vals),
                                      RefRotation(rot))
        assert F.decode_ints(got.values) == REF_F.decode_ints(want)
    for name, batch in (("empty_lagrange", (2,)), ("empty_coeff", ()),
                        ("empty_extended", (3,))):
        got, want = getattr(ours, name)(batch), getattr(theirs, name)(batch)
        assert got.shape[:-1] == want.shape[:-1]
        assert F.decode_ints(got.reshape(-1, 8)) == \
            REF_F.decode_ints(want.reshape(-1, want.shape[-1]))
    for name in ("constant_lagrange", "constant_extended"):
        got, want = getattr(ours, name)(F.p - 2), getattr(theirs, name)(F.p - 2)
        assert F.decode_ints(got) == REF_F.decode_ints(want)


def test_plonk_engine_config():
    default = PlonkEngineConfig.build_default()
    assert isinstance(default, PlonkEngine)
    assert isinstance(default.msm_backend, GpuMsmEngine)
    plain = H2cEngine()
    assert PlonkEngineConfig.set_msm(plain).msm_backend is plain
