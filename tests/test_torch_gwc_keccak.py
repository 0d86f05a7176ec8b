"""The port's Keccak256, its transcripts, the GWC multiopen and
ProofConfig against the JAX reference: Keccak's known vectors on the
native and the pure-Python side; Blake2b and Keccak256 transcript round
trips with equal bytes and challenges; a GWC multiopen proof with
byte-identical output that each package verifies; ProofConfig's checks,
its class resolution and one round trip.  Exact equality."""

import random

import pytest
import torch

from halo2_tpu import transcript as ref_tr
from halo2_tpu.commit import (Blind as RefBlind, ParamsKZG as RefParamsKZG,
                              PolyRef as RefPolyRef,
                              ProverGWC as RefProverGWC,
                              ProverQuery as RefProverQuery,
                              SingleStrategyKZG as RefSingleStrategyKZG,
                              VerifierGWC as RefVerifierGWC,
                              VerifierQuery as RefVerifierQuery)
from halo2_tpu.config import ProofConfig as RefProofConfig
from halo2_tpu.curves import BN254_G1 as REF_BN254, VESTA as REF_VESTA
from halo2_tpu.fields import BN254_FR as REF_F
from halo2_tpu_torch import native, transcript as tr
from halo2_tpu_torch.commit import (Blind, PolyRef, ProverGWC, ProverQuery,
                                    SingleStrategyKZG, VerifierGWC,
                                    VerifierQuery)
from halo2_tpu_torch.compat import plonk_api
from halo2_tpu_torch.compat.from_jax import params_kzg_from_jax
from halo2_tpu_torch.config import ProofConfig
from halo2_tpu_torch.curves import BN254_G1, VESTA
from halo2_tpu_torch.fields import BN254_FR as F
from halo2_tpu_torch.poly import eval_polynomial_int
from tests._torch_params_cache import own_params_cache  # noqa: F401

torch.set_num_threads(1)

K_GWC = 4
CURVES = {"vesta": (VESTA, REF_VESTA), "bn254": (BN254_G1, REF_BN254)}
KINDS = {"blake2b": ("Blake2bWrite", "Blake2bRead"),
         "keccak256": ("Keccak256Write", "Keccak256Read")}


def roundtrip(curve, Write, Read):
    """Points, scalars and common input through a writer and back through
    a reader: the proof bytes and the challenges on the way."""
    g = (curve.gen_x, curve.gen_y)
    pts = [g, (g[0], (-g[1]) % curve.Fq.p)]
    scalars = [0, 7, curve.Fr.p - 1]
    w = Write(curve)
    w_ch = [w.squeeze_challenge()]
    for pt in pts:
        w.write_point(pt)
    w_ch.append(w.squeeze_challenge())
    for s in scalars:
        w.write_scalar(s)
    w_ch.append(w.squeeze_challenge())
    w.common_scalar(42)
    w_ch.append(w.squeeze_challenge())
    proof = w.finalize()

    r = Read(curve, proof)
    r_ch = [r.squeeze_challenge()]
    assert r.read_n_points(len(pts)) == pts
    r_ch.append(r.squeeze_challenge())
    assert r.read_n_scalars(len(scalars)) == scalars
    r_ch.append(r.squeeze_challenge())
    r.common_scalar(42)
    r_ch.append(r.squeeze_challenge())
    assert w_ch == r_ch
    return proof, w_ch


def gwc_case(p, n):
    """Two polynomials as ints, queried at x (both) and z (the second)."""
    rng = random.Random(1)
    polys = [[rng.randrange(p) for _ in range(n)] for _ in range(2)]
    x, z = 111, 222
    evals = {(0, x): eval_polynomial_int(p, polys[0], x),
             (1, x): eval_polynomial_int(p, polys[1], x),
             (1, z): eval_polynomial_int(p, polys[1], z)}
    return polys, x, z, evals


def gwc_prove(params, curve, Blind, PolyRef, ProverQuery, ProverGWC, encode,
              Write):
    p = curve.Fr.p
    polys, x, z, evals = gwc_case(p, params.n)
    refs = [PolyRef(encode(c), Blind(0)) for c in polys]
    t = Write(curve)
    for r in refs:
        t.write_point(params.commit_affine(r.poly))
    for key in sorted(evals):
        t.write_scalar(evals[key])
    ProverGWC(params).create_proof(random.Random(2), t, [
        ProverQuery(x, refs[0]), ProverQuery(x, refs[1]),
        ProverQuery(z, refs[1])])
    return t.finalize()


def gwc_verify(params, curve, proof, VerifierQuery, VerifierGWC, Strategy,
               Read, tamper=None):
    p = curve.Fr.p
    _, x, z, evals = gwc_case(p, params.n)
    r = Read(curve, proof)
    cs = r.read_n_points(2)
    es = {key: r.read_scalar() for key in sorted(evals)}
    if tamper:
        es[tamper] = (es[tamper] + 1) % p
    vq = [VerifierQuery(x, cs[0], es[(0, x)]),
          VerifierQuery(x, cs[1], es[(1, x)]),
          VerifierQuery(z, cs[1], es[(1, z)])]
    return Strategy(params).process(
        lambda msm: VerifierGWC(params).verify_proof(r, vq, msm))


@pytest.fixture(scope="module")
def ref():
    rounds = {(c, k): roundtrip(CURVES[c][1], getattr(ref_tr, KINDS[k][0]),
                                getattr(ref_tr, KINDS[k][1]))
              for c in CURVES for k in KINDS}
    params = RefParamsKZG.new(K_GWC)
    gwc = {k: gwc_prove(params, REF_BN254, RefBlind, RefPolyRef,
                        RefProverQuery, RefProverGWC, REF_F.encode_ints,
                        getattr(ref_tr, KINDS[k][0])) for k in KINDS}
    return rounds, params, gwc


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
def test_keccak256_known_vectors(use_native, monkeypatch):
    if not use_native:
        # no native library: the pure-Python sponge
        monkeypatch.setattr(native, "get_lib", lambda: None)
    K = tr.Keccak256
    assert (K()._native is not None) == \
        (use_native and native.get_lib() is not None)
    assert K().digest().hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    assert K().update(b"abc").digest().hex() == (
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45")
    # incremental == one shot across the rate boundary
    msg = bytes(range(256))
    one = K().update(msg).digest()
    inc = K()
    for b in msg:
        inc.update(bytes([b]))
    assert inc.digest() == one == ref_tr.Keccak256().update(msg).digest()
    # digest() does not consume the state; a copy diverges from its source
    k = K().update(b"abc")
    c = k.copy().update(b"d")
    assert k.digest() == k.digest() == K().update(b"abc").digest()
    assert c.digest() == K().update(b"abcd").digest()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("curve", CURVES)
def test_transcript_roundtrip_matches_reference(ref, curve, kind):
    proof, challenges = roundtrip(CURVES[curve][0],
                                  getattr(tr, KINDS[kind][0]),
                                  getattr(tr, KINDS[kind][1]))
    assert (proof, challenges) == ref[0][(curve, kind)]
    assert all(0 < c < CURVES[curve][0].Fr.p for c in challenges)


@pytest.mark.parametrize("kind", KINDS)
def test_gwc_multiopen_matches_reference(ref, kind):
    _, ref_params, ref_proofs = ref
    params = params_kzg_from_jax(ref_params, device="cpu")
    Write, Read = (getattr(tr, n) for n in KINDS[kind])
    proof = gwc_prove(params, BN254_G1, Blind, PolyRef, ProverQuery,
                      ProverGWC, lambda c: F.encode_ints(c, "cpu"), Write)
    assert proof == ref_proofs[kind]
    ours = (params, BN254_G1, proof, VerifierQuery, VerifierGWC,
            SingleStrategyKZG, Read)
    assert gwc_verify(*ours)
    _, x, z, _ = gwc_case(F.p, params.n)
    assert not gwc_verify(*ours, tamper=(1, z))
    assert gwc_verify(ref_params, REF_BN254, proof, RefVerifierQuery,
                      RefVerifierGWC, RefSingleStrategyKZG,
                      getattr(ref_tr, KINDS[kind][1]))


@pytest.mark.parametrize("kw", [
    dict(curve="pallas", scheme="kzg-gwc"), dict(curve="bn254", scheme="ipa"),
    dict(curve="nope"), dict(scheme="kzg"), dict(transcript="sha256")])
def test_proof_config_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        RefProofConfig(k=5, **kw)
    with pytest.raises(ValueError):
        ProofConfig(k=5, device="cpu", **kw)


def test_proof_config_mesh_raises():
    """A mesh of more devices than are visible raises, in the port as in
    the reference, and never shrinks (the meshed proves themselves are in
    test_torch_dist_prove.py)."""
    import jax
    with pytest.raises(ValueError):
        RefProofConfig(k=5, mesh_devices=len(jax.devices()) + 1).engine()
    with pytest.raises(ValueError, match="CUDA devices"):
        ProofConfig(k=5, mesh_devices=torch.cuda.device_count() + 1).engine()
    assert ProofConfig(k=5, mesh_devices=4,
                       device="cpu").engine().mesh.size == 4


@pytest.mark.parametrize("scheme,curve", [
    ("ipa", "vesta"), ("ipa", "pallas"), ("kzg-gwc", "bn254"),
    ("kzg-shplonk", "bn254")])
@pytest.mark.parametrize("kind", KINDS)
def test_proof_config_resolves_like_reference(scheme, curve, kind):
    ours = ProofConfig(k=5, curve=curve, scheme=scheme, transcript=kind,
                       device="cpu")
    theirs = RefProofConfig(k=5, curve=curve, scheme=scheme, transcript=kind)
    assert [c.__name__ for c in ours._classes()] == \
        [c.__name__ for c in theirs._classes()]
    assert ours.F.p == theirs.F.p
    assert ours.curve_obj.name == theirs.curve_obj.name


def test_proof_config_roundtrip_kzg_shplonk_keccak():
    cfg = ProofConfig(k=5, curve="bn254", scheme="kzg-shplonk",
                      transcript="keccak256", device="cpu")
    circuit, inst = plonk_api.plonk_api_instance(cfg.F)
    params = cfg.params()
    assert params.device.type == "cpu"
    pk = cfg.keygen(circuit, params=params)
    proof = cfg.prove(pk, [circuit], [inst], random.Random(9), params=params)
    assert cfg.verify(pk.vk, proof, [inst], params=params)
    bad = bytearray(proof)
    bad[40] ^= 1
    assert not cfg.verify(pk.vk, bytes(bad), [inst], params=params)
