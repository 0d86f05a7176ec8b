"""The lying multiopen of tests/test_multiopen_negative.py in the port, one
case per scheme (IPA over Vesta, KZG / GWC and KZG / SHPLONK over BN254,
k=4): three random polynomials opened at five (polynomial, point) queries
on two rotation sets.  The opening proof must hash to the reference's, the
verifier must accept the honest evaluations, and it must reject a lie
(one evaluation plus 1) at every one of the five positions.

The reference's openings take minutes to compile on a CPU, so their
digests are pinned; the same function below drives either package and
computed them:

    JAX_PLATFORMS=cpu python -m tests.test_torch_multiopen_negative
"""

import hashlib
import importlib
import random

import pytest
import torch

from tests._torch_params_cache import own_params_cache  # noqa: F401

torch.set_num_threads(1)

K = 4
SCHEMES = {"ipa": ("VESTA", "IPA", "IPA", "IPA"),
           "gwc": ("BN254_G1", "KZG", "GWC", "KZG"),
           "shplonk": ("BN254_G1", "KZG", "SHPLONK", "KZG")}

# sha256 of the reference's opening proofs, from the command in the docstring
REF_OPENING_SHA256 = {
    "ipa":  # 704 bytes
        "ce078b1c59aed2987694384a795ad0658a1ff89505ba820119998a6f914d86f4",
    "gwc":  # 320 bytes
        "669e87a72d566f423deffa8565c3a299cf48d771b430ee6ab0fe7511d2f0f24b",
    "shplonk":  # 320 bytes
        "0355f15c5d0bf1e5787077188066402f2b1114248d6580536a8efa040eb79af5",
}


def opening(pkg: str, scheme: str):
    """The opening proof of `scheme` in package `pkg` and a function
    lie -> does the verifier accept, for lie None (honest) or a query."""
    commit = importlib.import_module(f"{pkg}.commit")
    curves = importlib.import_module(f"{pkg}.curves")
    arith = importlib.import_module(f"{pkg}.poly.arith")
    transcript = importlib.import_module(f"{pkg}.transcript")
    device = {} if pkg == "halo2_tpu" else {"device": "cpu"}
    curve_name, params_kind, multiopen, strategy = SCHEMES[scheme]
    curve = getattr(curves, curve_name)
    params = (commit.ParamsIPA.new(curve, K, **device) if params_kind == "IPA"
              else commit.ParamsKZG.new(K, **device))
    prover_cls = getattr(commit, f"Prover{multiopen}")
    verifier_cls = getattr(commit, f"Verifier{multiopen}")
    strategy_cls = getattr(commit, f"SingleStrategy{strategy}")
    F = curve.Fr
    p = F.p
    rng = random.Random(99)
    polys = [[rng.randrange(p) for _ in range(params.n)] for _ in range(3)]
    refs = [commit.PolyRef(F.encode_ints(c, **device),
                           commit.Blind.random(F, rng))
            for c in polys]
    comms = [params.commit_affine(r.poly, r.blind) for r in refs]
    x, y = 48278743, 938283942
    keys = [(0, x), (1, x), (1, y), (2, x), (2, y)]
    evals = {q: arith.eval_polynomial_int(p, polys[q[0]], q[1]) for q in keys}
    t = transcript.Blake2bWrite(curve)
    for c in comms:
        t.write_point(c)
    for q in keys:
        t.write_scalar(evals[q])
    prover_cls(params).create_proof(
        rng, t, [commit.ProverQuery(pt, refs[i]) for i, pt in keys])
    proof = t.finalize()

    def accepts(lie=None) -> bool:
        r = transcript.Blake2bRead(curve, proof)
        cs = r.read_n_points(3)
        es = {q: r.read_scalar() for q in keys}
        if lie is not None:
            es[lie] = (es[lie] + 1) % p
        vq = [commit.VerifierQuery(pt, cs[i], es[(i, pt)], ident=("c", i))
              for i, pt in keys]
        return strategy_cls(params).process(
            lambda msm: verifier_cls(params).verify_proof(r, vq, msm))

    return proof, keys, accepts


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_multiopen_rejects_every_lie(scheme):
    proof, keys, accepts = opening("halo2_tpu_torch", scheme)
    assert hashlib.sha256(proof).hexdigest() == REF_OPENING_SHA256[scheme]
    assert accepts(), f"{scheme}: honest evaluations rejected"
    for q in keys:
        assert not accepts(q), f"{scheme}: accepted a lie about {q}"


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    for scheme in sorted(SCHEMES):
        proof, keys, accepts = opening("halo2_tpu", scheme)
        assert accepts() and not any(accepts(q) for q in keys)
        print(f'"{scheme}": "{hashlib.sha256(proof).hexdigest()}",  '
              f'# {len(proof)} bytes', flush=True)
