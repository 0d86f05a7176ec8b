"""The port's BN254 G1, Pallas and Vesta (halo2_tpu_torch.curves) and kernel
B's plain version against the JAX reference's Curve, on both sides of the
plain versions' selection rule (`cuda_ops.on_ints`: python ints for small
CPU batches, int64 limbs otherwise).  Both packages run the same complete
formulas on canonical elements, so even the projective words must be
equal."""

import numpy as np
import pytest
import torch

from halo2_tpu.curves import (BN254_G1 as REF, PALLAS as REF_PALLAS,
                              VESTA as REF_VESTA)
from halo2_tpu.msm.host_msm import host_msm
from halo2_tpu_torch.compat.from_jax import limbs_from_jax
from halo2_tpu_torch.curves import BN254_G1, PALLAS, VESTA, cuda_ec
from halo2_tpu_torch.fields import cuda_ops

# The plain versions run many small tensor ops: one thread per worker
# is as fast and leaves the other cores to the other test workers.
torch.set_num_threads(1)

C = BN254_G1
R_ORDER = C.Fr.p


PASTA = {"pallas": (PALLAS, REF_PALLAS), "vesta": (VESTA, REF_VESTA)}


def plain_paths(monkeypatch):
    """Both sides of `cuda_ops.on_ints`: python ints, then int64 limbs."""
    yield "ints"
    monkeypatch.setattr(cuda_ops, "INT_ELEMS", 0)
    monkeypatch.setattr(cuda_ops, "INT_POINTS", 0)
    yield "limbs"


def _points(n: int, seed: int, curve=C, ref=REF) -> list:
    rng = np.random.default_rng(seed)
    ks = [int(k) for k in rng.integers(1, 1 << 62, size=n)]
    return [host_msm(ref, [k], [(curve.gen_x, curve.gen_y)]) for k in ks]


def _operands(curve=C, ref=REF):
    """P and Q covering random pairs, identities, P + P and P + (-P)."""
    ps = _points(12, 1, curve, ref)
    qs = _points(12, 2, curve, ref)
    ps[0] = None                                  # identity + Q
    qs[1] = None                                  # P + identity
    ps[2] = qs[2] = None                          # identity + identity
    qs[3] = ps[3]                                 # P + P
    qs[4] = (ps[4][0], (-ps[4][1]) % curve.Fq.p)  # P + (-P)
    return ps, qs


@pytest.fixture(scope="module")
def operands():
    return _operands()


def _both(pts, curve=C, ref=REF):
    return curve.from_affine_ints(pts, "cpu"), ref.from_affine_ints(pts)


def _group_law(curve, ref, ps, qs, op, monkeypatch):
    """One group-law op on both plain paths: the projective words equal the
    reference's, the affine results equal host_msm's."""
    P, RP = _both(ps, curve, ref)
    Q, RQ = _both(qs, curve, ref)
    if op == "add":
        theirs = ref.add(RP, RQ)
    elif op == "double":
        theirs = ref.double(RP)
    else:
        inf = torch.tensor([q is None for q in qs])
        theirs = ref.madd(RP, ref.batch_normalize(RQ), np.asarray(inf))
        Qa = curve.batch_normalize(Q)
    want = [host_msm(ref, [1, 1] if op != "double" else [2],
                     [p, q] if op != "double" else [p])
            for p, q in zip(ps, qs)]
    for path in plain_paths(monkeypatch):
        assert cuda_ops.on_ints(P, points=True) == (path == "ints")
        if op == "add":
            ours = curve.add(P, Q)
        elif op == "double":
            ours = curve.double(P)
        else:
            ours = curve.madd(P, Qa, inf)
        assert torch.equal(ours, limbs_from_jax(np.asarray(theirs))), path
        assert curve.to_affine_ints(ours) == want, path


def test_from_to_affine_match_reference(operands):
    ps, _ = operands
    ours, theirs = _both(ps)
    assert torch.equal(ours, limbs_from_jax(np.asarray(theirs)))
    assert C.to_affine_ints(ours) == ps
    assert torch.equal(C.identity((2,), "cpu"),
                       limbs_from_jax(np.asarray(REF.identity((2,)))))



@pytest.mark.parametrize("op", ["add", "madd", "double"])
def test_group_law_matches_reference(operands, op, monkeypatch):
    _group_law(C, REF, *operands, op, monkeypatch)


@pytest.mark.parametrize("op", ["add", "madd", "double"])
@pytest.mark.parametrize("name", sorted(PASTA))
def test_pasta_group_law_matches_reference(name, op, monkeypatch):
    """Pallas and Vesta (b = 5: the 3b = 15x = 16x - x chain)."""
    curve, ref = PASTA[name]
    _group_law(curve, ref, *_operands(curve, ref), op, monkeypatch)


def test_kernel_b_plain_called_directly(operands, monkeypatch):
    """Kernel B's plain versions, called directly on each curve: the int64
    limbs give the words the python ints give."""
    outs = {}
    for path in plain_paths(monkeypatch):
        for curve, ref in [(C, REF)] + [PASTA[k] for k in sorted(PASTA)]:
            ps, qs = operands if curve is C else _operands(curve, ref)
            P, Q = _both(ps, curve, ref)[0], _both(qs, curve, ref)[0]
            Qa, inf = curve.batch_normalize(Q), curve.is_identity(Q)
            outs[path, curve.name] = (
                cuda_ec.ec_add_plain(curve, P, Q),
                cuda_ec.ec_double_plain(curve, P),
                cuda_ec.ec_madd_plain(curve, P, Qa, inf))
    for (path, name), out in outs.items():
        for ints, limbs in zip(outs["ints", name], out):
            assert torch.equal(ints, limbs), (path, name)


def test_neg_eq_identity_normalize(operands):
    ps, qs = operands
    P, RP = _both(ps)
    assert torch.equal(C.neg(P), limbs_from_jax(np.asarray(REF.neg(RP))))
    assert C.is_identity(P).tolist() == [p is None for p in ps]
    assert C.eq(C.double(P), C.add(P, P)).all()
    assert not C.eq(P, C.neg(P))[3:].any()
    assert torch.equal(C.batch_normalize(P),
                       limbs_from_jax(np.asarray(REF.batch_normalize(RP))))
    assert C.to_affine_ints(C.from_affine_coords(C.batch_normalize(P))) == ps


CURVES = {"bn254": (C, REF), "vesta": (VESTA, REF_VESTA)}


@pytest.mark.parametrize("scalars", ["per-lane", "one"])
@pytest.mark.parametrize("name", sorted(CURVES))
def test_scalar_mul_matches_reference(name, scalars, monkeypatch):
    """The scalar-mul chain's plain version (kernel B's chain on the card)
    on both plain paths, per-lane scalars 0, 1, p - 1 and a 201-bit one,
    or one scalar p - 1 for every point, against the reference's
    scalar_mul word for word and host_msm."""
    curve, ref = CURVES[name]
    order = curve.Fr.p
    pts = [p for p in _operands(curve, ref)[0] if p is not None][:4]
    ks = [0, 1, order - 1, 2 ** 200 + 7] if scalars == "per-lane" else \
        [order - 1] * 4
    P, RP = _both(pts, curve, ref)
    k = curve.Fr.encode_ints(ks, "cpu")
    theirs = limbs_from_jax(np.asarray(ref.scalar_mul(
        RP, ref.Fr.encode_ints(ks))))
    want = [host_msm(ref, [s], [p]) for s, p in zip(ks, pts)]
    if scalars == "one":
        k = k[0]
    # the int64 limbs take seconds for 256 steps: one case runs them
    paths = plain_paths(monkeypatch) if (name, scalars) == (
        "bn254", "per-lane") else ["ints"]
    for path in paths:
        ours = curve.scalar_mul(P, k)
        assert torch.equal(ours, theirs), path
        assert curve.to_affine_ints(ours) == want, path
    assert curve.to_affine_ints(curve.scalar_mul_int(P[:1], 5)) == \
        [host_msm(ref, [5], [pts[0]])]


def test_horner_plain_matches_host_ints(monkeypatch):
    """The Horner chain's plain version (kernel B's chain on the card), on
    both plain paths, against sum_w S_w 2^(c w) on host integers, with an
    identity among the per-window sums."""
    from halo2_tpu_torch.msm.bucket_scan import (horner_windows,
                                                 horner_windows_plain)
    nw, c = 5, 6
    sums = _points(nw, 7)
    sums[nw - 1] = None
    S = C.double(C.from_affine_ints(sums, "cpu"))
    want = [host_msm(REF, [2 << (c * w) for w in range(nw)], sums)]
    for path in plain_paths(monkeypatch):
        ours = horner_windows_plain(C, S, c)
        assert C.to_affine_ints(ours[None]) == want, path
        assert torch.equal(horner_windows(C, S, c), ours), path


def test_generator_mul_matches_reference():
    """[k]G by mixed adds of the affine [2^i]G (ParamsKZG.setup's path)
    against the reference's double-and-add from G."""
    ks = [3, R_ORDER - 1, 0, 2 ** 200 + 7, 1]
    gen = (C.gen_x, C.gen_y)
    ours = C.generator_mul(C.Fr.encode_ints(ks, "cpu"))
    theirs = REF.scalar_mul(REF.from_affine_ints([gen] * len(ks)),
                            REF.Fr.encode_ints(ks))
    assert C.to_affine_ints(ours) == REF.to_affine_ints(theirs)
    assert C.to_affine_ints(ours) == [host_msm(REF, [s], [gen]) for s in ks]


def test_point_bytes_match_reference(operands):
    ps, _ = operands
    for pt in ps:
        b = C.point_to_bytes(pt)
        assert b == REF.point_to_bytes(pt)
        assert C.point_from_bytes(b) == pt
    with pytest.raises(ValueError):
        C.point_from_bytes(b"\xff" * 32)
