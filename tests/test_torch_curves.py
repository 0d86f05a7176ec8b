"""The port's BN254 G1 (halo2_tpu_torch.curves) and kernel B's plain version
against the JAX reference's Curve.  Both run the same complete formulas on
canonical elements, so even the projective words must be equal."""

import numpy as np
import pytest
import torch

from halo2_tpu.curves import BN254_G1 as REF
from halo2_tpu.msm.host_msm import host_msm
from halo2_tpu_torch.compat.from_jax import limbs_from_jax
from halo2_tpu_torch.curves import BN254_G1, cuda_ec

# The plain versions run many small tensor ops: one thread per worker
# is as fast and leaves the other cores to the other test workers.
torch.set_num_threads(1)

C = BN254_G1
R_ORDER = C.Fr.p


def _points(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    ks = [int(k) for k in rng.integers(1, 1 << 62, size=n)]
    return [host_msm(REF, [k], [(1, 2)]) for k in ks]


@pytest.fixture(scope="module")
def operands():
    """P and Q covering random pairs, identities, P + P and P + (-P)."""
    ps = _points(12, seed=1)
    qs = _points(12, seed=2)
    ps[0] = None                              # identity + Q
    qs[1] = None                              # P + identity
    ps[2] = qs[2] = None                      # identity + identity
    qs[3] = ps[3]                             # P + P
    qs[4] = (ps[4][0], (-ps[4][1]) % C.Fq.p)  # P + (-P)
    return ps, qs


def _both(pts):
    return C.from_affine_ints(pts, "cpu"), REF.from_affine_ints(pts)


def test_from_to_affine_match_reference(operands):
    ps, _ = operands
    ours, theirs = _both(ps)
    assert torch.equal(ours, limbs_from_jax(np.asarray(theirs)))
    assert C.to_affine_ints(ours) == ps
    assert torch.equal(C.identity((2,), "cpu"),
                       limbs_from_jax(np.asarray(REF.identity((2,)))))



@pytest.mark.parametrize("op", ["add", "madd", "double"])
def test_group_law_matches_reference(operands, op):
    ps, qs = operands
    P, RP = _both(ps)
    Q, RQ = _both(qs)
    if op == "add":
        ours, theirs = C.add(P, Q), REF.add(RP, RQ)
    elif op == "double":
        ours, theirs = C.double(P), REF.double(RP)
    else:
        inf = torch.tensor([q is None for q in qs])
        ours = C.madd(P, C.batch_normalize(Q), inf)
        theirs = REF.madd(RP, REF.batch_normalize(RQ), np.asarray(inf))
    assert torch.equal(ours, limbs_from_jax(np.asarray(theirs)))
    want = [host_msm(REF, [1, 1] if op != "double" else [2],
                     [p, q] if op != "double" else [p])
            for p, q in zip(ps, qs)]
    assert C.to_affine_ints(ours) == want


def test_kernel_b_plain_called_directly(operands):
    ps, qs = operands
    P, _ = _both(ps)
    Q, _ = _both(qs)
    assert torch.equal(cuda_ec.ec_add_plain(C, P, Q), C.add(P, Q))
    assert torch.equal(cuda_ec.ec_double_plain(C, P), C.double(P))
    inf = C.is_identity(Q)
    assert torch.equal(
        cuda_ec.ec_madd_plain(C, P, C.batch_normalize(Q), inf),
        C.madd(P, C.batch_normalize(Q), inf))


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


def test_scalar_mul_matches_reference(operands):
    ps, _ = operands
    pts = [p for p in ps if p is not None][:4]
    ks = [3, R_ORDER - 1, 0, 2 ** 200 + 7]
    P, RP = _both(pts)
    k = C.Fr.encode_ints(ks, "cpu")
    ours = C.scalar_mul(P, k)
    theirs = REF.scalar_mul(RP, REF.Fr.encode_ints(ks))
    assert torch.equal(ours, limbs_from_jax(np.asarray(theirs)))
    assert C.to_affine_ints(ours) == [host_msm(REF, [s], [p])
                                      for s, p in zip(ks, pts)]
    assert C.to_affine_ints(C.scalar_mul_int(P[:1], 5)) == \
        [host_msm(REF, [5], [pts[0]])]


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
