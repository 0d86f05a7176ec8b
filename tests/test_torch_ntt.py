"""The port's NTT (kernel C's plain version inside the four-step) and the
polynomial layer against the JAX reference.  Exact equality throughout."""

import numpy as np
import pytest
import torch

from halo2_tpu.fields import BN254_FR as REF_F
from halo2_tpu.ntt import get_ntt as ref_get_ntt
from halo2_tpu.ntt.fused import FusedNTT as RefFusedNTT, _base_ntt_jnp
from halo2_tpu.poly import EvaluationDomain as RefDomain
from halo2_tpu.poly.arith import (_kate_division_jit as ref_kate,
                                  eval_polys_at_points as ref_evals)
from halo2_tpu_torch.compat.from_jax import limbs_from_jax
from halo2_tpu_torch.fields import BN254_FR as F
from halo2_tpu_torch.ntt import get_ntt
from halo2_tpu_torch.ntt.fused import base_ntt, base_ntt_plain, stage_table
from halo2_tpu_torch.poly import EvaluationDomain, Poly, Rotation
from halo2_tpu_torch.poly.arith import eval_polys_at_points, kate_division

# The plain versions run many small tensor ops: one thread per worker
# is as fast and leaves the other cores to the other test workers.
torch.set_num_threads(1)


def _ints(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % F.p
            for row in words]


def _ours(ref_arr):
    return limbs_from_jax(np.asarray(ref_arr))


@pytest.mark.parametrize("log_m", [1, 3, 7])
def test_base_ntt_plain_matches_reference(log_m):
    m, B = 1 << log_m, 3
    vals = _ints(m * B, seed=log_m)
    ref_x = REF_F.encode_ints(vals).reshape(m, B, 16)
    omega = pow(F.root_of_unity, 1 << (F.S - log_m), F.p)
    ref_table = RefFusedNTT(REF_F, log_m, omega)._arrays[f"{log_m}:0:base"]
    table = stage_table(F, omega, log_m, "cpu")
    assert torch.equal(table, _ours(np.moveaxis(np.asarray(ref_table), 0, -1)))
    theirs = _base_ntt_jnp(REF_F, np.moveaxis(np.asarray(ref_x), -1, 0),
                           ref_table, log_m)
    x = _ours(ref_x).reshape(1, m, B, 8)
    ours = base_ntt_plain(F, x, table, log_m)
    assert torch.equal(ours[0], _ours(np.moveaxis(np.asarray(theirs), 0, -1)))
    assert torch.equal(base_ntt(F, x, table, log_m), ours)


@pytest.mark.parametrize("log_n", [5, 10, 11])
def test_forward_inverse_match_reference(log_n):
    n = 1 << log_n
    vals = _ints(2 * n, seed=100 + log_n)
    ref_a = REF_F.encode_ints(vals).reshape(2, n, 16)
    ref = ref_get_ntt(REF_F, log_n)
    ntt = get_ntt(F, log_n, "cpu")
    a = _ours(ref_a)
    fwd = ntt.forward(a)
    assert torch.equal(fwd, _ours(ref.forward(ref_a)))
    inv = ntt.inverse(a)
    assert torch.equal(inv, _ours(ref.inverse(ref_a)))
    assert torch.equal(ntt.inverse(fwd), a)


def test_domain_transforms_match_reference():
    k, j = 5, 4
    ref = RefDomain(REF_F, j, k)
    dom = EvaluationDomain(F, j, k, "cpu")
    assert (dom.extended_k, dom.omega, dom.extended_omega) == \
        (ref.extended_k, ref.omega, ref.extended_omega)
    vals = _ints(3 * dom.n, seed=7)
    ref_a = REF_F.encode_ints(vals).reshape(3, dom.n, 16)
    a = _ours(ref_a)
    coeff = dom.lagrange_to_coeff(Poly.lagrange(a))
    assert coeff.basis == "coeff"
    assert torch.equal(coeff.values, _ours(ref.lagrange_to_coeff(ref_a)))
    ref_ext = ref.coeff_to_extended(ref_a)
    ext = dom.coeff_to_extended(a)
    assert torch.equal(ext, _ours(ref_ext))
    assert torch.equal(dom.extended_to_coeff(ext),
                       _ours(ref.extended_to_coeff(ref_ext)))
    assert torch.equal(dom.divide_by_vanishing_poly(ext),
                       _ours(ref.divide_by_vanishing_poly(ref_ext)))
    assert torch.equal(dom.rotate_extended(ext, Rotation(-1)),
                       _ours(ref.rotate_extended(ref_ext, Rotation(-1))))
    assert torch.equal(dom.coeff_to_lagrange(coeff.values), a)
    assert dom.l_i_range_int(vals[0], pow(vals[0], dom.n, F.p), [-2, 0, 1]) \
        == ref.l_i_range_int(vals[0], pow(vals[0], dom.n, F.p), [-2, 0, 1])
    with pytest.raises(TypeError):
        dom.coeff_to_extended(Poly.lagrange(a))


def test_kate_division_and_evals_match_reference():
    vals = _ints(2 * 32, seed=8)
    ref_a = REF_F.encode_ints(vals).reshape(2, 32, 16)
    a = _ours(ref_a)
    b = vals[5]
    ours = kate_division(F, a, F.encode_int(b, "cpu"))
    assert torch.equal(ours, _ours(ref_kate(REF_F, ref_a,
                                            REF_F.encode_int(b))))
    points = [vals[1], vals[2], vals[1]]
    reqs = [(a[0], points[0]), (a[1], points[1]), (a[1], points[2])]
    want = ref_evals(REF_F, [(ref_a[0], points[0]), (ref_a[1], points[1]),
                             (ref_a[1], points[2])])
    assert eval_polys_at_points(F, reqs) == want
