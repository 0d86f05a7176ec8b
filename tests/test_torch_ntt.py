"""The port's NTT (kernel C's plain version, its load and store factors and
strided stores, inside the four-step of one, two and three split levels)
and the polynomial layer against the JAX reference.  Exact equality
throughout."""

import numpy as np
import pytest
import torch

from halo2_tpu.fields import BN254_FR as REF_F, PASTA_FP as REF_FP
from halo2_tpu.ntt import get_ntt as ref_get_ntt
from halo2_tpu.ntt.fused import (FusedNTT as RefFusedNTT, _base_ntt_jnp,
                                 _pow_table_host)
from halo2_tpu.poly import EvaluationDomain as RefDomain
from halo2_tpu.poly.arith import (_kate_division_jit as ref_kate,
                                  eval_polys_at_points as ref_evals)
from halo2_tpu_torch.compat.from_jax import limbs_from_jax, limbs_to_jax
from halo2_tpu_torch.fields import BN254_FR as F, PASTA_FP as FP
from halo2_tpu_torch.fields.cuda_ops import ints, words
from halo2_tpu_torch.ntt import get_ntt
from halo2_tpu_torch.ntt.fused import (BIG, FusedNTT, NttPass, base_ntt,
                                       base_ntt_plain, column_pass)
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


def _ref_base(log_m: int, x):
    """The reference's base NTT (`_base_ntt_jnp`, its stage table) along
    axis 1 of our (outer, m, inner, 8) words."""
    m = 1 << log_m
    omega = pow(F.root_of_unity, 1 << (F.S - log_m), F.p)
    table = RefFusedNTT(REF_F, log_m, omega)._arrays[f"{log_m}:0:base"]
    cols = limbs_to_jax(x.permute(1, 0, 2, 3).reshape(m, -1, 8))
    out = _base_ntt_jnp(REF_F, np.moveaxis(cols, -1, 0), table, log_m)
    return limbs_from_jax(np.moveaxis(np.asarray(out), 0, -1)).reshape(
        m, x.shape[0], x.shape[2], 8).permute(1, 0, 2, 3)


@pytest.mark.parametrize("log_m", [1, 3, 7])
def test_base_ntt_plain_matches_reference(log_m):
    m, B = 1 << log_m, 3
    omega = pow(F.root_of_unity, 1 << (F.S - log_m), F.p)
    ntt = FusedNTT(F, log_m, omega, "cpu")
    assert torch.equal(ntt._tables[(log_m, False)], _ours(_pow_table_host(
        REF_F, omega, max(m // 2, 1))))
    x = _ours(REF_F.encode_ints(_ints(m * B, seed=log_m))).reshape(1, m, B, 8)
    ours = base_ntt_plain(F, column_pass(ntt, x, log_m, False))
    assert torch.equal(ours, _ref_base(log_m, x))
    assert torch.equal(base_ntt(F, column_pass(ntt, x, log_m, False)), ours)


C_FLAG_SETS = ("load+pad", "store+truncate", "twiddle", "transpose",
               "load+pad+store+truncate+twiddle+transpose")


@pytest.mark.parametrize("flags", C_FLAG_SETS)
@pytest.mark.parametrize("log_m", [1, 3, 7])
def test_base_ntt_plain_factors_match_reference(log_m, flags):
    """Kernel C's plain version with load and store factors, zero rows,
    truncation, the mid twiddle and the transposed store against the
    reference's base NTT with the same factors applied as python ints."""
    flags = flags.split("+")
    m, outer, inner, p = 1 << log_m, 2, 3, F.p
    omega = pow(F.root_of_unity, 1 << (F.S - log_m), p)
    ntt = FusedNTT(F, log_m, omega, "cpu")
    x = F.encode_ints(_ints(outer * m * inner, seed=9 + log_m),
                      "cpu").reshape(outer, m, inner, 8)
    load, store = _ints(3, seed=1), _ints(3, seed=2)
    src_rows = (m + 1) // 2 if "pad" in flags else m
    dst_rows = (m + 1) // 2 if "truncate" in flags else m
    log_n, lo_bits = log_m + 2, (log_m + 3) // 2
    wn = pow(F.root_of_unity, 1 << (F.S - log_n), p)
    tr = "transpose" in flags
    spec = NttPass(
        x, torch.zeros_like(x), ntt._tables[(log_m, False)], log_m,
        ((inner, 1, 0, m if tr else 1, 0),
         (outer, m * inner, 0, m * inner, 0)),
        (inner, 1, 1 if tr else inner, 1),
        src_rows if "pad" in flags else BIG,
        dst_rows if "truncate" in flags else BIG,
        F.encode_ints(load, "cpu") if "load" in flags else None,
        F.encode_ints(store, "cpu") if "store" in flags else None,
        (0, log_n, lo_bits,
         F.encode_ints([pow(wn, e, p) for e in range(1 << lo_bits)], "cpu"),
         F.encode_ints([pow(wn, e << lo_bits, p)
                        for e in range(1 << (log_n - lo_bits))], "cpu"))
        if "twiddle" in flags else None)
    # Montgomery words times a python int c stay Montgomery words of the
    # product, so the factors go on the words' integers
    v = np.array(ints(x), dtype=object).reshape(outer, m, inner)
    for j in range(m):
        v[:, j] = v[:, j] * (load[j % 3] if "load" in flags else 1) % p \
            if j < src_rows else 0
    y = np.array(ints(_ref_base(log_m, words(list(v.ravel()), x.shape))),
                 dtype=object).reshape(outer, m, inner)
    want = np.zeros((outer, inner, m) if tr else (outer, m, inner),
                    dtype=object)
    for k in range(dst_rows):
        for i in range(inner):
            c = store[k % 3] if "store" in flags else 1
            if "twiddle" in flags:
                c = c * pow(wn, k * i, p)
            val = y[:, k, i] * c % p
            if tr:
                want[:, i, k] = val
            else:
                want[:, k, i] = val
    got = base_ntt_plain(F, spec)
    assert torch.equal(got.reshape(-1, 8),
                       words(list(want.ravel()), (-1, 8)))


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


@pytest.mark.parametrize("field, log_n, cap", [
    ("fr", 12, 10), ("pasta-fp", 11, 10), ("pasta-fp", 12, 10),
    ("fr", 11, 4), ("pasta-fp", 12, 3)])
def test_fused_ntt_matches_reference(field, log_n, cap):
    """FusedNTT forward and inverse against the reference's transform: one
    split level at 2^11 and 2^12 for BN254 Fr and Pasta Fp, and plans of
    two (2^11 on a 2^4 base) and three (2^12 on 2^3) split levels."""
    ours_f, ref_f = (F, REF_F) if field == "fr" else (FP, REF_FP)
    n = 1 << log_n
    vals = [v % ours_f.p for v in _ints(2 * n, seed=200 + log_n)]
    ref_a = ref_f.encode_ints(vals).reshape(2, n, 16)
    ref = ref_get_ntt(ref_f, log_n)
    omega = pow(ours_f.root_of_unity, 1 << (ours_f.S - log_n), ours_f.p)
    ntt = FusedNTT(ours_f, log_n, omega, "cpu", _log_max_base=cap)
    a = _ours(ref_a)
    assert torch.equal(ntt.forward(a), _ours(ref.forward(ref_a)))
    assert torch.equal(ntt.inverse(a), _ours(ref.inverse(ref_a)))


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
    # the coset pair at k = 6 too (extended 2^8, truncated to 3 n rows)
    ref = RefDomain(REF_F, j, 6)
    dom = EvaluationDomain(F, j, 6, "cpu")
    ref_a = REF_F.encode_ints(_ints(3 * dom.n, seed=8)).reshape(3, dom.n, 16)
    ref_ext = ref.coeff_to_extended(ref_a)
    ext = dom.coeff_to_extended(_ours(ref_a))
    assert torch.equal(ext, _ours(ref_ext))
    assert torch.equal(dom.extended_to_coeff(ext),
                       _ours(ref.extended_to_coeff(ref_ext)))


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
