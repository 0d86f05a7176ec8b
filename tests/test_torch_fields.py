"""The port's BN254 and Pasta fields (halo2_tpu_torch.fields) and kernel A's
plain version against the JAX reference's Field and python ints, on both
sides of the plain versions' selection rule (`cuda_ops.on_ints`: python
ints for small CPU batches, int64 limbs otherwise).  All arithmetic is
exact, so every comparison is equality (tolerance 0)."""

import numpy as np
import pytest
import torch

from halo2_tpu.fields import (BN254_FQ as REF_FQ, BN254_FR as REF_FR,
                              PASTA_FP as REF_PASTA_FP,
                              PASTA_FQ as REF_PASTA_FQ)
from halo2_tpu_torch.compat.from_jax import limbs_from_jax, limbs_to_jax
from halo2_tpu_torch.fields import (BN254_FQ, BN254_FR, PASTA_FP, PASTA_FQ,
                                    cuda_ops)

# The plain versions run many small tensor ops: one thread per worker
# is as fast and leaves the other cores to the other test workers.
torch.set_num_threads(1)

FIELDS = {"fr": (BN254_FR, REF_FR), "fq": (BN254_FQ, REF_FQ),
          "pasta_fp": (PASTA_FP, REF_PASTA_FP),
          "pasta_fq": (PASTA_FQ, REF_PASTA_FQ)}


def plain_paths(monkeypatch):
    """Both sides of `cuda_ops.on_ints`: python ints, then int64 limbs."""
    yield "ints"
    monkeypatch.setattr(cuda_ops, "INT_ELEMS", 0)
    monkeypatch.setattr(cuda_ops, "INT_POINTS", 0)
    yield "limbs"


def _ints(p: int, n: int, seed: int) -> list:
    """n values below p from a numpy seed, led by 0, 1, p-1, p-2."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % p
            for row in words]
    return [0, 1, p - 1, p - 2] + vals


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_constants_match_reference(name):
    F, R = FIELDS[name]
    for attr in ("p", "S", "root_of_unity", "root_of_unity_inv", "delta",
                 "zeta", "two_inv", "R", "R2", "R_inv"):
        assert getattr(F, attr) == getattr(R, attr), attr


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_encode_decode_match_reference(name):
    F, R = FIELDS[name]
    xs = _ints(F.p, 60, seed=1)
    ours = F.encode_ints(xs, "cpu")
    theirs = limbs_from_jax(np.asarray(R.encode_ints(xs)))
    assert torch.equal(ours, theirs)
    assert F.decode_ints(ours) == xs
    assert np.array_equal(limbs_to_jax(ours), np.asarray(R.encode_ints(xs)))
    assert torch.equal(F.encode_int(xs[7], "cpu"), ours[7])
    assert F.from_mont_int(F.to_mont_int(xs[9])) == xs[9]


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_binops_match_reference(name, op, monkeypatch):
    F, R = FIELDS[name]
    xs = _ints(F.p, 100, seed=2)
    ys = _ints(F.p, 100, seed=3)[::-1]
    a, b = R.encode_ints(xs), R.encode_ints(ys)
    theirs = limbs_from_jax(np.asarray(getattr(R, op)(a, b)))
    a_t, b_t = limbs_from_jax(np.asarray(a)), limbs_from_jax(np.asarray(b))
    for path in plain_paths(monkeypatch):
        assert cuda_ops.on_ints(a_t) == (path == "ints")
        assert torch.equal(getattr(F, op)(a_t, b_t), theirs), path


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_kernel_a_plain_against_ints(name, monkeypatch):
    """The plain version of kernel A, called directly, on broadcast shapes,
    against python-int arithmetic on decoded values."""
    F, _ = FIELDS[name]
    p = F.p
    xs = _ints(p, 64, seed=4)
    ys = _ints(p, 64, seed=5)
    a = F.encode_ints(xs, "cpu").reshape(4, 17, 8)
    b = F.encode_ints(ys, "cpu").reshape(4, 17, 8)
    scalar = F.encode_int(ys[10], "cpu")
    for path in plain_paths(monkeypatch):
        for mode, fn in ((cuda_ops.MUL, lambda x, y: x * y),
                         (cuda_ops.ADD, lambda x, y: x + y),
                         (cuda_ops.SUB, lambda x, y: x - y)):
            out = cuda_ops.binop_plain(F, mode, a, b)
            assert out.shape == (4, 17, 8)
            assert F.decode_ints(out) == [fn(x, y) % p
                                          for x, y in zip(xs, ys)], path
            out = cuda_ops.binop_plain(F, mode, a, scalar)
            assert F.decode_ints(out) == [fn(x, ys[10]) % p for x in xs], path


def test_unary_ops_and_inverses():
    F, R = FIELDS["fr"]
    p = F.p
    xs = _ints(p, 40, seed=6)
    a = F.encode_ints(xs, "cpu")
    assert F.decode_ints(F.neg(a)) == [(-x) % p for x in xs]
    assert F.decode_ints(F.square(a)) == [x * x % p for x in xs]
    assert F.decode_ints(F.double(a)) == [2 * x % p for x in xs]
    assert F.decode_ints(F.pow(a, 5)) == [pow(x, 5, p) for x in xs]
    assert F.decode_ints(F.inv(a[:6])) == [pow(x, p - 2, p) for x in xs[:6]]
    inv = F.batch_inv(a.reshape(4, 11, 8), axis=1)
    assert F.decode_ints(inv) == [pow(x, p - 2, p) for x in xs]
    theirs = R.batch_inv(R.encode_ints(xs))
    assert torch.equal(F.batch_inv(a), limbs_from_jax(np.asarray(theirs)))
    assert F.is_zero(a).tolist() == [x == 0 for x in xs]
    assert F.eq(a, F.encode_ints(xs, "cpu")).all()
    assert not F.eq(a, F.neg(a))[4:].any()
    prefix = F.prefix_product(a[4:12])
    acc, want = 1, []
    for x in xs[4:12]:
        acc = acc * x % p
        want.append(acc)
    assert F.decode_ints(prefix) == want


def test_repr_bytes_match_reference():
    F, R = FIELDS["fr"]
    for x in _ints(F.p, 8, seed=7):
        assert F.to_repr(x) == R.to_repr(x)
        assert F.from_repr(F.to_repr(x)) == x
    with pytest.raises(ValueError):
        F.from_repr(F.p.to_bytes(32, "little"))
    b = bytes(range(64))
    assert F.from_uniform_bytes(b) == R.from_uniform_bytes(b)
