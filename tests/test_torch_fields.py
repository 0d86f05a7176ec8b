"""The port's BN254 and Pasta fields (halo2_tpu_torch.fields) and kernel A's
plain version against the JAX reference's Field and python ints, on both
sides of the plain versions' selection rule (`cuda_ops.on_ints`: python
ints for small CPU batches, int64 limbs otherwise).  All arithmetic is
exact, so every comparison is equality (tolerance 0)."""

import random

import numpy as np
import pytest
import torch

from halo2_tpu.fields import (BN254_FQ as REF_FQ, BN254_FR as REF_FR,
                              PASTA_FP as REF_PASTA_FP,
                              PASTA_FQ as REF_PASTA_FQ)
from halo2_tpu_torch import native
from halo2_tpu_torch.compat.from_jax import limbs_from_jax, limbs_to_jax
from halo2_tpu_torch.fields import (BN254_FQ, BN254_FR, PASTA_FP, PASTA_FQ,
                                    cuda_ops, field)
from halo2_tpu_torch.plonk import prover

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


def _encoder_case(case: str):
    """(columns, tail, elements expected narrow, expected wide) of
    `encode_ints_cols` on 24 rows of BN254 Fr."""
    p = BN254_FR.p
    small = [[(i * 7919 + j) % (1 << 16) for i in range(24)]
             for j in range(3)]

    def with_value(v, at=5):
        col = list(small[0])
        col[at] = v
        return col
    high = with_value((1 << 64) - 1)
    high[7] = (1 << 33) + 12345
    return {
        "small": (small, None, 72, 0),
        "max_u64": ([high], None, 24, 0),
        "u64_overflow": ([with_value(1 << 64)], None, 0, 24),
        "above_p": ([with_value(p + 5)], None, 0, 24),
        "negative": ([with_value(-3, at=23)], None, 0, 24),
        "mixed": ([small[0], with_value(p + 5), small[1],
                   with_value(-1)], None, 48, 48),
        "no_columns": ([], None, 0, 0),
        "tail": (small, [_ints(p, 0, seed=j) for j in range(3)], 60, 12),
    }[case]


@pytest.mark.parametrize("case", ["small", "max_u64", "u64_overflow",
                                  "above_p", "negative", "mixed",
                                  "no_columns", "tail"])
def test_encode_ints_cols_words_and_paths(case):
    """The column encoder's words equal the 32-byte path's (each value
    reduced mod p, serialized, then the Montgomery map), column by column
    on either path, and its counters grow by the elements each path
    took."""
    F = BN254_FR
    cols, tail, narrow, wide = _encoder_case(case)
    before = field.encode_counters()
    ours = F.encode_ints_cols(cols, "cpu", tail=tail)
    after = field.encode_counters()
    assert after["narrow"] - before["narrow"] == narrow
    assert after["wide"] - before["wide"] == wide
    if tail:
        cols = [c[:len(c) - len(t)] + t for c, t in zip(cols, tail)]
    n = len(cols[0]) if cols else 0
    want = F.to_mont(_bytes_words(
        [v % F.p for col in cols for v in col])).reshape(len(cols), n, 8)
    assert ours.shape == want.shape and ours.dtype == torch.int32
    assert torch.equal(ours, want)


def _bytes_words(vals) -> torch.Tensor:
    """(n, 8) int32 words of ints in [0, 2^256) by `int.to_bytes`, the
    column encoder's Python serialization."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return torch.from_numpy(np.frombuffer(buf, dtype="<u4").view(
        np.int32).reshape(-1, 8).copy())


@pytest.fixture(params=["digits", "api"])
def encoder(request, monkeypatch):
    """The native encoder as built for this interpreter ("digits": on
    CPython 3.12 and 3.13, a direct read of an int's digits) and as built
    to read ints through the C API; either must build here."""
    if request.param == "api":
        lib = native.encode_lib(("-DH2_ENCODE_API",))
        monkeypatch.setattr(native, "encode_lib", lambda: lib)
    assert native.encode_lib() is not None
    return request.param


def _no_encoder(monkeypatch):
    monkeypatch.setattr(native, "encode_lib", lambda: None)


def _wide_ints(p: int, n: int, seed: int) -> list:
    """n values uniform over [0, 2^256), led by 0, 1, p - 1, p, 2p and
    2^256 - 1 (15p + 7 lies above 2^256 for every field here)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [0, 1, p - 1, p, 2 * p, (1 << 256) - 1] + [
        sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in words]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_native_words_equal_python_words(name, encoder, monkeypatch):
    """The native pass reduces values in [0, 2^256) mod p into the words
    the Python path gives, and so does the staging routine (`_stage`);
    with no modulus it writes them as they are; 15p + 7, 2^256 and -1
    fail the pass and are serialized (reduced) in Python, to the same
    words either way."""
    F, _ = FIELDS[name]
    p = F.p
    vals = _wide_ints(p, 200, seed=11)
    out = torch.empty((len(vals), 8), dtype=torch.int32)
    assert field._write_words(vals, len(vals), out, p)
    assert torch.equal(out, _bytes_words([v % p for v in vals]))
    words, counts = field._stage([vals], p, "cpu")
    assert torch.equal(words[0], out) and counts == (0, 206, 206)
    assert native.encode_words(vals, len(vals), out.data_ptr())
    assert torch.equal(out, _bytes_words(vals))
    assert 15 * p + 7 >= 1 << 256
    for bad in (15 * p + 7, 1 << 256, -1):
        col = vals[:5] + [bad]
        out = torch.empty((6, 8), dtype=torch.int32)
        assert not field._write_words(col, 6, out, p)
        assert torch.equal(out, _bytes_words([v % p for v in col]))
    _no_encoder(monkeypatch)
    out = torch.empty((len(vals), 8), dtype=torch.int32)
    assert not field._write_words(vals, len(vals), out, p)
    assert torch.equal(out, _bytes_words([v % p for v in vals]))


def _native_case(F, case: str):
    """(columns, tail, elements the native pass should write) of
    `encode_ints_cols` on 16 rows: full-width columns, and a column the
    pass refuses for one value (it then goes value by value)."""
    p = F.p
    full = [_wide_ints(p, 10, seed=20 + j) for j in range(3)]
    small = [(i * 7919) % (1 << 16) for i in range(16)]

    def with_value(v, at=9):
        col = list(full[0])
        col[at] = v
        return col
    tail = [[v % p for v in _wide_ints(p, 0, seed=0)] for _ in range(3)]
    return {
        "full_width": (full, None, 48),
        "with_narrow": ([full[0], small, full[1]], None, 32),
        "above_2_256": ([with_value(15 * p + 7), full[1]], None, 16),
        "two_to_256": ([full[1], with_value(1 << 256)], None, 16),
        "negative": ([with_value(-1), full[2]], None, 16),
        "numpy_int": ([with_value(np.int64(5)), full[2]], None, 16),
        "bool": ([with_value(True), full[2]], None, 32),
        "tail": (full, tail, 48),
        "tail_refused": (full, [tail[0], tail[1][:5] + [-3], tail[2]], 42),
        "tail_only": (list(tail), tail, 18),
        "one_row": ([[p + 3], [2]], None, 1),
        "no_columns": ([], None, 0),
    }[case]


@pytest.mark.parametrize("case", ["full_width", "with_narrow",
                                  "above_2_256", "two_to_256", "negative",
                                  "numpy_int", "bool", "tail",
                                  "tail_refused", "tail_only", "one_row",
                                  "no_columns"])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_encode_ints_cols_native_and_python_agree(name, case, monkeypatch):
    """`encode_ints_cols` gives the same words with the native pass and
    with the library absent, equal to each value reduced and serialized;
    `encode_native` grows by the wide and tail elements the pass wrote,
    and by nothing without it."""
    F, _ = FIELDS[name]
    cols, tail, native_elems = _native_case(F, case)
    n = len(cols[0]) if cols else 0
    full = [c[:n - len(t)] + t for c, t in zip(cols, tail)] if tail \
        else cols
    want = F.to_mont(_bytes_words(
        [int(v) % F.p for col in full for v in col])).reshape(
            len(cols), n, 8)
    got = []
    for present in (True, False):
        if not present:
            _no_encoder(monkeypatch)
        before = field.encode_counters()
        got.append(F.encode_ints_cols(cols, "cpu", tail=tail))
        after = field.encode_counters()
        grew = after["native"] - before["native"]
        assert grew == (native_elems if present else 0), present
        assert after["wide"] - before["wide"] >= grew
    assert torch.equal(got[0], want) and torch.equal(got[1], want)


def _every_route_values(p: int) -> list:
    """Values each host-to-device route must reduce and serialize alike:
    canonical, at and above p, on both sides of 2^64 and of 2^256, and
    negative."""
    return [0, 1, p - 1, p, 15 * p + 7, (1 << 64) - 1, 1 << 64,
            (1 << 256) - 1, -1]


@pytest.mark.parametrize("route", ["encode_int", "encode_ints",
                                   "encode_ints_cols", "random_poly"])
@pytest.mark.parametrize("present", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_every_route_stages_the_same_words(name, present, route,
                                           monkeypatch):
    """Every host-to-device route of field elements gives the words of
    `int.to_bytes` of each value mod p, then the Montgomery map, with the
    native pass and without it.  `encode_ints` also takes a numpy int
    (np.int64(-3), which the 64-bit path alone would wrap) and a value at
    a time (the 64-bit path); `encode_int` maps on the host, no kernel-A
    call; `_random_poly`'s staged words are its hi and lo values."""
    F, _ = FIELDS[name]
    p = F.p
    if not present:
        _no_encoder(monkeypatch)
    vals = _every_route_values(p)

    def want(xs):
        return F.to_mont(_bytes_words([int(x) % p for x in xs]))

    if route == "encode_int":
        calls = []
        real = cuda_ops.binop
        monkeypatch.setattr(cuda_ops, "binop",
                            lambda *a: calls.append(a) or real(*a))
        got = torch.stack([F.encode_int(v, "cpu") for v in vals])
        assert not calls
        assert torch.equal(got, want(vals))
    elif route == "encode_ints":
        xs = vals + [np.int64(-3)]
        assert torch.equal(F.encode_ints(xs, "cpu"), want(xs))
        for x in xs:
            assert torch.equal(F.encode_ints([x], "cpu"), want([x])), x
    elif route == "encode_ints_cols":
        cols = [[v] * 3 for v in vals]
        assert torch.equal(F.encode_ints_cols(cols, "cpu"),
                           want(vals).repeat_interleave(3, 0).reshape(
                               len(vals), 3, 8))
    else:
        n, seed = 9, 5
        g = np.random.Generator(np.random.PCG64(
            random.Random(seed).getrandbits(64)))
        raw = g.integers(0, 1 << 16, size=(n, 24), dtype=np.uint32)
        halves = [[sum(int(r[off + i]) << (16 * i) for i in range(12))
                   for r in raw] for off in (12, 0)]
        staged = []
        monkeypatch.setattr(prover, "staging", lambda *a: staged.append(
            field.staging(*a)) or staged[-1])
        got = prover._random_poly(F, n, random.Random(seed), "cpu")
        assert torch.equal(staged[0][0], _bytes_words(halves[0]))
        assert torch.equal(staged[0][1], _bytes_words(halves[1]))
        c192 = F.encode_int(1 << 192, "cpu")
        assert torch.equal(got, F.add(F.mul(want(halves[0]), c192),
                                      want(halves[1])))
        assert F.decode_ints(got) == [(hi << 192 | lo) % p
                                      for hi, lo in zip(*halves)]


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
