"""Kernels 10-15 of halo2_tpu_torch (the probes in halo2_tpu_torch/tools/):
their plain PyTorch versions, which the CPU wrappers take, against the JAX
reference's probes.  Rows 10, 12, 14 and 15 run the reference's Pallas
kernels in interpret mode; row 11 is held against the reference field's
plain multiply, on both sides of `cuda_ops.on_ints`, and row 13 against
the reference's own check (numpy indexing of its table).  Inputs
come from numpy seeds; everything is integer, so every comparison is
equality (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from halo2_tpu.fields import BN254_FQ as REF_FQ, BN254_FR as REF_FR
from halo2_tpu_torch.compat.from_jax import limbs_from_jax
from halo2_tpu_torch.fields import BN254_FQ, BN254_FR, cuda_ops
from halo2_tpu_torch.tools import alu_probe, dma_gather_probe, transpose_probe
from tools import alu_probe as ref_alu
from tools import dma_gather_probe as ref_gather
from tools import transpose_probe as ref_T

# The plain versions run many small tensor ops: one thread per worker
# is as fast and leaves the other cores to the other test workers.
torch.set_num_threads(1)


def plain_paths(monkeypatch):
    """Both sides of `cuda_ops.on_ints`: python ints, then int64 limbs."""
    yield "ints"
    monkeypatch.setattr(cuda_ops, "INT_ELEMS", 0)
    monkeypatch.setattr(cuda_ops, "INT_POINTS", 0)
    yield "limbs"


def _ints(p: int, n: int, seed: int) -> list:
    """n canonical values from a numpy seed, led by 0, 1, p-1."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n - 3, 8), dtype=np.uint64)
    return [0, 1, p - 1] + [sum(int(w) << (32 * i) for i, w in enumerate(r))
                            % p for r in words]


def _u32(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy -> int32 bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def test_mont_repeat_fr_matches_bench_kernel(monkeypatch):
    """Row 10: bench.py's `mul_alu_kernel` is the probe's `mont_repeat`
    body over BN254 Fr, run here in interpret mode, (16, n) limb-major."""
    n, reps = 2048, 2
    xs, ys = _ints(REF_FR.p, n, 1), _ints(REF_FR.p, n, 2)
    a, b = REF_FR.encode_ints(xs), REF_FR.encode_ints(ys)
    monkeypatch.setattr(ref_alu, "F", REF_FR)
    with pltpu.force_tpu_interpret_mode():
        want = ref_alu.mont_repeat(n, reps)(jnp.moveaxis(a, -1, 0),
                                            jnp.moveaxis(b, -1, 0))
    want = limbs_from_jax(np.asarray(want).T)
    got = alu_probe.mont_repeat(BN254_FR, limbs_from_jax(np.asarray(a)),
                                limbs_from_jax(np.asarray(b)), reps)
    assert torch.equal(got, want)
    p = BN254_FR.p
    assert BN254_FR.decode_ints(got[:64]) == [x * pow(y, reps, p) % p
                                              for x, y in zip(xs, ys[:64])]


def test_mont_repeat_fq_matches_reference_mul(monkeypatch):
    """Row 11: the probe's field, BN254 Fq, against the reference's plain
    `BN254_FQ.mul` applied reps times."""
    n, reps = 512, 3
    a = REF_FQ.encode_ints(_ints(REF_FQ.p, n, 3))
    b = REF_FQ.encode_ints(_ints(REF_FQ.p, n, 4)[::-1])
    want = a
    for _ in range(reps):
        want = REF_FQ.mul(want, b)
    want = limbs_from_jax(np.asarray(want))
    a_t, b_t = limbs_from_jax(np.asarray(a)), limbs_from_jax(np.asarray(b))
    for path in plain_paths(monkeypatch):
        assert cuda_ops.on_ints(a_t) == (path == "ints")
        assert torch.equal(alu_probe.mont_repeat(BN254_FQ, a_t, b_t, reps),
                           want), path


def test_u32_mul_repeat_matches_reference():
    """Row 12: v <- v b + 1 wrapping, interpret mode, (8, n)."""
    n, reps = 2048, 5
    a, b = _u32((8, n), 5), _u32((8, n), 6)
    a[0, :4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    b[0, :4] = [0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 2]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref_alu.u32_mul_repeat(n, reps)(jnp.asarray(a),
                                                          jnp.asarray(b)))
    got = alu_probe.u32_mul_repeat(_t(a), _t(b), reps)
    assert torch.equal(got, _t(want))
    v = int(a[1, 7])
    for _ in range(reps):
        v = (v * int(b[1, 7]) + 1) % (1 << 32)
    assert int(got[1, 7]) & 0xFFFFFFFF == v


def test_wide_mul_repeat_plain_matches_ints():
    """Kernel 12's IMAD.WIDE form, chains w_j <- lo(w_j) b + w_j mod 2^64
    from w_j = a + j, the lane the xor of every lo(w_j) and hi(w_j), which
    has no reference counterpart: its plain version against python
    integers, with the extreme words."""
    a, b = _u32((8, 64), 9), _u32((8, 64), 10)
    a[0, :4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    b[0, :4] = [0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 2]
    for reps in (0, 1, 5, 33):
        got = alu_probe.u32_mul_repeat(_t(a), _t(b), reps, wide=True)
        want = []
        for x, y in zip(a.ravel().tolist(), b.ravel().tolist()):
            lane = 0
            for j in range(alu_probe.WIDE_CHAINS):
                w = x + j
                for _ in range(reps):
                    w = ((w & 0xFFFFFFFF) * y + w) % (1 << 64)
                lane ^= (w & 0xFFFFFFFF) ^ (w >> 32)
            want.append(lane)
        assert (got.view(-1).to(torch.int64) & 0xFFFFFFFF).tolist() == want


def test_gather_rows_matches_reference():
    """Row 13: the table equals the reference's `mk_tbl` and the gather the
    reference's own check of its kernel (numpy indexing of the table)."""
    rows, m = 512, 512
    idx = dma_gather_probe.random_idx(m, rows, 7, "cpu")
    idx[:3] = torch.tensor([0, rows - 1, 0], dtype=torch.int32)
    for width in (128, 64):
        ref_tbl = np.asarray(ref_gather.mk_tbl(rows, width))
        tbl = dma_gather_probe.mk_tbl(rows, width, "cpu")
        assert torch.equal(tbl, _t(ref_tbl))
        got = dma_gather_probe.gather_rows(idx, tbl)
        assert torch.equal(got, _t(ref_tbl[idx.numpy()]))


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_limb_transpose_matches_reference(direction):
    """Rows 14/15: (R, 16) -> (16, R) and back, interpret mode, R = 2048."""
    r = 2048
    x = _u32((r, ref_T.L), 8)
    if direction == "bwd":
        x = np.ascontiguousarray(x.T)
    ref = ref_T.limb_T_fwd if direction == "fwd" else ref_T.limb_T_bwd
    port = (transpose_probe.limb_T_fwd if direction == "fwd"
            else transpose_probe.limb_T_bwd)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref(r)(jnp.asarray(x)))
    got = port(_t(x))
    assert got.shape == want.shape
    assert torch.equal(got, _t(want))
    assert torch.equal(got, _t(x).t())


def test_probe_wrappers_refuse_what_the_kernels_do_not_take():
    """Off the CPU a wrapper launches its kernel or raises: tensors on the
    meta device (no card here) are refused before any launch."""
    meta = torch.empty((64, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        alu_probe.mont_repeat(BN254_FR, meta, meta, 1)
    with pytest.raises(ValueError):
        alu_probe.u32_mul_repeat(meta, meta, 1)
    with pytest.raises(ValueError):
        dma_gather_probe.gather_rows(
            torch.empty(4, dtype=torch.int32, device="meta"), meta)
    with pytest.raises(ValueError):
        transpose_probe.limb_T_fwd(meta)
