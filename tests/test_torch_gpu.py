"""Kernels A-D of halo2_tpu_torch against their plain PyTorch versions on a
CUDA device, and a GPU proof against the CPU proof.  Every test needs the
card and skips without one.  The file imports nothing of JAX, so on a
machine without JAX run it as

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

import random

import numpy as np
import pytest
import torch

from halo2_tpu_torch import api
from halo2_tpu_torch._shared import host_msm, plonk_api
from halo2_tpu_torch.commit import ParamsKZG
from halo2_tpu_torch.curves import BN254_G1 as C, cuda_ec
from halo2_tpu_torch.fields import BN254_FQ, BN254_FR, cuda_ops
from halo2_tpu_torch.msm import StreamMSM, naive_msm
from halo2_tpu_torch.msm.stream_msm import (stream_bucket,
                                            stream_bucket_plain, stream_keys)
from halo2_tpu_torch.ntt import get_ntt
from halo2_tpu_torch.ntt.fused import base_ntt, base_ntt_plain, stage_table

# The plain versions run many small tensor ops: one thread per worker
# is as fast and leaves the other cores to the other test workers.
torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ints(p: int, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(r)) % p
            for r in words]
    return [0, 1, p - 1] + vals


@pytest.mark.parametrize("F", [BN254_FR, BN254_FQ], ids=["fr", "fq"])
def test_kernel_a_matches_plain(F, cuda):
    xs, ys = _ints(F.p, 5000, 1), _ints(F.p, 5000, 2)[::-1]
    a, b = F.encode_ints(xs, cuda), F.encode_ints(ys, cuda)
    for mode, fn in ((cuda_ops.MUL, lambda x, y: x * y),
                     (cuda_ops.ADD, lambda x, y: x + y),
                     (cuda_ops.SUB, lambda x, y: x - y)):
        out = cuda_ops.binop(F, mode, a, b)
        assert torch.equal(out, cuda_ops.binop_plain(F, mode, a, b))
        assert F.decode_ints(out[:50]) == [fn(x, y) % F.p
                                          for x, y in zip(xs[:50], ys[:50])]


def test_kernel_b_matches_plain(cuda):
    n = 3000
    gen = C.from_affine_ints([(C.gen_x, C.gen_y)], cuda).expand(n, 3, 8)
    ks = C.Fr.encode_ints(_ints(C.Fr.p, n - 3, 3), cuda)
    P = C.generator_mul(ks)
    assert torch.equal(C.eq(P, C.scalar_mul(gen, ks)),
                       torch.ones(n, dtype=torch.bool, device=cuda))
    Q = C.generator_mul(C.Fr.encode_ints(_ints(C.Fr.p, n - 3, 4), cuda))
    Q[10:20] = P[10:20]
    Q[20:30] = C.neg(P[20:30])
    inf = C.is_identity(Q)
    inf[5::11] = True
    Qa = C.batch_normalize(Q)
    assert torch.equal(cuda_ec.ec_add(C, P, Q), cuda_ec.ec_add_plain(C, P, Q))
    assert torch.equal(cuda_ec.ec_double(C, P),
                       cuda_ec.ec_double_plain(C, P))
    assert torch.equal(cuda_ec.ec_madd(C, P, Qa, inf),
                       cuda_ec.ec_madd_plain(C, P, Qa, inf))
    pts = C.to_affine_ints(P[:40])
    assert C.to_affine_ints(C.double(P[:40])) == \
        [host_msm().host_msm(C, [2], [p]) for p in pts]


def test_kernel_c_matches_plain(cuda):
    F = BN254_FR
    for log_m, outer, inner in ((10, 2, 3), (9, 1, 8), (1, 3, 5)):
        m = 1 << log_m
        x = F.encode_ints(_ints(F.p, outer * m * inner - 3, log_m),
                          cuda).reshape(outer, m, inner, 8)
        omega = pow(F.root_of_unity, 1 << (F.S - log_m), F.p)
        table = stage_table(F, omega, log_m, cuda)
        assert torch.equal(base_ntt(F, x, table, log_m),
                           base_ntt_plain(F, x, table, log_m))
    a = F.encode_ints(_ints(F.p, (2 << 12) - 3, 5), "cpu").reshape(
        2, 1 << 12, 8)
    assert torch.equal(get_ntt(F, 12, cuda).forward(a.to(cuda)).cpu(),
                       get_ntt(F, 12, "cpu").forward(a))
    ntt = get_ntt(F, 20, cuda)
    big = a.reshape(-1, 8).to(cuda).repeat(128, 1).reshape(1 << 20, 8)
    assert torch.equal(ntt.inverse(ntt.forward(big)), big)


def test_kernel_d_matches_plain_and_naive(cuda):
    n = 1 << 10
    bases = C.generator_mul(C.Fr.encode_ints(_ints(C.Fr.p, n - 3, 6), cuda))
    desc = StreamMSM(C, bases)
    for vals in (_ints(C.Fr.p, n - 3, 7), [0] * n, [C.Fr.p - 5] * n):
        s = C.Fr.encode_ints(vals, cuda)
        keys = stream_keys(C, s, desc.lanes)
        assert torch.equal(stream_bucket(C, keys, desc.table),
                           stream_bucket_plain(C, keys, desc.table))
        assert C.to_affine_ints(desc(s)[None]) == \
            C.to_affine_ints(naive_msm(C, s, bases)[None])


def test_gpu_proof_equals_cpu_proof(cuda):
    F = BN254_FR
    circuit, inst = plonk_api().plonk_api_instance(F)
    proofs = []
    for dev in ("cpu", cuda):
        params = ParamsKZG.new(5, device=dev)
        pk = api.keygen(F, params, 5, circuit)
        proofs.append(api.create_proof(params, pk, [circuit], [inst],
                                       random.Random(1)))
        assert api.verify(params, pk.vk, proofs[-1], [inst])
    assert proofs[0] == proofs[1]
