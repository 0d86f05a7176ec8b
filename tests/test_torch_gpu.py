"""Kernels A-D, 8-15, kernel B's chains and the ordering pass of
halo2_tpu_torch (BN254 and Pasta instances) against their plain PyTorch
versions on a CUDA device, the sorted fixed-base MSM (CachedMSM) against
StreamMSM and the CPU, and GPU proofs (KZG / SHPLONK, IPA, and the
shuffle circuit on KZG / GWC / Keccak256) against CPU proofs; the
lookup's host permute against its device permute, and a lookup_heavy
proof under HALO2_TPU_SANITY=1 (and HALO2_TPU_HOST_LOOKUP=1) against the
plain one; key and params serde and the MockProver on the card against
the CPU; the column encoder's words against the CPU's.  Every test
needs the card and skips without one.  The file
imports nothing of JAX, so on a machine without JAX run it as

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from halo2_tpu_torch import _build, api
from halo2_tpu_torch.commit import (ParamsIPA, ParamsKZG, ProverSHPLONK,
                                    SingleStrategyKZG, VerifierSHPLONK)
from halo2_tpu_torch.compat import (SerdeFormat, pk_read, pk_write,
                                    plonk_api, shuffle_api, vk_read,
                                    vk_write)
from halo2_tpu_torch.config import ProofConfig
from halo2_tpu_torch.curves import BN254_G1 as C, PALLAS, VESTA, cuda_ec
from halo2_tpu_torch.dev import MockProver
from halo2_tpu_torch.fields import (BN254_FQ, BN254_FR, PASTA_FP, PASTA_FQ,
                                    cuda_ops)
from halo2_tpu_torch.msm import StreamMSM, msm, naive_msm
from halo2_tpu_torch.msm import bucket_scan as bs
from halo2_tpu_torch.msm import stream_msm as sm
from halo2_tpu_torch.msm.host_msm import host_msm
from halo2_tpu_torch.ntt import fused, get_ntt
from halo2_tpu_torch.ntt.fused import (BIG, FusedNTT, NttPass, base_ntt,
                                       base_ntt_plain)
from halo2_tpu_torch.poly import EvaluationDomain
from halo2_tpu_torch.tools import alu_probe, dma_gather_probe, transpose_probe

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


def test_column_encoder_matches_cpu(cuda):
    """`encode_ints_cols` on the card (64-bit columns in one pinned copy, a
    wide column, a full-width one, both staged in pinned memory by the
    native pass, a tail of drawn rows) equals the CPU's words; two calls
    back to back, so a reused pinned block would show.  So do
    `encode_ints`, `encode_int` and the prover's `_random_poly`."""
    F = BN254_FR
    n, rng = 1 << 16, random.Random(5)
    calls = []
    for _ in range(2):
        cols = [[rng.randrange(1 << 33) for _ in range(n)] for _ in range(4)]
        cols[2][n // 3] = F.p + 5
        cols[3] = [rng.randrange(1 << 256) for _ in range(n)]
        tail = [[rng.randrange(F.p) for _ in range(6)] for _ in cols]
        calls.append((cols, tail, F.encode_ints_cols(cols, cuda, tail=tail)))
    for cols, tail, got in calls:
        assert torch.equal(got.cpu(), F.encode_ints_cols(cols, "cpu",
                                                         tail=tail))
    # the other routes through the same staging: values and constants,
    # and the vanishing argument's random polynomial
    from halo2_tpu_torch.plonk.prover import _random_poly
    vals = [0, 1, F.p - 1, F.p, (1 << 64) - 1, 1 << 64, -1]
    assert torch.equal(F.encode_ints(vals, cuda).cpu(),
                       F.encode_ints(vals, "cpu"))
    assert torch.equal(
        torch.stack([F.encode_int(v, cuda) for v in vals]).cpu(),
        torch.stack([F.encode_int(v, "cpu") for v in vals]))
    assert torch.equal(_random_poly(F, n, random.Random(9), cuda).cpu(),
                       _random_poly(F, n, random.Random(9), "cpu"))


@pytest.mark.parametrize("F", [BN254_FR, BN254_FQ, PASTA_FP, PASTA_FQ],
                         ids=["fr", "fq", "pasta-fp", "pasta-fq"])
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


@pytest.mark.parametrize("C", [C, PALLAS, VESTA],
                         ids=["bn254", "pallas", "vesta"])
def test_kernel_b_matches_plain(C, cuda):
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
        [host_msm(C, [2], [p]) for p in pts]


@pytest.mark.parametrize("C", [C, PALLAS, VESTA],
                         ids=["bn254", "pallas", "vesta"])
def test_kernel_b_chains_match_plain(C, cuda):
    """Kernel B's two chains against their plain versions: scalar mul
    with one scalar for all points and with per-lane scalars (0, 1, p - 1
    among them), and the Horner combine at the MSMs' window shapes."""
    n = 256
    P = C.double(C.generator_mul(C.Fr.encode_ints(_ints(C.Fr.p, n - 3, 13),
                                                  cuda)))
    P[9] = C.identity((), cuda)
    ks = C.Fr.encode_ints(_ints(C.Fr.p, n - 3, 14), cuda)
    for k in (ks, ks[4], ks[:3]):
        Pk = P[:3] if k.shape[0] == 3 else P
        assert torch.equal(C.scalar_mul(Pk, k),
                           cuda_ec.scalar_mul_plain(C, Pk, k))
    pts = C.to_affine_ints(P[:8])
    vals = C.Fr.decode_ints(ks[:8])
    assert C.to_affine_ints(C.scalar_mul(P[:8], ks[:8])) == \
        [host_msm(C, [v], [p]) for v, p in zip(vals, pts)]
    for nw, c in ((43, 6), (33, 8), (65, 4)):
        S = P[:nw]
        assert torch.equal(bs.horner_windows(C, S, c),
                           bs.horner_windows_plain(C, S, c))


C_FLAGS = ("load", "pad", "store", "truncate", "twiddle", "transpose")


def _words_below_p(F, n: int, seed: int, dev) -> torch.Tensor:
    """n random canonical elements as (n, 8) words, made without python
    ints: the top word below p's."""
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8),
                                             dtype=np.uint64)
    w[:, 7] %= F.p >> 224
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)


def _c_case(F, log_m: int, flags, dev, seed: int, outer=2, inner=3):
    """Kernel C's pass along axis 1 of (outer, m, inner) words with the
    factors and masks named in `flags` (see NttPass); "transpose" writes
    (outer, inner, m).  The output starts as zeros."""
    m, p = 1 << log_m, F.p
    if outer * m * inner > 1 << 12:
        x = _words_below_p(F, outer * m * inner, seed, dev)
    else:
        x = F.encode_ints(_ints(p, outer * m * inner, seed)[
            :outer * m * inner], dev)
    x = x.reshape(outer, m, inner, 8)
    w = pow(F.root_of_unity, 1 << (F.S - log_m), p)
    powers = F.encode_ints([pow(w, e, p) for e in range(max(m // 2, 1))], dev)
    tr = "transpose" in flags
    dims = ((inner, 1, 0, m if tr else 1, 0),
            (outer, m * inner, 0, m * inner, 0))
    consts = _ints(p, 6, seed + 1)[3:9]
    twiddle = None
    if "twiddle" in flags:
        log_n = log_m + 2
        wn = pow(F.root_of_unity, 1 << (F.S - log_n), p)
        lo_bits = (log_n + 1) // 2
        twiddle = (0, log_n, lo_bits,
                   F.encode_ints([pow(wn, e, p)
                                  for e in range(1 << lo_bits)], dev),
                   F.encode_ints([pow(wn, e << lo_bits, p)
                                  for e in range(1 << (log_n - lo_bits))],
                                 dev))
    return NttPass(
        x, torch.zeros_like(x), powers, log_m, dims,
        (inner, 1, 1 if tr else inner, 1),
        (m + 1) // 2 if "pad" in flags else BIG,
        (m + 1) // 2 if "truncate" in flags else BIG,
        F.encode_ints(consts[:3], dev) if "load" in flags else None,
        F.encode_ints(consts[3:], dev) if "store" in flags else None,
        twiddle)


@pytest.mark.parametrize("F", [BN254_FR, PASTA_FP, PASTA_FQ],
                         ids=["fr", "pasta-fp", "pasta-fq"])
def test_kernel_c_matches_plain(F, cuda):
    """Every flag combination at m = 2^1 .. 2^10 on 6 columns; every flag
    on 600 columns (several blocks, a partial last one); and every flag,
    with and without the transposed store, on enough columns for a block
    of the most columns at that m (min(MAX_COLS, ELEMS / m)), with a
    partial last block."""
    for log_m in range(1, 11):
        for bits in range(1 << len(C_FLAGS)):
            flags = [f for i, f in enumerate(C_FLAGS) if bits >> i & 1]
            case = _c_case(F, log_m, flags, cuda, log_m + bits)
            want = base_ntt_plain(F, _c_case(F, log_m, flags, cuda,
                                             log_m + bits))
            assert torch.equal(base_ntt(F, case), want), (log_m, flags)
        case = _c_case(F, log_m, C_FLAGS, cuda, 7, outer=3, inner=200)
        want = base_ntt_plain(F, _c_case(F, log_m, C_FLAGS, cuda, 7, 3, 200))
        assert torch.equal(base_ntt(F, case), want), log_m
        per_block = min(fused.MAX_COLS, fused.ELEMS >> log_m)
        sms = fused.sm_count(cuda.index or 0)
        cols = fused.BLOCKS_PER_SM * sms * per_block + 5
        assert fused._log_cols(log_m, cols, sms) == per_block.bit_length() - 1
        for flags in (C_FLAGS, C_FLAGS[:-1]):
            case = _c_case(F, log_m, flags, cuda, 9, outer=1, inner=cols)
            want = base_ntt_plain(F, dataclasses.replace(
                case, dst=torch.zeros_like(case.dst)))
            assert torch.equal(base_ntt(F, case), want), (log_m, flags)


@pytest.mark.parametrize("F", [BN254_FR, PASTA_FP, PASTA_FQ],
                         ids=["fr", "pasta-fp", "pasta-fq"])
def test_transforms_match_cpu(F, cuda):
    """Whole transforms on the card equal the CPU-plain ones: forward and
    inverse at 2^11 and 2^12, the coset pair of domains extended to 2^11
    and 2^12, a plan of two split levels (base capped at 2^3), and
    inverse(forward(x)) at 2^20 and 2^22."""
    for log_n in (11, 12):
        a = F.encode_ints(_ints(F.p, (2 << log_n) - 3, log_n),
                          "cpu").reshape(2, 1 << log_n, 8)
        gpu, cpu = get_ntt(F, log_n, cuda), get_ntt(F, log_n, "cpu")
        assert torch.equal(gpu.forward(a.to(cuda)).cpu(), cpu.forward(a))
        assert torch.equal(gpu.inverse(a.to(cuda)).cpu(), cpu.inverse(a))
        dg = EvaluationDomain(F, 5, log_n - 2, cuda)
        dc = EvaluationDomain(F, 5, log_n - 2, "cpu")
        c = a[:, : dc.n]
        assert torch.equal(dg.coeff_to_extended(c.to(cuda)).cpu(),
                           dc.coeff_to_extended(c))
        assert torch.equal(dg.extended_to_coeff(a.to(cuda)).cpu(),
                           dc.extended_to_coeff(a))
        omega = pow(F.root_of_unity, 1 << (F.S - log_n), F.p)
        two_g = FusedNTT(F, log_n, omega, cuda, _log_max_base=3)
        two_c = FusedNTT(F, log_n, omega, "cpu", _log_max_base=3)
        assert torch.equal(two_g.forward(a.to(cuda)).cpu(), two_c.forward(a))
        assert torch.equal(two_g._transform(
            a[:, :1000].to(cuda), True, load=(2, 3, 5), store=(7, 11, 13),
            rows=999).cpu(), two_c._transform(
            a[:, :1000], True, load=(2, 3, 5), store=(7, 11, 13), rows=999))
    for log_n in (20, 22):
        ntt = get_ntt(F, log_n, cuda)
        big = a.reshape(-1, 8).to(cuda).repeat(1 << (log_n - 13), 1)
        assert torch.equal(ntt.inverse(ntt.forward(big)), big)


def _stream_scalar_sets(C, n: int, seed: int) -> list:
    """Random, 16-bit, zero, equal, one-bucket and sparse (0, 1, 2)
    scalars."""
    rng = np.random.default_rng(seed)
    return [_ints(C.Fr.p, n - 3, seed),
            [int(v) for v in rng.integers(0, 1 << 16, size=n)], [0] * n,
            [C.Fr.p - 5] * n, [1] * n,
            [int(v) for v in rng.integers(0, 3, size=n)]]


def _check_stream_pass(C, keys, table, per_window):
    """The ordering pass and kernel D or 8 against their plain versions."""
    nkeys = sm.n_keys(keys, per_window)
    pieces = sm.pieces_for(C, keys.numel(), nkeys, keys.device)
    slots = sm.slots_for(pieces, nkeys)
    order, info = sm.msm_order(keys, per_window, pieces)
    p_order, p_info = sm.msm_order_plain(keys, per_window, pieces)
    total = int(info[0])
    assert torch.equal(info, p_info)
    assert torch.equal(order[:total], p_order[:total])
    got = sm.stream_bucket_windows(C, order, table, info, nkeys, slots) \
        if per_window else sm.stream_bucket(C, order, table, info, slots)
    assert torch.equal(got, sm.accumulate_plain(C, order, table, info, nkeys,
                                                slots))


@pytest.mark.parametrize("C", [C, VESTA], ids=["bn254", "vesta"])
def test_kernel_d_matches_plain_and_naive(C, cuda):
    n = 1 << 10
    bases = C.generator_mul(C.Fr.encode_ints(_ints(C.Fr.p, n - 3, 6), cuda))
    desc = StreamMSM(C, bases)
    for vals in _stream_scalar_sets(C, n, 7):
        s = C.Fr.encode_ints(vals, cuda)
        _check_stream_pass(C, sm.stream_keys(C, s), desc.table, False)
        assert C.to_affine_ints(desc(s)[None]) == \
            C.to_affine_ints(naive_msm(C, s, bases)[None])


@pytest.mark.parametrize("C", [C, VESTA], ids=["bn254", "vesta"])
def test_kernel_8_matches_plain_and_naive(C, cuda):
    n = 1 << 10
    bases = C.generator_mul(C.Fr.encode_ints(_ints(C.Fr.p, n - 3, 8), cuda))
    table = sm.pack_base_stream_table(C, bases)
    for vals in _stream_scalar_sets(C, n, 9):
        s = C.Fr.encode_ints(vals, cuda)
        _check_stream_pass(C, sm.stream_keys(C, s), table, True)
        assert C.to_affine_ints(sm.msm_stream_unbaked(C, s, table)[None]) \
            == C.to_affine_ints(naive_msm(C, s, bases)[None])


def test_cached_msm_matches_stream_msm_and_cpu(cuda):
    """The sorted fixed-base MSM on the card (kernel 9, B and the sort),
    baked in one chunk and in window chunks, and unbaked in chunks that
    shift_add combines, against StreamMSM on the same bases and the
    CPU-plain CachedMSM, all scalars and fewer."""
    from halo2_tpu_torch.msm import CachedMSM
    n = 1 << 10
    for G in (C, VESTA):
        bases = G.generator_mul(G.Fr.encode_ints(_ints(G.Fr.p, n - 3, 13),
                                                 cuda))
        bases[5] = G.identity((1,), cuda)[0]
        stream = StreamMSM(G, bases)
        s = G.Fr.encode_ints(_ints(G.Fr.p, n - 3, 14), cuda)
        for m in (n, 700):
            want = G.to_affine_ints(stream(s[:m])[None])
            for kw in (dict(), dict(max_rows=8 * n),
                       dict(max_rows=8 * n, max_baked_rows=1)):
                desc = CachedMSM(G, bases, c=8, **kw)
                assert desc.baked == ("max_baked_rows" not in kw)
                assert G.to_affine_ints(desc(s[:m])[None]) == want, (m, kw)
        cpu = CachedMSM(G, bases[:256].cpu(), c=8)
        card = CachedMSM(G, bases[:256], c=8)
        assert G.to_affine_ints(cpu(s[:256].cpu())[None]) == \
            G.to_affine_ints(card(s[:256])[None])


@pytest.mark.parametrize("C", [C, PALLAS, VESTA],
                         ids=["bn254", "pallas", "vesta"])
def test_kernel_9_matches_plain(C, cuda):
    n = 1 << 12
    pts = C.generator_mul(C.Fr.encode_ints(_ints(C.Fr.p, n - 3, 10), cuda))
    pts[7::13] = C.identity((1,), cuda)
    rows = bs.pack_affine_rows(C.batch_normalize(pts), C.is_identity(pts))
    runs = torch.sort(torch.from_numpy(np.random.default_rng(11).integers(
        0, 60, size=n)).to(torch.int32))[0]
    for keys in (runs, torch.full((n,), 9, dtype=torch.int32)):
        keys = keys.clone()
        keys[-128:] = bs.SENTINEL_KEY
        keys = keys.to(cuda)
        for mode, data, k in ((bs.PACKED, rows, keys),
                              (bs.AFFINE, rows, keys >> 1),
                              (bs.PROJECTIVE, pts, keys >> 1)):
            for block in (64, bs.MIN_BLOCK, 8):
                got = bs.scan_level(C, k, data, block, mode)
                want = bs.scan_level_plain(C, k, data, block, mode)
                assert torch.equal(got[0], want[0]), block
                assert torch.equal(got[1], want[1]), block
    vals = _ints(C.Fr.p, n - 3, 12)
    s = C.Fr.encode_ints(vals, cuda)
    assert C.to_affine_ints(msm(C, s, pts)[None]) == \
        [host_msm(C, vals, C.to_affine_ints(pts))]


def test_gpu_proof_equals_cpu_proof(cuda):
    F = BN254_FR
    circuit, inst = plonk_api.plonk_api_instance(F)
    proofs = []
    for dev in ("cpu", cuda):
        params = ParamsKZG.new(5, device=dev)
        pk = api.keygen(F, params, 5, circuit)
        proofs.append(api.create_proof(params, pk, [circuit], [inst],
                                       random.Random(1),
                                       multiopen_prover_cls=ProverSHPLONK))
        assert api.verify(params, pk.vk, proofs[-1], [inst],
                          multiopen_verifier_cls=VerifierSHPLONK,
                          strategy_cls=SingleStrategyKZG)
    assert proofs[0] == proofs[1]


def test_gpu_ipa_proof_equals_cpu_proof(cuda, tmp_path, monkeypatch):
    F = PASTA_FP
    circuit, inst = plonk_api.plonk_api_instance(F)
    proofs = []
    for dev in ("cpu", cuda):
        # an empty params cache for each side, so that each makes its own
        monkeypatch.setenv("HALO2_TPU_CACHE", str(tmp_path / str(dev)))
        params = ParamsIPA.new(VESTA, 6, device=dev)
        pk = api.keygen(F, params, 6, circuit)
        proofs.append(api.create_proof(params, pk, [circuit], [inst],
                                       random.Random(1)))
        assert api.verify(params, pk.vk, proofs[-1], [inst])
    assert proofs[0] == proofs[1]


def test_host_permute_matches_device_permute(cuda):
    """The lookup's host permute (HALO2_TPU_HOST_LOOKUP=1) against the
    sort-based device permute on CUDA tensors at 2^16 rows: a table with
    repeats, inputs with ties."""
    from halo2_tpu_torch.plonk.lookup_sort import (
        permute_expression_pair, permute_expression_pair_device)
    F = BN254_FR
    n = 1 << 16
    rng = random.Random(5)
    values = [0, 1, F.p - 1] + _ints(F.p, 5000, 6)
    table = [rng.choice(values) for _ in range(n)]
    inp = [rng.choice(table) for _ in range(n)]
    perm_in, perm_tab = permute_expression_pair(inp, table, "range")
    a, s = permute_expression_pair_device(F, F.encode_ints(inp, cuda),
                                          F.encode_ints(table, cuda), n)
    assert F.decode_ints(a) == perm_in
    assert F.decode_ints(s) == perm_tab


def test_gpu_lookup_sanity_proof_equals_plain(cuda, monkeypatch):
    """lookup_heavy k=10 on the card: the proofs under HALO2_TPU_SANITY=1,
    and under it with HALO2_TPU_HOST_LOOKUP=1, equal the plain one (every
    sanity check passing)."""
    from halo2_tpu_torch.compat.lookup_heavy import lookup_heavy_instance
    F, k = BN254_FR, 10
    circuit, inst, kg_circuit = lookup_heavy_instance(F, k)
    params = ParamsKZG.new(k, device=cuda)
    pk = api.keygen(F, params, k, kg_circuit)
    proofs = []
    for env in ({}, {"HALO2_TPU_SANITY": "1"},
                {"HALO2_TPU_SANITY": "1", "HALO2_TPU_HOST_LOOKUP": "1"}):
        with monkeypatch.context() as mp:
            for name, value in env.items():
                mp.setenv(name, value)
            proofs.append(api.create_proof(
                params, pk, [circuit], [inst], random.Random(1),
                multiopen_prover_cls=ProverSHPLONK))
    assert proofs[0] == proofs[1] == proofs[2]
    assert api.verify(params, pk.vk, proofs[0], [inst],
                      multiopen_verifier_cls=VerifierSHPLONK,
                      strategy_cls=SingleStrategyKZG)


def test_gpu_shuffle_gwc_keccak_proof_equals_cpu_proof(cuda):
    circuit, kg_circuit, _ = shuffle_api.shuffle_instance(8)
    proofs = []
    for dev in ("cpu", cuda):
        cfg = ProofConfig(k=8, scheme="kzg-gwc", transcript="keccak256",
                          device=str(dev))
        params = cfg.params()
        pk = cfg.keygen(kg_circuit, params=params)
        proofs.append(cfg.prove(pk, [circuit], [[]], random.Random(1),
                                params=params))
        assert cfg.verify(pk.vk, proofs[-1], [[]], params=params)
    assert proofs[0] == proofs[1]


@pytest.mark.parametrize("F", [BN254_FR, BN254_FQ], ids=["fr", "fq"])
def test_kernels_10_11_match_plain(F, cuda):
    """At 5,000 elements, at a tail (2^12 K + 3, K the elements a thread
    runs) and below one block."""
    per_thread = _build.library().h2_mont_elems_per_thread()
    for n in (5000, 4096 * per_thread + 3, 100):
        a = alu_probe.random_elems(F, n, 13, cuda)
        b = alu_probe.random_elems(F, n, 14, cuda)
        for reps in (0, 1, 7):
            assert torch.equal(alu_probe.mont_repeat(F, a, b, reps),
                               alu_probe.mont_repeat_plain(F, a, b, reps))


def test_kernel_12_matches_plain(cuda):
    """The u32 chain and its IMAD.WIDE form."""
    a = alu_probe.random_u32((8, 3000), 15, cuda)
    b = alu_probe.random_u32((8, 3000), 16, cuda)
    for wide in (False, True):
        for reps in (1, 17, 64):
            assert torch.equal(
                alu_probe.u32_mul_repeat(a, b, reps, wide),
                alu_probe.u32_mul_repeat_plain(a, b, reps, wide))


def test_kernels_13_15_match_plain(cuda):
    idx = dma_gather_probe.random_idx(3001, 700, 17, cuda)
    for width in (128, 64, 4):
        tbl = dma_gather_probe.mk_tbl(700, width, cuda)
        assert torch.equal(dma_gather_probe.gather_rows(idx, tbl),
                           dma_gather_probe.gather_rows_plain(idx, tbl))
    for shape in ((3001, 16), (16, 3001), (33, 65), (7, 9)):
        x = alu_probe.random_u32(shape, 18, cuda)
        for fn in (transpose_probe.limb_T_fwd, transpose_probe.limb_T_bwd):
            assert torch.equal(fn(x), transpose_probe.transpose_plain(x))


def test_gpu_serde_equals_cpu(cuda):
    """plonk_api's KZG keys and params at k=8 written on the card give the
    CPU's bytes in every format, and read back onto the card equal."""
    F = BN254_FR
    circuit, _ = plonk_api.plonk_api_instance(F)
    keys = {}
    for dev in ("cpu", cuda):
        params = ParamsKZG.new(8, device=dev)
        keys[str(dev)] = (params, api.keygen(F, params, 8, circuit))
    (cpu_params, cpu_pk), (params, pk) = keys["cpu"], keys[str(cuda)]
    for fmt in SerdeFormat:
        data = pk_write(pk, fmt)
        assert data == pk_write(cpu_pk, fmt)
        assert vk_write(pk.vk, fmt) == vk_write(cpu_pk.vk, fmt)
        back = pk_read(F, params, 8, circuit, data, fmt)
        assert back.vk.pinned() == pk.vk.pinned()
        for name in ("l0", "l_last", "l_active_row", "fixed_values",
                     "fixed_polys", "fixed_cosets"):
            assert torch.equal(getattr(back, name), getattr(pk, name))
        for name in ("permutations", "polys", "cosets"):
            assert torch.equal(getattr(back.permutation, name),
                               getattr(pk.permutation, name))
        assert vk_read(F, params, 8, circuit, vk_write(pk.vk, fmt),
                       fmt).transcript_repr == pk.vk.transcript_repr
        blob = params.write(fmt)
        assert blob == cpu_params.write(fmt)
        back = ParamsKZG.read(blob, fmt, device=cuda)
        assert torch.equal(back.g, params.g)
        assert torch.equal(back.g_lagrange, params.g_lagrange)


def test_gpu_mock_prover_equals_cpu(cuda):
    """The MockProver's failures on the card equal the CPU's at k=8:
    plonk_api with its instance and with the instance + 1, the shuffle and
    the two-phase circuits with good and bad witnesses."""
    circuit, inst = plonk_api.plonk_api_instance(BN254_FR)
    cases = [(BN254_FR, circuit, inst),
             (BN254_FR, circuit, [[v + 1 for v in col] for col in inst])]
    for name in ("shuffle", "phase"):
        good, _, bad = getattr(shuffle_api, f"{name}_instance")(8)
        cases += [(BN254_FR, good, []), (BN254_FR, bad, [])]
    kinds = []
    for F, circuit, inst in cases:
        runs = [[(f.kind, f.detail, str(f.location), f.cell_values)
                 for f in MockProver.run(F, 8, circuit, inst,
                                         device=dev).verify()]
                for dev in ("cpu", cuda)]
        assert runs[0] == runs[1]
        kinds.append(sorted({f[0] for f in runs[1]}))
    # plonk_api's instance enters through its 'Public input' gate
    assert kinds == [[], ["gate"], [], ["shuffle"], [], ["gate"]]


def test_dist_on_a_virtual_mesh_matches_one_device(cuda):
    """The sharded NTT (batched columns, forward and inverse), prefix
    product and MSMs on Mesh([cuda:0] * 4) against the unsharded port
    functions on the card (MSMs as group elements), and a meshed k=5 KZG
    proof against the unmeshed one."""
    from halo2_tpu_torch.dist import (Mesh, ShardedCachedMSM, ShardedNTT,
                                      sharded_msm, sharded_prefix_product)
    from halo2_tpu_torch.engine import GpuMsmEngine, PlonkEngineConfig
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = Mesh([dev] * 4)
    for F, log_n in ((BN254_FR, 14), (PASTA_FP, 11)):
        a = torch.stack([F.encode_ints(_ints(F.p, (1 << log_n) - 3, s), dev)
                         for s in (1, 2)])
        dist = ShardedNTT(mesh, F, log_n)
        single = get_ntt(F, log_n, dev)
        assert torch.equal(dist.forward(a), single.forward(a))
        assert torch.equal(dist.inverse(a), single.inverse(a))
        assert torch.equal(sharded_prefix_product(mesh, F, a[0]),
                           F.prefix_product(a[0]))
    n = 1 << 12
    for G in (C, VESTA):
        pts = G.generator_mul(G.Fr.encode_ints(_ints(G.Fr.p, n - 3, 3), dev))
        s = G.Fr.encode_ints(_ints(G.Fr.p, n - 3, 4), dev)
        want = G.to_affine_ints(msm(G, s, pts)[None])
        assert G.to_affine_ints(sharded_msm(mesh, G, s, pts)[None]) == want
        assert G.to_affine_ints(
            ShardedCachedMSM(mesh, G, pts)(s)[None]) == want
    F = BN254_FR
    circuit, inst = plonk_api.plonk_api_instance(F)
    params = ParamsKZG.new(5, device=dev)
    proofs = []
    for engine in (None, PlonkEngineConfig.set_msm(GpuMsmEngine(mesh=mesh),
                                                   mesh=mesh)):
        pk = api.keygen(F, params, 5, circuit, engine=engine)
        proofs.append(api.create_proof(params, pk, [circuit], [inst],
                                       random.Random(1), engine=engine,
                                       multiopen_prover_cls=ProverSHPLONK))
    assert proofs[0] == proofs[1]
