"""The port's benchmark (halo2_tpu_torch.bench) on the CPU at tiny sizes:
its generated points are (i+1) G, its MSM engine on them equals the host
MSM, the micro stage returns the reference's keys, `auto_c` is the
reference's, and the e2e stage's steady proof is byte for byte a direct
`create_proof` under the same seed (the call that tests/test_torch_e2e.py
holds against the JAX package).  All comparisons are exact."""

import hashlib
import random

import torch

from halo2_tpu.msm.msm import auto_c as ref_auto_c
from halo2_tpu_torch import api, bench
from halo2_tpu_torch.commit import ParamsKZG, ProverSHPLONK
from halo2_tpu_torch.compat import plonk_api
from halo2_tpu_torch.curves import BN254_G1 as G
from halo2_tpu_torch.msm import StreamMSM
from halo2_tpu_torch.msm.bucket_scan import n_windows_for
from halo2_tpu_torch.msm.host_msm import host_msm
from halo2_tpu_torch.msm.msm import auto_c
from halo2_tpu_torch.tools.alu_probe import random_elems

# The plain versions run many small tensor ops: one thread per worker
# is as fast and leaves the other cores to the other test workers.
torch.set_num_threads(1)

K = 6

ROOFLINE_KEYS = {"field_mul_per_s", "field_mul_methodology",
                 "field_mul_stream_per_s", "msm_roofline_pts_per_s",
                 "msm_fraction", "ntt_roofline_elems_per_s", "ntt_fraction"}


def test_gen_points_and_their_msm_match_host():
    pts = bench.gen_points(G, K, "cpu")
    aff = G.to_affine_ints(pts)
    g = (G.gen_x, G.gen_y)
    assert aff == [host_msm(G, [i + 1], [g]) for i in range(1 << K)]
    s = random_elems(G.Fr, 1 << K, 3, "cpu")
    got = G.to_affine_ints(StreamMSM(G, pts)(s)[None])
    assert got == [host_msm(G, G.Fr.decode_ints(s), aff)]


def test_stage_micro_returns_the_reference_keys():
    res = bench.stage_micro("cpu", k=K, ntt_k=6, rk=1 << 11, mul_reps=2,
                            ntt_reps=1, runs=1, min_s=0)
    assert {"msm_points_per_sec", "ntt_elems_per_sec", "roofline"} <= set(res)
    assert ROOFLINE_KEYS <= set(res["roofline"])
    assert res["device"] == "cpu"
    assert res["roofline"]["msm_windows"] == n_windows_for(G.Fr, auto_c(1 << K))
    assert res["roofline"]["msm_engine_windows"] == 43
    assert res["msm_points_per_sec"] > 0 and res["ntt_elems_per_sec"] > 0
    # the card's guards (and their SASS bound) run on the card only
    assert "field_mul_alu_bound_per_s" not in res["roofline"]


def test_auto_c_matches_reference():
    for n in (1, 33, 1 << 6, 1 << 12, 1 << 16, 1 << 18, 1 << 20, 1 << 24):
        assert auto_c(n) == ref_auto_c(n), n
    assert n_windows_for(G.Fr, auto_c(1 << 18)) == 20


def test_bench_e2e_proof_equals_direct_proof(monkeypatch):
    """The stage's params are ParamsKZG.new(5); its proving key is taken
    from its own keygen call (recorded) to save a second keygen."""
    keys = []

    def keygen(*args):
        keys.append(api_keygen(*args))
        return keys[-1]

    api_keygen = api.keygen
    monkeypatch.setattr(api, "keygen", keygen)
    res = bench.bench_e2e(5, device="cpu")
    F = G.Fr
    params = ParamsKZG.new(5, device="cpu")
    circuit, inst = plonk_api.plonk_api_instance(F)
    proof = api.create_proof(params, keys[0], [circuit], [inst],
                             random.Random(2),
                             multiopen_prover_cls=ProverSHPLONK)
    assert res["proof_sha256"] == hashlib.sha256(proof).hexdigest()
    assert res["proof_bytes"] == len(proof)
    assert {"k", "circuit", "scheme", "keygen_s", "prove_first_s", "prove_s",
            "verify_s", "proof_bytes", "steps_s"} <= set(res)
    assert res["k"] == 5 and res["circuit"] == "plonk_api"
    assert res["steps_s"]
