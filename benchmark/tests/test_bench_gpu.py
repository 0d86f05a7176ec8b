"""The harness on the card at a small k: a plain and a traced run, each
correct, the traced one with every per-layer metric and every share in
(0, 100].  Skipped, from inside the test, where no card is visible.

    python -m pytest -o addopts="" -m gpu benchmark/tests -q
"""

from __future__ import annotations

import time

import pytest

from benchmark import harness

SMALL_CUDA_K = 10


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card is visible")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_on_the_card(small_root, card, trace):
    res = harness.run("kzg-lookup_heavy-k20.full", 2**32 + 7, 1.0, trace,
                      time.perf_counter(), device=card, root=small_root)
    assert res["checks"]["rejected"] == 0 and res["checks"]["checked"] >= 1
    m = res["metrics"]
    if not trace:
        assert set(m) == {"prove_s", "peak_mem_gib", "setup_s"}
        assert res["peak"] > 0
        return
    assert {"witness_commit_s", "msm_roofline", "ntt_roofline",
            "device_idle", "proof_mfu"} <= set(m)
    for name in ("msm_roofline", "ntt_roofline", "proof_mfu"):
        assert 0 < m[name]["value"] <= 100
    assert 0 < res["busy_s"] < res["window_s"]
    assert res["breakdown"]["device_ops"] and res["breakdown"]["idle_gaps"]
