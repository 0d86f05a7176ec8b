"""CPU fixtures of the benchmark's tests: a checkout root whose
BENCHMARK.json points each configuration at a copy cut to a small k, so
that a whole run fits a test."""

from __future__ import annotations

import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SMALL_K = 6


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cells() -> list:
    return [w["name"] for w in bench()["workloads"]]


def config(name: str) -> dict:
    entry = [c for c in bench()["configs"] if c["name"] == name][0]
    with open(os.path.join(ROOT, entry["file"])) as f:
        return json.load(f)


@pytest.fixture
def small_root(tmp_path, request, monkeypatch):
    """A root with BENCHMARK.json and every configuration at k = SMALL_K,
    or at the test module's SMALL_CUDA_K; the IPA parameters' cache in
    it too."""
    monkeypatch.setenv("HALO2_TPU_CACHE", str(tmp_path / "halo2_tpu"))
    k = getattr(request.module, "SMALL_CUDA_K", SMALL_K)
    b = bench()
    for c in b["configs"]:
        cfg = config(c["name"])
        cfg["k"] = k
        path = tmp_path / f"{c['name']}.json"
        path.write_text(json.dumps(cfg))
        c["file"] = path.name
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return str(tmp_path)
