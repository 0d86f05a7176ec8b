"""The port's IPA params disk cache against the reference's: the same file
name under $HALO2_TPU_CACHE/params and the same bytes.  A cold
`ParamsIPA.new` makes the params and writes the file, a warm one reads it
and makes nothing; cold and warm params are equal tensor for tensor; a
file the reference's cache wrote is read by the port."""

import os

import pytest
import torch

import halo2_tpu.commit.ipa as ref_ipa
from halo2_tpu.commit import ParamsIPA as RefParamsIPA
from halo2_tpu.curves import VESTA as REF_VESTA
from halo2_tpu_torch.commit import ParamsIPA
from halo2_tpu_torch.commit.ipa import params_cache_path
from halo2_tpu_torch.curves import VESTA

torch.set_num_threads(1)

K = 4


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """Both packages' caches under tmp_path (the reference reads
    $HALO2_TPU_CACHE when it is imported, so its path is set here)."""
    monkeypatch.setenv("HALO2_TPU_CACHE", str(tmp_path))
    monkeypatch.setattr(ref_ipa, "_PARAMS_CACHE", str(tmp_path / "params"))
    return tmp_path


def _no_generate(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a warm cache made params anew")
    monkeypatch.setattr(ParamsIPA, "_generate", staticmethod(refuse))


def test_cold_then_warm(cache, monkeypatch):
    path = params_cache_path(VESTA, K)
    assert path == os.path.join(str(cache), "params",
                                f"ipa-v2-pasta__Vesta-{K}.bin")
    assert not os.path.exists(path)
    cold = ParamsIPA.new(VESTA, K, device="cpu")
    with open(path, "rb") as f:
        data = f.read()
    assert data == cold.write()
    _no_generate(monkeypatch)
    warm = ParamsIPA.new(VESTA, K, device="cpu")
    assert warm.write() == data
    assert torch.equal(warm.g, cold.g)
    assert torch.equal(warm.g_lagrange, cold.g_lagrange)
    assert (warm.w_aff, warm.u_aff) == (cold.w_aff, cold.u_aff)


def test_file_equals_the_reference_cache(cache, monkeypatch):
    """The reference's cache writes the file; the port reads it (making
    nothing) and writes the same bytes when cold."""
    curve = VESTA
    ref = RefParamsIPA.new(REF_VESTA, K)
    path = params_cache_path(curve, K)
    with open(path, "rb") as f:
        data = f.read()
    assert data == ref.write()
    monkeypatch.setattr(ParamsIPA, "_generate", staticmethod(
        lambda *a: pytest.fail("the reference's file was not read")))
    read = ParamsIPA.new(curve, K, device="cpu")
    assert read.write() == data
    monkeypatch.undo()
    monkeypatch.setenv("HALO2_TPU_CACHE", str(cache / "port"))
    assert ParamsIPA.new(curve, K, device="cpu").write() == data
    with open(params_cache_path(curve, K), "rb") as f:
        assert f.read() == data
