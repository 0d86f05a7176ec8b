"""Key and params serde in the port against the JAX reference, at K=5:
SimpleCircuit on IPA / Vesta (the setting of test_dev_tools.py) and
plonk_api on KZG / BN254 (test_torch_e2e.py's).  The reference's params
and keys are built with its own constructors from the port's points and
key tensors, which equal its keygen's (test_torch_ipa.py,
test_torch_e2e.py and test_torch_shuffle.py hold the keys, pinned form
and hash, against the reference's keygen), so that no reference keygen
compiles here; everything below is serialised and read by each package's
own code.  In each
SerdeFormat: the port's vk_write / pk_write bytes equal the reference's;
each package reads the other's bytes into keys equal to its own; a
corrupted RAW_BYTES coordinate or element raises ValueError in both; the
version byte and k are checked; an unchecked read of an out-of-range
element keeps what the reference keeps.  ParamsKZG.write and
ParamsIPA.write give the reference's bytes, and each package reads the
other's params.  Exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuits import SimpleCircuit as RefSimple
from halo2_tpu.commit import ParamsIPA as RefParamsIPA
from halo2_tpu.commit import ParamsKZG as RefParamsKZG
from halo2_tpu.compat import serde as ref_serde
from halo2_tpu.compat.plonk_api import plonk_api_instance as ref_plonk_api
from halo2_tpu.curves import BN254_G1 as REF_G1
from halo2_tpu.curves import VESTA as REF_VESTA
from halo2_tpu.fields import BN254_FR as REF_FR
from halo2_tpu.fields import PASTA_FP as REF_FP
from halo2_tpu.frontend.circuit import compile_circuit as ref_compile
from halo2_tpu.plonk.keygen import ConstraintSystemBack as RefCsBack
from halo2_tpu.plonk.keygen import PermutationPK as RefPermutationPK
from halo2_tpu.plonk.keygen import PermutationVK as RefPermutationVK
from halo2_tpu.plonk.keygen import ProvingKey as RefProvingKey
from halo2_tpu.plonk.keygen import VerifyingKey as RefVerifyingKey
from halo2_tpu.plonk.prover import Evaluator as RefEvaluator
from halo2_tpu.poly.domain import EvaluationDomain as RefDomain
from halo2_tpu_torch import api
from halo2_tpu_torch.commit import ParamsIPA, ParamsKZG
from halo2_tpu_torch.compat import (SerdeFormat, pk_read, pk_write, vk_read,
                                    vk_write)
from halo2_tpu_torch.compat.from_jax import limbs_from_jax, limbs_to_jax
from halo2_tpu_torch.compat.plonk_api import plonk_api_instance
from halo2_tpu_torch.curves import VESTA
from halo2_tpu_torch.examples.simple_example import SimpleCircuit
from halo2_tpu_torch.fields import BN254_FR, PASTA_FP
from tests._torch_params_cache import own_params_cache  # noqa: F401

torch.set_num_threads(1)

K = 5
SCHEMES = ("ipa", "kzg")
FORMATS = list(SerdeFormat)
PK_TENSORS = ("l0", "l_last", "l_active_row", "fixed_values", "fixed_polys",
              "fixed_cosets")
PERM_TENSORS = ("permutations", "polys", "cosets")


def _ref_fmt(fmt):
    return ref_serde.SerdeFormat[fmt.name]


def _ref_pk(rF, curve, rcircuit, pk):
    """The reference's ProvingKey with the port's commitments and tensors
    (what its pk_read builds)."""
    cs = RefCsBack(ref_compile(rF, K, rcircuit)[0].cs, rF.p)
    domain = RefDomain(rF, max(cs.degree(), 2), K)
    vk = RefVerifyingKey(rF, curve, domain, cs, pk.vk.fixed_commitments,
                         RefPermutationVK(pk.vk.permutation.commitments), K)

    def j(t):
        return jnp.asarray(limbs_to_jax(t))

    perm = pk.permutation
    return RefProvingKey(
        vk, j(pk.l0), j(pk.l_last), j(pk.l_active_row), j(pk.fixed_values),
        j(pk.fixed_polys), j(pk.fixed_cosets),
        RefPermutationPK(j(perm.permutations), j(perm.polys), j(perm.cosets)),
        RefEvaluator(rF, domain, cs))


@pytest.fixture(scope="module")
def keys():
    """scheme -> (ref F, ref params, ref pk, ref circuit, F, params, pk,
    circuit)."""
    ipa = ParamsIPA.new(VESTA, K, device="cpu")
    kzg = ParamsKZG.new(K, device="cpu")
    out = {}
    for scheme, rF, curve, rparams, rcircuit, F, params, circuit in (
            ("ipa", REF_FP, REF_VESTA, RefParamsIPA(
                REF_VESTA, K, g_aff=ipa.g_aff,
                g_lagrange_aff=ipa.g_lagrange_aff, w=ipa.w_aff,
                u=ipa.u_aff), RefSimple(7), PASTA_FP, ipa, SimpleCircuit(7)),
            ("kzg", REF_FR, REF_G1, RefParamsKZG(
                K, kzg.g_aff, kzg.g_lagrange_aff, kzg.g2, kzg.s_g2,
                kzg.s_secret), ref_plonk_api(REF_FR)[0], BN254_FR, kzg,
             plonk_api_instance(BN254_FR)[0])):
        pk = api.keygen(F, params, K, circuit)
        rpk = _ref_pk(rF, curve, rcircuit, pk)
        assert rpk.vk.pinned() == pk.vk.pinned()
        out[scheme] = (rF, rparams, rpk, rcircuit, F, params, pk, circuit)
    return out


def _assert_pk_equal(pk, other):
    assert other.vk.pinned() == pk.vk.pinned()
    assert other.vk.transcript_repr == pk.vk.transcript_repr
    for name in PK_TENSORS:
        assert torch.equal(getattr(other, name), getattr(pk, name)), name
    for name in PERM_TENSORS:
        assert torch.equal(getattr(other.permutation, name),
                           getattr(pk.permutation, name)), name


def _assert_ref_pk_equal(rpk, other):
    assert other.vk.transcript_repr == rpk.vk.transcript_repr
    for name in PK_TENSORS:
        assert np.array_equal(np.asarray(getattr(other, name)),
                              np.asarray(getattr(rpk, name))), name
    for name in PERM_TENSORS:
        assert np.array_equal(np.asarray(getattr(other.permutation, name)),
                              np.asarray(getattr(rpk.permutation, name))), name


@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.name)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_key_bytes_equal_the_reference(keys, scheme, fmt):
    _, _, rpk, _, _, _, pk, _ = keys[scheme]
    assert vk_write(pk.vk, fmt) == ref_serde.vk_write(rpk.vk, _ref_fmt(fmt))
    assert pk_write(pk, fmt) == ref_serde.pk_write(rpk, _ref_fmt(fmt))


@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.name)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_each_package_reads_the_other(keys, scheme, fmt):
    rF, rparams, rpk, rc, F, params, pk, c = keys[scheme]
    rfmt = _ref_fmt(fmt)
    vk = vk_read(F, params, K, c,
                 ref_serde.vk_write(rpk.vk, rfmt), fmt)
    assert vk.pinned() == pk.vk.pinned()
    assert vk.fixed_commitments == pk.vk.fixed_commitments
    _assert_pk_equal(pk, pk_read(F, params, K, c,
                                 ref_serde.pk_write(rpk, rfmt), fmt))
    rvk = ref_serde.vk_read(rF, rparams, K, rc,
                            vk_write(pk.vk, fmt), rfmt)
    assert rvk.transcript_repr == rpk.vk.transcript_repr
    _assert_ref_pk_equal(rpk, ref_serde.pk_read(
        rF, rparams, K, rc, pk_write(pk, fmt), rfmt))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_corrupted_raw_bytes_raise_in_both(keys, scheme):
    """A coordinate byte of the first fixed commitment, then the top byte
    of a pk element (>= p): RAW_BYTES refuses both in both packages."""
    rF, rparams, rpk, rc, F, params, pk, c = keys[scheme]
    raw = SerdeFormat.RAW_BYTES
    blob = bytearray(vk_write(pk.vk, raw))
    blob[14] ^= 0x5A
    with pytest.raises(ValueError):
        vk_read(F, params, K, c, bytes(blob), raw)
    with pytest.raises(ValueError):
        ref_serde.vk_read(rF, rparams, K, rc, bytes(blob),
                          _ref_fmt(raw))
    pkb = bytearray(pk_write(pk, raw))
    top = len(vk_write(pk.vk, raw)) + 4 + 31     # l0[0]'s last byte
    pkb[top] = 0xFF
    with pytest.raises(ValueError, match="out of range"):
        pk_read(F, params, K, c, bytes(pkb), raw)
    with pytest.raises(ValueError, match="out of range"):
        ref_serde.pk_read(rF, rparams, K, rc, bytes(pkb),
                          _ref_fmt(raw))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_unchecked_read_reduces_as_the_reference(keys, scheme):
    rF, rparams, rpk, rc, F, params, pk, c = keys[scheme]
    fmt = SerdeFormat.RAW_BYTES_UNCHECKED
    pkb = bytearray(pk_write(pk, fmt))
    top = len(vk_write(pk.vk, fmt)) + 4 + 31
    pkb[top] = 0xFF
    mine = pk_read(F, params, K, c, bytes(pkb), fmt)
    theirs = ref_serde.pk_read(rF, rparams, K, rc, bytes(pkb),
                               _ref_fmt(fmt))
    assert torch.equal(mine.l0, limbs_from_jax(np.asarray(theirs.l0)))
    assert not torch.equal(mine.l0, pk.l0)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_version_byte_and_k_checked(keys, scheme):
    rF, rparams, rpk, rc, F, params, pk, c = keys[scheme]
    blob = vk_write(pk.vk)
    assert blob[0] == 0x04 and blob[1] == K
    for bad, what in ((bytes([3]) + blob[1:], "version"),
                      (blob[:1] + bytes([K + 1]) + blob[2:], "k mismatch")):
        with pytest.raises(ValueError, match=what):
            vk_read(F, params, K, c, bad)
        with pytest.raises(ValueError, match=what):
            ref_serde.vk_read(rF, rparams, K, rc, bad)


@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.name)
def test_params_kzg_bytes_and_read_back(keys, fmt):
    rparams, params = keys["kzg"][1], keys["kzg"][5]
    blob = params.write(fmt)
    assert blob == rparams.write(_ref_fmt(fmt))
    back = ParamsKZG.read(blob, fmt, s_secret=params.s_secret, device="cpu")
    assert torch.equal(back.g, params.g)
    assert torch.equal(back.g_lagrange, params.g_lagrange)
    assert (back.g2, back.s_g2, back.k) == (params.g2, params.s_g2, K)
    theirs = RefParamsKZG.read(blob, _ref_fmt(fmt))
    assert theirs.g_aff == rparams.g_aff
    assert theirs.g_lagrange_aff == rparams.g_lagrange_aff


def test_params_kzg_raw_bytes_checks_points(keys):
    params = keys["kzg"][5]
    raw = SerdeFormat.RAW_BYTES
    blob = bytearray(params.write())
    blob[4 + 64 * 3 + 5] ^= 0x21                # x of g[3]: off the curve
    with pytest.raises(ValueError, match="not on curve"):
        ParamsKZG.read(bytes(blob), raw, device="cpu")
    blob = bytearray(params.write())
    blob[4 + 64 * 3 + 31] = 0xFF                # x of g[3] >= q
    with pytest.raises(ValueError, match="out of range"):
        ParamsKZG.read(bytes(blob), raw, device="cpu")


def test_params_ipa_bytes_and_read_back(keys):
    rparams, params = keys["ipa"][1], keys["ipa"][5]
    blob = params.write()
    assert blob == rparams.write()
    back = ParamsIPA.read(VESTA, blob, device="cpu")
    assert torch.equal(back.g, params.g)
    assert torch.equal(back.g_lagrange, params.g_lagrange)
    assert (back.w_aff, back.u_aff) == (params.w_aff, params.u_aff)
    assert RefParamsIPA.read(REF_VESTA, blob).g_lagrange_aff == \
        rparams.g_lagrange_aff
