"""halo2_tpu_torch stands alone: a fresh interpreter with `jax` and the JAX
package `halo2_tpu` both blocked imports the port (its dev tools,
middleware, serde, batch verifier and examples too), proves plonk_api with
KZG / SHPLONK and with IPA over Vesta at k=5 (the smallest k plonk_api
fits) on the CPU, verifies both proofs and rejects tampered ones, runs the
MockProver and a vk_write / vk_read round trip (and imports the
multi-device layer, dist/, and the sorted MSM's names); and no file of the port or of chip_smoke.py
names the JAX package."""

import os
import re
import subprocess
import sys

from tests._torch_params_cache import own_params_cache  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import random, sys
sys.modules["jax"] = None
sys.modules["halo2_tpu"] = None
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from halo2_tpu_torch import api
from halo2_tpu_torch.commit import (ParamsIPA, ParamsKZG, ProverSHPLONK,
                                    SingleStrategyKZG, VerifierSHPLONK)
from halo2_tpu_torch.compat import plonk_api, shuffle_api
from halo2_tpu_torch.compat.serde import SerdeFormat, vk_read, vk_write
from halo2_tpu_torch.config import ProofConfig
from halo2_tpu_torch.curves import VESTA
from halo2_tpu_torch.dev import MockProver
from halo2_tpu_torch.fields import BN254_FR, PASTA_FP
import halo2_tpu_torch.examples.circuit_layout
import halo2_tpu_torch.examples.proof_size
import halo2_tpu_torch.examples.two_chip
import halo2_tpu_torch.examples.vector_mul
import halo2_tpu_torch.dist
import halo2_tpu_torch.dist.mesh
import halo2_tpu_torch.dist.msm
import halo2_tpu_torch.dist.multihost
import halo2_tpu_torch.dist.ntt
import halo2_tpu_torch.dist.scan
import halo2_tpu_torch.middleware
import halo2_tpu_torch.plonk.batch
from halo2_tpu_torch.api import ParamsIPA, backend_verify_queries
from halo2_tpu_torch.commit import create_opening_proof, verify_opening_proof
from halo2_tpu_torch.engine import GpuMsmEngine, PlonkEngineConfig
from halo2_tpu_torch.msm import CachedMSM, pippenger_msm
from halo2_tpu_torch.msm.bucket_scan import (
    msm_packed_rows, msm_unbaked_rows, msm_windowed_cached, packed_digits,
    shift_add, sort_perm, unpack_affine_rows)
from halo2_tpu_torch.msm.msm import default_cached_msm, window_bases
from halo2_tpu_torch.msm.stream_msm import auto_c_stream
from halo2_tpu_torch.ntt import NTT, bit_reverse_indices
from halo2_tpu_torch.plonk import VerifyError, evaluate_expression, keygen_vk
from halo2_tpu_torch.poly import eval_polynomial

def run(F, params, k, **kw):
    circuit, inst = plonk_api.plonk_api_instance(F)
    pk = api.keygen(F, params, k, circuit)
    proof = api.create_proof(params, pk, [circuit], [inst], random.Random(1),
                             **{a: b for a, b in kw.items()
                                if a == "multiopen_prover_cls"})
    vkw = {a: b for a, b in kw.items() if a != "multiopen_prover_cls"}
    bad = bytearray(proof)
    bad[100] ^= 1
    ok = api.verify(params, pk.vk, proof, [inst], **vkw)
    rejected = not api.verify(params, pk.vk, bytes(bad), [inst], **vkw)
    fmt = SerdeFormat.RAW_BYTES
    vk = vk_read(F, params, k, circuit, vk_write(pk.vk, fmt), fmt)
    assert vk.pinned() == pk.vk.pinned()
    assert MockProver.run(F, k, circuit, inst, device="cpu").verify() == []
    return ok, rejected, len(proof)

kzg = run(BN254_FR, ParamsKZG.new(5, device="cpu"), 5,
          multiopen_prover_cls=ProverSHPLONK,
          multiopen_verifier_cls=VerifierSHPLONK,
          strategy_cls=SingleStrategyKZG)
ipa = run(PASTA_FP, ParamsIPA.new(VESTA, 5, device="cpu"), 5)
loaded = [m for m in sys.modules if sys.modules[m] is not None and
          (m.split(".")[0] in ("jax", "halo2_tpu"))]
assert not loaded, loaded
print("RESULT", *kzg, *ipa)
"""

# A reference to the JAX package from the port's files: an import of it, a
# module path into it, or a file path into it.
_REF = re.compile(r"\bhalo2_tpu(\.|/| import|\s*$)|\bfrom halo2_tpu\s"
                  r"|\bimport halo2_tpu\b(?!_)", re.M)


def test_port_proves_and_verifies_without_jax():
    res = subprocess.run([sys.executable, "-c", CHILD, ROOT],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "RESULT True True 2208 True True 2752" in res.stdout, res.stdout[-2000:]


def test_port_names_no_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, dirs, names in os.walk(os.path.join(ROOT, "halo2_tpu_torch")):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        files += [os.path.join(base, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh", ".cpp"))]
    hits = []
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if _REF.search(line):
                    hits.append(f"{os.path.relpath(path, ROOT)}:{i}: "
                                f"{line.strip()}")
    assert len(files) > 40
    assert not hits, "\n".join(hits)
