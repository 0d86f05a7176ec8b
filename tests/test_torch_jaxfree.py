"""halo2_tpu_torch imports and proves without JAX: a fresh interpreter with
`jax` blocked imports the port, proves plonk_api at k=5 on the CPU and
verifies the proof (and rejects a tampered one)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import random, sys
sys.modules["jax"] = None
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from halo2_tpu_torch import api
from halo2_tpu_torch._shared import plonk_api
from halo2_tpu_torch.commit import ParamsKZG
from halo2_tpu_torch.fields import BN254_FR as F
circuit, inst = plonk_api().plonk_api_instance(F)
params = ParamsKZG.new(5)
pk = api.keygen(F, params, 5, circuit)
proof = api.create_proof(params, pk, [circuit], [inst], random.Random(1))
bad = bytearray(proof)
bad[100] ^= 1
ok = api.verify(params, pk.vk, proof, [inst])
rejected = not api.verify(params, pk.vk, bytes(bad), [inst])
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None)
print("RESULT", ok, rejected, len(proof))
"""


def test_port_proves_and_verifies_without_jax():
    res = subprocess.run([sys.executable, "-c", CHILD, ROOT],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "RESULT True True 2208" in res.stdout, res.stdout[-2000:]
