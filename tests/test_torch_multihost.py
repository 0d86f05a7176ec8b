"""The port's sharded NTT across processes: two processes over gloo, each
with 4 CPU shards (tests/_torch_multihost_child.py, which imports only the
port), on a flat 8-shard mesh and on the 2 x 4 (hosts, rows) hybrid mesh.
The forward transform at k=10 over BN254 must equal the reference's
single-process `get_ntt(F, 10).forward`, computed here, word for word.
The rendezvous is a file under tmp_path: no port is bound."""

import os
import random
import subprocess
import sys

import pytest
import torch

from halo2_tpu.fields import BN254_FR as REF_F
from halo2_tpu.ntt import get_ntt as ref_get_ntt
from halo2_tpu_torch.fields import BN254_FR as F

K = 10


@pytest.fixture(scope="module")
def want():
    coeffs = REF_F.rand_ints(1 << K, random.Random(77))
    return REF_F.decode_ints(ref_get_ntt(REF_F, K).forward(
        REF_F.encode_ints(coeffs)))


@pytest.mark.parametrize("layout", ["flat", "hybrid"])
def test_sharded_ntt_across_two_processes(tmp_path, want, layout):
    child = os.path.join(os.path.dirname(__file__),
                         "_torch_multihost_child.py")
    out = tmp_path / f"mh-{layout}.pt"
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, child, str(rank), "2", init, str(K), str(out),
         layout, "cpu", "4"], stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for rank in range(2)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            errs.append((p.returncode, err.decode()[-2000:]))
    finally:
        for p in procs:
            p.kill()
    assert all(rc == 0 for rc, _ in errs), errs
    got = F.decode_ints(torch.load(out))
    assert got == want, "multi-process NTT diverged from the reference"
