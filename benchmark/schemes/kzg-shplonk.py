"""KZG on BN254, multi-opened with SHPLONK, over a Blake2b transcript.

The parameters come from the configuration's fixed SRS seed: the harness
hands the trapdoor s to the program's `ParamsKZG.setup`, and the plain
reference works the verifying key out from s and checks each opening by
the G1 identity that the pairing check stands for."""

from __future__ import annotations

from benchmark import work
from benchmark.reference import bn254, kzg, plonk
from benchmark.reference.srs import srs_secret
from benchmark.reference.vk import VerifyingKey, kzg_key

CURVE = "bn254"
TRANSCRIPT = "blake2b"
REFERENCE_CURVE = bn254.G1
MULTIOPEN_COMMITMENTS = 2           # SHPLONK's h1 and h2
Rejected = plonk.Rejected


def program(config: dict, device):
    """(params, field, create_proof keyword arguments) on the port."""
    from halo2_tpu_torch.commit import ParamsKZG, ProverSHPLONK
    from halo2_tpu_torch.fields import BN254_FR
    from halo2_tpu_torch.transcript import Blake2bWrite
    params = ParamsKZG.setup(config["k"], s=srs_secret(config["srs_seed"]),
                             device=device)
    return params, BN254_FR, {"transcript_cls": Blake2bWrite,
                              "multiopen_prover_cls": ProverSHPLONK}


def reference_key(shape, config: dict, plain, rows: int) -> VerifyingKey:
    k = config["k"]
    return kzg_key(shape, srs_secret(config["srs_seed"]),
                   plain.fixed_columns(k, rows, shape.usable_rows),
                   plain.copies(k, rows))


def verify(shape, key: VerifyingKey, proof: bytes, instance):
    """Raises Rejected where the proof fails a check."""
    plonk.verify(shape, key, proof, instance, kzg.shplonk(key.extra["s"]))


def msm_work(shape, advice, lookup_columns, instance) -> work.LayerWork:
    """The instance is absorbed, not committed; SHPLONK commits h1 and
    h2 over n points."""
    dense = work.derived_commitments(shape) + MULTIOPEN_COMMITMENTS
    return work.msm_work(shape, CURVE, advice, lookup_columns,
                         [shape.n] * dense)
