"""IPA over Vesta (the `halo2` API's default, no trusted setup), its
multi-open and inner-product argument, over a Blake2b transcript.

The program's parameters are `ParamsIPA.new` (the hash-to-curve
generators, cached by the port under `HALO2_TPU_CACHE`).  The plain
reference makes the generators again itself and checks each proof's
inner-product argument with one 2^k-point MSM on python ints; its
generators and verifying key are kept under `.bench_cache/reference/`
in the checkout, so that only a checkout's first run makes them."""

from __future__ import annotations

import os

from benchmark import work
from benchmark.reference import ipa, plonk
from benchmark.reference.pasta import VESTA

CURVE = "vesta"
TRANSCRIPT = "blake2b"
REFERENCE_CURVE = VESTA
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".bench_cache", "reference")
Rejected = plonk.Rejected


def program(config: dict, device):
    """(params, field, create_proof keyword arguments) on the port."""
    from halo2_tpu_torch.commit import ParamsIPA, ProverIPA
    from halo2_tpu_torch.curves import VESTA as PORT_VESTA
    from halo2_tpu_torch.fields import PASTA_FP
    from halo2_tpu_torch.transcript import Blake2bWrite
    params = ParamsIPA.new(PORT_VESTA, config["k"], device=device)
    return params, PASTA_FP, {"transcript_cls": Blake2bWrite,
                              "multiopen_prover_cls": ProverIPA}


def reference_key(shape, config: dict, plain, rows: int):
    k = config["k"]
    params = ipa.Params(k, CACHE)
    key = ipa.ipa_key(shape, params, plain.fixed_columns(
        k, rows, shape.usable_rows), plain.copies(k, rows), CACHE)
    key.extra["params"] = params
    return key


def verify(shape, key, proof: bytes, instance):
    """Raises Rejected where the proof fails a check."""
    params = key.extra["params"]
    comms = key.extra.get(("instance", repr(instance)))
    if comms is None:
        comms = ipa.instance_commitments(shape, params, instance)
        key.extra[("instance", repr(instance))] = comms
    plonk.verify(shape, key, proof, instance, ipa.multiopen(params), comms)


def msm_work(shape, advice, lookup_columns, instance) -> work.LayerWork:
    """The instance columns are committed; the multi-open commits q' and
    the argument's random polynomial over n points, then each of its k
    rounds makes two MSMs of half the points left, with u and w
    appended."""
    n, k = shape.n, shape.k
    dense = [n] * (work.derived_commitments(shape) + 2)
    dense += [(n >> (j + 1)) + 2 for j in range(k) for _ in range(2)]
    return work.msm_work(shape, CURVE, advice, lookup_columns, dense,
                         instance)
