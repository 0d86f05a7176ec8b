"""Top-level proving API (port of halo2_tpu/api.py) for KZG / SHPLONK /
Blake2b on BN254.  The device is the params' device.

    params = ParamsKZG.new(k, device="cuda")
    pk = keygen(BN254_FR, params, k, circuit)
    proof = create_proof(params, pk, [circuit], [instances], rng)
    ok = verify(params, pk.vk, proof, [instances])
"""

from __future__ import annotations

import time
from typing import List, Optional

from halo2_tpu.frontend import WitnessCalculator, compile_circuit
from halo2_tpu.frontend.circuit import configure_circuit
from halo2_tpu.frontend.constraint_system import ConstraintSystem

from ._shared import errors
from .commit import (ProverSHPLONK, SingleStrategyKZG, VerifierSHPLONK,
                     new_rng)
from .engine import PlonkEngine
from .plonk import Prover
from .plonk import keygen as backend_keygen
from .plonk.verifier import verify_proof
from .transcript import Blake2bRead, Blake2bWrite


def keygen(F, params, k: int, circuit, compress_selectors: bool = True,
           engine: Optional[PlonkEngine] = None):
    """compile_circuit + backend keygen; returns the ProvingKey (.vk)."""
    compiled, _config, _cs = compile_circuit(F, k, circuit,
                                             compress_selectors)
    return backend_keygen(F, params, compiled, k, engine=engine)


def create_proof(params, pk, circuits: List, instances, rng=None,
                 transcript_cls=Blake2bWrite,
                 multiopen_prover_cls=ProverSHPLONK,
                 engine: Optional[PlonkEngine] = None,
                 timings: Optional[dict] = None) -> bytes:
    """One proof over one or more circuit instances.  Pass a dict as
    `timings` to collect the per-[TRANSCRIPT-N] step wall-time table."""
    F = pk.vk.F
    k = pk.vk.k
    rng = rng if rng is not None else new_rng()
    transcript = transcript_cls(params.curve)
    mo_prover = multiopen_prover_cls(params)

    t0 = time.time()
    prover = Prover(params, pk, instances, rng, transcript,
                    query_instance=mo_prover.QUERY_INSTANCE, engine=engine)
    if timings is not None:
        prover.timings = timings
    prover.timings["instances [T1-2]"] = time.time() - t0

    t0 = time.time()
    calcs = []
    for circuit, inst in zip(circuits, instances):
        cs_front = ConstraintSystem()
        config = configure_circuit(circuit, cs_front)
        calcs.append(WitnessCalculator(F, k, circuit, config, cs_front, inst))
    challenges = {}
    for phase in pk.vk.cs.cs.phases():
        witnesses = [calc.calc(phase, challenges) for calc in calcs]
        challenges = prover.commit_phase(phase, witnesses)
    prover.timings["witness+advice_commits [T3-4]"] = time.time() - t0

    queries = prover.create_proof()
    t0 = time.time()
    mo_prover.create_proof(rng, transcript, queries)
    prover.timings["multiopen [T24+]"] = time.time() - t0
    return transcript.finalize()


def verify(params, vk, proof: bytes, instances,
           transcript_cls=Blake2bRead,
           multiopen_verifier_cls=VerifierSHPLONK,
           strategy_cls=SingleStrategyKZG) -> bool:
    transcript = transcript_cls(params.curve, proof)
    verifier = multiopen_verifier_cls(params)
    try:
        queries = verify_proof(params, vk, transcript, instances,
                               verifier.QUERY_INSTANCE)
        return strategy_cls(params).process(
            lambda msm: verifier.verify_proof(transcript, queries, msm))
    except errors().VerifyError:
        return False
