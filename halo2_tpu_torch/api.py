"""Top-level proving API (port of the JAX reference's api.py), with its
defaults: IPA multiopen and strategy, Blake2b transcript.  The device is
the params' device (CUDA unless the caller names another).

    params = ParamsIPA.new(VESTA, k)
    pk = keygen(PASTA_FP, params, k, circuit)
    proof = create_proof(params, pk, [circuit], [instances], rng)
    ok = verify(params, pk.vk, proof, [instances])

KZG callers pass `multiopen_prover_cls=ProverSHPLONK` (or `ProverGWC`),
and `multiopen_verifier_cls=VerifierSHPLONK` (or `VerifierGWC`),
`strategy_cls=SingleStrategyKZG`; an EVM verifier's transcript is
`Keccak256Write` / `Keccak256Read`.  `config.ProofConfig` picks all of
these from names.  `keygen` and `create_proof` take an `engine`
(`engine.PlonkEngine`); one with a mesh (dist/) shards their transforms,
fixed-base MSMs and permutation products over the mesh's devices, with
the proof bytes of one device.
"""

from __future__ import annotations

from typing import List, Optional

from .frontend import WitnessCalculator, compile_circuit
from .frontend.circuit import configure_circuit
from .frontend.constraint_system import ConstraintSystem
from .plonk.errors import VerifyError
from .commit import (ParamsIPA, ProverIPA, SingleStrategyIPA,  # noqa: F401
                     VerifierIPA, new_rng)
from .engine import PlonkEngine
from .plonk import Prover
from .plonk import keygen as backend_keygen
from .plonk.verifier import (  # noqa: F401
    verify_proof as backend_verify_queries)
from .plonk.verifier import verify_proof_single
from .trace import Trace
from .transcript import Blake2bRead, Blake2bWrite


def keygen(F, params, k: int, circuit, compress_selectors: bool = True,
           engine: Optional[PlonkEngine] = None):
    """compile_circuit + backend keygen; returns the ProvingKey (.vk)."""
    compiled, _config, _cs = compile_circuit(F, k, circuit,
                                             compress_selectors)
    return backend_keygen(F, params, compiled, k, engine=engine)


def create_proof(params, pk, circuits: List, instances, rng=None,
                 transcript_cls=Blake2bWrite,
                 multiopen_prover_cls=ProverIPA,
                 engine: Optional[PlonkEngine] = None,
                 timings: Optional[dict] = None) -> bytes:
    """One proof over one or more circuit instances.  Pass a dict as
    `timings` to collect the proof's record (`trace.py`): seconds under
    each [TRANSCRIPT-N] step and its parts, and the proof's kernel
    launches, MSM elements and host waits."""
    F = pk.vk.F
    k = pk.vk.k
    rng = rng if rng is not None else new_rng()
    transcript = transcript_cls(params.curve)
    mo_prover = multiopen_prover_cls(params)
    trace = Trace(timings, params.device)

    with trace.proof():
        with trace.span("instances [T1-2]"):
            prover = Prover(params, pk, instances, rng, transcript,
                            query_instance=mo_prover.QUERY_INSTANCE,
                            engine=engine, trace=trace)

        with trace.span("witness+advice_commits [T3-4]"):
            with trace.span("synthesis [T3-4]"):
                calcs = []
                for circuit, inst in zip(circuits, instances):
                    cs_front = ConstraintSystem()
                    config = configure_circuit(circuit, cs_front)
                    calcs.append(WitnessCalculator(F, k, circuit, config,
                                                   cs_front, inst))
            challenges = {}
            for phase in pk.vk.cs.cs.phases():
                with trace.span("synthesis [T3-4]"):
                    witnesses = [calc.calc(phase, challenges)
                                 for calc in calcs]
                challenges = prover.commit_phase(phase, witnesses)

        queries = prover.create_proof()
        with trace.span("multiopen [T24+]"):
            mo_prover.create_proof(rng, transcript, queries)
    return transcript.finalize()


def verify(params, vk, proof: bytes, instances,
           transcript_cls=Blake2bRead,
           multiopen_verifier_cls=VerifierIPA,
           strategy_cls=SingleStrategyIPA) -> bool:
    try:
        return verify_proof_single(params, vk, proof, instances,
                                   transcript_cls, multiopen_verifier_cls,
                                   strategy_cls)
    except VerifyError:
        return False
