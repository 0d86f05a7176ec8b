"""Batch verifier (port of the JAX reference's plonk/batch.py;
halo2_backend/src/plonk/verifier/batch.rs:70-138, "batch" feature, IPA-only
in the reference): many proofs' deferred MSMs folded under random scalings,
then one final check, whose dense 2^k MSM runs on the params' cached table
of g (the ordering pass and kernel D on the card)."""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List

from ..commit.ipa import ParamsIPA
from ..commit.ipa_multiopen import VerifierIPA
from .errors import VerifyError
from .keygen import VerifyingKey
from .verifier import verify_proof as backend_verify_queries


@dataclass
class _BatchItem:
    instances: List
    proof: bytes


class BatchVerifier:
    def __init__(self, rng=None):
        self.items: List[_BatchItem] = []
        self.rng = rng or random.SystemRandom()

    def add_proof(self, instances: List[List[List[int]]], proof: bytes):
        self.items.append(_BatchItem(instances, proof))

    def finalize(self, params: ParamsIPA, vk: VerifyingKey,
                 transcript_cls=None) -> bool:
        """Returns False if *some* proof is invalid (batch.rs:104-137).

        Folding follows batch.rs:96-106 `accumulate_msm`: the accumulator
        is rescaled by a fresh random factor before each proof's MSM is
        added, so every proof ends up with an independent random weight and
        two invalid proofs cannot cancel each other's MSM errors.  A
        malformed proof (`VerifyError`: bad bytes, a stream cut short, wrong
        instances) makes the batch False, as do the reference's ValueError
        and AssertionError.  The transcript defaults to Blake2bRead,
        imported here: the transcript module imports this package's errors,
        and so this package."""
        if transcript_cls is None:
            from ..transcript import Blake2bRead as transcript_cls
        acc = params.empty_msm()
        for item in self.items:
            try:
                transcript = transcript_cls(params.curve, item.proof)
                verifier = VerifierIPA(params)
                queries = backend_verify_queries(
                    params, vk, transcript, item.instances,
                    verifier.QUERY_INSTANCE)
                guard = verifier.verify_proof(transcript, queries,
                                              params.empty_msm())
                acc.scale(self.rng.randrange(1, params.curve.Fr.p))
                acc.add_msm(guard.use_challenges())
            except (VerifyError, ValueError, AssertionError):
                return False
        return acc.check()
