"""KZG multiopen, GWC variant (port of the JAX reference's commit/gwc.py;
poly/kzg/multiopen/gwc{,/prover,/verifier}.rs).

One witness commitment per distinct opening point z:
W_z = commit(sum_i v^i p_i / (X - z)), the points in the order the query
list first meets them; the verifier folds everything into its DualMSM
with powers of u.
"""

from __future__ import annotations

from typing import List

import torch

from ..poly.arith import kate_division, tree_sum
from ..poly.poly import COEFF, unwrap
from .base import ProverQuery, VerifierQuery
from .kzg import DualMSM, GuardKZG, MSMKZG, ParamsKZG


def _group_by_point(queries):
    """gwc.rs:25-49: the queries of each point, points in first-appearance
    order."""
    groups: dict = {}
    for q in queries:
        groups.setdefault(q.point, []).append(q)
    return list(groups.items())


class ProverGWC:
    QUERY_INSTANCE = False

    def __init__(self, params: ParamsKZG):
        self.params = params

    def create_proof(self, rng, transcript, queries: List[ProverQuery]):
        params = self.params
        F = params.curve.Fr
        p = F.p
        dev = params.device
        v = transcript.squeeze_challenge()
        for z, qs in _group_by_point(queries):
            vpows = [1] * len(qs)
            for i in range(1, len(qs)):
                vpows[i] = vpows[i - 1] * v % p
            stack = torch.stack([unwrap(q.poly_ref.poly, COEFF, "ProverGWC")
                                 for q in qs])
            # (sum_i v^i p_i) / (X - z): the Kate division drops exactly
            # the folded evaluation, so no eval is subtracted
            # (gwc/prover.rs:58-90)
            fold = tree_sum(F, F.mul(stack, F.encode_ints(vpows, dev)
                                     [:, None, :]), dim=0)
            w = kate_division(F, fold, F.encode_int(z, dev))
            # n - 1 coefficients: pad to n so that the commitment goes
            # through the params' cached fixed-base table
            w = torch.cat([w, torch.zeros_like(fold[w.shape[0]:])])
            transcript.write_point(params.commit_affine(w))


class VerifierGWC:
    QUERY_INSTANCE = False

    def __init__(self, params: ParamsKZG):
        self.params = params

    def verify_proof(self, transcript, queries: List[VerifierQuery],
                     msm_accumulator: DualMSM) -> GuardKZG:
        params = self.params
        p = params.curve.Fr.p
        v = transcript.squeeze_challenge()
        groups = _group_by_point(queries)
        w = transcript.read_n_points(len(groups))
        u = transcript.squeeze_challenge()

        commitment_multi = MSMKZG(params)
        eval_multi = 0
        witness = MSMKZG(params)
        witness_with_aux = MSMKZG(params)
        power_u = 1
        for (z, qs), wi in zip(groups, w):
            batch = MSMKZG(params)
            eval_batch = 0
            power_v = 1
            for q in qs:
                if q.is_msm:
                    m = q.commitment.clone()
                    m.scale(power_v)
                    batch.add_msm(m)
                else:
                    batch.append_term(power_v, q.commitment)
                eval_batch = (eval_batch + power_v * q.eval) % p
                power_v = power_v * v % p
            batch.scale(power_u)
            commitment_multi.add_msm(batch)
            eval_multi = (eval_multi + power_u * eval_batch) % p
            witness_with_aux.append_term(power_u * z % p, wi)
            witness.append_term(power_u, wi)
            power_u = power_u * u % p

        msm_accumulator.left.add_msm(witness)
        msm_accumulator.right.add_msm(witness_with_aux)
        msm_accumulator.right.add_msm(commitment_multi)
        # - eval_multi G1
        curve = params.curve
        msm_accumulator.right.append_term(
            eval_multi, (curve.gen_x, (-curve.gen_y) % curve.Fq.p))
        return GuardKZG(msm_accumulator)
