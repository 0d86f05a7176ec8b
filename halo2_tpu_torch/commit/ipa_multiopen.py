"""IPA multiopen (port of the JAX reference's commit/ipa_multiopen.py;
halo2_backend/src/poly/ipa/multiopen.rs and multiopen/{prover,
verifier}.rs): queries grouped into point sets, same-set polynomials
folded by x1, the multi-point quotient built by repeated Kate division and
folded by x2, and the x4-collapsed polynomial opened at x3 by the IPA
argument."""

from __future__ import annotations

import torch

from ..poly.arith import (eval_polynomial_int, eval_polys_at_points,
                          kate_division, lagrange_interpolate_int)
from .base import Blind
from .ipa import MSMIPA, GuardIPA, ParamsIPA, create_opening_proof, \
    verify_opening_proof


def construct_intermediate_sets(queries, key_fn, eval_fn):
    """(commitment_data, point_sets) (multiopen.rs:62-172): commitment_data
    lists (payload query, set index, evals in set order) per commitment in
    first-appearance order; point_sets lists each set's points ordered by
    first appearance."""
    point_index = {}
    comm_order = []
    comm_points = {}
    comm_payload = {}
    comm_evals = {}
    for q in queries:
        if q.point not in point_index:
            point_index[q.point] = len(point_index)
        key = key_fn(q)
        if key not in comm_points:
            comm_order.append(key)
            comm_points[key] = []
            comm_evals[key] = {}
            comm_payload[key] = q
        comm_points[key].append(point_index[q.point])
        comm_evals[key][point_index[q.point]] = eval_fn(q)

    set_index = {}
    commitment_data = []
    for key in comm_order:
        pts = tuple(sorted(set(comm_points[key])))
        if pts not in set_index:
            set_index[pts] = len(set_index)
        commitment_data.append((key, set_index[pts], pts))
    inv_point = {v: k for k, v in point_index.items()}
    point_sets = [None] * len(set_index)
    for pts, idx in set_index.items():
        point_sets[idx] = [inv_point[i] for i in pts]
    return [(comm_payload[key], sidx, [comm_evals[key][i] for i in pts])
            for key, sidx, pts in commitment_data], point_sets


class ProverIPA:
    QUERY_INSTANCE = True

    def __init__(self, params: ParamsIPA):
        self.params = params

    def create_proof(self, rng, transcript, queries):
        params = self.params
        F = params.curve.Fr
        p = F.p
        dev = params.device
        x1 = transcript.squeeze_challenge()
        x2 = transcript.squeeze_challenge()
        comm_data, point_sets = construct_intermediate_sets(
            queries, key_fn=lambda q: id(q.poly_ref), eval_fn=lambda q: None)

        # x1-fold the polynomials that share a point set (prover.rs:49-72)
        q_polys = [None] * len(point_sets)
        q_blinds = [0] * len(point_sets)
        x1_enc = F.encode_int(x1, dev)
        for query, set_idx, _ in comm_data:
            poly = query.poly_ref.poly
            q_polys[set_idx] = poly if q_polys[set_idx] is None else \
                F.add(F.mul(q_polys[set_idx], x1_enc), poly)
            q_blinds[set_idx] = (q_blinds[set_idx] * x1 +
                                 query.poly_ref.blind.value) % p

        # f(X) = sum_i x2^i q_i(X) / prod_{z in set i} (X - z)
        q_prime = None
        x2_enc = F.encode_int(x2, dev)
        for points, poly in zip(point_sets, q_polys):
            div = poly
            for point in points:
                div = kate_division(F, div, F.encode_int(point, dev))
            div = torch.cat([div, div.new_zeros(
                (params.n - div.shape[0],) + div.shape[1:])])
            q_prime = div if q_prime is None else \
                F.add(F.mul(q_prime, x2_enc), div)
        q_prime_blind = Blind(rng.randrange(p))
        transcript.write_point(params.commit_affine(q_prime, q_prime_blind))
        x3 = transcript.squeeze_challenge()
        for v in eval_polys_at_points(F, [(poly, x3) for poly in q_polys]):
            transcript.write_scalar(v)

        x4 = transcript.squeeze_challenge()
        x4_enc = F.encode_int(x4, dev)
        p_poly = q_prime
        p_blind = q_prime_blind.value
        for poly, blind in zip(q_polys, q_blinds):
            p_poly = F.add(F.mul(p_poly, x4_enc), poly)
            p_blind = (p_blind * x4 + blind) % p
        create_opening_proof(params, rng, transcript, p_poly, Blind(p_blind),
                             x3)


class VerifierIPA:
    QUERY_INSTANCE = True

    def __init__(self, params: ParamsIPA):
        self.params = params

    def verify_proof(self, transcript, queries, msm_acc: MSMIPA) -> GuardIPA:
        params = self.params
        p = params.curve.Fr.p
        x1 = transcript.squeeze_challenge()
        x2 = transcript.squeeze_challenge()
        comm_data, point_sets = construct_intermediate_sets(
            queries, key_fn=lambda q: q.commitment_key(),
            eval_fn=lambda q: q.eval)

        n_sets = len(point_sets)
        q_commitments = [params.empty_msm() for _ in range(n_sets)]
        x1_powers = [1] * n_sets
        q_eval_sets = [[0] * len(ps) for ps in point_sets]
        # reverse commitment order, so x1 powers increase
        # (multiopen/verifier.rs:86-95)
        for query, set_idx, evals in reversed(comm_data):
            power = x1_powers[set_idx]
            if query.is_msm:
                m = query.commitment.clone()
                m.scale(power)
                q_commitments[set_idx].add_msm(m)
            else:
                q_commitments[set_idx].append_term(power, query.commitment)
            for j, ev in enumerate(evals):
                q_eval_sets[set_idx][j] = (q_eval_sets[set_idx][j] +
                                           ev * power) % p
            x1_powers[set_idx] = (power * x1) % p

        q_prime_commitment = transcript.read_point()
        x3 = transcript.squeeze_challenge()
        u = [transcript.read_scalar() for _ in range(n_sets)]

        # the expected value of f at x3 (multiopen/verifier.rs:114-128)
        msm_eval = 0
        for points, evals, proof_eval in zip(point_sets, q_eval_sets, u):
            r_eval = eval_polynomial_int(
                p, lagrange_interpolate_int(p, points, evals), x3)
            ev = (proof_eval - r_eval) % p
            for point in points:
                ev = (ev * pow((x3 - point) % p, p - 2, p)) % p
            msm_eval = (msm_eval * x2 + ev) % p

        x4 = transcript.squeeze_challenge()
        msm_acc.append_term(1, q_prime_commitment)
        v = msm_eval
        for q_commitment, q_eval in zip(q_commitments, u):
            msm_acc.scale(x4)
            msm_acc.add_msm(q_commitment)
            v = (v * x4 + q_eval) % p
        return verify_opening_proof(params, msm_acc, transcript, x3, v)
