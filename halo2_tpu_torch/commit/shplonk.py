"""KZG multiopen, SHPLONK variant (port of the JAX reference's commit/shplonk.py;
poly/kzg/multiopen/shplonk/{prover,verifier}.rs).

Commitments are grouped by their rotation set (first-appearance order of
sets, points sorted); one quotient commitment h1 over all sets, then a
linearization polynomial opened at u via h2.  The transcript order is the
reference's: y, v, h1, u, h2.
"""

from __future__ import annotations

from typing import List

import torch

from ..poly.arith import (eval_polynomial_int, eval_polys_at_points,
                          kate_division, lagrange_interpolate_int, tree_sum)
from ..poly.poly import COEFF, unwrap
from .base import ProverQuery, VerifierQuery
from .kzg import DualMSM, GuardKZG, MSMKZG, ParamsKZG


def construct_intermediate_sets(queries, key_fn, eval_fn):
    """(rotation_sets, super_point_set); each set is (payloads, points,
    evals_matrix) with evals_matrix[ci][pi] the eval of commitment ci at
    points[pi]."""
    comm_order = []
    comm_rotations = {}
    comm_payload = {}
    evals = {}
    super_points = set()
    for q in queries:
        key = key_fn(q)
        super_points.add(q.point)
        if key not in comm_rotations:
            comm_order.append(key)
            comm_rotations[key] = set()
            comm_payload[key] = q
        comm_rotations[key].add(q.point)
        evals[(key, q.point)] = eval_fn(q)
    set_order = []
    set_commitments = {}
    for key in comm_order:
        pts = tuple(sorted(comm_rotations[key]))
        if pts not in set_commitments:
            set_order.append(pts)
            set_commitments[pts] = []
        set_commitments[pts].append(key)
    rotation_sets = []
    for pts in set_order:
        keys = set_commitments[pts]
        rotation_sets.append((
            [comm_payload[k] for k in keys], list(pts),
            [[evals[(k, pt)] for pt in pts] for k in keys]))
    return rotation_sets, sorted(super_points)


def _eval_vanishing(p: int, roots: List[int], u: int) -> int:
    acc = 1
    for r in roots:
        acc = acc * (u - r) % p
    return acc


def _weighted_sum(F, stack, weights):
    """sum_i weights[i] * stack[i]: (s, n, 8) x (s, 8) -> (n, 8)."""
    return tree_sum(F, F.mul(stack, weights[:, None, :]), dim=0)


class ProverSHPLONK:
    QUERY_INSTANCE = False

    def __init__(self, params: ParamsKZG):
        self.params = params

    def create_proof(self, rng, transcript, queries: List[ProverQuery]):
        params = self.params
        F = params.curve.Fr
        p = F.p
        n = params.n
        dev = params.device

        y = transcript.squeeze_challenge()
        rotation_sets, super_point_set = construct_intermediate_sets(
            queries, key_fn=lambda q: id(q.poly_ref), eval_fn=lambda q: None)

        reqs = [(q.poly_ref.poly, pt) for payloads, points, _ in rotation_sets
                for q in payloads for pt in points]
        vals = iter(eval_polys_at_points(F, reqs))
        set_evals = [[[next(vals) for _ in points] for _ in payloads]
                     for payloads, points, _ in rotation_sets]

        v = transcript.squeeze_challenge()

        # per set: fold_i = sum_j y^j P_ij; K_i = (fold_i - R_i) / prod(X - pt)
        # with R_i the interpolant of the y-folded evals; h = sum_i v^i K_i
        folds, kates, r_folds = [], [], []
        for (payloads, points, _), evals in zip(rotation_sets, set_evals):
            m = len(payloads)
            ypows = [1] * m
            for j in range(1, m):
                ypows[j] = ypows[j - 1] * y % p
            fold_evals = [sum(yj * evals[j][pi] for j, yj in
                              enumerate(ypows)) % p
                          for pi in range(len(points))]
            r_fold = lagrange_interpolate_int(p, points, fold_evals)
            r_folds.append(r_fold)
            stack = torch.stack([unwrap(q.poly_ref.poly, COEFF,
                                        "ProverSHPLONK") for q in payloads])
            fold = _weighted_sum(F, stack, F.encode_ints(ypows, dev))
            r_pad = torch.zeros_like(fold)
            r_pad[:len(points)] = F.encode_ints(r_fold, dev)
            div = F.sub(fold, r_pad)
            for pt in points:
                div = kate_division(F, div, F.encode_int(pt, dev))
            folds.append(fold)
            kates.append(torch.cat([div, torch.zeros_like(
                fold[: n - div.shape[0]])], dim=0))

        n_sets = len(rotation_sets)
        vpows = [1] * n_sets
        for i in range(1, n_sets):
            vpows[i] = vpows[i - 1] * v % p
        h_x = _weighted_sum(F, torch.stack(kates), F.encode_ints(vpows, dev))
        transcript.write_point(params.commit_affine(h_x))
        u = transcript.squeeze_challenge()

        # l = sum_i (v^i z_diff_i) fold_i - (sum_i v^i z_diff_i c_i) e_0
        #     - Z_T(u) h,  c_i = (y-folded r_i)(u);  h2 = l / (X - u) / z_0
        weights, const_acc, z_diffs = [], 0, []
        for (payloads, points, _), r_fold, pv in zip(
                rotation_sets, r_folds, vpows):
            z_i = _eval_vanishing(
                p, [pt for pt in super_point_set if pt not in points], u)
            z_diffs.append(z_i)
            w = pv * z_i % p
            weights.append(w)
            const_acc = (const_acc + w * eval_polynomial_int(p, r_fold, u)) % p
        zt_eval = _eval_vanishing(p, super_point_set, u)
        l_x = _weighted_sum(F, torch.stack(folds),
                            F.encode_ints(weights, dev))
        e0 = torch.zeros_like(l_x)
        e0[0] = F.encode_int(const_acc, dev)
        l_x = F.sub(F.sub(l_x, e0), F.mul(h_x, F.encode_int(zt_eval, dev)))
        h2 = F.mul(kate_division(F, l_x, F.encode_int(u, dev)),
                   F.encode_int(pow(z_diffs[0], p - 2, p), dev))
        h2 = torch.cat([h2, torch.zeros_like(h2[: n - h2.shape[0]])], dim=0)
        transcript.write_point(params.commit_affine(h2))


class VerifierSHPLONK:
    QUERY_INSTANCE = False

    def __init__(self, params: ParamsKZG):
        self.params = params

    def verify_proof(self, transcript, queries: List[VerifierQuery],
                     msm_accumulator: DualMSM) -> GuardKZG:
        params = self.params
        p = params.curve.Fr.p
        rotation_sets, super_point_set = construct_intermediate_sets(
            queries, key_fn=lambda q: q.commitment_key(),
            eval_fn=lambda q: q.eval)

        y = transcript.squeeze_challenge()
        v = transcript.squeeze_challenge()
        h1 = transcript.read_point()
        u = transcript.squeeze_challenge()
        h2 = transcript.read_point()

        z_0_diff_inverse = z_0 = 0
        outer_msm = MSMKZG(params)
        r_outer_acc = 0
        power_v = 1
        for i, (payloads, points, ev_matrix) in enumerate(rotation_sets):
            diffs = [pt for pt in super_point_set if pt not in points]
            z_diff_i = _eval_vanishing(p, diffs, u)
            if i == 0:
                z_0 = _eval_vanishing(p, points, u)
                z_0_diff_inverse = pow(z_diff_i, p - 2, p)
                z_diff_i = 1
            else:
                z_diff_i = z_diff_i * z_0_diff_inverse % p
            inner_msm = MSMKZG(params)
            r_inner_acc = 0
            power_y = 1
            for q, evs in zip(payloads, ev_matrix):
                r_x = lagrange_interpolate_int(p, points, evs)
                r_inner_acc = (r_inner_acc +
                               power_y * eval_polynomial_int(p, r_x, u)) % p
                if q.is_msm:
                    m = q.commitment.clone()
                    m.scale(power_y)
                    inner_msm.add_msm(m)
                else:
                    inner_msm.append_term(power_y, q.commitment)
                power_y = power_y * y % p
            inner_msm.scale(power_v * z_diff_i % p)
            outer_msm.add_msm(inner_msm)
            r_outer_acc = (r_outer_acc +
                           power_v * r_inner_acc * z_diff_i) % p
            power_v = power_v * v % p

        fq = params.curve.Fq.p
        g1 = (params.curve.gen_x, params.curve.gen_y)
        outer_msm.append_term(r_outer_acc, (g1[0], (-g1[1]) % fq))
        outer_msm.append_term(z_0, (h1[0], (-h1[1]) % fq) if h1 else None)
        outer_msm.append_term(u, h2)
        msm_accumulator.left.append_term(1, h2)
        msm_accumulator.right.add_msm(outer_msm)
        return GuardKZG(msm_accumulator)
