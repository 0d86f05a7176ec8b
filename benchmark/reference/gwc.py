"""GWC's multi-open verifier (poly/kzg/multiopen/gwc/verifier.rs) for KZG
with a known trapdoor s: one witness commitment W_i a distinct opening
point z_i, the points in the order the queries first name them.  The
pairing check e(sum u^i W_i, [s]G2) = e(sum u^i (z_i W_i + C_i - e_i G),
G2), with C_i and e_i the v-folds of the commitments and evaluations at
z_i, is the equal G1 identity

    sum u^i (s - z_i) W_i = sum u^i (C_i - e_i G)."""

from __future__ import annotations

from .plonk import Rejected


def points_in_order(queries) -> list:
    """(z, [(commitment, eval), ...]) a distinct point, in first-appearance
    order, each point's queries in theirs."""
    groups: dict = {}
    for _key, comm, pt, ev in queries:
        groups.setdefault(pt, []).append((comm, ev))
    return list(groups.items())


def gwc(s: int):
    """The multi-open check of a plonk query list for trapdoor s."""
    def check(t, queries):
        curve = t.curve
        R = curve.r
        groups = points_in_order(queries)
        v = t.squeeze_challenge()
        ws = [t.read_point() for _ in groups]
        u = t.squeeze_challenge()
        left, scalars, points = [], [], []
        power_u, evals = 1, 0
        for (z, qs), w in zip(groups, ws):
            left.append(power_u * (s - z) % R)
            power_v = 1
            for comm, ev in qs:
                scalars.append(power_u * power_v % R)
                points.append(comm)
                evals = (evals + power_u * power_v * ev) % R
                power_v = power_v * v % R
            power_u = power_u * u % R
        scalars.append(-evals % R)
        points.append(curve.gen)
        if curve.msm(left, ws) != curve.msm(scalars, points):
            raise Rejected("the opening: sum u^i (s - z_i) W_i != "
                           "sum u^i (C_i - e_i G)")
    return check
