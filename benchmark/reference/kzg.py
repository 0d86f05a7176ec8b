"""SHPLONK's multi-open verifier (poly/kzg/multiopen/shplonk/verifier.rs)
for KZG with a known trapdoor s: the pairing check e(left, [s]G2) =
e(right, G2) is the equal G1 identity s left = right."""

from __future__ import annotations

from .plonk import Rejected, interpolate_at, vanishing


def shplonk(s: int):
    """The multi-open check of `plonk.verify` for trapdoor s."""
    def check(t, queries):
        left, right = _shplonk(t, queries)
        if t.curve.mul(left, s) != right:
            raise Rejected("the opening: s * left != right")
    return check


def _shplonk(t, queries):
    curve = t.curve
    R = curve.r
    # rotation sets: commitments by first appearance, grouped by their
    # sorted point sets, the sets in first-appearance order
    order, points_of, comm_of, evals = [], {}, {}, {}
    for key, comm, pt, ev in queries:
        if key not in points_of:
            order.append(key)
            points_of[key] = set()
            comm_of[key] = comm
        points_of[key].add(pt)
        evals[(key, pt)] = ev
    set_order, members = [], {}
    for key in order:
        pts = tuple(sorted(points_of[key]))
        if pts not in members:
            set_order.append(pts)
            members[pts] = []
        members[pts].append(key)
    super_points = sorted({pt for _k, _c, pt, _e in queries})

    y = t.squeeze_challenge()
    v = t.squeeze_challenge()
    h1 = t.read_point()
    u = t.squeeze_challenge()
    h2 = t.read_point()

    scalars, points = [], []
    r_outer, power_v, z_0, z_0_diff_inv = 0, 1, 0, 0
    for i, pts in enumerate(set_order):
        z_diff = vanishing([p for p in super_points if p not in pts], u, R)
        if i == 0:
            z_0 = vanishing(pts, u, R)
            z_0_diff_inv = pow(z_diff, R - 2, R)
            z_diff = 1
        else:
            z_diff = z_diff * z_0_diff_inv % R
        weight = power_v * z_diff % R
        r_inner, power_y = 0, 1
        for key in members[pts]:
            r_inner = (r_inner + power_y * interpolate_at(
                list(pts), [evals[(key, p)] for p in pts], u, R)) % R
            scalars.append(power_y * weight % R)
            points.append(comm_of[key])
            power_y = power_y * y % R
        r_outer = (r_outer + weight * r_inner) % R
        power_v = power_v * v % R
    scalars += [(-r_outer) % R, (-z_0) % R, u]
    points += [curve.gen, h1, h2]
    return h2, curve.msm(scalars, points)
