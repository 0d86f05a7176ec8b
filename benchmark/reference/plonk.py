"""The PLONK verifier (halo2 plonk/verifier.rs) on python ints: the
transcript replayed to the multi-open's queries, with the expected h(x)
folded from every gate, lookup and permutation constraint.  The
multi-open (SHPLONK in kzg.py, IPA in ipa.py) then checks the queries."""

from __future__ import annotations

from typing import List, Sequence

from .curve import inv
from .shape import Shape, evaluate
from .transcript import Blake2bRead, TranscriptError
from .vk import VerifyingKey


class Rejected(Exception):
    """The proof fails a check; the message says which."""


def rotate(shape: Shape, x: int, rot: int) -> int:
    return x * pow(shape.omega, rot % shape.n, shape.curve.r) % shape.curve.r


def _lagrange_at(shape: Shape, x: int, xn: int, rots: Sequence[int]):
    """L_r(x) = omega^r (x^n - 1) / (n (x - omega^r)) for each rotation r."""
    r = shape.curve.r
    common = (xn - 1) * inv(shape.n, r) % r
    out = []
    for rot in rots:
        w = pow(shape.omega, rot % shape.n, r)
        out.append(common * w % r * inv(x - w, r) % r)
    return out


def verify(shape: Shape, key: VerifyingKey, proof: bytes,
           instance: List[List[int]], multiopen, instance_commitments=None):
    """Checks one proof of one circuit instance; raises Rejected, naming
    the check, where it fails.  `instance_commitments` (IPA) puts the
    instance columns in as commitments, queried like advice; without
    them (KZG) their values are absorbed and evaluated here.
    multiopen(transcript, queries) checks the openings."""
    t = Blake2bRead(shape.curve, proof)
    try:
        queries = _queries(shape, key, t, instance, instance_commitments)
        multiopen(t, queries)
    except TranscriptError as e:
        raise Rejected(f"transcript: {e}") from None
    if not t.at_end():
        raise Rejected("bytes left after the opening")


def _queries(shape: Shape, key: VerifyingKey, t: Blake2bRead, instance,
             instance_commitments):
    curve = shape.curve
    R = curve.r
    n = shape.n
    bf = shape.blinding_factors
    if len(instance) != shape.num_instance:
        raise Rejected("instance columns")
    for col in instance:
        if len(col) > shape.usable_rows:
            raise Rejected("instance too long")
    t.common_scalar(key.transcript_repr)
    if instance_commitments is not None:
        for pt in instance_commitments:
            t.common_point(pt)
    else:
        for col in instance:
            for v in col:
                t.common_scalar(v % R)

    advice = [t.read_point() for _ in range(shape.num_advice)]
    theta = t.squeeze_challenge()
    permuted = [(t.read_point(), t.read_point()) for _ in shape.lookups]
    beta = t.squeeze_challenge()
    gamma = t.squeeze_challenge()
    m = len(shape.permutation)
    chunk = shape.chunk_len
    n_sets = -(-m // chunk)
    perm_z = [t.read_point() for _ in range(n_sets)]
    lookup_z = [t.read_point() for _ in shape.lookups]
    random_c = t.read_point()
    y = t.squeeze_challenge()
    h_comms = [t.read_point() for _ in range(shape.quotient_poly_degree)]
    x = t.squeeze_challenge()
    xn = pow(x, n, R)

    if instance_commitments is not None:
        inst_evals = [t.read_scalar() for _ in shape.queries["instance"]]
    else:
        inst_evals = []
        for col, rot in shape.queries["instance"]:
            vals = instance[col]
            ls = _lagrange_at(shape, x, xn, [i + rot for i in
                                             range(len(vals))])
            inst_evals.append(sum(v * lv for v, lv in zip(vals, ls)) % R)
    advice_evals = [t.read_scalar() for _ in shape.queries["advice"]]
    fixed_evals = [t.read_scalar() for _ in shape.queries["fixed"]]
    random_eval = t.read_scalar()
    sigma_evals = [t.read_scalar() for _ in range(m)]
    sets = []
    for si in range(n_sets):
        ev, ev_next = t.read_scalar(), t.read_scalar()
        ev_last = t.read_scalar() if si < n_sets - 1 else None
        sets.append((ev, ev_next, ev_last))
    lookup_evals = [tuple(t.read_scalar() for _ in range(5))
                    for _ in shape.lookups]

    evals = {"advice": advice_evals, "fixed": fixed_evals,
             "instance": inst_evals}

    def query(kind, col, rot):
        return evals[kind][shape.query_index(kind, col, rot)]

    # the expected h(x): every constraint folded by y (verifier.rs:351-446)
    ls = _lagrange_at(shape, x, xn, range(-(bf + 1), 1))
    l_last, l_blind, l_0 = ls[0], sum(ls[1:1 + bf]) % R, ls[bf + 1]
    active = (1 - l_last - l_blind) % R
    acc = 0

    def fold(v):
        nonlocal acc
        acc = (acc * y + v) % R

    def compress(exprs):
        out = 0
        for e in exprs:
            out = (out * theta + evaluate(e, query, R)) % R
        return out

    for gate in shape.gates:
        for poly in gate["polys"]:
            fold(evaluate(poly, query, R))
    delta = curve.fr.delta
    if sets:
        fold(l_0 * (1 - sets[0][0]) % R)
        fold(l_last * (sets[-1][0] ** 2 - sets[-1][0]) % R)
        for i in range(1, len(sets)):
            fold((sets[i][0] - sets[i - 1][2]) * l_0 % R)
        for ci, (ev, ev_next, _) in enumerate(sets):
            left, right = ev_next, ev
            cur = beta * x % R * pow(delta, ci * chunk, R) % R
            for j, (kind, col) in enumerate(
                    shape.permutation[ci * chunk:(ci + 1) * chunk]):
                val = query(kind, col, 0)
                left = left * (val + beta * sigma_evals[ci * chunk + j]
                               + gamma) % R
                right = right * (val + cur + gamma) % R
                cur = cur * delta % R
            fold((left - right) * active % R)
    for lk, (z, z_next, a, a_prev, s) in zip(shape.lookups, lookup_evals):
        fold(l_0 * (1 - z) % R)
        fold(l_last * (z * z - z) % R)
        left = z_next * (a + beta) * (s + gamma) % R
        right = z * (compress(lk["input"]) + beta) * \
            (compress(lk["table"]) + gamma) % R
        fold((left - right) * active % R)
        fold(l_0 * (a - s) % R)
        fold((a - s) * (a - a_prev) * active % R)
    expected_h = acc * inv(xn - 1, R) % R
    h_comm = curve.msm([pow(xn, i, R) for i in range(len(h_comms))], h_comms)

    # the queries, in the prover's order; each commitment keyed by its slot
    x_next, x_prev = rotate(shape, x, 1), rotate(shape, x, -1)
    x_last = rotate(shape, x, -(bf + 1))
    queries = []            # (key, commitment, point, eval)
    if instance_commitments is not None:
        for qi, (col, rot) in enumerate(shape.queries["instance"]):
            queries.append((("inst", col), instance_commitments[col],
                            rotate(shape, x, rot), inst_evals[qi]))
    for qi, (col, rot) in enumerate(shape.queries["advice"]):
        queries.append((("adv", col), advice[col], rotate(shape, x, rot),
                        advice_evals[qi]))
    for si, ((ev, ev_next, _), comm) in enumerate(zip(sets, perm_z)):
        queries.append((("permz", si), comm, x, ev))
        queries.append((("permz", si), comm, x_next, ev_next))
    for si in range(n_sets - 2, -1, -1):
        queries.append((("permz", si), perm_z[si], x_last, sets[si][2]))
    for li, ((pin, ptab), z, (zev, znext, a, a_prev, s)) in enumerate(
            zip(permuted, lookup_z, lookup_evals)):
        queries += [(("lkz", li), z, x, zev), (("lkin", li), pin, x, a),
                    (("lktab", li), ptab, x, s),
                    (("lkin", li), pin, x_prev, a_prev),
                    (("lkz", li), z, x_next, znext)]
    for qi, (col, rot) in enumerate(shape.queries["fixed"]):
        queries.append((("fix", col), key.fixed_commitments[col],
                        rotate(shape, x, rot), fixed_evals[qi]))
    for j in range(m):
        queries.append((("sigma", j), key.permutation_commitments[j], x,
                        sigma_evals[j]))
    queries.append((("h",), h_comm, x, expected_h))
    queries.append((("rand",), random_c, x, random_eval))
    return queries


def vanishing(points: Sequence[int], u: int, r: int) -> int:
    acc = 1
    for pt in points:
        acc = acc * (u - pt) % r
    return acc


def interpolate_at(points: Sequence[int], evals: Sequence[int], u: int,
                   r: int):
    """The value at u of the polynomial through (points[i], evals[i])."""
    acc = 0
    for i, (xi, yi) in enumerate(zip(points, evals)):
        num, den = 1, 1
        for j, xj in enumerate(points):
            if j != i:
                num = num * (u - xj) % r
                den = den * (xi - xj) % r
        acc = (acc + yi * num * inv(den, r)) % r
    return acc
