"""halo2's IPA on Vesta, the verifier's side on python ints: the
verifying key from the parameters' generators (poly/ipa/commitment.rs),
the instance commitments, and the multi-open with its inner-product
argument (poly/ipa/multiopen/verifier.rs, commitment/verifier.rs,
strategy.rs).  A commitment to coefficients c with blind r is
<c, g> + r w; Lagrange values are taken to coefficients by an inverse
NTT first."""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List

from .curve import inv
from .pasta import VESTA, generators
from .plonk import Rejected, interpolate_at
from .shape import Shape
from .vk import VerifyingKey, sigma_corrections

CURVE = VESTA


class Params:
    """g, w, u of 2^k rows, read from `cache_dir` when they were made
    there before (they take a minute on python ints at k = 14)."""

    def __init__(self, k: int, cache_dir: str = None):
        self.k = k
        self.n = 1 << k
        path = cache_dir and os.path.join(cache_dir,
                                          f"ipa-vesta-generators-{k}.json")
        if path and os.path.exists(path):
            with open(path) as f:
                pts = [tuple(p) for p in json.load(f)]
        else:
            g, w, u = generators(k)
            pts = g + [w, u]
            if path:
                os.makedirs(cache_dir, exist_ok=True)
                tmp = f"{path}.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(pts, f)
                os.replace(tmp, path)
        self.g, self.w, self.u = pts[:self.n], pts[self.n], pts[self.n + 1]

    def commit_coeffs(self, coeffs: List[int], blind: int):
        return CURVE.msm(list(coeffs) + [blind], self.g[:len(coeffs)]
                         + [self.w])


def intt(shape: Shape, values: List[int]) -> List[int]:
    """Lagrange values over the 2^k domain -> coefficients."""
    r = CURVE.r
    n = shape.n
    a = list(values) + [0] * (n - len(values))
    j = 0
    for i in range(1, n):               # bit-reversal permutation
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    w_inv = inv(shape.omega, r)
    length = 2
    while length <= n:
        wl = pow(w_inv, n // length, r)
        half = length // 2
        ws = [1] * half
        for t in range(1, half):
            ws[t] = ws[t - 1] * wl % r
        for start in range(0, n, length):
            for t in range(half):
                x = a[start + t]
                y = a[start + t + half] * ws[t] % r
                a[start + t] = (x + y) % r
                a[start + t + half] = (x - y) % r
        length *= 2
    n_inv = inv(n, r)
    return [v * n_inv % r for v in a]


def _dense(shape: Shape, column: Dict[int, int]) -> List[int]:
    out = [0] * shape.n
    for row, v in column.items():
        out[row] = v % CURVE.r
    return out


def ipa_key(shape: Shape, params: Params, fixed_columns, copies,
            cache_dir: str = None) -> VerifyingKey:
    """Each fixed column commits with blind 1 (keygen.rs); sigma_j's
    values are delta^j omega^i plus the copies' corrections, whose
    coefficients are delta^j X plus the corrections' inverse NTT.  Kept
    in `cache_dir` under the hash of everything it is made from."""
    r = CURVE.r
    tag = hashlib.sha256(json.dumps(
        [shape.as_data(), [sorted(c.items()) for c in fixed_columns],
         copies, params.k]).encode()).hexdigest()[:16]
    path = cache_dir and os.path.join(cache_dir, f"ipa-key-{tag}.json")
    if path and os.path.exists(path):
        with open(path) as f:
            fixed, perm = json.load(f)
        key = VerifyingKey([tuple(p) for p in fixed],
                           [tuple(p) for p in perm])
        return key.hash(shape)
    fixed = [params.commit_coeffs(intt(shape, _dense(shape, col)), 1)
             for col in fixed_columns]
    perm = []
    for j, fix in enumerate(sigma_corrections(shape, copies)):
        coeffs = intt(shape, _dense(shape, fix)) if fix else [0] * shape.n
        coeffs[1] = (coeffs[1] + pow(CURVE.fr.delta, j, r)) % r
        perm.append(params.commit_coeffs(coeffs, 1))
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump([fixed, perm], f)
        os.replace(tmp, path)
    return VerifyingKey(fixed, perm).hash(shape)


def instance_commitments(shape: Shape, params: Params, instance):
    """Each instance column committed in Lagrange form with blind 1."""
    return [params.commit_coeffs(intt(shape, col), 1) for col in instance]


def multiopen(params: Params):
    """The multi-open check of `plonk.verify`."""
    def check(t, queries):
        msm = _multiopen(t, queries, params)
        if CURVE.msm(*msm) is not None:
            raise Rejected("the opening: the inner-product argument's "
                           "MSM is not the identity")
    return check


def _multiopen(t, queries, params: Params):
    R = CURVE.r
    x1 = t.squeeze_challenge()
    x2 = t.squeeze_challenge()
    # point sets (multiopen.rs): points by first appearance; each
    # commitment's set is its sorted point indices; sets by first
    # appearance
    point_index, order, pts_of, comm_of, ev_of = {}, [], {}, {}, {}
    for key, comm, pt, ev in queries:
        point_index.setdefault(pt, len(point_index))
        if key not in pts_of:
            order.append(key)
            pts_of[key], ev_of[key] = [], {}
            comm_of[key] = comm
        pts_of[key].append(point_index[pt])
        ev_of[key][point_index[pt]] = ev
    set_index, data = {}, []
    for key in order:
        pts = tuple(sorted(set(pts_of[key])))
        set_index.setdefault(pts, len(set_index))
        data.append((key, set_index[pts], [ev_of[key][i] for i in pts]))
    by_index = {v: k for k, v in point_index.items()}
    point_sets = [None] * len(set_index)
    for pts, idx in set_index.items():
        point_sets[idx] = [by_index[i] for i in pts]

    n_sets = len(point_sets)
    q_terms = [[] for _ in range(n_sets)]       # (scalar, point)
    x1_powers = [1] * n_sets
    q_evals = [[0] * len(ps) for ps in point_sets]
    for key, si, evals in reversed(data):
        power = x1_powers[si]
        q_terms[si].append((power, comm_of[key]))
        for j, ev in enumerate(evals):
            q_evals[si][j] = (q_evals[si][j] + ev * power) % R
        x1_powers[si] = power * x1 % R

    q_prime = t.read_point()
    x3 = t.squeeze_challenge()
    u_evals = [t.read_scalar() for _ in range(n_sets)]
    f_eval = 0
    for points, evals, proof_eval in zip(point_sets, q_evals, u_evals):
        ev = (proof_eval - interpolate_at(points, evals, x3, R)) % R
        for point in points:
            ev = ev * inv(x3 - point, R) % R
        f_eval = (f_eval * x2 + ev) % R
    x4 = t.squeeze_challenge()

    # the accumulator: sparse terms, w and u scalars, dense g-scalars
    terms = [(1, q_prime)]
    v = f_eval
    for q_term, q_eval in zip(q_terms, u_evals):
        terms = [(s * x4 % R, p) for s, p in terms] + q_term
        v = (v * x4 + q_eval) % R
    g_scalars = [0] * params.n
    g_scalars[0] = (-v) % R
    s_comm = t.read_point()
    xi = t.squeeze_challenge()
    terms.append((xi, s_comm))
    z = t.squeeze_challenge()
    rounds = []
    for _ in range(params.k):
        l_pt, r_pt = t.read_point(), t.read_point()
        rounds.append((l_pt, r_pt, t.squeeze_challenge()))
    u = []
    for l_pt, r_pt, u_j in rounds:
        terms += [(inv(u_j, R), l_pt), (u_j, r_pt)]
        u.append(u_j)
    neg_c = (-t.read_scalar()) % R
    f = t.read_scalar()
    b, cur = 1, x3
    for u_j in reversed(u):                     # prod (1 + u_j x3^(2^i))
        b = b * (1 + u_j * cur) % R
        cur = cur * cur % R
    terms += [(neg_c * b * z % R, params.u), ((-f) % R, params.w)]
    s = [0] * params.n                          # <s, g>: the folded g
    s[0] = neg_c
    length = 1
    for u_j in reversed(u):
        for i in range(length):
            s[length + i] = s[i] * u_j % R
        length *= 2
    scalars = [(a + b2) % R for a, b2 in zip(g_scalars, s)]
    return ([sc for sc, _ in terms] + scalars,
            [pt for _, pt in terms] + params.g)
