"""PLONK verifier (port of the JAX reference's plonk/verifier.py;
verifier.rs:32-511).  Host-side integer arithmetic, except the instance
commitments of query_instance schemes (IPA), which are full-length MSMs on
the params' device; the deferred MSMs are checked by the commitment
scheme's strategy."""

from __future__ import annotations

from typing import Dict, List

from ..commit.base import Blind, VerifierQuery
from ..frontend.expression import ADVICE, FIXED, INSTANCE, Rotation
from .errors import VerifyError
from .keygen import VerifyingKey


def verify_proof(params, vk: VerifyingKey, transcript, instances,
                 query_instance: bool) -> List[VerifierQuery]:
    """Replays the prover's transcript; returns the verifier queries for
    the multiopen verifier."""
    F = vk.F
    p = F.p
    cs_back = vk.cs
    cs = cs_back.cs
    domain = vk.domain
    n = domain.n
    bf = cs_back.blinding_factors()
    n_circ = len(instances)
    for inst in instances:
        if len(inst) != cs.num_instance_columns:
            raise VerifyError("invalid number of instance columns")

    # instance commitments of query_instance schemes (verifier.rs:82-116)
    instance_commitments = []
    if query_instance:
        for inst in instances:
            comms = []
            for values in inst:
                if len(values) > n - (bf + 1):
                    raise VerifyError("instance too large")
                col = [v % p for v in values] + [0] * (n - len(values))
                comms.append(params.commit_affine_lagrange(
                    F.encode_ints(col, params.device), Blind(1)))
            instance_commitments.append(comms)

    # [TRANSCRIPT-1/2]
    vk.hash_into(transcript)
    if query_instance:
        for comms in instance_commitments:
            for comm in comms:
                transcript.common_point(comm)
    else:
        for inst in instances:
            for values in inst:
                for v in values:
                    transcript.common_scalar(v % p)

    # [TRANSCRIPT-3/4] advice commitments per phase, challenges
    advice_commitments = [[None] * cs.num_advice_columns
                          for _ in range(n_circ)]
    challenges: Dict[int, int] = {}
    for phase in cs.phases():
        column_indices = [i for i, ph in enumerate(cs.advice_column_phase)
                          if ph == phase]
        for c in range(n_circ):
            for ci in column_indices:
                advice_commitments[c][ci] = transcript.read_point()
        for index, ch_phase in enumerate(cs.challenge_phase):
            if ch_phase == phase:
                challenges[index] = transcript.squeeze_challenge()

    # [TRANSCRIPT-5..12]
    theta = transcript.squeeze_challenge()
    lookups_permuted = [[(transcript.read_point(), transcript.read_point())
                         for _ in cs.lookups] for _ in range(n_circ)]
    beta = transcript.squeeze_challenge()
    gamma = transcript.squeeze_challenge()
    m = len(cs.permutation.columns)
    chunk_len = vk.cs_degree - 2
    num_sets = (m + chunk_len - 1) // chunk_len
    permutations_committed = [[transcript.read_point()
                               for _ in range(num_sets)]
                              for _ in range(n_circ)]
    lookups_committed = [[transcript.read_point() for _ in cs.lookups]
                         for _ in range(n_circ)]
    shuffles_committed = [[transcript.read_point() for _ in cs.shuffles]
                          for _ in range(n_circ)]
    random_commitment = transcript.read_point()
    y = transcript.squeeze_challenge()
    h_commitments = [transcript.read_point()
                     for _ in range(domain.quotient_poly_degree)]
    x = transcript.squeeze_challenge()
    xn = pow(x, n, p)

    # [TRANSCRIPT-16] instance evals: read (query_instance schemes), else
    # barycentric from the raw values (verifier.rs:266-305)
    instance_evals = [[] for _ in range(n_circ)]
    if query_instance:
        instance_evals = [[transcript.read_scalar()
                           for _ in cs_back.instance_queries]
                          for _ in range(n_circ)]
    elif cs_back.instance_queries:
        max_rot = max(max(r.i for _, r in cs_back.instance_queries), 0)
        min_rot = min(min(r.i for _, r in cs_back.instance_queries), 0)
        max_len = max([len(col) for inst in instances for col in inst] + [0])
        l_evals = domain.l_i_range_int(
            x, xn, list(range(-max_rot, max_len + abs(min_rot))))
        for c, inst in enumerate(instances):
            for column, rot in cs_back.instance_queries:
                offset = max_rot + rot.i
                acc = 0
                for i, v in enumerate(inst[column.index]):
                    acc = (acc + v * l_evals[offset + i]) % p
                instance_evals[c].append(acc)

    # [TRANSCRIPT-17..22]
    advice_evals = [[transcript.read_scalar()
                     for _ in cs_back.advice_queries] for _ in range(n_circ)]
    fixed_evals = [transcript.read_scalar() for _ in cs_back.fixed_queries]
    random_eval = transcript.read_scalar()
    sigma_evals = [transcript.read_scalar() for _ in range(m)]
    permutations_evaluated = []
    for c in range(n_circ):
        sets = []
        for si in range(num_sets):
            ev = transcript.read_scalar()
            ev_next = transcript.read_scalar()
            ev_last = transcript.read_scalar() if si < num_sets - 1 else None
            sets.append((ev, ev_next, ev_last))
        permutations_evaluated.append(sets)
    lookups_evaluated = [[tuple(transcript.read_scalar() for _ in range(5))
                          for _ in cs.lookups] for _ in range(n_circ)]
    shuffles_evaluated = [[(transcript.read_scalar(), transcript.read_scalar())
                           for _ in cs.shuffles] for _ in range(n_circ)]

    # expected h(x) (verifier.rs:351-446)
    l_evals = domain.l_i_range_int(x, xn, list(range(-(bf + 1), 1)))
    l_last = l_evals[0]
    l_blind = sum(l_evals[1:1 + bf]) % p
    l_0 = l_evals[bf + 1]
    active_rows = (1 - (l_last + l_blind)) % p
    challenges_list = [challenges[i] for i in range(cs.num_challenges)]

    def eval_expr(expr, c):
        def query_fn(column, rot):
            idx = cs_back.get_query_index(column, rot)
            return {ADVICE: advice_evals[c], FIXED: fixed_evals,
                    INSTANCE: instance_evals[c]}[column.kind][idx]

        def selector_fn(s):
            raise AssertionError("selector in verifier expression")

        return expr.evaluate(
            lambda v: v % p, selector_fn, query_fn,
            lambda ch: challenges_list[ch.index],
            lambda a: (-a) % p, lambda a, b: (a + b) % p,
            lambda a, b: (a * b) % p, lambda a, k: (a * k) % p)

    h_sum = 0

    def fold(v):
        nonlocal h_sum
        h_sum = (h_sum * y + v) % p

    def compress(exprs, c):
        acc = 0
        for e in exprs:
            acc = (acc * theta + eval_expr(e, c)) % p
        return acc

    for c in range(n_circ):
        for gate in cs.gates:
            for poly in gate.polys:
                fold(eval_expr(poly, c))
        sets = permutations_evaluated[c]
        if sets:
            fold(l_0 * (1 - sets[0][0]) % p)
            fold(l_last * (sets[-1][0] * sets[-1][0] - sets[-1][0]) % p)
            for i in range(1, len(sets)):
                fold((sets[i][0] - sets[i - 1][2]) * l_0 % p)
            for ci, (ev, ev_next, _) in enumerate(sets):
                left, right = ev_next, ev
                cur_delta = (beta * x % p) * pow(F.delta, ci * chunk_len,
                                                 p) % p
                for j, col in enumerate(cs.permutation.columns[
                        ci * chunk_len:(ci + 1) * chunk_len]):
                    idx = cs_back.get_query_index(col, Rotation(0))
                    val = {ADVICE: advice_evals[c], FIXED: fixed_evals,
                           INSTANCE: instance_evals[c]}[col.kind][idx]
                    sigma = sigma_evals[ci * chunk_len + j]
                    left = left * (val + beta * sigma + gamma) % p
                    right = right * (val + cur_delta + gamma) % p
                    cur_delta = cur_delta * F.delta % p
                fold((left - right) * active_rows % p)
        for lk_arg, (prod_ev, prod_next, pin_ev, pin_prev, ptab_ev) in zip(
                cs.lookups, lookups_evaluated[c]):
            fold(l_0 * (1 - prod_ev) % p)
            fold(l_last * (prod_ev * prod_ev - prod_ev) % p)
            left = prod_next * (pin_ev + beta) * (ptab_ev + gamma) % p
            right = prod_ev * (compress(lk_arg.input_expressions, c) + beta) \
                * (compress(lk_arg.table_expressions, c) + gamma) % p
            fold((left - right) * active_rows % p)
            fold(l_0 * (pin_ev - ptab_ev) % p)
            fold((pin_ev - ptab_ev) * (pin_ev - pin_prev) * active_rows % p)
        # shuffles (shuffle/verifier.rs:60-120)
        for sh_arg, (prod_ev, prod_next) in zip(cs.shuffles,
                                                shuffles_evaluated[c]):
            fold(l_0 * (1 - prod_ev) % p)
            fold(l_last * (prod_ev * prod_ev - prod_ev) % p)
            left = prod_next * (compress(sh_arg.shuffle_expressions, c)
                                + gamma) % p
            right = prod_ev * (compress(sh_arg.input_expressions, c)
                               + gamma) % p
            fold((left - right) * active_rows % p)

    expected_h_eval = h_sum * pow((xn - 1) % p, p - 2, p) % p
    h_msm = params.empty_msm()
    power = 1
    for comm in h_commitments:
        h_msm.append_term(power, comm)
        power = power * xn % p

    # verifier queries in the prover's order
    queries: List[VerifierQuery] = []
    x_next = domain.rotate_omega_int(x, Rotation(1))
    x_last = domain.rotate_omega_int(x, Rotation(-(bf + 1)))
    x_prev = domain.rotate_omega_int(x, Rotation(-1))
    for c in range(n_circ):
        if query_instance:
            for qi, (column, at) in enumerate(cs_back.instance_queries):
                queries.append(VerifierQuery(
                    domain.rotate_omega_int(x, at),
                    instance_commitments[c][column.index],
                    instance_evals[c][qi], ident=("inst", c, column.index)))
        for qi, (column, at) in enumerate(cs_back.advice_queries):
            queries.append(VerifierQuery(
                domain.rotate_omega_int(x, at),
                advice_commitments[c][column.index], advice_evals[c][qi],
                ident=("adv", c, column.index)))
        sets = permutations_evaluated[c]
        comms = permutations_committed[c]
        for si, ((ev, ev_next, _), comm) in enumerate(zip(sets, comms)):
            queries.append(VerifierQuery(x, comm, ev, ident=("permz", c, si)))
            queries.append(VerifierQuery(x_next, comm, ev_next,
                                         ident=("permz", c, si)))
        for si, ((_, _, ev_last), comm) in reversed(
                list(enumerate(zip(sets, comms)))[:-1]):
            queries.append(VerifierQuery(x_last, comm, ev_last,
                                         ident=("permz", c, si)))
        for li, ((pin_c, ptab_c), prod_c, evs) in enumerate(zip(
                lookups_permuted[c], lookups_committed[c],
                lookups_evaluated[c])):
            prod_ev, prod_next, pin_ev, pin_prev, ptab_ev = evs
            queries += [
                VerifierQuery(x, prod_c, prod_ev, ident=("lkz", c, li)),
                VerifierQuery(x, pin_c, pin_ev, ident=("lkin", c, li)),
                VerifierQuery(x, ptab_c, ptab_ev, ident=("lktab", c, li)),
                VerifierQuery(x_prev, pin_c, pin_prev, ident=("lkin", c, li)),
                VerifierQuery(x_next, prod_c, prod_next,
                              ident=("lkz", c, li)),
            ]
        for si, (comm, (prod_ev, prod_next)) in enumerate(zip(
                shuffles_committed[c], shuffles_evaluated[c])):
            queries.append(VerifierQuery(x, comm, prod_ev,
                                         ident=("shz", c, si)))
            queries.append(VerifierQuery(x_next, comm, prod_next,
                                         ident=("shz", c, si)))
    for qi, (column, at) in enumerate(cs_back.fixed_queries):
        queries.append(VerifierQuery(
            domain.rotate_omega_int(x, at),
            vk.fixed_commitments[column.index], fixed_evals[qi],
            ident=("fix", column.index)))
    for j in range(m):
        queries.append(VerifierQuery(x, vk.permutation.commitments[j],
                                     sigma_evals[j], ident=("sigma", j)))
    queries.append(VerifierQuery(x, h_msm, expected_h_eval, is_msm=True,
                                 ident=("h",)))
    queries.append(VerifierQuery(x, random_commitment, random_eval,
                                 ident=("rand",)))
    return queries


def verify_proof_single(params, vk: VerifyingKey, proof: bytes, instances,
                        transcript_cls, multiopen_verifier_cls,
                        strategy_cls) -> bool:
    """One proof through a transcript, a multiopen verifier and a
    strategy; VerifyError propagates (api.verify turns it into False)."""
    transcript = transcript_cls(params.curve, proof)
    verifier = multiopen_verifier_cls(params)
    queries = verify_proof(params, vk, transcript, instances,
                           verifier.QUERY_INSTANCE)
    return strategy_cls(params).process(
        lambda msm: verifier.verify_proof(transcript, queries, msm))
