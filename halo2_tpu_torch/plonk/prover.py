"""PLONK prover (port of the JAX reference's plonk/prover.py; prover.rs
state machine :174-494 and proof steps :512-899): gates, the permutation
argument, lookups, shuffles and the vanishing argument, for multiopen
schemes that absorb the instances as scalars (SHPLONK, GWC) or commit to
them (IPA).

Column sets move through the NTTs as stacked tensors; grand products use
batch inversion and log-depth prefix products; transcript traffic stays on
the host between device phases.  Randomness comes only from the caller's
`random.Random`, drawn in the reference's order, so proofs are
byte-identical to the reference's under the same seed.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from ..commit.base import Blind, PolyRef, ProverQuery
from ..commit.kzg import PreMSM
from ..fields.field import NWORDS, Field
from ..frontend.expression import ADVICE, FIXED, INSTANCE, Rotation
from ..ntt import powers
from ..poly.arith import eval_polys_at_points, prefix_product
from ..poly.poly import Poly
from .evaluation import evaluate_expression
from .keygen import ProvingKey
from .lookup_sort import permute_expression_pair_device

def _random_poly(F: Field, n: int, rng, device):
    """n uniform field elements from 384 rng-derived bits each: one 64-bit
    draw seeds numpy's PCG64, exactly as the reference
    (prover.py:43-57); value = hi * 2^192 + lo."""
    g = np.random.Generator(np.random.PCG64(rng.getrandbits(64)))
    raw = g.integers(0, 1 << 16, size=(n, 24), dtype=np.uint32)

    def words(limbs):                 # (n, 12) u16 -> (n, 8) int32 words
        w = np.zeros((n, NWORDS), np.uint32)
        w[:, :6] = limbs[:, 0::2] | (limbs[:, 1::2] << 16)
        return torch.from_numpy(w.view(np.int32).copy()).to(device)

    c192 = F.encode_int(pow(2, 192, F.p), device)
    return F.add(F.mul(F.to_mont(words(raw[:, 12:])), c192),
                 F.to_mont(words(raw[:, :12])))


def _sync(device):
    """Wait for the device work queued so far (step timings)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Evaluator:
    """The h-numerator over the extended domain (evaluation.rs:317-623):
    one batched coset NTT per argument, then elementwise passes for the
    gates, the permutation, each lookup and each shuffle (cosets streamed
    per argument)."""

    def __init__(self, F: Field, domain, cs_back):
        self.F = F
        self.domain = domain
        self.cs_back = cs_back
        dev = domain.device
        pts = powers(F, F.encode_int(domain.extended_omega, dev),
                     domain.extended_n)
        self.ext_points = F.mul(pts, F.encode_int(domain.g_coset, dev))

    def _ev(self, expr, fixed, advice, instance, challenges):
        return evaluate_expression(
            self.F, expr, fixed=fixed, advice=advice, instance=instance,
            challenges=challenges, device=self.domain.device,
            rot_scale=1 << (self.domain.extended_k - self.domain.k))

    def evaluate_h(self, pk: ProvingKey, advice_polys, instance_polys,
                   challenges, y, beta, gamma, theta, lookups, shuffles,
                   permutations):
        """Lists are per circuit; lookups[c][l] = (z, a', s') coeff polys,
        shuffles[c][s] = z, permutations[c] = [z per set].  Returns the
        extended-domain numerator of h."""
        F, domain, cs = self.F, self.domain, self.cs_back.cs
        dev = domain.device
        ext_n = domain.extended_n
        value = F.zeros((ext_n,), dev)
        ch = {i: c for i, c in enumerate(challenges)}

        def to_ext(p):
            return domain.coeff_to_extended(p).values

        for c in range(len(advice_polys)):
            advice = to_ext(advice_polys[c]) if advice_polys[c].shape[0] \
                else F.zeros((0, ext_n), dev)
            instance = to_ext(instance_polys[c]) \
                if instance_polys[c].shape[0] else F.zeros((0, ext_n), dev)
            cols = (pk.fixed_cosets, advice, instance)

            for gate in cs.gates:
                for poly in gate.polys:
                    value = F.add(F.mul(value, y),
                                  self._ev(poly, *cols, ch))
            if permutations[c]:
                value = self._perm(pk, value, y, beta, gamma,
                                   to_ext(Poly.stack(permutations[c])), cols)
            for li, (z, a, s) in enumerate(lookups[c]):
                value = self._lookup(pk, cs.lookups[li], value, y, beta,
                                     gamma, theta, ch,
                                     to_ext(Poly.stack([z, a, s])), cols)
            for si, z in enumerate(shuffles[c]):
                value = self._shuffle(pk, cs.shuffles[si], value, y, gamma,
                                      theta, ch, to_ext(z), cols)
        return Poly.extended(value)

    def _perm(self, pk, value, y, beta, gamma, exts, cols):
        F, domain, cs_back = self.F, self.domain, self.cs_back
        dev = domain.device
        one = F.ones((), dev)
        l0, l_last, l_active = pk.l0, pk.l_last, pk.l_active_row
        kind_map = {FIXED: cols[0], ADVICE: cols[1], INSTANCE: cols[2]}
        last_rot = Rotation(-(cs_back.blinding_factors() + 1))
        chunk_len = cs_back.degree() - 2
        columns = cs_back.cs.permutation.columns
        n_sets = exts.shape[0]
        # l_0(X) (1 - z_0(X))
        value = F.add(F.mul(value, y), F.mul(l0, F.sub(one, exts[0])))
        # l_last(X) (z_l(X)^2 - z_l(X))
        value = F.add(F.mul(value, y), F.mul(
            l_last, F.sub(F.square(exts[-1]), exts[-1])))
        # l_0(X) (z_i(X) - z_(i-1)(omega^last X))
        for i in range(1, n_sets):
            prev = domain.rotate_extended(exts[i - 1], last_rot)
            value = F.add(F.mul(value, y), F.mul(l0, F.sub(exts[i], prev)))
        delta = F.encode_int(F.delta, dev)
        for ci in range(n_sets):
            z = exts[ci]
            left = domain.rotate_extended(z, Rotation(1))
            right = z
            cur_delta = F.mul(F.mul(beta, self.ext_points), F.encode_int(
                pow(F.delta, ci * chunk_len, F.p), dev))
            for j, col in enumerate(columns[ci * chunk_len:
                                            (ci + 1) * chunk_len]):
                vals = kind_map[col.kind][col.index]
                sigma = pk.permutation.cosets[ci * chunk_len + j]
                left = F.mul(left, F.add(F.add(vals, F.mul(beta, sigma)),
                                         gamma))
                right = F.mul(right, F.add(F.add(vals, cur_delta), gamma))
                cur_delta = F.mul(cur_delta, delta)
            value = F.add(F.mul(value, y),
                          F.mul(F.sub(left, right), l_active))
        return value

    def _compress(self, exprs, theta, cols, ch):
        F = self.F
        acc = F.zeros((self.domain.extended_n,), self.domain.device)
        for e in exprs:
            acc = F.add(F.mul(acc, theta), self._ev(e, *cols, ch))
        return acc

    def _lookup(self, pk, lk_arg, value, y, beta, gamma, theta, ch, zas,
                cols):
        F, domain = self.F, self.domain
        one = F.ones((), domain.device)
        l0, l_last, l_active = pk.l0, pk.l_last, pk.l_active_row
        z, a, s = zas[0], zas[1], zas[2]
        z_next = domain.rotate_extended(z, Rotation(1))
        a_prev = domain.rotate_extended(a, Rotation(-1))
        comp_in = self._compress(lk_arg.input_expressions, theta, cols, ch)
        comp_tab = self._compress(lk_arg.table_expressions, theta, cols, ch)
        # l_0 (1 - z)
        value = F.add(F.mul(value, y), F.mul(l0, F.sub(one, z)))
        # l_last (z^2 - z)
        value = F.add(F.mul(value, y),
                      F.mul(l_last, F.sub(F.square(z), z)))
        # active (z(wX)(a' + b)(s' + g) - z(X)(A + b)(S + g))
        left = F.mul(F.mul(z_next, F.add(a, beta)), F.add(s, gamma))
        right = F.mul(F.mul(z, F.add(comp_in, beta)), F.add(comp_tab, gamma))
        value = F.add(F.mul(value, y), F.mul(F.sub(left, right), l_active))
        # l_0 (a' - s')
        value = F.add(F.mul(value, y), F.mul(l0, F.sub(a, s)))
        # active (a' - s') (a' - a'(w^-1 X))
        return F.add(F.mul(value, y), F.mul(
            F.mul(F.sub(a, s), F.sub(a, a_prev)), l_active))

    def _shuffle(self, pk, sh_arg, value, y, gamma, theta, ch, z, cols):
        F, domain = self.F, self.domain
        one = F.ones((), domain.device)
        l0, l_last, l_active = pk.l0, pk.l_last, pk.l_active_row
        z_next = domain.rotate_extended(z, Rotation(1))
        comp_in = self._compress(sh_arg.input_expressions, theta, cols, ch)
        comp_sh = self._compress(sh_arg.shuffle_expressions, theta, cols, ch)
        # l_0 (1 - z)
        value = F.add(F.mul(value, y), F.mul(l0, F.sub(one, z)))
        # l_last (z^2 - z)
        value = F.add(F.mul(value, y),
                      F.mul(l_last, F.sub(F.square(z), z)))
        # active (z(wX)(S + g) - z(X)(A + g))
        left = F.mul(z_next, F.add(comp_sh, gamma))
        right = F.mul(z, F.add(comp_in, gamma))
        return F.add(F.mul(value, y), F.mul(F.sub(left, right), l_active))


class Prover:
    """Multi-circuit prover state machine (prover.rs:130-899)."""

    def __init__(self, params, pk: ProvingKey, instances, rng, transcript,
                 query_instance: bool, engine=None):
        self.params = params
        self.query_instance = query_instance
        self.pk = pk
        self.F = F = pk.vk.F
        self.device = dev = params.device
        self.rng = rng
        self.transcript = transcript
        self.timings: Dict[str, float] = {}
        self.mesh = engine.mesh if engine is not None else None
        if engine is not None:
            params.set_engine(engine)
            if engine.mesh is not None and pk.vk.domain._mesh is None:
                pk.vk.domain.set_mesh(engine.mesh)
        self.challenges: Dict[int, int] = {}
        cs = pk.vk.cs.cs
        for inst in instances:
            if len(inst) != cs.num_instance_columns:
                raise ValueError("invalid number of instance columns")
        domain = pk.vk.domain
        n = domain.n
        bf = pk.vk.cs.blinding_factors()

        # [TRANSCRIPT-1] vk hash
        pk.vk.hash_into(transcript)
        # [TRANSCRIPT-2] instances: absorbed as scalars, or committed
        # (query_instance schemes) and absorbed as points
        self.instance_values = []
        self.instance_polys = []
        for inst in instances:
            cols = []
            for values in inst:
                if len(values) > n - (bf + 1):
                    raise ValueError("instance too large")
                if not query_instance:
                    for v in values:
                        transcript.common_scalar(v % F.p)
                cols.append([v % F.p for v in values] +
                            [0] * (n - len(values)))
            vals = F.encode_ints_cols(cols, dev) if cols \
                else F.zeros((0, n), dev)
            if query_instance:
                pre = PreMSM(params.curve)
                for col in vals:
                    pre.append_term(1, params.commit_lagrange(
                        Poly.lagrange(col), Blind(1)))
                for pt in pre.normalize():
                    transcript.common_point(pt)
            self.instance_values.append(vals)
            self.instance_polys.append(
                domain.lagrange_to_coeff(Poly.lagrange(vals)) if cols
                else Poly.coeff(vals))
        na = cs.num_advice_columns
        self.advice_values = [F.zeros((na, n), dev) for _ in instances]
        self.advice_blinds = [[Blind(1)] * na for _ in instances]

    # ------------------------------------------------------------------

    def commit_phase(self, phase: int, witnesses) -> Dict[int, int]:
        """witnesses: per circuit, {advice column index: values} for this
        phase.  Returns the challenges so far (prover.rs:309-494)."""
        F = self.F
        pk = self.pk
        cs = pk.vk.cs.cs
        n = pk.vk.domain.n
        bf = pk.vk.cs.blinding_factors()
        unusable_start = n - (bf + 1)
        unblinded = set(cs.unblinded_advice_columns)
        rng = self.rng
        column_indices = [i for i, ph in enumerate(cs.advice_column_phase)
                          if ph == phase]
        for circ, witness in enumerate(witnesses):
            assert set(witness.keys()) == set(column_indices)
            if not column_indices:
                continue
            col_vals, blinds = [], []
            for ci in column_indices:
                values = [v % F.p for v in witness[ci]]
                assert len(values) == n
                if ci not in unblinded:
                    for r in range(unusable_start, n):
                        values[r] = rng.randrange(F.p)
                    blind = Blind(rng.randrange(F.p))
                else:
                    blind = Blind(1)
                col_vals.append(values)
                blinds.append(blind)
            cols = F.encode_ints_cols(col_vals, self.device)
            pre = PreMSM(self.params.curve)
            for j in range(len(column_indices)):
                pre.append_term(1, self.params.commit_lagrange(
                    Poly.lagrange(cols[j]), blinds[j]))
            # [TRANSCRIPT-3]
            for pt in pre.normalize():
                self.transcript.write_point(pt)
            idx = torch.tensor(column_indices, device=self.device)
            self.advice_values[circ][idx] = cols
            for j, ci in enumerate(column_indices):
                self.advice_blinds[circ][ci] = blinds[j]
        # [TRANSCRIPT-4]
        for index, ch_phase in enumerate(cs.challenge_phase):
            if ch_phase == phase:
                assert index not in self.challenges
                self.challenges[index] = self.transcript.squeeze_challenge()
        return dict(self.challenges)

    # ------------------------------------------------------------------

    def _tick(self, name: str):
        """Charge the wall time since the previous tick to step `name`,
        after the device finished the step's work."""
        _sync(self.device)
        now = time.time()
        self.timings[name] = self.timings.get(name, 0.0) + now - self._t_last
        self._t_last = now

    def create_proof(self) -> List[ProverQuery]:
        F = self.F
        p = F.p
        dev = self.device
        pk = self.pk
        params = self.params
        cs_back = pk.vk.cs
        cs = cs_back.cs
        domain = pk.vk.domain
        n = domain.n
        bf = cs_back.blinding_factors()
        rng = self.rng
        t = self.transcript
        n_circ = len(self.instance_values)
        _sync(dev)
        self._t_last = time.time()

        challenges_enc = [F.encode_int(self.challenges[i], dev)
                          for i in range(cs.num_challenges)]

        # [TRANSCRIPT-5] theta; [TRANSCRIPT-6] permuted lookup commitments
        theta = t.squeeze_challenge()
        permuted = [[self._lookup_commit_permuted(c, lk, theta,
                                                  challenges_enc)
                     for lk in cs.lookups] for c in range(n_circ)]
        self._tick("lookup_permute [T5-6]")

        # [TRANSCRIPT-7/8] beta, gamma; [9] permutation; [10] lookup
        # products; [11] shuffle products
        beta = t.squeeze_challenge()
        gamma = t.squeeze_challenge()
        permutations_z = [self._permutation_commit(c, beta, gamma)
                          for c in range(n_circ)]
        lookups_committed = [[self._lookup_commit_product(pl, beta, gamma)
                              for pl in permuted[c]] for c in range(n_circ)]
        permuted = None     # the Lagrange intermediates are dead from here
        shuffles_committed = [[self._shuffle_commit_product(
            c, sh, theta, gamma, challenges_enc) for sh in cs.shuffles]
            for c in range(n_circ)]
        self._tick("grand_products [T9-11]")

        # [TRANSCRIPT-12] vanishing random poly
        random_poly = Poly.coeff(_random_poly(F, n, rng, dev))
        random_blind = Blind(rng.randrange(p))
        t.write_point(params.commit_affine(random_poly, random_blind))
        advice_polys = [domain.lagrange_to_coeff(Poly.lagrange(a))
                        if a.shape[0] else Poly.coeff(a)
                        for a in self.advice_values]
        self.advice_values = None
        self._tick("vanishing_random [T12]")

        # [TRANSCRIPT-13] y; evaluate h
        y = t.squeeze_challenge()
        h_ext = pk.ev.evaluate_h(
            pk, advice_polys, self.instance_polys, challenges_enc,
            F.encode_int(y, dev), F.encode_int(beta, dev),
            F.encode_int(gamma, dev), F.encode_int(theta, dev),
            [[(lk["product_poly"], lk["permuted_input_poly"],
               lk["permuted_table_poly"]) for lk in lkc]
             for lkc in lookups_committed],
            [[sh["product_poly"] for sh in shc]
             for shc in shuffles_committed],
            [[s["poly"] for s in pz] for pz in permutations_z])
        self._tick("evaluate_h [T13]")

        # [TRANSCRIPT-14] h pieces
        h_coeff = domain.extended_to_coeff(
            domain.divide_by_vanishing_poly(h_ext))
        n_pieces = domain.quotient_poly_degree
        h_pieces = [h_coeff[i * n:(i + 1) * n] for i in range(n_pieces)]
        h_blinds = [Blind(rng.randrange(p)) for _ in range(n_pieces)]
        pre = PreMSM(params.curve)
        for piece, blind in zip(h_pieces, h_blinds):
            pre.append_term(1, params.commit(piece, blind))
        for pt in pre.normalize():
            t.write_point(pt)
        self._tick("h_pieces [T14]")

        # [TRANSCRIPT-15] x
        x = t.squeeze_challenge()
        xn = pow(x, n, p)
        h_poly = None
        h_blind = 0
        xn_enc = F.encode_int(xn, dev)
        for piece, blind in zip(reversed(h_pieces), reversed(h_blinds)):
            if h_poly is None:
                h_poly, h_blind = piece, blind.value
            else:
                h_poly = Poly.coeff(F.add(F.mul(h_poly.values, xn_enc),
                                          piece.values))
                h_blind = (h_blind * xn + blind.value) % p

        # [TRANSCRIPT-17..22] opening evaluations, in transcript order
        x_next = domain.rotate_omega_int(x, Rotation(1))
        x_last = domain.rotate_omega_int(x, Rotation(-(bf + 1)))
        x_prev = domain.rotate_omega_int(x, Rotation(-1))
        m = len(cs.permutation.columns)
        reqs = []
        if self.query_instance:
            for c in range(n_circ):
                for column, at in cs_back.instance_queries:
                    reqs.append((self.instance_polys[c][column.index],
                                 domain.rotate_omega_int(x, at)))
        for c in range(n_circ):
            for column, at in cs_back.advice_queries:
                reqs.append((advice_polys[c][column.index],
                             domain.rotate_omega_int(x, at)))
        for column, at in cs_back.fixed_queries:
            reqs.append((pk.fixed_polys[column.index],
                         domain.rotate_omega_int(x, at)))
        reqs.append((random_poly, x))
        for j in range(m):
            reqs.append((pk.permutation.polys[j], x))
        for c in range(n_circ):
            sets = permutations_z[c]
            for si, s in enumerate(sets):
                reqs.append((s["poly"], x))
                reqs.append((s["poly"], x_next))
                if si < len(sets) - 1:
                    reqs.append((s["poly"], x_last))
        for c in range(n_circ):
            for lk in lookups_committed[c]:
                reqs += [(lk["product_poly"], x),
                         (lk["product_poly"], x_next),
                         (lk["permuted_input_poly"], x),
                         (lk["permuted_input_poly"], x_prev),
                         (lk["permuted_table_poly"], x)]
        for c in range(n_circ):
            for sh in shuffles_committed[c]:
                reqs += [(sh["product_poly"], x),
                         (sh["product_poly"], x_next)]
        for v in eval_polys_at_points(F, reqs):
            t.write_scalar(v)
        self._tick("evals [T15-23]")

        # prover queries (prover.rs:840-889)
        queries: List[ProverQuery] = []
        for c in range(n_circ):
            if self.query_instance:
                inst_refs = {}
                for column, at in cs_back.instance_queries:
                    if column.index not in inst_refs:
                        inst_refs[column.index] = PolyRef(
                            self.instance_polys[c][column.index], Blind(1))
                    queries.append(ProverQuery(
                        domain.rotate_omega_int(x, at),
                        inst_refs[column.index]))
            adv_refs = {}
            for column, at in cs_back.advice_queries:
                if column.index not in adv_refs:
                    adv_refs[column.index] = PolyRef(
                        advice_polys[c][column.index],
                        self.advice_blinds[c][column.index])
                queries.append(ProverQuery(domain.rotate_omega_int(x, at),
                                           adv_refs[column.index]))
            set_refs = [PolyRef(s["poly"], s["blind"])
                        for s in permutations_z[c]]
            for ref in set_refs:
                queries.append(ProverQuery(x, ref))
                queries.append(ProverQuery(x_next, ref))
            for ref in reversed(set_refs[:-1]):
                queries.append(ProverQuery(x_last, ref))
            for lk in lookups_committed[c]:
                prod = PolyRef(lk["product_poly"], lk["product_blind"])
                pin = PolyRef(lk["permuted_input_poly"],
                              lk["permuted_input_blind"])
                ptab = PolyRef(lk["permuted_table_poly"],
                               lk["permuted_table_blind"])
                queries += [ProverQuery(x, prod), ProverQuery(x, pin),
                            ProverQuery(x, ptab), ProverQuery(x_prev, pin),
                            ProverQuery(x_next, prod)]
            for sh in shuffles_committed[c]:
                prod = PolyRef(sh["product_poly"], sh["product_blind"])
                queries += [ProverQuery(x, prod), ProverQuery(x_next, prod)]
        fixed_refs = {}
        for column, at in cs_back.fixed_queries:
            if column.index not in fixed_refs:
                fixed_refs[column.index] = PolyRef(
                    pk.fixed_polys[column.index], Blind(1))
            queries.append(ProverQuery(domain.rotate_omega_int(x, at),
                                       fixed_refs[column.index]))
        for j in range(m):
            queries.append(ProverQuery(
                x, PolyRef(pk.permutation.polys[j], Blind(1))))
        queries.append(ProverQuery(x, PolyRef(h_poly, Blind(h_blind))))
        queries.append(ProverQuery(x, PolyRef(random_poly, random_blind)))
        return queries

    # ------------------------------------------------------------------
    # argument helpers
    # ------------------------------------------------------------------

    def _compress(self, circ, exprs, theta_enc, challenges_enc):
        F = self.F
        acc = F.zeros((self.pk.vk.domain.n,), self.device)
        for e in exprs:
            acc = F.add(F.mul(acc, theta_enc), evaluate_expression(
                F, e, fixed=self.pk.fixed_values,
                advice=self.advice_values[circ],
                instance=self.instance_values[circ],
                challenges=dict(enumerate(challenges_enc)),
                device=self.device))
        return acc

    def _lookup_commit_permuted(self, circ, lk_arg, theta, challenges_enc):
        """lookup/prover.rs:64-173 with the sort-based permute."""
        F = self.F
        p = F.p
        dev = self.device
        domain = self.pk.vk.domain
        bf = self.pk.vk.cs.blinding_factors()
        usable = domain.n - (bf + 1)
        rng = self.rng
        theta_enc = F.encode_int(theta, dev)
        comp_in = self._compress(circ, lk_arg.input_expressions, theta_enc,
                                 challenges_enc)
        comp_tab = self._compress(circ, lk_arg.table_expressions, theta_enc,
                                  challenges_enc)
        a_dev, s_dev = permute_expression_pair_device(F, comp_in, comp_tab,
                                                      usable)
        blind_in = F.encode_ints([rng.randrange(p) for _ in range(bf + 1)],
                                 dev)
        blind_tab = F.encode_ints([rng.randrange(p) for _ in range(bf + 1)],
                                  dev)
        permuted_input = Poly.lagrange(torch.cat([a_dev, blind_in]))
        permuted_table = Poly.lagrange(torch.cat([s_dev, blind_tab]))
        in_blind = Blind(rng.randrange(p))
        tab_blind = Blind(rng.randrange(p))
        pre = PreMSM(self.params.curve)
        pre.append_term(1, self.params.commit_lagrange(permuted_input,
                                                       in_blind))
        pre.append_term(1, self.params.commit_lagrange(permuted_table,
                                                       tab_blind))
        for pt in pre.normalize():
            self.transcript.write_point(pt)
        return {
            "compressed_input": comp_in, "compressed_table": comp_tab,
            "permuted_input": permuted_input.values,
            "permuted_table": permuted_table.values,
            "permuted_input_poly": domain.lagrange_to_coeff(permuted_input),
            "permuted_table_poly": domain.lagrange_to_coeff(permuted_table),
            "permuted_input_blind": in_blind,
            "permuted_table_blind": tab_blind,
        }

    def _commit_product(self, ratios):
        """The grand product z of a lookup or a shuffle: 1, then the
        running product of `ratios` over the usable rows, then bf random
        draws and one blind, committed in Lagrange form (lookup/prover.rs:
        254-324, shuffle/prover.rs:160-211).  Returns (coeff z, blind)."""
        F = self.F
        p = F.p
        dev = self.device
        n = self.pk.vk.domain.n
        bf = self.pk.vk.cs.blinding_factors()
        z = torch.cat([F.ones((1,), dev), prefix_product(F, ratios)])
        z = Poly.lagrange(torch.cat([z[: n - bf], F.encode_ints(
            [self.rng.randrange(p) for _ in range(bf)], dev)]))
        blind = Blind(self.rng.randrange(p))
        self.transcript.write_point(
            self.params.commit_affine_lagrange(z, blind))
        return self.pk.vk.domain.lagrange_to_coeff(z), blind

    def _lookup_commit_product(self, pl, beta, gamma):
        """lookup/prover.rs:182-324."""
        F = self.F
        dev = self.device
        b_enc, g_enc = F.encode_int(beta, dev), F.encode_int(gamma, dev)
        denom = F.mul(F.add(pl["permuted_input"], b_enc),
                      F.add(pl["permuted_table"], g_enc))
        numer = F.mul(F.add(pl["compressed_input"], b_enc),
                      F.add(pl["compressed_table"], g_enc))
        z, blind = self._commit_product(F.mul(numer, F.batch_inv(denom)))
        return {
            "product_poly": z,
            "product_blind": blind,
            "permuted_input_poly": pl["permuted_input_poly"],
            "permuted_table_poly": pl["permuted_table_poly"],
            "permuted_input_blind": pl["permuted_input_blind"],
            "permuted_table_blind": pl["permuted_table_blind"],
        }

    def _permutation_commit(self, circ, beta, gamma):
        """permutation/prover.rs:50-197; one z per chunk of columns."""
        F = self.F
        p = F.p
        dev = self.device
        pk = self.pk
        domain = pk.vk.domain
        n = domain.n
        bf = pk.vk.cs.blinding_factors()
        columns = pk.vk.cs.cs.permutation.columns
        if not columns:
            return []
        chunk_len = pk.vk.cs_degree - 2
        b_enc, g_enc = F.encode_int(beta, dev), F.encode_int(gamma, dev)
        omega_pows = powers(F, F.encode_int(domain.omega, dev), n)
        kind_map = {ADVICE: self.advice_values[circ],
                    FIXED: pk.fixed_values,
                    INSTANCE: self.instance_values[circ]}
        sets = []
        pre = PreMSM(self.params.curve)
        last_z = 1
        delta_power = 0
        for ci in range(0, len(columns), chunk_len):
            chunk = columns[ci: ci + chunk_len]
            modified = F.ones((n,), dev)
            for j, col in enumerate(chunk):
                vals = kind_map[col.kind][col.index]
                sigma = pk.permutation.permutations[ci + j]
                modified = F.mul(modified, F.add(F.add(
                    F.mul(b_enc, sigma), g_enc), vals))
            modified = F.batch_inv(modified)
            for col in chunk:
                vals = kind_map[col.kind][col.index]
                deltaomega = F.mul(omega_pows, F.encode_int(
                    pow(F.delta, delta_power, p), dev))
                modified = F.mul(modified, F.add(F.add(
                    F.mul(deltaomega, b_enc), g_enc), vals))
                delta_power += 1
            if self.mesh is not None:
                from ..dist.scan import sharded_prefix_product
                cum = sharded_prefix_product(self.mesh, F, modified)
            else:
                cum = prefix_product(F, modified)
            z = torch.cat([F.encode_ints([last_z], dev),
                           F.mul(cum[:-1], F.encode_int(last_z, dev))])
            z = torch.cat([z[: n - bf], F.encode_ints(
                [self.rng.randrange(p) for _ in range(bf)], dev)])
            last_z = F.decode_int(z[n - (bf + 1)])
            blind = Blind(self.rng.randrange(p))
            z = Poly.lagrange(z)
            pre.append_term(1, self.params.commit_lagrange(z, blind))
            sets.append({"poly": domain.lagrange_to_coeff(z), "blind": blind})
        # the z commitments are written together: no challenge lies between
        for pt in pre.normalize():
            self.transcript.write_point(pt)
        return sets

    def _shuffle_commit_product(self, circ, sh_arg, theta, gamma,
                                challenges_enc):
        """shuffle/prover.rs:97-211: the grand product of
        (A + gamma) / (S + gamma)."""
        F = self.F
        dev = self.device
        theta_enc = F.encode_int(theta, dev)
        g_enc = F.encode_int(gamma, dev)
        comp_in = self._compress(circ, sh_arg.input_expressions, theta_enc,
                                 challenges_enc)
        comp_sh = self._compress(circ, sh_arg.shuffle_expressions, theta_enc,
                                 challenges_enc)
        z, blind = self._commit_product(F.mul(
            F.add(comp_in, g_enc), F.batch_inv(F.add(comp_sh, g_enc))))
        return {"product_poly": z, "product_blind": blind}
