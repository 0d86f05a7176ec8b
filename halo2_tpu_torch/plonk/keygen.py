"""Backend keygen (port of the JAX reference's plonk/keygen.py; keygen.rs and
permutation/keygen.rs).  Column data lands on the params' device as stacked
tensors; commitments are normalized to host affine ints."""

from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from ..commit.base import Blind
from ..commit.kzg import PreMSM
from ..compat import pinned
from ..fields.field import Field
from ..frontend.circuit import CompiledCircuit
from ..frontend.constraint_system import ConstraintSystem
from ..frontend.expression import ADVICE, FIXED, INSTANCE, Column, Rotation
from ..poly.domain import EvaluationDomain


class ConstraintSystemBack:
    """Frontend CS plus indexed query lists (backend circuit.rs:57-95)."""

    def __init__(self, cs: ConstraintSystem, p: int = 0):
        self.cs = cs
        self.p = p
        self.advice_queries: List[Tuple[Column, Rotation]] = []
        self.fixed_queries: List[Tuple[Column, Rotation]] = []
        self.instance_queries: List[Tuple[Column, Rotation]] = []
        self._index: Dict = {}
        self.num_advice_queries = [0] * cs.num_advice_columns

        def add(column: Column, rot: Rotation):
            key = (column.kind, column.index, rot.i)
            if key in self._index:
                return
            lst = {ADVICE: self.advice_queries, FIXED: self.fixed_queries,
                   INSTANCE: self.instance_queries}[column.kind]
            self._index[key] = len(lst)
            lst.append((column, rot))
            if column.kind == ADVICE:
                self.num_advice_queries[column.index] += 1

        def walk(expr):
            expr.evaluate(
                lambda _: None, lambda _: None,
                lambda c, r: add(c, r), lambda _: None,
                lambda a: None, lambda a, b: None, lambda a, b: None,
                lambda a, _: None)

        for gate in cs.gates:
            for poly in gate.polys:
                walk(poly)
        for lk in cs.lookups:
            for e in lk.input_expressions + lk.table_expressions:
                walk(e)
        for sh in cs.shuffles:
            for e in sh.input_expressions + sh.shuffle_expressions:
                walk(e)
        for col in cs.permutation.columns:
            add(col, Rotation(0))

    def get_query_index(self, column: Column, rot: Rotation) -> int:
        return self._index[(column.kind, column.index, rot.i)]

    def degree(self) -> int:
        return self.cs.degree()

    def blinding_factors(self) -> int:
        factors = max(self.num_advice_queries + [1])
        return max(3, factors) + 1 + 1

    def usable_rows(self, n: int) -> int:
        """Rows of a 2^k domain left for the witness: n less the blinding
        rows and the last row."""
        return n - (self.blinding_factors() + 1)


class PermutationAssembly:
    """Cycle merge (permutation/keygen.rs:20-118)."""

    def __init__(self, n: int, columns: List[Column]):
        self.n = n
        self.columns = columns
        m = len(columns)
        self.mapping = [[(j, i) for i in range(n)] for j in range(m)]
        self.aux = [[(j, i) for i in range(n)] for j in range(m)]
        self.sizes = [[1] * n for _ in range(m)]
        self._col_idx = {c: j for j, c in enumerate(columns)}

    def copy(self, lcol: Column, lrow: int, rcol: Column, rrow: int):
        for col in (lcol, rcol):
            if col not in self._col_idx:
                raise ValueError(f"column {col} not in permutation "
                                 "(missing enable_equality?)")
        left = (self._col_idx[lcol], lrow)
        right = (self._col_idx[rcol], rrow)
        left_cycle = self.aux[left[0]][left[1]]
        right_cycle = self.aux[right[0]][right[1]]
        if left_cycle == right_cycle:
            return
        if (self.sizes[left_cycle[0]][left_cycle[1]] <
                self.sizes[right_cycle[0]][right_cycle[1]]):
            left_cycle, right_cycle = right_cycle, left_cycle
        self.sizes[left_cycle[0]][left_cycle[1]] += \
            self.sizes[right_cycle[0]][right_cycle[1]]
        i = right_cycle
        while True:
            self.aux[i[0]][i[1]] = left_cycle
            i = self.mapping[i[0]][i[1]]
            if i == right_cycle:
                break
        lm = self.mapping[left[0]][left[1]]
        self.mapping[left[0]][left[1]] = self.mapping[right[0]][right[1]]
        self.mapping[right[0]][right[1]] = lm

    def sigma_values(self, F: Field, domain: EvaluationDomain):
        """sigma_j(omega^i) = delta^j' omega^i' for mapping (j,i) -> (j',i')."""
        p = F.p
        omega_powers = [1] * self.n
        for i in range(1, self.n):
            omega_powers[i] = (omega_powers[i - 1] * domain.omega) % p
        delta_powers = [1] * max(len(self.columns), 1)
        for j in range(1, len(self.columns)):
            delta_powers[j] = (delta_powers[j - 1] * F.delta) % p
        return [[(delta_powers[jj] * omega_powers[ii]) % p
                 for jj, ii in self.mapping[j]]
                for j in range(len(self.columns))]


@dataclass
class PermutationVK:
    commitments: List


@dataclass
class PermutationPK:
    permutations: torch.Tensor    # (m, n, 8) lagrange sigma values
    polys: torch.Tensor           # (m, n, 8) coeff
    cosets: torch.Tensor          # (m, ext_n, 8)


class VerifyingKey:
    def __init__(self, F: Field, curve, domain: EvaluationDomain,
                 cs_back: ConstraintSystemBack, fixed_commitments: List,
                 permutation_vk: PermutationVK, k: int):
        self.F = F
        self.curve = curve
        self.domain = domain
        self.cs = cs_back
        self.cs_degree = cs_back.degree()
        self.fixed_commitments = fixed_commitments
        self.permutation = permutation_vk
        self.k = k
        self.transcript_repr = self._compute_repr()

    def pinned(self) -> str:
        """`format!("{:#?}", vk.pinned())`, the reference's golden form."""
        return pinned.pinned_pretty(self)

    def pinned_compact(self) -> str:
        return pinned.pinned_compact(self)

    def _compute_repr(self) -> int:
        """Pinned-vk hash (plonk.rs:189-202)."""
        s = self.pinned_compact().encode()
        h = hashlib.blake2b(digest_size=64, person=b"Halo2-Verify-Key")
        h.update(len(s).to_bytes(8, "little"))
        h.update(s)
        return self.F.from_uniform_bytes(h.digest())

    def hash_into(self, transcript):
        transcript.common_scalar(self.transcript_repr)


class ProvingKey:
    def __init__(self, vk: VerifyingKey, l0, l_last, l_active_row,
                 fixed_values, fixed_polys, fixed_cosets,
                 permutation_pk: PermutationPK, evaluator):
        self.vk = vk
        self.l0 = l0
        self.l_last = l_last
        self.l_active_row = l_active_row
        self.fixed_values = fixed_values
        self.fixed_polys = fixed_polys
        self.fixed_cosets = fixed_cosets
        self.permutation = permutation_pk
        self.ev = evaluator


def keygen(F: Field, params, compiled: CompiledCircuit, k: int,
           engine=None) -> ProvingKey:
    """keygen_vk + keygen_pk fused, on the params' device; an engine with
    a mesh shards the domain's transforms and the commitments over it."""
    from .prover import Evaluator

    curve = params.curve
    dev = params.device
    cs = compiled.cs
    # HALO2_TPU_DEBUG_KEYGEN=1: the reference's five step lines
    # (keygen.py:232-309), each after the device's queue drained
    dbg = os.environ.get("HALO2_TPU_DEBUG_KEYGEN") == "1"
    t_last = [time.time()]

    def kt(name):
        if dbg:
            if torch.device(dev).type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.time()
            print(f"[keygen] {name}: {now - t_last[0]:.1f}s", flush=True)
            t_last[0] = now

    cs_back = ConstraintSystemBack(cs, F.p)
    n = 1 << k
    domain = EvaluationDomain(F, max(cs_back.degree(), 2), k, dev)
    if engine is not None:
        params.set_engine(engine)
        if engine.mesh is not None:
            domain.set_mesh(engine.mesh)

    nf = cs.num_fixed_columns
    if nf:
        fixed_values = F.encode_ints_cols(
            [col + [0] * (n - len(col)) for col in compiled.preprocessing.fixed],
            dev)
        fixed_polys = domain.lagrange_to_coeff(fixed_values)
        fixed_cosets = domain.coeff_to_extended(fixed_polys)
    else:
        fixed_values = fixed_polys = F.zeros((0, n), dev)
        fixed_cosets = F.zeros((0, domain.extended_n), dev)
    kt("fixed encode+ffts")
    # fixed and sigma commitments share one batched normalization
    pre = PreMSM(curve)
    for col in fixed_values:
        pre.append_term(1, params.commit_lagrange(col, Blind(1)))
    kt("fixed commits")

    assembly = PermutationAssembly(n, cs.permutation.columns)
    for (lc, lr), (rc, rr) in compiled.preprocessing.copies:
        assembly.copy(lc, lr, rc, rr)
    kt("perm cycle merge")
    m = len(cs.permutation.columns)
    if m:
        sigmas = F.encode_ints_cols(assembly.sigma_values(F, domain), dev)
        sigma_polys = domain.lagrange_to_coeff(sigmas)
        sigma_cosets = domain.coeff_to_extended(sigma_polys)
    else:
        sigmas = sigma_polys = F.zeros((0, n), dev)
        sigma_cosets = F.zeros((0, domain.extended_n), dev)
    for col in sigmas:
        pre.append_term(1, params.commit_lagrange(col, Blind(1)))
    commitments = pre.normalize()
    fixed_commitments, perm_commitments = commitments[:nf], commitments[nf:]
    kt("sigma values+ffts+commits")

    vk = VerifyingKey(F, curve, domain, cs_back, fixed_commitments,
                      PermutationVK(perm_commitments), k)

    # l0, l_last, l_blind as extended-domain evaluations (keygen.rs:134-166)
    bf = cs_back.blinding_factors()
    cols = []
    for rows in ([0], [n - bf - 1], range(n - bf, n)):
        col = [0] * n
        for r in rows:
            col[r] = 1
        cols.append(col)
    l0, l_last, l_blind = domain.coeff_to_extended(
        domain.lagrange_to_coeff(F.encode_ints_cols(cols, dev))).unbind(0)
    one = F.ones((domain.extended_n,), dev)
    l_active_row = F.sub(F.sub(one, l_last), l_blind)
    kt("vk hash + lagrange basis")

    return ProvingKey(vk, l0, l_last, l_active_row, fixed_values,
                      fixed_polys, fixed_cosets,
                      PermutationPK(sigmas, sigma_polys, sigma_cosets),
                      Evaluator(F, domain, cs_back))


def keygen_vk(F: Field, params, compiled: CompiledCircuit,
              k: int) -> VerifyingKey:
    """The verifying key alone: `keygen(...).vk`, as in the reference."""
    return keygen(F, params, compiled, k).vk
