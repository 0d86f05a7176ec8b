"""Circuit cost measurement + proof-size/verification cost model (port of
the JAX reference's dev/cost_model.py).

Mirrors halo2_frontend/src/dev/cost.rs (CircuitCost :27-90) and
dev/cost_model.rs (CostOptions/ModelCircuit :16-242, "cost-estimator"
feature): derives column/query/argument counts from a configured circuit and
computes marginal/total proof sizes per commitment scheme.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, asdict
from typing import Optional

from ..frontend.circuit import Circuit, configure_circuit
from ..frontend.constraint_system import ConstraintSystem

COMMITMENT_SCHEMES = ("ipa", "kzg-gwc", "kzg-shplonk")


@dataclass
class CircuitCost:
    """Structural counts for a circuit at size 2^k."""
    k: int
    max_degree: int
    advice_columns: int
    fixed_columns: int
    instance_columns: int
    selectors: int
    gates: int
    gate_constraints: int
    lookups: int
    shuffles: int
    permutation_columns: int
    advice_queries: int
    fixed_queries: int
    instance_queries: int
    blinding_factors: int
    minimum_rows: int

    @staticmethod
    def measure(k: int, circuit: Circuit) -> "CircuitCost":
        cs = ConstraintSystem()
        configure_circuit(circuit, cs)
        return CircuitCost(
            k=k,
            max_degree=cs.degree(),
            advice_columns=cs.num_advice_columns,
            fixed_columns=cs.num_fixed_columns,
            instance_columns=cs.num_instance_columns,
            selectors=cs.num_selectors,
            gates=len(cs.gates),
            gate_constraints=sum(len(g.polys) for g in cs.gates),
            lookups=len(cs.lookups),
            shuffles=len(cs.shuffles),
            permutation_columns=len(cs.permutation.columns),
            advice_queries=len(cs.advice_queries),
            fixed_queries=len(cs.fixed_queries),
            instance_queries=len(cs.instance_queries),
            blinding_factors=cs.blinding_factors(),
            minimum_rows=cs.minimum_rows(),
        )

    # -- proof size model (dev/cost_model.rs:128-242) --------------------

    def proof_size(self, scheme: str = "ipa", num_instances: int = 1) -> int:
        """Estimated proof bytes (32-byte points/scalars)."""
        assert scheme in COMMITMENT_SCHEMES
        point = scalar = 32
        chunk_len = max(self.max_degree - 2, 1)
        perm_sets = -(-self.permutation_columns // chunk_len) \
            if self.permutation_columns else 0
        quotient_pieces = max(self.max_degree - 1, 1)

        size = 0
        # advice commitments + lookup (2 perm + 1 product) + shuffle products
        size += self.advice_columns * point
        size += self.lookups * 3 * point
        size += self.shuffles * point
        size += perm_sets * point
        size += point              # vanishing random poly
        size += quotient_pieces * point
        # evals
        size += self.advice_queries * scalar
        size += self.fixed_queries * scalar
        size += scalar             # random eval
        size += self.permutation_columns * scalar     # sigma evals
        size += (perm_sets * 2 + max(perm_sets - 1, 0)) * scalar
        size += self.lookups * 5 * scalar
        size += self.shuffles * 2 * scalar
        if scheme == "ipa":
            size += self.instance_queries * scalar
            # multiopen: q' commit + per-set evals + S + 2k L/R + c + f
            size += point + 2 * scalar
            size += point          # s_poly
            size += 2 * self.k * point
            size += 2 * scalar
        elif scheme == "kzg-gwc":
            # one witness commitment per distinct opening point (~3-5)
            size += 5 * point
        else:  # shplonk
            size += 2 * point
        return size

    # -- verification time model (book/src/user/dev-tools.md:113
    #    "Verification: at least 81.689ms"; the reference's cost-model
    #    example prices the verifier's multiexps with a live host
    #    micro-benchmark) -------------------------------------------------

    def verifier_msm_sizes(self, scheme: str = "ipa",
                           num_instances: int = 1) -> list:
        """Sizes of the MSMs the verifier must evaluate.  Our verifier
        defers every commitment fold into host-side Pippenger MSMs
        (msm/host_msm.py, plonk/verifier.py), so the estimate counts
        exactly those."""
        assert scheme in COMMITMENT_SCHEMES
        chunk_len = max(self.max_degree - 2, 1)
        perm_sets = -(-self.permutation_columns // chunk_len) \
            if self.permutation_columns else 0
        quotient_pieces = max(self.max_degree - 1, 1)
        # every proof/vk commitment enters the final folded MSM once:
        n_comm = (self.advice_columns + self.fixed_columns
                  + self.instance_columns * num_instances
                  + self.selectors  # compressed into fixed, upper bound
                  + 3 * self.lookups + self.shuffles
                  + perm_sets + self.permutation_columns
                  + 1 + quotient_pieces)
        if scheme == "ipa":
            # Guard::use_g — the b-vector MSM over the 2^k SRS bases
            return [n_comm + 2 * self.k, 1 << self.k]
        # GWC folds per-rotation witnesses, SHPLONK two pairs; both end in
        # one deferred MSM over the commitments plus the pairing inputs
        return [n_comm + (5 if scheme == "kzg-gwc" else 2)]

    def verification_time(self, scheme: str = "ipa", num_instances: int = 1,
                          calibration: Optional[dict] = None) -> float:
        """Estimated verification seconds ("at least": MSM + pairing floor,
        ignoring transcript hashing and scalar bookkeeping).

        calibration: {"msm_pt_s": seconds per MSM point,
                      "pairing_s": seconds per pairing check} — pass
        `calibrate_verifier()`'s result for live-measured rates; the
        defaults are the reference's, from a python-int host_msm / bn254
        pairing measurement (order-of-magnitude, like its example)."""
        cal = calibration or _DEFAULT_VERIFIER_CALIBRATION
        t = sum(n * cal["msm_pt_s"] for n in self.verifier_msm_sizes(
            scheme, num_instances))
        if scheme.startswith("kzg"):
            t += cal["pairing_s"]
        return t

    def to_json(self, scheme: str = "ipa") -> str:
        d = asdict(self)
        d["proof_size"] = {s: self.proof_size(s) for s in COMMITMENT_SCHEMES}
        d["verification_time_s"] = {
            s: round(self.verification_time(s), 4)
            for s in COMMITMENT_SCHEMES}
        return json.dumps(d, indent=2)


# The reference's defaults, host rates (no device): host_msm ~0.43 ms a
# point (256-point BN254 Pippenger on python ints), a BN254 2-pairing check
# ~68 ms (compat/bn254_pairing through the native host library).
# Recalibrate with calibrate_verifier().
_DEFAULT_VERIFIER_CALIBRATION = {"msm_pt_s": 0.43e-3, "pairing_s": 0.068}


def calibrate_verifier(curve=None, n: int = 256) -> dict:
    """Measure the host-verifier primitive rates on THIS machine (the
    reference's cost-model example ran the same style of live multiexp
    micro-bench).  Returns a calibration dict for `verification_time`."""
    import random
    import time
    if curve is None:
        from ..curves import BN254_G1 as curve
    from ..msm.host_msm import host_msm
    rng = random.Random(7)

    def _py_mul(P, k):
        acc, add = None, P
        while k:
            if k & 1:
                acc = _py_add(acc, add)
            add = _py_add(add, add)
            k >>= 1
        return acc

    def _py_add(P, Q):
        p = curve.Fq.p
        if P is None:
            return Q
        if Q is None:
            return P
        x1, y1 = P
        x2, y2 = Q
        if x1 == x2 and (y1 + y2) % p == 0:
            return None
        if P == Q:
            lam = (3 * x1 * x1) * pow(2 * y1, p - 2, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, p - 2, p) % p
        x3 = (lam * lam - x1 - x2) % p
        return (x3, (lam * (x1 - x3) - y1) % p)

    pts = [_py_mul((curve.gen_x, curve.gen_y), rng.randrange(1, 1 << 62))
           for _ in range(n)]
    scalars = [rng.randrange(curve.Fr.p) for _ in range(n)]
    t0 = time.time()
    host_msm(curve, scalars, pts)
    msm_pt_s = (time.time() - t0) / n
    from ..compat.bn254_pairing import G2_X, G2_Y, pairing_check
    g1 = (curve.gen_x, curve.gen_y)
    t0 = time.time()
    pairing_check([(g1, (G2_X, G2_Y)), (g1, (G2_X, G2_Y))])
    return {"msm_pt_s": msm_pt_s, "pairing_s": time.time() - t0}


def from_circuit_to_model_circuit(k: int, circuit: Circuit,
                                  scheme: str = "ipa") -> dict:
    """cost_model.rs:244 equivalent: structured dict for tooling."""
    cost = CircuitCost.measure(k, circuit)
    d = asdict(cost)
    d["scheme"] = scheme
    d["estimated_proof_size"] = cost.proof_size(scheme)
    return d
