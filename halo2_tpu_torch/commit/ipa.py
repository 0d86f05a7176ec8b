"""IPA commitments over the Pasta curves (port of the JAX reference's
commit/ipa.py; halo2_backend/src/poly/ipa/*).

`ParamsIPA` holds the generators g, their Lagrange form and the host
points w (blinding base) and u on one device.  The generators come from the
pasta_curves-compatible hash_to_curve("Halo2-Parameters")
(ipa/commitment.rs:156-214), so they equal the reference's point for
point.  Full-length commitments go through the params' engine (cached
fixed-base descriptors, kernel D).  The blinding term [blind] w is one
python-int scalar multiplication on the host, added on the device: the
reference runs it as a one-point device MSM, which on the card is a chain
of 256 steps of launches (`naive_msm`); chip_smoke.py times both and the
host's share of an IPA prove.  The opening argument runs its 2k
variable-base MSMs on the device (`msm.msm`: the segmented-scan kernel
above 32 points), each with the round's u and w terms appended, and the
verifier's accumulator (`MSMIPA`) stays on the host until its dense
g-scalars meet the cached descriptor of g.
"""

from __future__ import annotations

import os
import random
import struct
import tempfile
from dataclasses import dataclass
from typing import List, Optional

import torch

from .._build import resolve_device
from ..curves.curve import Curve
from ..curves.hash_to_curve import hash_to_curve
from ..curves.iso_constants import PALLAS_ISO, VESTA_ISO
from ..curves.point_ntt import g_to_lagrange
from ..engine import PlonkEngine
from ..msm.host_msm import host_msm
from ..msm.msm import msm
from ..ntt import powers
from ..poly.arith import eval_polynomial_int, eval_polys_at_points, tree_sum
from ..poly.poly import COEFF, LAGRANGE, unwrap
from .base import Blind

_ISO = {"pasta::Vesta": VESTA_ISO, "pasta::Pallas": PALLAS_ISO}


def params_cache_path(curve: Curve, k: int) -> str:
    """`<cache>/params/ipa-v2-<curve>-<k>.bin`, the reference's file name;
    <cache> is $HALO2_TPU_CACHE, as in the reference, or else
    ~/.cache/halo2_tpu_torch."""
    cache = os.environ.get("HALO2_TPU_CACHE") or os.path.expanduser(
        "~/.cache/halo2_tpu_torch")
    return os.path.join(cache, "params", f"ipa-v2-"
                        f"{curve.name.replace(':', '_')}-{k}.bin")


class ParamsIPA:
    """k, n, g (coefficient-basis generators), g_lagrange, w, u."""

    def __init__(self, curve: Curve, k: int, g, g_lagrange, w_aff, u_aff):
        """g, g_lagrange: (2^k, 3, 8) point tensors on the params' device;
        w_aff, u_aff: affine host int pairs."""
        self.curve = curve
        self.k = k
        self.n = 1 << k
        self.g = g
        self.g_lagrange = g_lagrange
        self.device = g.device
        self.w_aff = w_aff
        self.u_aff = u_aff
        self.engine = PlonkEngine()
        self._g_aff = None
        self._g_lagrange_aff = None

    @property
    def g_aff(self) -> List:
        if self._g_aff is None:
            self._g_aff = self.curve.to_affine_ints(self.g)
        return self._g_aff

    @property
    def g_lagrange_aff(self) -> List:
        if self._g_lagrange_aff is None:
            self._g_lagrange_aff = self.curve.to_affine_ints(self.g_lagrange)
        return self._g_lagrange_aff

    @staticmethod
    def new(curve: Curve, k: int, device="cuda") -> "ParamsIPA":
        """The reference's parameters (ipa/commitment.rs:156-214): g[i] =
        H([0, i as u32 le]), w = H([1]), u = H([2]) on the host, and
        g_lagrange by the inverse point NTT on `device`.  Cached on disk
        as the reference caches them: `params_cache_path(curve, k)` is
        read when it exists and written when it does not."""
        device = resolve_device(device)
        if curve.name not in _ISO:
            raise ValueError(f"no hash-to-curve suite for {curve.name}")
        path = params_cache_path(curve, k)
        if os.path.exists(path):
            with open(path, "rb") as f:
                return ParamsIPA.read(curve, f.read(), device)
        params = ParamsIPA._generate(curve, k, device)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # write then rename, so that a concurrent reader never sees part
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        with os.fdopen(fd, "wb") as f:
            f.write(params.write())
        os.replace(tmp, path)
        return params

    @staticmethod
    def _generate(curve: Curve, k: int, device) -> "ParamsIPA":
        hasher = hash_to_curve(_ISO[curve.name], "Halo2-Parameters")
        g_aff = [hasher(b"\x00" + i.to_bytes(4, "little"))
                 for i in range(1 << k)]
        g = curve.from_affine_ints(g_aff, device)
        gl = g_to_lagrange(curve, g, k)
        params = ParamsIPA(curve, k, g, curve.from_affine_coords(
            curve.batch_normalize(gl), curve.is_identity(gl)),
            hasher(b"\x01"), hasher(b"\x02"))
        params._g_aff = g_aff
        return params

    # -- serde (poly/ipa/commitment.rs:107-144 layout) ------------------

    def write(self) -> bytes:
        out = bytearray(struct.pack("<I", self.k))
        for pt in self.g_aff + self.g_lagrange_aff + [self.w_aff,
                                                      self.u_aff]:
            out += self.curve.point_to_bytes(pt)
        return bytes(out)

    @staticmethod
    def read(curve: Curve, data: bytes, device="cuda") -> "ParamsIPA":
        device = resolve_device(device)
        k = struct.unpack("<I", data[:4])[0]
        n = 1 << k
        pts = [curve.point_from_bytes(data[4 + 32 * i: 36 + 32 * i])
               for i in range(2 * n + 2)]
        return ParamsIPA(curve, k, curve.from_affine_ints(pts[:n], device),
                         curve.from_affine_ints(pts[n:2 * n], device),
                         pts[2 * n], pts[2 * n + 1])

    # -- commitments: <poly, bases> + [blind] w -------------------------

    def set_engine(self, engine):
        self.engine = engine

    def _msm_cached(self, coeffs, bases):
        backend = self.engine.msm_backend
        return backend.msm_with_cached_base(
            self.curve, coeffs, backend.get_base_descriptor(self.curve, bases))

    def _commit_with(self, bases, poly, blind: Blind):
        n = poly.shape[0]
        acc = self._msm_cached(poly, bases) if n == self.n else \
            msm(self.curve, poly, bases[:n])
        wterm = host_msm(self.curve, [blind.value], [self.w_aff])
        return self.curve.add(acc, self.curve.from_affine_ints(
            [wterm], self.device)[0])

    def commit(self, poly, blind: Blind):
        return self._commit_with(self.g, unwrap(poly, COEFF,
                                                "ParamsIPA.commit"), blind)

    def commit_lagrange(self, values, blind: Blind):
        return self._commit_with(
            self.g_lagrange,
            unwrap(values, LAGRANGE, "ParamsIPA.commit_lagrange"), blind)

    def commit_affine(self, poly, blind: Blind):
        return self.curve.to_affine_ints(self.commit(poly, blind)[None])[0]

    def commit_affine_lagrange(self, values, blind: Blind):
        return self.curve.to_affine_ints(
            self.commit_lagrange(values, blind)[None])[0]

    def empty_msm(self) -> "MSMIPA":
        return MSMIPA(self)


class MSMIPA:
    """Deferred MSM accumulator (poly/ipa/msm.rs): dense g-scalars, sparse
    (scalar, point) terms and the w / u scalars, on the host until
    `check`."""

    def __init__(self, params: ParamsIPA):
        self.params = params
        self.terms = []          # [(int scalar, (x, y) affine ints)]
        self.g_scalars = None    # [int] of length n, or None
        self.w_scalar = None
        self.u_scalar = None

    def clone(self) -> "MSMIPA":
        m = MSMIPA(self.params)
        m.terms = list(self.terms)
        m.g_scalars = list(self.g_scalars) if self.g_scalars else None
        m.w_scalar = self.w_scalar
        m.u_scalar = self.u_scalar
        return m

    def append_term(self, scalar: int, point):
        if point is not None:
            self.terms.append((scalar % self.params.curve.Fr.p, point))

    def add_constant_term(self, c: int):
        """Adds [c] g[0] (ipa/msm.rs add_constant_term)."""
        if self.g_scalars is None:
            self.g_scalars = [0] * self.params.n
        self.g_scalars[0] = (self.g_scalars[0] + c) % self.params.curve.Fr.p

    def add_to_g_scalars(self, scalars):
        p = self.params.curve.Fr.p
        if self.g_scalars is None:
            self.g_scalars = [0] * self.params.n
        for i, s in enumerate(scalars):
            self.g_scalars[i] = (self.g_scalars[i] + s) % p

    def add_to_w_scalar(self, s: int):
        self.w_scalar = ((self.w_scalar or 0) + s) % self.params.curve.Fr.p

    def add_to_u_scalar(self, s: int):
        self.u_scalar = ((self.u_scalar or 0) + s) % self.params.curve.Fr.p

    def scale(self, factor: int):
        p = self.params.curve.Fr.p
        self.terms = [((s * factor) % p, pt) for s, pt in self.terms]
        if self.g_scalars:
            self.g_scalars = [(s * factor) % p for s in self.g_scalars]
        if self.w_scalar is not None:
            self.w_scalar = (self.w_scalar * factor) % p
        if self.u_scalar is not None:
            self.u_scalar = (self.u_scalar * factor) % p

    def add_msm(self, other: "MSMIPA"):
        self.terms.extend(other.terms)
        if other.g_scalars:
            self.add_to_g_scalars(other.g_scalars)
        if other.w_scalar is not None:
            self.add_to_w_scalar(other.w_scalar)
        if other.u_scalar is not None:
            self.add_to_u_scalar(other.u_scalar)

    def _sparse_affine(self):
        """The sparse terms plus w / u, summed on the host (tens of
        terms)."""
        scalars = [s for s, _ in self.terms]
        pts = [pt for _, pt in self.terms]
        if self.w_scalar is not None:
            scalars.append(self.w_scalar)
            pts.append(self.params.w_aff)
        if self.u_scalar is not None:
            scalars.append(self.u_scalar)
            pts.append(self.params.u_aff)
        return host_msm(self.params.curve, scalars, pts)

    def eval(self):
        """The accumulated point (3, 8) on the params' device."""
        params = self.params
        curve = params.curve
        sparse = curve.from_affine_ints([self._sparse_affine()],
                                        params.device)[0]
        if not self.g_scalars:
            return sparse
        dense = params._msm_cached(
            curve.Fr.encode_ints(self.g_scalars, params.device), params.g)
        return curve.add(dense, sparse)

    def check(self) -> bool:
        if not self.g_scalars:
            return self._sparse_affine() is None
        return bool(self.params.curve.is_identity(self.eval()))


# ----------------------------------------------------------------------
# opening argument (poly/ipa/commitment/{prover,verifier}.rs)
# ----------------------------------------------------------------------

def create_opening_proof(params: ParamsIPA, rng, transcript, p_poly,
                         p_blind: Blind, x3: int):
    """k-round IPA opening of the coefficients `p_poly` (n, 8) at x3."""
    curve = params.curve
    F = curve.Fr
    n, k, p = params.n, params.k, F.p
    dev = params.device

    # a random polynomial with a root at x3
    s_ints = [rng.randrange(p) for _ in range(n)]
    s_ints[0] = (s_ints[0] - eval_polynomial_int(p, s_ints, x3)) % p
    s_poly = F.encode_ints(s_ints, dev)
    s_blind = Blind(rng.randrange(p))
    transcript.write_point(params.commit_affine(s_poly, s_blind))
    xi = transcript.squeeze_challenge()
    z = transcript.squeeze_challenge()

    # P' = xi S + P, less its value at x3 in the constant term
    p_prime = F.add(F.mul(s_poly, F.encode_int(xi, dev)), p_poly)
    v = eval_polys_at_points(F, [(p_prime, x3)])[0]
    p_prime[0] = F.sub(p_prime[0], F.encode_int(v, dev))
    f = (s_blind.value * xi + p_blind.value) % p

    b = powers(F, F.encode_int(x3, dev), n)
    g_prime = params.g
    uw = curve.from_affine_ints([params.u_aff, params.w_aff], dev)
    for j in range(k):
        half = 1 << (k - j - 1)
        value_l, value_r = F.decode_ints(torch.stack([
            tree_sum(F, F.mul(p_prime[half:], b[:half])),
            tree_sum(F, F.mul(p_prime[:half], b[half:]))]))
        rand_l = rng.randrange(p)
        rand_r = rng.randrange(p)
        # L = <p'_hi, g'_lo> + [value_l z] u + [rand_l] w, and R alike: the
        # reference's two device MSMs per side as one, with u, w appended
        extra_l = F.encode_ints([value_l * z % p, rand_l], dev)
        extra_r = F.encode_ints([value_r * z % p, rand_r], dev)
        lr = torch.stack([
            msm(curve, torch.cat([p_prime[half:], extra_l]),
                torch.cat([g_prime[:half], uw])),
            msm(curve, torch.cat([p_prime[:half], extra_r]),
                torch.cat([g_prime[half:], uw]))])
        l_aff, r_aff = curve.to_affine_ints(lr)
        transcript.write_point(l_aff)
        transcript.write_point(r_aff)

        u_j = transcript.squeeze_challenge()
        u_j_inv = pow(u_j, p - 2, p)
        u_enc = F.encode_int(u_j, dev)
        p_prime = F.add(p_prime[:half],
                        F.mul(p_prime[half:], F.encode_int(u_j_inv, dev)))
        b = F.add(b[:half], F.mul(b[half:], u_enc))
        g_prime = curve.add(g_prime[:half],
                            curve.scalar_mul(g_prime[half:], u_enc))
        f = (f + rand_l * u_j_inv + rand_r * u_j) % p

    transcript.write_scalar(F.decode_int(p_prime[0]))
    transcript.write_scalar(f)


class GuardIPA:
    """Deferred verification state (poly/ipa/strategy.rs:19-71): the
    opening's challenges fold into the dense g-scalars when used."""

    def __init__(self, msm_acc: MSMIPA, neg_c: int, u: list):
        self.msm = msm_acc
        self.neg_c = neg_c
        self.u = u

    def use_challenges(self) -> MSMIPA:
        s = compute_s(self.msm.params.curve.Fr.p, self.u, self.neg_c)
        self.msm.add_to_g_scalars(s)
        return self.msm

    def use_g(self, g):
        """The caller supplies the purported G = <s, params.g>; returns the
        MSM with -c G added and the Accumulator a recursive verifier
        carries (strategy.rs:54-66)."""
        self.msm.append_term(self.neg_c, g)
        return self.msm, Accumulator(g=g, u_packed=list(self.u))

    def compute_g(self):
        """G = <s, params.g> (strategy.rs:68-71): a 2^k variable-base MSM
        on the params' device (kernel 9 on the card), as an affine point."""
        params = self.msm.params
        curve = params.curve
        s = compute_s(curve.Fr.p, self.u, 1)
        g = msm(curve, curve.Fr.encode_ints(s, params.device), params.g)
        return curve.to_affine_ints(g[None])[0]

    def use_g_with_computed(self):
        return self.use_g(self.compute_g())


@dataclass
class Accumulator:
    """An evaluation claim and its packed challenges, for the recursion
    path (strategy.rs:27-36)."""
    g: object
    u_packed: list


def verify_opening_proof(params: ParamsIPA, msm_acc: MSMIPA, transcript,
                         x: int, v: int) -> GuardIPA:
    """ipa/commitment/verifier.rs:13-89."""
    p = params.curve.Fr.p
    msm_acc.add_constant_term((-v) % p)
    s_comm = transcript.read_point()
    xi = transcript.squeeze_challenge()
    msm_acc.append_term(xi, s_comm)
    z = transcript.squeeze_challenge()

    rounds = []
    for _ in range(params.k):
        l_pt = transcript.read_point()
        r_pt = transcript.read_point()
        rounds.append((l_pt, r_pt, transcript.squeeze_challenge()))
    u = []
    for l_pt, r_pt, u_j in rounds:
        msm_acc.append_term(pow(u_j, p - 2, p), l_pt)
        msm_acc.append_term(u_j, r_pt)
        u.append(u_j)

    neg_c = (-transcript.read_scalar()) % p
    f = transcript.read_scalar()
    b = compute_b(p, x, u)
    msm_acc.add_to_u_scalar((neg_c * b * z) % p)
    msm_acc.add_to_w_scalar((-f) % p)
    return GuardIPA(msm_acc, neg_c, u)


def compute_b(p: int, x: int, u: list) -> int:
    """prod_i (1 + u_{k-1-i} x^{2^i}) (verifier.rs:92-100)."""
    tmp, cur = 1, x
    for u_j in reversed(u):
        tmp = (tmp * (1 + u_j * cur)) % p
        cur = (cur * cur) % p
    return tmp


def compute_s(p: int, u: list, init: int) -> list:
    """Coefficients of g(X) = prod_i (1 + u_{k-1-i} X^{2^i}), scaled by
    init (strategy.rs:157-172)."""
    v = [0] * (1 << len(u))
    v[0] = init % p
    length = 1
    for u_j in reversed(u):
        for i in range(length):
            v[length + i] = (v[i] * u_j) % p
        length *= 2
    return v


# ----------------------------------------------------------------------
# verification strategies (poly/ipa/strategy.rs:75-154)
# ----------------------------------------------------------------------

class SingleStrategyIPA:
    def __init__(self, params: ParamsIPA):
        self.params = params

    def process(self, f) -> bool:
        return f(self.params.empty_msm()).use_challenges().check()


class AccumulatorStrategyIPA:
    """Folds several proofs into one MSM under random scalings; one check
    at the end."""

    def __init__(self, params: ParamsIPA, rng: Optional[random.Random] = None):
        self.params = params
        self.msm = params.empty_msm()
        self.rng = rng or random.SystemRandom()

    def process(self, f):
        self.msm.scale(self.rng.randrange(1, self.params.curve.Fr.p))
        self.msm = f(self.msm).use_challenges()
        return self

    def finalize(self) -> bool:
        return self.msm.check()
