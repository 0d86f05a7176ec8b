"""KZG commitments on BN254 (port of the JAX reference's commit/kzg.py).

`ParamsKZG` holds [s^i]G1 and the Lagrange-basis bases on one device;
commitments of full-length polynomials go through its engine's cached
fixed-base descriptors (by default `GpuMsmEngine`, kernel D or 8).  MSMKZG /
DualMSM are host-side accumulators for the verifier, whose MSMs have tens
of terms and run on the host.

Locally generated params keep the toxic scalar s, and DualMSM checks the
equivalent G1 identity s * left == right (insecure, test use only, as the
reference marks `setup`); params without s use the real pairing.
"""

from __future__ import annotations

import random
import struct
from typing import List, Optional

import torch

from .._build import resolve_device
from ..compat import bn254_pairing as bn
from ..curves import BN254_G1
from ..curves.point_ntt import g_to_lagrange
from ..engine import PlonkEngine
from ..msm.host_msm import host_msm
from ..msm.msm import msm
from ..poly.poly import COEFF, LAGRANGE, unwrap
from .base import Blind

DEFAULT_S = 3141592653589793      # the reference's ParamsKZG.new default


class ParamsKZG:
    def __init__(self, k: int, g, g_lagrange, g2, s_g2,
                 s_secret: Optional[int] = None):
        """g, g_lagrange: (2^k, 3, 8) point tensors on the params' device;
        g2, s_g2: G2 points as ((x0, x1), (y0, y1)) ints."""
        self.curve = BN254_G1
        self.k = k
        self.n = 1 << k
        self.g = g
        self.g_lagrange = g_lagrange
        self.device = g.device
        self.g2 = g2
        self.s_g2 = s_g2
        self.s_secret = s_secret
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
    def setup(k: int, s: Optional[int] = None, rng=None,
              device="cuda") -> "ParamsKZG":
        """Insecure trusted setup (kzg/commitment.rs:64-131) on `device`."""
        device = resolve_device(device)
        curve = BN254_G1
        F = curve.Fr
        p = F.p
        n = 1 << k
        if s is None:
            s = (rng or random.SystemRandom()).randrange(1, p)
        powers_s = [1] * n
        for i in range(1, n):
            powers_s[i] = powers_s[i - 1] * s % p
        # L_i(s) = (s^n - 1) / n * omega^i / (s - omega^i)
        root = pow(F.root_of_unity, 1 << (F.S - k), p)
        multiplier = (pow(s, n, p) - 1) * pow(n, p - 2, p) % p
        root_pows = [1] * n
        for i in range(1, n):
            root_pows[i] = root_pows[i - 1] * root % p
        denoms = [(s - rp) % p for rp in root_pows]
        prefix = [1] * (n + 1)
        for i, d in enumerate(denoms):
            prefix[i + 1] = prefix[i] * d % p
        acc = pow(prefix[n], p - 2, p)
        inv = [0] * n
        for i in range(n - 1, -1, -1):
            inv[i] = acc * prefix[i] % p
            acc = acc * denoms[i] % p
        lag = [multiplier * root_pows[i] % p * inv[i] % p for i in range(n)]

        def affine_points(scalars):
            proj = curve.generator_mul(F.encode_ints(scalars, device))
            return curve.from_affine_coords(curve.batch_normalize(proj),
                                            curve.is_identity(proj))

        g2 = bn.g2_to_ints(bn.g2_generator())
        s_g2 = bn.g2_to_ints(bn.g2_scalar_mul(bn.g2_generator(), s))
        return ParamsKZG(k, affine_points(powers_s), affine_points(lag), g2,
                         s_g2, s_secret=s)

    @staticmethod
    def new(k: int, s: Optional[int] = DEFAULT_S,
            device="cuda") -> "ParamsKZG":
        """Deterministic test params with the reference's default s, so both
        packages commit against one SRS (toxic s retained, insecure)."""
        return ParamsKZG.setup(k, s=s, device=device)

    def downsize(self, k: int) -> "ParamsKZG":
        """The params of a smaller domain (kzg/commitment.rs:291-299): the
        first 2^k monomial-basis points, and their Lagrange form by the
        inverse point NTT.  Returns new params; self is unchanged."""
        assert k <= self.k
        curve = self.curve
        g = self.g[: 1 << k]
        gl = g_to_lagrange(curve, g, k)
        return ParamsKZG(k, g, curve.from_affine_coords(
            curve.batch_normalize(gl), curve.is_identity(gl)),
            self.g2, self.s_g2, s_secret=self.s_secret)

    # -- serde (kzg/commitment.rs:167-267 layout; write() defaults to
    # RawBytes like the reference's ParamsProver::write at :320-322) -----

    def write(self, fmt=None) -> bytes:
        """[k: u32 LE] g ‖ g_lagrange ‖ g2 ‖ s_g2; the 2^(k+1) points in
        one device pass."""
        from ..compat.serde import SerdeFormat, _write_g2, points_to_bytes
        fmt = fmt or SerdeFormat.RAW_BYTES
        return b"".join([
            struct.pack("<I", self.k),
            points_to_bytes(self.curve, torch.cat([self.g, self.g_lagrange]),
                            fmt),
            _write_g2(self.g2, fmt), _write_g2(self.s_g2, fmt)])

    @staticmethod
    def read(data: bytes, fmt=None, s_secret=None,
             device="cuda") -> "ParamsKZG":
        """The inverse of `write`, onto `device`; a RAW_BYTES read checks
        every point's range and curve equation in one batched pass."""
        from ..compat.serde import SerdeFormat, _read_g2, points_from_bytes
        device = resolve_device(device)
        fmt = fmt or SerdeFormat.RAW_BYTES
        k = struct.unpack("<I", data[:4])[0]
        n = 1 << k
        pts, off = points_from_bytes(BN254_G1, data, 4, 2 * n, fmt, device)
        g2, off = _read_g2(data, off, fmt)
        s_g2, off = _read_g2(data, off, fmt)
        return ParamsKZG(k, pts[:n], pts[n:], g2, s_g2, s_secret=s_secret)

    # -- commitments (the blind is unused: KZG hides with the random poly)

    def set_engine(self, engine):
        self.engine = engine

    def _msm_cached(self, coeffs, bases):
        """MSM of full-length coeffs against one of the params' base
        tables, through the engine's descriptor for that table."""
        backend = self.engine.msm_backend
        return backend.msm_with_cached_base(
            self.curve, coeffs, backend.get_base_descriptor(self.curve, bases))

    def commit(self, poly, blind: Blind = None):
        poly = unwrap(poly, COEFF, "ParamsKZG.commit")
        n = poly.shape[0]
        if n == self.n:
            return self._msm_cached(poly, self.g)
        return msm(self.curve, poly, self.g[:n])

    def commit_lagrange(self, values, blind: Blind = None):
        values = unwrap(values, LAGRANGE, "ParamsKZG.commit_lagrange")
        n = values.shape[0]
        if n == self.n:
            return self._msm_cached(values, self.g_lagrange)
        return msm(self.curve, values, self.g_lagrange[:n])

    def commit_affine(self, poly, blind: Blind = None):
        return self.curve.to_affine_ints(self.commit(poly)[None])[0]

    def commit_affine_lagrange(self, values, blind: Blind = None):
        return self.curve.to_affine_ints(
            self.commit_lagrange(values)[None])[0]

    def empty_msm(self) -> "MSMKZG":
        return MSMKZG(self)


class MSMKZG:
    """Host-side deferred MSM (kzg/msm.rs:14-92)."""

    def __init__(self, params: ParamsKZG):
        self.params = params
        self.scalars: List[int] = []
        self.bases: List = []

    def clone(self) -> "MSMKZG":
        m = MSMKZG(self.params)
        m.scalars = list(self.scalars)
        m.bases = list(self.bases)
        return m

    def append_term(self, scalar: int, point):
        self.scalars.append(scalar % self.params.curve.Fr.p)
        self.bases.append(point)

    def add_msm(self, other: "MSMKZG"):
        self.scalars.extend(other.scalars)
        self.bases.extend(other.bases)

    def scale(self, factor: int):
        p = self.params.curve.Fr.p
        self.scalars = [s * factor % p for s in self.scalars]

    def combine_with_base(self, base: int):
        """Horner folding of the scalars: the i-th of m times base^(m-1-i)
        (kzg/msm.rs:37-46)."""
        p = self.params.curve.Fr.p
        acc = 1
        for i in range(len(self.scalars) - 1, -1, -1):
            self.scalars[i] = self.scalars[i] * acc % p
            acc = acc * base % p

    def eval_affine(self):
        """Evaluate on the host: verifier MSMs have tens of terms."""
        terms = [(s, b) for s, b in zip(self.scalars, self.bases)
                 if b is not None]
        if not terms:
            return None
        return host_msm(self.params.curve, [s for s, _ in terms],
                                   [b for _, b in terms])


class PreMSM:
    """Collects (scalar, projective device point) terms so that all the
    points share one batched normalization and one host fetch
    (kzg/msm.rs:96-137).  Takes params or a curve; `to_msm` needs params."""

    def __init__(self, params_or_curve):
        self.params = params_or_curve
        self.curve = getattr(params_or_curve, "curve", params_or_curve)
        self.scalars: List[int] = []
        self.points = []

    def append_term(self, scalar: int, point_proj):
        self.scalars.append(scalar % self.curve.Fr.p)
        self.points.append(point_proj)

    def add_msm(self, other: "PreMSM"):
        self.scalars.extend(other.scalars)
        self.points.extend(other.points)

    def normalize(self) -> List:
        """Every collected point as affine ints (None for the identity)."""
        if not self.points:
            return []
        return self.curve.to_affine_ints(torch.stack(self.points, dim=0))

    def to_msm(self) -> MSMKZG:
        """The host MSM of the collected terms, the points normalized."""
        m = MSMKZG(self.params)
        m.scalars = list(self.scalars)
        m.bases = self.normalize()
        return m


class DualMSM:
    """Two-channel accumulator; the check is e(left, sG2) e(right, -G2) == 1
    (kzg/msm.rs:151-207)."""

    def __init__(self, params: ParamsKZG):
        self.params = params
        self.left = MSMKZG(params)
        self.right = MSMKZG(params)

    def scale(self, e: int):
        self.left.scale(e)
        self.right.scale(e)

    def add_msm(self, other: "DualMSM"):
        self.left.add_msm(other.left)
        self.right.add_msm(other.right)

    def check(self) -> bool:
        left = self.left.eval_affine()
        right = self.right.eval_affine()
        params = self.params
        if params.s_secret is not None:
            if left is None and right is None:
                return True
            curve = params.curve
            out = host_msm(curve, [params.s_secret, curve.Fr.p - 1],
                                      [left, right])
            return out is None
        return bn.pairing_check([
            (left, params.s_g2),
            (right, (params.g2[0], tuple((-y) % bn.Q for y in params.g2[1]))),
        ])


class GuardKZG:
    def __init__(self, msm: DualMSM):
        self.msm = msm


class SingleStrategyKZG:
    def __init__(self, params: ParamsKZG):
        self.params = params

    def process(self, f) -> bool:
        return f(DualMSM(self.params)).msm.check()


class AccumulatorStrategyKZG:
    """Folds several proofs into one DualMSM under random scalings; one
    check at the end (kzg/strategy.rs)."""

    def __init__(self, params: ParamsKZG, rng=None):
        self.params = params
        self.msm = DualMSM(params)
        self.rng = rng or random.SystemRandom()

    def process(self, f):
        self.msm.scale(self.rng.randrange(1, self.params.curve.Fr.p))
        self.msm = f(self.msm).msm
        return self

    def finalize(self) -> bool:
        return self.msm.check()
