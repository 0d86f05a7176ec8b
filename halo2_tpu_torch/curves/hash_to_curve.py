"""hash_to_curve("...") for the Pasta curves — pasta_curves-compatible.

The IPA parameter generators are drawn from
`C::CurveExt::hash_to_curve("Halo2-Parameters")`
(halo2_backend/src/poly/ipa/commitment.rs:156-214).  pasta_curves implements
the IETF hash-to-curve construction with:

  * expand_message_xmd over BLAKE2b-512 (block size 128, chunk 64),
    DST = domain_prefix || "-" || curve_id || "_XMD:BLAKE2b_SSWU_RO_"
  * two field elements per message, each reduced from a byte-reversed
    64-byte chunk via from_uniform_bytes (i.e. big-endian interpretation)
  * simplified SWU onto a 3-isogenous curve E_iso: y^2 = x^3 + a*x + b
    with Z the SSWU non-square, sign normalized to sgn0(u) = is_odd
  * the two mapped points are ADDED ON THE ISO CURVE, then a single
    degree-3 isogeny (13-constant rational map) lands on the target curve

The iso-curve and isogeny constants are re-derived from first principles
(Velu's formulas over the published pasta moduli) in tools/derive_iso.py and
pinned in iso_constants.py; the derivation is validated end-to-end against
the reference's golden pinned-vk commitments (tests/test_pinned_vk.py).

Everything here is host-side python-int math: parameter generation is a
one-time, disk-cached setup step (ParamsIPA.new), not a prover hot path.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, List, Tuple


# ----------------------------------------------------------------------
# generic short-Weierstrass host arithmetic (y^2 = x^3 + a x + b over F_p)
# ----------------------------------------------------------------------

def ec_add(p: int, a: int, P, Q):
    """Affine add; None is the identity."""
    if P is None:
        return Q
    if Q is None:
        return P
    x1, y1 = P
    x2, y2 = Q
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = (3 * x1 * x1 + a) * pow(2 * y1, p - 2, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, p - 2, p) % p
    x3 = (lam * lam - x1 - x2) % p
    y3 = (lam * (x1 - x3) - y1) % p
    return (x3, y3)


def ec_mul(p: int, a: int, P, k: int):
    acc = None
    while k:
        if k & 1:
            acc = ec_add(p, a, acc, P)
        P = ec_add(p, a, P, P)
        k >>= 1
    return acc


def is_on_curve(p: int, a: int, b: int, P) -> bool:
    if P is None:
        return True
    x, y = P
    return (y * y - (x * x * x + a * x + b)) % p == 0


# ----------------------------------------------------------------------
# field helpers
# ----------------------------------------------------------------------

def _sqrt(p: int, a: int):
    """Tonelli-Shanks; returns a root or None."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    t = p - 1
    s = 0
    while t % 2 == 0:
        t //= 2
        s += 1
    if s == 1:
        return pow(a, (p + 1) // 4, p)
    # find a non-residue
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    c = pow(z, t, p)
    m, t_, r = s, pow(a, t, p), pow(a, (t + 1) // 2, p)
    while t_ != 1:
        i, tmp = 0, t_
        while tmp != 1:
            tmp = tmp * tmp % p
            i += 1
        bexp = pow(c, 1 << (m - i - 1), p)
        m, c = i, bexp * bexp % p
        t_ = t_ * c % p
        r = r * bexp % p
    return r


def _sqrt_ratio(p: int, root_of_unity: int, num: int, div: int):
    """ff::Field::sqrt_ratio semantics: (is_square, y) with
    y^2 = num/div when square, else y^2 = ROOT_OF_UNITY * num/div."""
    num %= p
    div %= p
    if num == 0:
        return True, 0
    ratio = num * pow(div, p - 2, p) % p
    r = _sqrt(p, ratio)
    if r is not None:
        return True, r
    r = _sqrt(p, root_of_unity * ratio % p)
    assert r is not None
    return False, r


# ----------------------------------------------------------------------
# expand_message_xmd with BLAKE2b-512 (pasta_curves hash_to_field)
# ----------------------------------------------------------------------

def hash_to_field(curve_id: str, domain_prefix: str, message: bytes,
                  p: int) -> Tuple[int, int]:
    """Two field elements from expand_message_xmd/BLAKE2b, each chunk
    interpreted big-endian and reduced mod p (pasta hash_to_field)."""
    CHUNK = 64
    R_IN_BYTES = 128  # BLAKE2b block size (Z_pad length)
    dst = (domain_prefix.encode() + b"-" + curve_id.encode()
           + b"_XMD:BLAKE2b_SSWU_RO_")
    assert len(dst) < 256
    dst_prime = dst + bytes([len(dst)])

    def H(data: bytes) -> bytes:
        return hashlib.blake2b(data, digest_size=CHUNK).digest()

    b0 = H(b"\x00" * R_IN_BYTES + message
           + bytes([0, CHUNK * 2]) + b"\x00" + dst_prime)
    b1 = H(b0 + b"\x01" + dst_prime)
    b2 = H(bytes(x ^ y for x, y in zip(b0, b1)) + b"\x02" + dst_prime)
    # byte-reverse + from_uniform_bytes(LE) == big-endian interpretation
    return (int.from_bytes(b1, "big") % p, int.from_bytes(b2, "big") % p)


# ----------------------------------------------------------------------
# simplified SWU + 3-isogeny
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class IsoSpec:
    """Everything defining hash_to_curve for one target curve."""
    curve_id: str       # "pallas" / "vesta"
    p: int              # base field modulus
    b: int              # target curve: y^2 = x^3 + b
    iso_a: int          # iso curve a
    iso_b: int          # iso curve b
    z: int              # SSWU non-square
    root_of_unity: int  # 2^S root of unity for sqrt_ratio
    theta: int          # sqrt(Z / ROOT_OF_UNITY)
    isogeny: Tuple[int, ...]  # 13 constants


def map_to_curve_simple_swu(spec: IsoSpec, u: int):
    """SSWU onto the iso curve, Jacobian output (X, Y, Z_coord).
    Mirrors pasta_curves map_to_curve_simple_swu including the final
    sgn0(y) == sgn0(u) normalization (sgn0 = is_odd)."""
    p = spec.p
    a, b, z = spec.iso_a, spec.iso_b, spec.z
    z_u2 = z * u * u % p
    ta = (z_u2 * z_u2 + z_u2) % p
    num_x1 = b * (ta + 1) % p
    div = a * (z if ta == 0 else (p - ta)) % p
    num2_x1 = num_x1 * num_x1 % p
    div2 = div * div % p
    div3 = div2 * div % p
    num_gx1 = ((num2_x1 + a * div2) * num_x1 + b * div3) % p
    num_x2 = z_u2 * num_x1 % p

    gx1_square, y1 = _sqrt_ratio(p, spec.root_of_unity, num_gx1, div3)
    y2 = spec.theta * z_u2 % p * u % p * y1 % p

    num_x = num_x1 if gx1_square else num_x2
    y = y1 if gx1_square else y2
    if (y & 1) != (u & 1):
        y = (p - y) % p
    return (num_x * div % p, y * div3 % p, div)


def iso_map(spec: IsoSpec, jac):
    """Degree-3 isogeny, Jacobian in/out (pasta iso_map shape):
      x -> (c0 x^3 + c1 x^2 + c2 x + c3) / (x^2 + c4 x + c5)
      y -> y (c6 x^3 + c7 x^2 + c8 x + c9) / (x^3 + c10 x^2 + c11 x + c12)
    """
    p = spec.p
    i = spec.isogeny
    x, y, zc = jac
    z2 = zc * zc % p
    z3 = z2 * zc % p
    z4 = z2 * z2 % p
    z6 = z3 * z3 % p
    num_x = ((i[0] * x + i[1] * z2) % p * x + i[2] * z4) % p * x % p
    num_x = (num_x + i[3] * z6) % p
    div_x = ((z2 * x + i[4] * z4) % p * x + i[5] * z6) % p
    num_y = (((i[6] * x + i[7] * z2) % p * x + i[8] * z4) % p * x
             + i[9] * z6) % p * y % p
    div_y = (((x + i[10] * z2) % p * x + i[11] * z4) % p * x
             + i[12] * z6) % p * z3 % p
    zo = div_x * div_y % p
    xo = num_x * div_y % p * zo % p
    yo = num_y * div_x % p * zo % p * zo % p
    return (xo, yo, zo)


def _jac_to_affine(p: int, jac):
    x, y, z = jac
    if z % p == 0:
        return None
    zi = pow(z, p - 2, p)
    zi2 = zi * zi % p
    return (x * zi2 % p, y * zi2 % p * zi % p)


def hash_to_curve(spec: IsoSpec, domain_prefix: str) -> Callable:
    """Returns message -> affine (x, y) point on the target curve,
    byte-identical to pasta_curves' hash_to_curve."""

    def hasher(message: bytes):
        u0, u1 = hash_to_field(spec.curve_id, domain_prefix, message, spec.p)
        q0 = _jac_to_affine(spec.p, map_to_curve_simple_swu(spec, u0))
        q1 = _jac_to_affine(spec.p, map_to_curve_simple_swu(spec, u1))
        # sum on the ISO curve, then one isogeny application
        r = ec_add(spec.p, spec.iso_a, q0, q1)
        if r is None:
            return None
        pt = _jac_to_affine(spec.p, iso_map(spec, (r[0], r[1], 1)))
        assert pt is not None and is_on_curve(spec.p, 0, spec.b, pt)
        return pt

    return hasher


def theta_for(p: int, root_of_unity: int, z: int) -> int:
    """theta = sqrt(Z / ROOT_OF_UNITY); sign is irrelevant because SSWU
    normalizes sgn0(y) afterwards."""
    r = _sqrt(p, z * pow(root_of_unity, p - 2, p) % p)
    assert r is not None
    return r
