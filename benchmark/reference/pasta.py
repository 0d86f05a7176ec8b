"""Vesta (y^2 = x^3 + 5 over the Pasta field Fq, of order Fp) and its
parameters' generators: halo2's IPA takes g_i = H([0, i as u32 le]),
w = H([1]), u = H([2]) with H = hash_to_curve("Halo2-Parameters")
(ipa/commitment.rs), the IETF construction as pasta_curves implements it:
expand_message_xmd over BLAKE2b-512, two field elements read big-endian,
simplified SWU onto the 3-isogenous curve y^2 = x^3 + A x + 1265, the two
points added there, then the isogeny.  The isogeny's constants are
pasta_curves' for Vesta."""

from __future__ import annotations

import hashlib

from .curve import Curve, ScalarField, inv, sqrt

FP = ScalarField(
    0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001, 5)
FQ = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001
VESTA = Curve(FQ, 5, (FQ - 1, 2), FP)

_ISO_A = 0x267f9b2ee592271a81639c4d96f787739673928c7d01b212c515ad7242eaa6b1
_ISO_B = 1265
_Z = FQ - 13
_ROOT = 0x2de6a9b8746d3f589e5c4dfd492ae26e9bb97ea3c106f049a70e2c1102b6d05f
_THETA = 0x2b3483a1ee9a382f53c3808d9e2f235738578ccadf03ac27632cae9872df1b5d
_ISOGENY = (
    0x38e38e38e38e38e38e38e38e38e38e390205dd51cfa0961a43cd42c800000001,
    0x1d935247b4473d17acecf10f5f7c09a2216b8861ec72bd5d8b95c6aaf703bcc5,
    0x18760c7f7a9ad20ded7ee4a9cdf78f8fd59d03d23b39cb11aeac67bbeb586a3d,
    0x31c71c71c71c71c71c71c71c71c71c71e1c521a795ac8356fb539a6f0000002b,
    0x0a2de485568125d51454798a5b5c56b2a3ad678129b604d3b7284f7eaf21a2e9,
    0x14735171ee5427780c621de8b91c242a30cd6d53df49d235f169c187d2533465,
    0x12f684bda12f684bda12f684bda12f685601f4709a8adcb36bef1642aaaaaaab,
    0x2ec9a923da239e8bd6767887afbe04d121d910aefb03b31d8bee58e5fb81de63,
    0x19b0d87e16e2578866d1466e9de10e6497a3ca5c24e9ea634986913ab4443034,
    0x1ed097b425ed097b425ed097b425ed098bc32d36fb21a6a38f64842c55555533,
    0x2f44d6c801c1b8bf9e7eb64f890a820c06a767bfc35b5bac58dfecce86b2745e,
    0x3d59f455cafc7668252659ba2b546c7e926847fb9ddd76a1d43d449776f99d2f,
    0x40000000000000000000000000000000224698fc0994a8dd8c46eb20fffffde5,
)


def _hash_to_field(message: bytes, prefix: str):
    """Two elements of Fq from expand_message_xmd over BLAKE2b-512."""
    dst = prefix.encode() + b"-vesta_XMD:BLAKE2b_SSWU_RO_"
    dst_prime = dst + bytes([len(dst)])

    def h(data):
        return hashlib.blake2b(data, digest_size=64).digest()

    b0 = h(bytes(128) + message + bytes([0, 128]) + b"\x00" + dst_prime)
    b1 = h(b0 + b"\x01" + dst_prime)
    b2 = h(bytes(x ^ y for x, y in zip(b0, b1)) + b"\x02" + dst_prime)
    return int.from_bytes(b1, "big") % FQ, int.from_bytes(b2, "big") % FQ


def _sqrt_ratio(num: int, div: int):
    """(num/div is a square, a root of it, or else of ROOT num/div)."""
    if num % FQ == 0:
        return True, 0
    ratio = num * inv(div, FQ) % FQ
    y = sqrt(ratio, FQ)
    if y is not None:
        return True, y
    return False, sqrt(_ROOT * ratio % FQ, FQ)


def _sswu(u: int):
    """Simplified SWU onto the iso curve, Jacobian (X, Y, Z), sgn0(y) =
    sgn0(u)."""
    p = FQ
    z_u2 = _Z * u * u % p
    ta = (z_u2 * z_u2 + z_u2) % p
    num_x1 = _ISO_B * (ta + 1) % p
    div = _ISO_A * (_Z if ta == 0 else p - ta) % p
    div2 = div * div % p
    div3 = div2 * div % p
    num_gx1 = ((num_x1 * num_x1 + _ISO_A * div2) * num_x1
               + _ISO_B * div3) % p
    square, y1 = _sqrt_ratio(num_gx1, div3)
    num_x = num_x1 if square else z_u2 * num_x1 % p
    y = y1 if square else _THETA * z_u2 % p * u % p * y1 % p
    if (y & 1) != (u & 1):
        y = (p - y) % p
    return num_x * div % p, y * div3 % p, div


def _affine(p, jac):
    x, y, z = jac
    zi = inv(z, p)
    return x * zi * zi % p, y * zi * zi * zi % p


def _iso_add(a, b):
    """Affine addition on the iso curve (a != +-b for hash outputs)."""
    p = FQ
    (x1, y1), (x2, y2) = a, b
    if x1 == x2:
        lam = (3 * x1 * x1 + _ISO_A) * inv(2 * y1, p) % p
    else:
        lam = (y2 - y1) * inv(x2 - x1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    return x3, (lam * (x1 - x3) - y1) % p


def _iso_map(x: int, y: int):
    """The degree-3 isogeny to Vesta, on an affine point."""
    p, c = FQ, _ISOGENY
    num_x = ((c[0] * x + c[1]) * x + c[2]) * x + c[3]
    div_x = (x + c[4]) * x + c[5]
    num_y = (((c[6] * x + c[7]) * x + c[8]) * x + c[9]) * y
    div_y = ((x + c[10]) * x + c[11]) * x + c[12]
    return num_x * inv(div_x, p) % p, num_y * inv(div_y, p) % p


def hash_to_curve(message: bytes, prefix: str = "Halo2-Parameters"):
    u0, u1 = _hash_to_field(message, prefix)
    pt = _iso_map(*_iso_add(_affine(FQ, _sswu(u0)), _affine(FQ, _sswu(u1))))
    if not VESTA.on_curve(pt):
        raise ValueError("hash_to_curve left the curve")
    return pt


def generators(k: int):
    """(g_0 .. g_{2^k - 1}, w, u) of halo2's IPA parameters."""
    g = [hash_to_curve(b"\x00" + i.to_bytes(4, "little"))
         for i in range(1 << k)]
    return g, hash_to_curve(b"\x01"), hash_to_curve(b"\x02")
