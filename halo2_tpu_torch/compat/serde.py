"""Key serialization, byte-compatible with the reference layouts (port of
the JAX reference's compat/serde.py).

  vk   (plonk.rs:58-155):   [VERSION=0x04][k: u8][num_fixed: u32 LE]
                            [fixed commitments][permutation commitments]
  pk   (plonk.rs:297-376):  vk ‖ l0 ‖ l_last ‖ l_active_row
                            ‖ fixed_values ‖ fixed_polys ‖ fixed_cosets
                            ‖ permutation pk (permutations ‖ polys ‖ cosets)
  poly (poly.rs:170-198):   [len: u32 BE][elements]
  poly slice (helpers.rs:106-136): [count: u32 BE][polys]

Element encodings per SerdeFormat (helpers.rs:9-103):
  PROCESSED            compressed points (C::to_bytes) / canonical LE field
  RAW_BYTES            uncompressed Montgomery-form x‖y with range+curve
                       checks / Montgomery-form field with range check
  RAW_BYTES_UNCHECKED  same bytes, no checks

The port's Montgomery radix is 2^256, as the reference's and halo2curves',
so a RAW_BYTES element is its eight words as they are, and a PROCESSED one
the words of `F.from_mont` (kernel A).  Polynomials and parameter points
are (de)serialised as whole tensors: one device pass converts them, one
tensor compare range-checks them, and one batched y^2 = x^3 + b checks the
points of a RAW_BYTES read.  The verifying key's few commitments and the
G2 points are host ints, with the reference's codecs.

Like the reference's legacy `vk_read` / `pk_read`
(halo2_proofs/src/plonk.rs:45-86), reading recompiles the circuit to
recover the constraint system; the stored numerical data is trusted.
"""

from __future__ import annotations

import struct
from enum import Enum

import numpy as np
import torch

from ..fields.field import NWORDS

VERSION = 0x04   # plonk.rs:57
ELEM_BYTES = 4 * NWORDS


class SerdeFormat(Enum):
    """helpers.rs:9-21."""
    PROCESSED = 0
    RAW_BYTES = 1
    RAW_BYTES_UNCHECKED = 2


# ----------------------------------------------------------------------
# host point codecs (the verifying key's commitments)
# ----------------------------------------------------------------------

def _write_point(curve, pt, fmt: SerdeFormat) -> bytes:
    if fmt == SerdeFormat.PROCESSED:
        return curve.point_to_bytes(pt)
    # raw: uncompressed Montgomery x || y (identity = all zeros)
    Fq = curve.Fq
    if pt is None:
        return b"\x00" * 64
    x, y = pt
    return (Fq.to_mont_int(x).to_bytes(32, "little")
            + Fq.to_mont_int(y).to_bytes(32, "little"))


def _read_point(curve, data: bytes, off: int, fmt: SerdeFormat):
    if fmt == SerdeFormat.PROCESSED:
        return curve.point_from_bytes(data[off:off + 32]), off + 32
    Fq = curve.Fq
    xm = int.from_bytes(data[off:off + 32], "little")
    ym = int.from_bytes(data[off + 32:off + 64], "little")
    off += 64
    if xm == 0 and ym == 0:
        return None, off
    x, y = Fq.from_mont_int(xm), Fq.from_mont_int(ym)
    if fmt == SerdeFormat.RAW_BYTES:
        if xm >= Fq.p or ym >= Fq.p:
            raise ValueError("coordinate out of range")
        if (y * y - x * x * x - curve.b) % Fq.p != 0:
            raise ValueError("point not on curve")
    return (x, y), off


# ----------------------------------------------------------------------
# BN254 G2 codec (halo2curves new_curve_impl encoding over Fq2)
# ----------------------------------------------------------------------

_BN_Q = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
# G2: y^2 = x^3 + b2 with b2 = 3 / (9 + u)
_B2 = (19485874751759354771024239261021720505790618469301721065564631296452457478373,
       266929791119991161246907387137283842545076965332900288569378510910307636690)


def _fq2_mul(a, b):
    q = _BN_Q
    return ((a[0] * b[0] - a[1] * b[1]) % q, (a[0] * b[1] + a[1] * b[0]) % q)


def _fq2_add(a, b):
    q = _BN_Q
    return ((a[0] + b[0]) % q, (a[1] + b[1]) % q)


def _fq2_sqrt(a):
    """sqrt in Fq2 = Fq[u]/(u^2+1), q = 3 mod 4 (norm-based method)."""
    q = _BN_Q
    c0, c1 = a
    if c1 == 0:
        r = _fq_sqrt(c0)
        if r is not None:
            return (r, 0)
        r = _fq_sqrt((-c0) % q)
        return None if r is None else (0, r)
    norm = (c0 * c0 + c1 * c1) % q
    n = _fq_sqrt(norm)
    if n is None:
        return None
    inv2 = pow(2, q - 2, q)
    x0sq = (c0 + n) * inv2 % q
    x0 = _fq_sqrt(x0sq)
    if x0 is None:
        x0sq = (c0 - n) * inv2 % q
        x0 = _fq_sqrt(x0sq)
        if x0 is None:
            return None
    x1 = c1 * pow(2 * x0, q - 2, q) % q
    return (x0, x1)


def _fq_sqrt(a):
    q = _BN_Q
    a %= q
    if a == 0:
        return 0
    r = pow(a, (q + 1) // 4, q)  # q = 3 mod 4
    return r if r * r % q == a else None


def _g2_on_curve(pt):
    x, y = pt
    lhs = _fq2_mul(y, y)
    rhs = _fq2_add(_fq2_mul(_fq2_mul(x, x), x), _B2)
    return lhs == rhs


def g2_to_bytes(pt) -> bytes:
    """Compressed G2 (64 bytes): x.c0 LE ‖ x.c1 LE with sign(y.c0 odd) in
    the top bit of the last byte; identity all-zeros (halo2curves macro)."""
    if pt is None:
        return b"\x00" * 64
    (x0, x1), (y0, _y1) = pt
    buf = bytearray(x0.to_bytes(32, "little") + x1.to_bytes(32, "little"))
    if y0 & 1:
        buf[63] |= 0x80
    return bytes(buf)


def g2_from_bytes(b: bytes):
    buf = bytearray(b)
    sign = (buf[63] & 0x80) >> 7
    buf[63] &= 0x7F
    x0 = int.from_bytes(buf[:32], "little")
    x1 = int.from_bytes(buf[32:], "little")
    if x0 == 0 and x1 == 0 and not sign:
        return None
    q = _BN_Q
    if x0 >= q or x1 >= q:
        raise ValueError("invalid G2 x coordinate")
    y = _fq2_sqrt(_fq2_add(_fq2_mul(_fq2_mul((x0, x1), (x0, x1)), (x0, x1)),
                           _B2))
    if y is None:
        raise ValueError("G2 point not on curve")
    y0, y1 = y
    if (y0 & 1) != sign:
        y0, y1 = (q - y0) % q, (q - y1) % q
    return ((x0, x1), (y0, y1))


def _write_g2(pt, fmt: SerdeFormat) -> bytes:
    if fmt == SerdeFormat.PROCESSED:
        return g2_to_bytes(pt)
    # raw Montgomery x.c0 ‖ x.c1 ‖ y.c0 ‖ y.c1 (identity all zeros)
    if pt is None:
        return b"\x00" * 128
    R = 1 << 256
    out = bytearray()
    for v in (*pt[0], *pt[1]):
        out += (v * R % _BN_Q).to_bytes(32, "little")
    return bytes(out)


def _read_g2(data: bytes, off: int, fmt: SerdeFormat):
    if fmt == SerdeFormat.PROCESSED:
        return g2_from_bytes(data[off:off + 64]), off + 64
    q = _BN_Q
    Rinv = pow(1 << 256, q - 2, q)
    vals = []
    for i in range(4):
        raw = int.from_bytes(data[off + 32 * i: off + 32 * (i + 1)],
                             "little")
        if fmt == SerdeFormat.RAW_BYTES and raw >= q:
            raise ValueError("G2 coordinate out of range")
        vals.append(raw * Rinv % q)
    off += 128
    if all(v == 0 for v in vals):
        return None, off
    pt = ((vals[0], vals[1]), (vals[2], vals[3]))
    if fmt == SerdeFormat.RAW_BYTES and not _g2_on_curve(pt):
        raise ValueError("G2 point not on curve")
    return pt, off


# ----------------------------------------------------------------------
# tensor codecs: (..., 8) word tensors <-> 32-byte little-endian elements
# ----------------------------------------------------------------------

def _to_bytes(words: torch.Tensor) -> np.ndarray:
    """(..., 8) int32 words -> (..., 32) uint8 on the host."""
    return words.contiguous().cpu().numpy().view("<u4").view(np.uint8)


def _from_bytes(data, off: int, count: int, device) -> torch.Tensor:
    """`count` 32-byte elements at data[off:] -> (count, 8) int32 words on
    `device`."""
    arr = np.frombuffer(data, dtype="<i4", count=count * NWORDS, offset=off)
    return torch.from_numpy(arr.reshape(count, NWORDS).copy()).to(device)


def _not_below(F, w: torch.Tensor) -> torch.Tensor:
    """Which 256-bit words are >= p, as one compare: the sign of the
    highest differing word decides, and sum_i sign_i 2^i has that sign."""
    x = w.to(torch.int64) & 0xFFFFFFFF
    pw = torch.tensor([(F.p >> (32 * i)) & 0xFFFFFFFF for i in range(NWORDS)],
                      dtype=torch.int64, device=w.device)
    weight = torch.tensor([1 << i for i in range(NWORDS)], dtype=torch.int64,
                          device=w.device)
    return ((x - pw).sign() * weight).sum(-1) >= 0


def _reduce(F, w: torch.Tensor, where: torch.Tensor) -> torch.Tensor:
    """Words with the rows `where` (>= p) reduced mod p on the host: what
    an unchecked read keeps of an out-of-range element (the reference
    reduces it through its python ints)."""
    idx = where.nonzero().flatten()
    if idx.numel():
        vals = [v % F.p for v in F.words_to_ints(w[idx])]
        w = w.clone()
        w[idx] = torch.tensor(
            np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals),
                          dtype="<i4").reshape(-1, NWORDS).copy(),
            device=w.device)
    return w


def _felts_to_bytes(F, t: torch.Tensor, fmt: SerdeFormat) -> np.ndarray:
    """(..., 8) Montgomery elements -> (..., 32) uint8: their canonical
    values (PROCESSED, one from-Montgomery pass) or their words."""
    return _to_bytes(F.from_mont(t) if fmt == SerdeFormat.PROCESSED else t)


def _felts_from_bytes(F, data, off: int, count: int, fmt: SerdeFormat,
                     device) -> torch.Tensor:
    """`count` elements at data[off:] -> (count, 8) Montgomery words."""
    return _felts_from_words(F, _from_bytes(data, off, count, device), fmt)


def _felts_from_words(F, w: torch.Tensor, fmt: SerdeFormat) -> torch.Tensor:
    """Stored words -> Montgomery words: the range check, then the map to
    Montgomery form for PROCESSED."""
    high = _not_below(F, w)
    if fmt != SerdeFormat.RAW_BYTES_UNCHECKED:
        if bool(high.any()):
            raise ValueError("field element out of range")
    else:
        w = _reduce(F, w, high)
    return F.to_mont(w) if fmt == SerdeFormat.PROCESSED else w


def points_to_bytes(curve, P: torch.Tensor, fmt: SerdeFormat) -> bytes:
    """(n, 3, 8) projective points -> n compressed 32-byte points
    (PROCESSED) or n Montgomery x ‖ y (raw); the identity is all zeros."""
    F = curve.Fq
    inf = curve.is_identity(P)
    xy = curve.batch_normalize(P)            # the identity -> (0, 0)
    if fmt != SerdeFormat.PROCESSED:
        return _to_bytes(xy).tobytes()
    xy = F.from_mont(xy)
    x = xy[:, 0].to(torch.int64) & 0xFFFFFFFF
    odd = (xy[:, 1, 0] & 1).to(torch.int64)
    x[:, NWORDS - 1] |= odd << 31
    x[inf] = 0
    return _to_bytes(x.to(torch.int32)).tobytes()


def points_from_bytes(curve, data, off: int, n: int, fmt: SerdeFormat,
                      device):
    """n points at data[off:] -> ((n, 3, 8) tensor on `device`, offset)."""
    F = curve.Fq
    if fmt == SerdeFormat.PROCESSED:
        return _points_processed(curve, data, off, n, device), off + 32 * n
    w = _from_bytes(data, off, 2 * n, device).reshape(n, 2, NWORDS)
    inf = (w == 0).all(-1).all(-1)
    high = _not_below(F, w)
    if fmt == SerdeFormat.RAW_BYTES:
        if bool(high.any()):
            raise ValueError("coordinate out of range")
        x, y = w[:, 0], w[:, 1]
        lhs = F.mul(y, y)
        rhs = F.add(F.mul(F.mul(x, x), x), F.encode_int(curve.b, device))
        if bool((~F.eq(lhs, rhs) & ~inf).any()):
            raise ValueError("point not on curve")
    else:
        w = _reduce(F, w.reshape(2 * n, NWORDS), high.flatten()).reshape(
            n, 2, NWORDS)
    return curve.from_affine_coords(w, inf), off + 64 * n


def _points_processed(curve, data, off: int, n: int, device):
    """Decompression on the device: y = (x^3 + b)^((p + 1) / 4), the
    square root for p = 3 mod 4 (BN254's base field), checked by squaring,
    and negated where its parity is not the stored sign."""
    F = curve.Fq
    if F.p % 4 != 3:
        raise NotImplementedError(
            f"batched point decompression needs p = 3 mod 4 ({curve.name})")
    w = _from_bytes(data, off, n, device)
    inf = (w == 0).all(-1)
    sign = ((w[:, NWORDS - 1].to(torch.int64) >> 31) & 1).bool()
    w[:, NWORDS - 1] &= 0x7FFFFFFF
    if bool(_not_below(F, w).any()):
        raise ValueError("invalid x coordinate")
    x = F.to_mont(w)
    rhs = F.add(F.mul(F.mul(x, x), x), F.encode_int(curve.b, device))
    y = F.pow(rhs, (F.p + 1) // 4)
    if bool((~F.eq(F.mul(y, y), rhs) & ~inf).any()):
        raise ValueError("not on curve")
    flip = ((F.from_mont(y)[:, 0] & 1).bool() != sign)[:, None]
    y = torch.where(flip, F.neg(y), y)
    return curve.from_affine_coords(torch.stack([x, y], dim=1), inf)


# ----------------------------------------------------------------------
# polynomial (vec) codecs — poly.rs:170-198, helpers.rs:106-136
# ----------------------------------------------------------------------

def _poly_slice_parts(F, arr: torch.Tensor, fmt: SerdeFormat) -> list:
    """(m, n, 8) -> the buffers of [m: u32 BE] then m x ([n: u32 BE][n
    elements]), the elements as views of one host copy."""
    m, n = arr.shape[0], arr.shape[1]
    body = _felts_to_bytes(F, arr, fmt).reshape(m, n * ELEM_BYTES)
    parts = [struct.pack(">I", m)]
    for row in body:
        parts += [struct.pack(">I", n), row]
    return parts


def _read_poly_slice(F, data, off: int, fmt: SerdeFormat, n_expected: int,
                     device):
    """-> ((m, n, 8) tensor, offset); the polys' elements go through one
    check and one conversion."""
    (m,) = struct.unpack(">I", data[off:off + 4])
    off += 4
    spans = []
    for _ in range(m):
        (n,) = struct.unpack(">I", data[off:off + 4])
        spans.append((off + 4, n))
        off += 4 + n * ELEM_BYTES
    if not spans:
        return F.zeros((0, n_expected), device), off
    lengths = {n for _, n in spans}
    if len(lengths) != 1:
        raise ValueError(f"polynomials of unequal lengths {sorted(lengths)}")
    n = spans[0][1]
    # one host copy of the polys' elements, without their length headers
    buf = np.concatenate([np.frombuffer(data, dtype="<i4", count=n * NWORDS,
                                        offset=o) for o, _ in spans])
    w = torch.from_numpy(buf.reshape(m * n, NWORDS)).to(device)
    return _felts_from_words(F, w, fmt).reshape(m, n, NWORDS), off


def _read_poly(F, data, off: int, fmt: SerdeFormat, device):
    (n,) = struct.unpack(">I", data[off:off + 4])
    return (_felts_from_bytes(F, data, off + 4, n, fmt, device),
            off + 4 + n * ELEM_BYTES)


# ----------------------------------------------------------------------
# vk
# ----------------------------------------------------------------------

def vk_write(vk, fmt: SerdeFormat = SerdeFormat.PROCESSED) -> bytes:
    """plonk.rs:72-86 layout."""
    curve = vk.curve
    assert vk.k <= vk.F.S
    out = bytearray([VERSION, vk.k])
    out += struct.pack("<I", len(vk.fixed_commitments))
    for pt in vk.fixed_commitments:
        out += _write_point(curve, pt, fmt)
    for pt in vk.permutation.commitments:
        out += _write_point(curve, pt, fmt)
    return bytes(out)


def _vk_read_at(F, curve, cs_back, data: bytes, off: int, fmt: SerdeFormat,
                device):
    from ..plonk.keygen import PermutationVK, VerifyingKey
    from ..poly.domain import EvaluationDomain
    if data[off] != VERSION:
        raise ValueError(f"unexpected vk version byte {data[off]}")
    k = data[off + 1]
    if k > F.S:
        raise ValueError(f"circuit size value (k): {k} exceeds maximum")
    off += 2
    (n_fixed,) = struct.unpack("<I", data[off:off + 4])
    off += 4
    fixed = []
    for _ in range(n_fixed):
        pt, off = _read_point(curve, data, off, fmt)
        fixed.append(pt)
    perm = []
    for _ in range(len(cs_back.cs.permutation.columns)):
        pt, off = _read_point(curve, data, off, fmt)
        perm.append(pt)
    domain = EvaluationDomain(F, max(cs_back.degree(), 2), k, device)
    vk = VerifyingKey(F, curve, domain, cs_back, fixed,
                      PermutationVK(perm), k)
    return vk, off


def _compile(F, k: int, circuit, compress_selectors: bool):
    from ..frontend.circuit import compile_circuit
    from ..plonk.keygen import ConstraintSystemBack
    compiled, _cfg, _cs = compile_circuit(F, k, circuit, compress_selectors)
    return ConstraintSystemBack(compiled.cs, F.p)


def vk_read(F, params, k: int, circuit, data: bytes,
            fmt: SerdeFormat = SerdeFormat.PROCESSED,
            compress_selectors: bool = True):
    """Recompiles `circuit` to recover the constraint system (the legacy
    vk_read pattern, halo2_proofs/src/plonk.rs:45-60), then deserializes
    onto the params' device."""
    cs_back = _compile(F, k, circuit, compress_selectors)
    vk, _off = _vk_read_at(F, params.curve, cs_back, data, 0, fmt,
                           params.device)
    if vk.k != k:
        raise ValueError(f"vk k mismatch: file has {vk.k}, expected {k}")
    return vk


# ----------------------------------------------------------------------
# pk
# ----------------------------------------------------------------------

def pk_write(pk, fmt: SerdeFormat = SerdeFormat.PROCESSED) -> bytes:
    """plonk.rs:311-321 layout."""
    F = pk.vk.F
    parts = [vk_write(pk.vk, fmt)]
    for t in (pk.l0, pk.l_last, pk.l_active_row):
        parts += _poly_slice_parts(F, t[None], fmt)[1:]     # no count
    for t in (pk.fixed_values, pk.fixed_polys, pk.fixed_cosets,
              pk.permutation.permutations, pk.permutation.polys,
              pk.permutation.cosets):
        parts += _poly_slice_parts(F, t, fmt)
    return b"".join(parts)


def pk_read(F, params, k: int, circuit, data: bytes,
            fmt: SerdeFormat = SerdeFormat.PROCESSED,
            compress_selectors: bool = True):
    """plonk.rs:334-360: read the vk, then the polynomial payload onto the
    params' device; the evaluator is rebuilt from the constraint system."""
    from ..plonk.keygen import PermutationPK, ProvingKey
    from ..plonk.prover import Evaluator

    dev = params.device
    cs_back = _compile(F, k, circuit, compress_selectors)
    vk, off = _vk_read_at(F, params.curve, cs_back, data, 0, fmt, dev)
    n = 1 << k
    ext_n = vk.domain.extended_n
    polys = []
    for _ in range(3):
        t, off = _read_poly(F, data, off, fmt, dev)
        polys.append(t)
    for n_expected in (n, n, ext_n, n, n, ext_n):
        t, off = _read_poly_slice(F, data, off, fmt, n_expected, dev)
        polys.append(t)
    if off != len(data):
        raise ValueError(f"trailing bytes in pk file ({len(data) - off})")
    (l0, l_last, l_active_row, fixed_values, fixed_polys, fixed_cosets,
     perms, sigma_polys, sigma_cosets) = polys
    return ProvingKey(vk, l0, l_last, l_active_row, fixed_values,
                      fixed_polys, fixed_cosets,
                      PermutationPK(perms, sigma_polys, sigma_cosets),
                      Evaluator(F, vk.domain, cs_back))
