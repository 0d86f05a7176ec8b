"""Kernel B (csrc/ec.cu): complete add / mixed add / double on BN254 G1,
Pallas and Vesta, the double-and-add scalar multiplication as one chain,
and their plain PyTorch versions.

Replaces the JAX reference's curves/pallas_ec.py (`ec_add`, `ec_madd`, `ec_double`)
and the lax.scan of its Curve.scalar_mul.  Points are (..., 3, 8) int32
projective words, affine operands (..., 2, 8).  The wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it launches the
kernel.

The plain versions follow the reference formulas (RC15 Algs 7-9) term by
term in int64 limbs, grouping independent multiplies into one batched
`Limbs.mul`; every intermediate is a canonical field element, so the
grouping does not change a single output word.  For the same reason the
small CPU batches that `cuda_ops.on_ints` picks run the same formulas over
python ints (`_*_ints`).
"""

from __future__ import annotations

import torch

from .._build import I32, I64, P, Kernel, stream_of
from ..fields.cuda_ops import (NWORDS, chunked, ints, limbs_for, on_ints,
                               to_limbs, to_words, words)

_EC_CHUNK = 1 << 9         # points per CPU plain-version step (cache-sized)
_EC_ARGS = [I32, I32, P, P, P, P, I64, P]  # op, curve, p, q, q_inf, out, n,
                                          # stream
_add_kernel = Kernel("h2_ec_op", _EC_ARGS, name="h2_ec_add")
_madd_kernel = Kernel("h2_ec_op", _EC_ARGS, name="h2_ec_madd")
_double_kernel = Kernel("h2_ec_op", _EC_ARGS, name="h2_ec_double")
# curve, points, scalars, scalar step (0: one for all), out, n, stream
_scalar_mul_kernel = Kernel("h2_ec_scalar_mul", [I32, P, P, I32, P, I64, P])


# ----------------------------------------------------------------------
# limb-level bodies (shared with the plain MSM bucket version)
# ----------------------------------------------------------------------

def _st(*xs):
    return torch.stack(xs, dim=-2)


def add_limbs(L, P, Q, b3: int):
    """Complete projective addition (RC15 Alg 7, a = 0) on (..., 3, 16)."""
    X1, Y1, Z1 = P.unbind(-2)
    X2, Y2, Z2 = Q.unbind(-2)
    t0, t1, t2 = L.mul(P, Q).unbind(-2)
    s = L.add(_st(X1, Y1, X1, X2, Y2, X2), _st(Y1, Z1, Z1, Y2, Z2, Z2))
    m = L.mul(s[..., :3, :], s[..., 3:, :])
    u = L.add(_st(t0, t1, t0), _st(t1, t2, t2))
    t3, t4, Y3 = L.sub(m, u).unbind(-2)
    t0 = L.add(L.add(t0, t0), t0)
    t2, Y3 = L.mul_b3(_st(t2, Y3), b3).unbind(-2)
    Z3 = L.add(t1, t2)
    t1 = L.sub(t1, t2)
    return _combine(L, t0, t1, t3, t4, Y3, Z3)


def _combine(L, t0, t1, t3, t4, Y3, Z3):
    """X3 = t3 t1 - t4 Y3, Y3 = Y3 t0 + t1 Z3, Z3 = Z3 t4 + t0 t3."""
    pr = L.mul(_st(t3, t4, Y3, t1, Z3, t0), _st(t1, Y3, t0, Z3, t4, t3))
    X3 = L.sub(pr[..., 0, :], pr[..., 1, :])
    YZ = L.add(pr[..., 2::2, :], pr[..., 3::2, :])
    return torch.cat([X3.unsqueeze(-2), YZ], dim=-2)


def madd_limbs(L, P, Qa, b3: int, q_inf=None):
    """Complete mixed addition (RC15 Alg 8): P (..., 3, 16) + affine
    Qa (..., 2, 16); lanes flagged in q_inf pass P through."""
    X1, Y1, Z1 = P.unbind(-2)
    X2, Y2 = Qa.unbind(-2)
    s0, s1 = L.add(_st(X2, X1), _st(Y2, Y1)).unbind(-2)
    t0, t1, t3, y2z1, x2z1 = L.mul(_st(X1, Y1, s0, Y2, X2),
                                   _st(X2, Y2, s1, Z1, Z1)).unbind(-2)
    u01, t4, Y3 = L.add(_st(t0, y2z1, x2z1), _st(t1, Y1, X1)).unbind(-2)
    t3 = L.sub(t3, u01)
    t0 = L.add(L.add(t0, t0), t0)
    t2, Y3 = L.mul_b3(_st(Z1, Y3), b3).unbind(-2)
    Z3 = L.add(t1, t2)
    t1 = L.sub(t1, t2)
    out = _combine(L, t0, t1, t3, t4, Y3, Z3)
    if q_inf is not None:
        out = torch.where(q_inf[..., None, None], P, out)
    return out


def double_limbs(L, P, b3: int):
    """Complete doubling (RC15 Alg 9, a = 0) on (..., 3, 16)."""
    X, Y, Z = P.unbind(-2)
    t0, t1, t2, xy = L.mul(_st(Y, Y, Z, X), _st(Y, Z, Z, Y)).unbind(-2)
    Z3 = L.add(t0, t0)
    Z3 = L.add(Z3, Z3)
    Z3 = L.add(Z3, Z3)
    t2 = L.mul_b3(t2, b3)
    X3, Z3 = L.mul(_st(t2, t1), _st(Z3, Z3)).unbind(-2)
    Y3 = L.add(t0, t2)
    t1 = L.add(t2, t2)
    t2 = L.add(t1, t2)
    t0 = L.sub(t0, t2)
    m0, m1 = L.mul(_st(t0, t0), _st(Y3, xy)).unbind(-2)
    Y3 = L.add(X3, m0)
    X3 = L.add(m1, m1)
    return _st(X3, Y3, Z3)


# ----------------------------------------------------------------------
# the same bodies over python ints (small CPU batches)
# ----------------------------------------------------------------------

def _combine_ints(p, r, t0, t1, t3, t4, y3, z3):
    """X3 = t3 t1 - t4 Y3, Y3 = Y3 t0 + t1 Z3, Z3 = Z3 t4 + t0 t3, each
    product a Montgomery product (times R^-1)."""
    return ((t3 * t1 - t4 * y3) * r % p, (y3 * t0 + t1 * z3) * r % p,
            (z3 * t4 + t0 * t3) * r % p)


def _add_pt(p, r, b3, x1, y1, z1, x2, y2, z2):
    t0, t1, t2 = x1 * x2 * r % p, y1 * y2 * r % p, z1 * z2 * r % p
    t3 = ((x1 + y1) * (x2 + y2) * r - t0 - t1) % p
    t4 = ((y1 + z1) * (y2 + z2) * r - t1 - t2) % p
    y3 = ((x1 + z1) * (x2 + z2) * r - t0 - t2) * b3 % p
    t2 = t2 * b3 % p
    return _combine_ints(p, r, 3 * t0, t1 - t2, t3, t4, y3, t1 + t2)


def _double_pt(p, r, b3, x, y, z):
    t0 = y * y * r % p
    t1 = y * z * r % p
    t2 = z * z * r * b3 % p
    z3 = 8 * t0
    y3 = t0 + t2
    t0 = t0 - 3 * t2
    return ((2 * t0 * x * y * r * r) % p, (t2 * z3 + t0 * y3) * r % p,
            t1 * z3 * r % p)


def _add_ints(curve, P, Q):
    F = curve.Fq
    p, r, b3 = F.p, F.R_inv, curve.b3
    a, b = ints(P), ints(Q)
    out = []
    for i in range(0, len(a), 3):
        out += _add_pt(p, r, b3, *a[i:i + 3], *b[i:i + 3])
    return words(out, P.shape)


def _madd_ints(curve, P, Qa, q_inf):
    F = curve.Fq
    p, r, b3 = F.p, F.R_inv, curve.b3
    a, b = ints(P), ints(Qa)
    skip = q_inf.reshape(-1).tolist()
    out = []
    for j, i in enumerate(range(0, len(a), 3)):
        x1, y1, z1 = a[i:i + 3]
        if skip[j]:
            out += (x1, y1, z1)
            continue
        x2, y2 = b[2 * j:2 * j + 2]
        t0, t1 = x1 * x2 * r % p, y1 * y2 * r % p
        t3 = ((x2 + y2) * (x1 + y1) * r - t0 - t1) % p
        t4 = (y2 * z1 * r + y1) % p
        y3 = (x2 * z1 * r + x1) * b3 % p
        t2 = z1 * b3 % p
        out += _combine_ints(p, r, 3 * t0, t1 - t2, t3, t4, y3, t1 + t2)
    return words(out, P.shape)


def _double_ints(curve, P):
    F = curve.Fq
    p, r, b3 = F.p, F.R_inv, curve.b3
    a = ints(P)
    out = []
    for i in range(0, len(a), 3):
        out += _double_pt(p, r, b3, *a[i:i + 3])
    return words(out, P.shape)


def _scalar_mul_ints(curve, P, k):
    """The double-and-add chain per point, k canonical scalar words."""
    F = curve.Fq
    p, r, b3 = F.p, F.R_inv, curve.b3
    a = ints(P)
    out = []
    for j, s in enumerate(ints(k)):
        acc, base = (0, F.R, 0), a[3 * j:3 * j + 3]
        for i in range(s.bit_length()):
            if (s >> i) & 1:
                acc = _add_pt(p, r, b3, *acc, *base)
            if i + 1 < s.bit_length():
                base = _double_pt(p, r, b3, *base)
        out += acc
    return words(out, P.shape)


# ----------------------------------------------------------------------
# plain versions on words
# ----------------------------------------------------------------------

def _chunk(P, n: int) -> int:
    """Points per limb step: cache-sized on the CPU; the whole batch on the
    card, where small steps are bound by launch overhead."""
    return _EC_CHUNK if P.device.type == "cpu" else max(n, 1)


def ec_add_plain(curve, P, Q):
    P, Q = torch.broadcast_tensors(P, Q)
    if on_ints(P, points=True):
        return _add_ints(curve, P, Q)
    L = limbs_for(curve.Fq, P.device)
    shape = P.shape
    n = P.numel() // (3 * NWORDS)
    out = chunked(lambda p, q: to_words(add_limbs(L, to_limbs(p),
                                                  to_limbs(q), curve.b3)),
                  n, P.reshape(n, 3, NWORDS), Q.reshape(n, 3, NWORDS),
                  chunk=_chunk(P, n))
    return out.reshape(shape)


def ec_madd_plain(curve, P, Qa, q_inf):
    if on_ints(P, points=True):
        return _madd_ints(curve, P, Qa, q_inf)
    L = limbs_for(curve.Fq, P.device)
    shape = P.shape
    n = P.numel() // (3 * NWORDS)
    out = chunked(lambda p, q, i: to_words(madd_limbs(L, to_limbs(p),
                                                      to_limbs(q), curve.b3,
                                                      i)),
                  n, P.reshape(n, 3, NWORDS), Qa.reshape(n, 2, NWORDS),
                  q_inf.reshape(n), chunk=_chunk(P, n))
    return out.reshape(shape)


def ec_double_plain(curve, P):
    if on_ints(P, points=True):
        return _double_ints(curve, P)
    L = limbs_for(curve.Fq, P.device)
    shape = P.shape
    n = P.numel() // (3 * NWORDS)
    out = chunked(lambda p: to_words(double_limbs(L, to_limbs(p),
                                                  curve.b3)),
                  n, P.reshape(n, 3, NWORDS), chunk=_chunk(P, n))
    return out.reshape(shape)


def _batch(P, k):
    """The broadcast batch shape of points (..., 3, 8) and scalars (..., 8)."""
    # torch.broadcast_shapes would do, but its first call imports for
    # seconds; broadcasting one word of each operand costs nothing
    return torch.broadcast_tensors(P[..., 0, 0], k[..., 0])[0].shape


def scalar_mul_plain(curve, P, k_mont):
    """Plain version of the scalar-mul chain: [k]P for (..., 3, 8) points and
    broadcast (..., 8) Montgomery scalars, double-and-add over the 256 bits
    of canonical k, least significant first: at a set bit acc = acc + base
    (kernel B's add), then base doubles.  Small CPU batches run the chain
    per point over python ints (`on_ints`)."""
    batch = _batch(P, k_mont)
    P = P.expand(batch + (3, NWORDS))
    k = curve.Fr.from_mont(k_mont).expand(batch + (NWORDS,))
    if on_ints(P, points=True):
        return _scalar_mul_ints(curve, P, k)
    k = k.to(torch.int64) & 0xFFFFFFFF
    acc = curve.identity(batch, P.device)
    base = P
    for i in range(256):
        bit = ((k[..., i // 32] >> (i % 32)) & 1).bool()
        acc = torch.where(bit[..., None, None], ec_add_plain(curve, acc, base),
                          acc)
        if i < 255:
            base = ec_double_plain(curve, base)
    return acc


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------

def check_words(*ts):
    """The kernel wrappers' check: (..., 8) int32 words on one CUDA
    device."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"EC op across devices {dev} and {t.device}")
        if t.dtype != torch.int32 or t.shape[-1] != NWORDS:
            raise ValueError(f"EC op needs (..., 8) int32 words, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if dev.type != "cuda":
        raise ValueError(f"EC op on unsupported device {dev}")


def ec_add(curve, P, Q):
    """Complete projective add of broadcast (..., 3, 8) point tensors."""
    P, Q = torch.broadcast_tensors(P, Q)
    if P.device.type == "cpu":
        return ec_add_plain(curve, P, Q)
    check_words(P, Q)
    P = P.contiguous()
    Q = Q.contiguous()
    out = torch.empty_like(P)
    _add_kernel.launch(0, curve.kernel_id, P.data_ptr(), Q.data_ptr(), None,
                       out.data_ptr(), out.numel() // (3 * NWORDS),
                       stream_of(out))
    return out


def ec_madd(curve, P, Qa, q_inf=None):
    """Complete mixed add: P (..., 3, 8) + affine Qa (..., 2, 8), with an
    optional (...) bool mask of lanes where Q is the identity."""
    batch = _batch(P, Qa[..., 0, :])
    P = P.expand(batch + (3, NWORDS))
    Qa = Qa.expand(batch + (2, NWORDS))
    if q_inf is None:
        q_inf = torch.zeros(batch, dtype=torch.bool, device=P.device)
    q_inf = q_inf.expand(batch)
    if P.device.type == "cpu":
        return ec_madd_plain(curve, P, Qa, q_inf)
    check_words(P, Qa)
    if q_inf.dtype != torch.bool or q_inf.device != P.device:
        raise ValueError("q_inf must be a bool tensor on the points' device")
    P = P.contiguous()
    Qa = Qa.contiguous()
    q_inf = q_inf.contiguous()
    out = torch.empty_like(P)
    _madd_kernel.launch(1, curve.kernel_id, P.data_ptr(), Qa.data_ptr(),
                        q_inf.data_ptr(), out.data_ptr(),
                        out.numel() // (3 * NWORDS), stream_of(out))
    return out


def ec_double(curve, P):
    """Complete projective doubling of (..., 3, 8) points."""
    if P.device.type == "cpu":
        return ec_double_plain(curve, P)
    check_words(P)
    P = P.contiguous()
    out = torch.empty_like(P)
    _double_kernel.launch(2, curve.kernel_id, P.data_ptr(), None, None,
                          out.data_ptr(), out.numel() // (3 * NWORDS),
                          stream_of(out))
    return out


def ec_scalar_mul(curve, P, k_mont):
    """[k]P for (..., 3, 8) points and broadcast (..., 8) Montgomery scalars
    of the curve's scalar field: on the card one launch of the whole chain,
    with one scalar for every point when k_mont holds only one."""
    if P.device.type == "cpu":
        return scalar_mul_plain(curve, P, k_mont)
    check_words(P, k_mont)
    batch = _batch(P, k_mont)
    P = P.expand(batch + (3, NWORDS)).contiguous()
    one = all(d == 1 or s == 0 for d, s in zip(k_mont.shape[:-1],
                                               k_mont.stride()[:-1]))
    if one:
        k = k_mont[(0,) * (k_mont.dim() - 1)].contiguous()
    else:
        k = k_mont.expand(batch + (NWORDS,)).contiguous()
    out = torch.empty_like(P)
    _scalar_mul_kernel.launch(curve.kernel_id, P.data_ptr(), k.data_ptr(),
                              0 if one else 1, out.data_ptr(),
                              out.numel() // (3 * NWORDS), stream_of(out))
    return out
