"""Kernel B (csrc/ec.cu): BN254 G1 complete add / mixed add / double, and
their plain PyTorch versions.

Replaces halo2_tpu/curves/pallas_ec.py (`ec_add`, `ec_madd`, `ec_double`).
Points are (..., 3, 8) int32 projective words, affine operands (..., 2, 8).
The wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel.

The plain versions follow the reference formulas (RC15 Algs 7-9) term by
term in int64 limbs, grouping independent multiplies into one batched
`Limbs.mul`; every intermediate is a canonical field element, so the
grouping does not change a single output word.
"""

from __future__ import annotations

import torch

from .._build import I32, I64, P, Kernel, stream_of
from ..fields.cuda_ops import NWORDS, chunked, limbs_for, to_limbs, to_words

_EC_CHUNK = 1 << 9         # points per plain-version step (cache-sized)
_EC_ARGS = [I32, P, P, P, P, I64, P]     # op, p, q, q_inf, out, n, stream
_add_kernel = Kernel("h2_ec_op", _EC_ARGS, name="h2_ec_add")
_madd_kernel = Kernel("h2_ec_op", _EC_ARGS, name="h2_ec_madd")
_double_kernel = Kernel("h2_ec_op", _EC_ARGS, name="h2_ec_double")


# ----------------------------------------------------------------------
# limb-level bodies (shared with the plain MSM bucket version)
# ----------------------------------------------------------------------

def _st(*xs):
    return torch.stack(xs, dim=-2)


def add_limbs(L, P, Q):
    """Complete projective addition (RC15 Alg 7, a = 0) on (..., 3, 16)."""
    X1, Y1, Z1 = P.unbind(-2)
    X2, Y2, Z2 = Q.unbind(-2)
    t0, t1, t2 = L.mul(P, Q).unbind(-2)
    s = L.add(_st(X1, Y1, X1, X2, Y2, X2), _st(Y1, Z1, Z1, Y2, Z2, Z2))
    m = L.mul(s[..., :3, :], s[..., 3:, :])
    u = L.add(_st(t0, t1, t0), _st(t1, t2, t2))
    t3, t4, Y3 = L.sub(m, u).unbind(-2)
    t0 = L.add(L.add(t0, t0), t0)
    t2, Y3 = L.mul_b3(_st(t2, Y3)).unbind(-2)
    Z3 = L.add(t1, t2)
    t1 = L.sub(t1, t2)
    return _combine(L, t0, t1, t3, t4, Y3, Z3)


def _combine(L, t0, t1, t3, t4, Y3, Z3):
    """X3 = t3 t1 - t4 Y3, Y3 = Y3 t0 + t1 Z3, Z3 = Z3 t4 + t0 t3."""
    pr = L.mul(_st(t3, t4, Y3, t1, Z3, t0), _st(t1, Y3, t0, Z3, t4, t3))
    X3 = L.sub(pr[..., 0, :], pr[..., 1, :])
    YZ = L.add(pr[..., 2::2, :], pr[..., 3::2, :])
    return torch.cat([X3.unsqueeze(-2), YZ], dim=-2)


def madd_limbs(L, P, Qa, q_inf=None):
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
    t2, Y3 = L.mul_b3(_st(Z1, Y3)).unbind(-2)
    Z3 = L.add(t1, t2)
    t1 = L.sub(t1, t2)
    out = _combine(L, t0, t1, t3, t4, Y3, Z3)
    if q_inf is not None:
        out = torch.where(q_inf[..., None, None], P, out)
    return out


def double_limbs(L, P):
    """Complete doubling (RC15 Alg 9, a = 0) on (..., 3, 16)."""
    X, Y, Z = P.unbind(-2)
    t0, t1, t2, xy = L.mul(_st(Y, Y, Z, X), _st(Y, Z, Z, Y)).unbind(-2)
    Z3 = L.add(t0, t0)
    Z3 = L.add(Z3, Z3)
    Z3 = L.add(Z3, Z3)
    t2 = L.mul_b3(t2)
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
# plain versions on words
# ----------------------------------------------------------------------

def ec_add_plain(curve, P, Q):
    L = limbs_for(curve.Fq, P.device)
    P, Q = torch.broadcast_tensors(P, Q)
    shape = P.shape
    n = P.numel() // (3 * NWORDS)
    out = chunked(lambda p, q: to_words(add_limbs(L, to_limbs(p),
                                                  to_limbs(q))),
                  n, P.reshape(n, 3, NWORDS), Q.reshape(n, 3, NWORDS),
                  chunk=_EC_CHUNK)
    return out.reshape(shape)


def ec_madd_plain(curve, P, Qa, q_inf):
    L = limbs_for(curve.Fq, P.device)
    shape = P.shape
    n = P.numel() // (3 * NWORDS)
    out = chunked(lambda p, q, i: to_words(madd_limbs(L, to_limbs(p),
                                                      to_limbs(q), i)),
                  n, P.reshape(n, 3, NWORDS), Qa.reshape(n, 2, NWORDS),
                  q_inf.reshape(n), chunk=_EC_CHUNK)
    return out.reshape(shape)


def ec_double_plain(curve, P):
    L = limbs_for(curve.Fq, P.device)
    shape = P.shape
    n = P.numel() // (3 * NWORDS)
    out = chunked(lambda p: to_words(double_limbs(L, to_limbs(p))),
                  n, P.reshape(n, 3, NWORDS), chunk=_EC_CHUNK)
    return out.reshape(shape)


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------

def _check(*ts):
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
    _check(P, Q)
    P = P.contiguous()
    Q = Q.contiguous()
    out = torch.empty_like(P)
    _add_kernel.launch(0, P.data_ptr(), Q.data_ptr(), None, out.data_ptr(),
                      out.numel() // (3 * NWORDS), stream_of(out))
    return out


def ec_madd(curve, P, Qa, q_inf=None):
    """Complete mixed add: P (..., 3, 8) + affine Qa (..., 2, 8), with an
    optional (...) bool mask of lanes where Q is the identity."""
    # torch.broadcast_shapes would do, but its first call imports for
    # seconds; broadcasting one word of each operand costs nothing
    batch = torch.broadcast_tensors(P[..., 0, 0], Qa[..., 0, 0])[0].shape
    P = P.expand(batch + (3, NWORDS))
    Qa = Qa.expand(batch + (2, NWORDS))
    if q_inf is None:
        q_inf = torch.zeros(batch, dtype=torch.bool, device=P.device)
    q_inf = q_inf.expand(batch)
    if P.device.type == "cpu":
        return ec_madd_plain(curve, P, Qa, q_inf)
    _check(P, Qa)
    if q_inf.dtype != torch.bool or q_inf.device != P.device:
        raise ValueError("q_inf must be a bool tensor on the points' device")
    P = P.contiguous()
    Qa = Qa.contiguous()
    q_inf = q_inf.contiguous()
    out = torch.empty_like(P)
    _madd_kernel.launch(1, P.data_ptr(), Qa.data_ptr(), q_inf.data_ptr(),
                      out.data_ptr(), out.numel() // (3 * NWORDS),
                      stream_of(out))
    return out


def ec_double(curve, P):
    """Complete projective doubling of (..., 3, 8) points."""
    if P.device.type == "cpu":
        return ec_double_plain(curve, P)
    _check(P)
    P = P.contiguous()
    out = torch.empty_like(P)
    _double_kernel.launch(2, P.data_ptr(), None, None, out.data_ptr(),
                      out.numel() // (3 * NWORDS), stream_of(out))
    return out
