"""Batched short-Weierstrass (a = 0) curve arithmetic on tensors
(port of the JAX reference's curves/curve.py: BN254 G1, Pallas, Vesta).

A batch of points is an (..., 3, 8) int32 tensor — X, Y, Z in Montgomery
words — in homogeneous projective coordinates with the complete
Renes-Costello-Batina formulas (kernel B); the identity is (0 : 1 : 0).
"""

from __future__ import annotations

import torch

from ..fields.field import NWORDS, Field
from ..trace import to_host
from . import cuda_ec


class Curve:
    """y^2 = x^3 + b over base field Fq, with scalar field Fr (odd order).
    `kernel_id` names the curve in the CUDA sources (0 BN254 G1, 1 Pallas,
    2 Vesta)."""

    def __init__(self, name: str, Fq: Field, Fr: Field, b: int, gen_xy,
                 kernel_id: int):
        self.name = name
        self.Fq = Fq
        self.Fr = Fr
        self.b = b
        self.b3 = (3 * b) % Fq.p
        self.kernel_id = kernel_id
        self.gen_x, self.gen_y = gen_xy
        assert (self.gen_y ** 2 - self.gen_x ** 3 - b) % Fq.p == 0

    # ------------------------------------------------------------------
    # constructors and conversions
    # ------------------------------------------------------------------

    def identity(self, shape, device) -> torch.Tensor:
        F = self.Fq
        zero = F.zeros(tuple(shape), device)
        return torch.stack([zero, F.ones(tuple(shape), device), zero], dim=-2)

    def generator(self, shape=(), device="cuda") -> torch.Tensor:
        """The curve's generator, (*shape, 3, 8) on `device`."""
        g = self.from_affine_ints([(self.gen_x, self.gen_y)], device)[0]
        return g.expand(tuple(shape) + tuple(g.shape)).contiguous()

    def from_affine_ints(self, pts, device) -> torch.Tensor:
        """[(x, y) or None (identity), ...] -> (n, 3, 8)."""
        F = self.Fq
        xs, ys, zs = [], [], []
        for pt in pts:
            if pt is None:
                xs.append(0)
                ys.append(1)
                zs.append(0)
            else:
                x, y = pt
                xs.append(x % F.p)
                ys.append(y % F.p)
                zs.append(1)
        enc = F.encode_ints(xs + ys + zs, device).reshape(3, len(pts), NWORDS)
        return enc.transpose(0, 1).contiguous()

    def to_affine_ints(self, pts) -> list:
        """(..., 3, 8) -> [(x, y) or None, ...] host ints (one batched
        normalization, one host fetch)."""
        pts = pts.reshape(-1, 3, NWORDS)
        inf = to_host(self.is_identity(pts)).tolist()
        aff = self.batch_normalize(pts)
        vals = self.Fq.decode_ints(aff)
        return [None if inf[i] else (vals[2 * i], vals[2 * i + 1])
                for i in range(pts.shape[0])]

    def batch_normalize(self, P):
        """(n, 3, 8) projective -> (n, 2, 8) affine (identity -> (0, 0)),
        one field inversion in total."""
        F = self.Fq
        zinv = F.batch_inv(P[..., 2, :].reshape(-1, NWORDS)).reshape(
            P.shape[:-2] + (1, NWORDS))
        return F.mul(P[..., :2, :], zinv)

    def from_affine_coords(self, xy, inf_mask=None):
        """(..., 2, 8) affine (+ optional identity mask) -> (..., 3, 8)."""
        F = self.Fq
        x, y = xy[..., 0, :], xy[..., 1, :]
        if inf_mask is None:
            inf_mask = F.is_zero(x) & F.is_zero(y)
        m = inf_mask[..., None]
        one = F.ones(x.shape[:-1], x.device)
        zero = torch.zeros_like(x)
        return torch.stack([torch.where(m, zero, x), torch.where(m, one, y),
                            torch.where(m, zero, one)], dim=-2)

    # ------------------------------------------------------------------
    # group law (kernel B)
    # ------------------------------------------------------------------

    def add(self, P, Q):
        return cuda_ec.ec_add(self, P, Q)

    def madd(self, P, Q_affine, q_inf=None):
        return cuda_ec.ec_madd(self, P, Q_affine, q_inf)

    def double(self, P):
        return cuda_ec.ec_double(self, P)

    def neg(self, P):
        return torch.stack([P[..., 0, :], self.Fq.neg(P[..., 1, :]),
                            P[..., 2, :]], dim=-2)

    def eq(self, P, Q):
        """Projective equality (cross-multiplied), identity-aware."""
        F = self.Fq
        P, Q = torch.broadcast_tensors(P, Q)
        X1, Y1, Z1 = P[..., 0, :], P[..., 1, :], P[..., 2, :]
        X2, Y2, Z2 = Q[..., 0, :], Q[..., 1, :], Q[..., 2, :]
        x_eq = F.eq(F.mul(X1, Z2), F.mul(X2, Z1))
        y_eq = F.eq(F.mul(Y1, Z2), F.mul(Y2, Z1))
        p_inf = F.is_zero(Z1)
        q_inf = F.is_zero(Z2)
        return (p_inf & q_inf) | (~p_inf & ~q_inf & x_eq & y_eq)

    def is_identity(self, P):
        return self.Fq.is_zero(P[..., 2, :])

    # ------------------------------------------------------------------
    # scalar multiplication
    # ------------------------------------------------------------------

    def scalar_mul(self, P, k_mont):
        """[k]P with k (..., 8) Montgomery scalars: double-and-add over the
        256 bits of canonical k, least significant first (kernel B's chain,
        one launch; plain version `cuda_ec.scalar_mul_plain`)."""
        return cuda_ec.ec_scalar_mul(self, P, k_mont)

    def generator_mul(self, k_mont):
        """[k]G for (..., 8) Montgomery scalars, G the generator: one mixed
        add of the affine [2^i]G per bit of canonical k, where a lane whose
        bit is clear passes its accumulator through (madd's q_inf mask)."""
        dev = k_mont.device
        nbits = self.Fr.p.bit_length()
        pows = [self.from_affine_ints([(self.gen_x, self.gen_y)], dev)[0]]
        for _ in range(nbits - 1):
            pows.append(self.double(pows[-1]))
        table = self.batch_normalize(torch.stack(pows))      # (nbits, 2, 8)
        k = self.Fr.from_mont(k_mont).to(torch.int64) & 0xFFFFFFFF
        acc = self.identity(k_mont.shape[:-1], dev)
        for i in range(nbits):
            clear = ((k[..., i // 32] >> (i % 32)) & 1) == 0
            acc = self.madd(acc, table[i], clear)
        return acc

    def scalar_mul_int(self, P, k: int):
        k = int(k) % self.Fr.p
        return self.scalar_mul(P, self.Fr.encode_int(k, P.device).expand(
            P.shape[:-2] + (NWORDS,)))

    # ------------------------------------------------------------------
    # serialization (32-byte compressed; x LE with y-parity in top bit)
    # ------------------------------------------------------------------

    def point_to_bytes(self, pt) -> bytes:
        if pt is None:
            return b"\x00" * 32
        x, y = pt
        buf = bytearray(int(x).to_bytes(32, "little"))
        if y & 1:
            buf[31] |= 0x80
        return bytes(buf)

    def point_from_bytes(self, b: bytes):
        if b == b"\x00" * 32:
            return None
        buf = bytearray(b)
        sign = (buf[31] & 0x80) >> 7
        buf[31] &= 0x7F
        x = int.from_bytes(bytes(buf), "little")
        p = self.Fq.p
        if x >= p:
            raise ValueError("invalid x coordinate")
        rhs = (x * x * x + self.b) % p
        y = self._sqrt_int(rhs)
        if y is None:
            raise ValueError("not on curve")
        if (y & 1) != sign:
            y = p - y
        return (x, y)

    def _sqrt_int(self, a: int):
        """Square root over python ints, None for a non-residue: one power
        for p = 3 mod 4 (BN254 Fq), Tonelli-Shanks otherwise (Pasta)."""
        p = self.Fq.p
        if a == 0:
            return 0
        if pow(a, (p - 1) // 2, p) != 1:
            return None
        if p % 4 == 3:
            return pow(a, (p + 1) // 4, p)
        S, t = self.Fq.S, self.Fq.t_odd
        M, c = S, pow(self.Fq.generator, t, p)
        t_, R = pow(a, t, p), pow(a, (t + 1) // 2, p)
        while t_ != 1:
            i, tmp = 0, t_
            while tmp != 1:
                tmp = tmp * tmp % p
                i += 1
            b = pow(c, 1 << (M - i - 1), p)
            M, c = i, b * b % p
            t_ = t_ * c % p
            R = R * b % p
        return R

    def __hash__(self):
        return hash((self.name, self.Fq.p, self.b))

    def __eq__(self, other):
        return (isinstance(other, Curve) and other.Fq == self.Fq
                and other.b == self.b)

    def __repr__(self):
        return f"Curve({self.name})"
