"""Short Weierstrass curves y^2 = x^3 + b over python ints, in Jacobian
coordinates, with their scalar field's constants and the compressed
32-byte point encoding that halo2's transcripts use (x little-endian, the
parity of y in the top bit of the last byte, all zero for the
identity)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

Affine = Optional[Tuple[int, int]]      # None is the identity


def inv(a: int, p: int) -> int:
    return pow(a % p, p - 2, p)


def batch_inv(values: Sequence[int], p: int) -> list:
    """Montgomery's trick: every inverse for one exponentiation."""
    prefix = [1] * (len(values) + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * v % p
    acc = inv(prefix[-1], p)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = acc * prefix[i] % p
        acc = acc * values[i] % p
    return out


_TS = {}         # p -> (s, t, c): Tonelli-Shanks' constants


def sqrt(a: int, p: int) -> Optional[int]:
    """A square root mod p (Tonelli-Shanks), or None."""
    a %= p
    if a == 0:
        return 0
    if p % 4 == 3:
        y = pow(a, (p + 1) // 4, p)
        return y if y * y % p == a else None
    if p not in _TS:
        t, s = p - 1, 0
        while t % 2 == 0:
            t //= 2
            s += 1
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        _TS[p] = (s, t, pow(z, t, p))
    m, t, c = _TS[p]
    t_, r = pow(a, t, p), pow(a, (t + 1) // 2, p)
    while t_ != 1:
        i, tmp = 0, t_
        while tmp != 1:
            tmp = tmp * tmp % p
            i += 1
            if i == m:
                return None             # a is not a square
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t_ = t_ * c % p
        r = r * b % p
    return r


class ScalarField:
    """A prime field of 2-adicity S with its multiplicative generator:
    the root of unity of order 2^S and delta, the permutation's coset
    shift, generator^(2^S)."""

    def __init__(self, p: int, generator: int):
        self.p = p
        t, s = p - 1, 0
        while t % 2 == 0:
            t //= 2
            s += 1
        self.S = s
        self.root_of_unity = pow(generator, t, p)
        self.delta = pow(generator, 1 << s, p)


class Curve:
    """y^2 = x^3 + b over F_q, of prime order fr.p."""

    def __init__(self, q: int, b: int, gen: Tuple[int, int],
                 fr: ScalarField):
        self.q = q
        self.b = b
        self.gen = gen
        self.fr = fr
        self.r = fr.p

    _O = (1, 1, 0)

    def _double(self, P):
        X, Y, Z = P
        if Z == 0 or Y == 0:
            return self._O
        q = self.q
        A = X * X % q
        B = Y * Y % q
        C = B * B % q
        D = 2 * ((X + B) * (X + B) - A - C) % q
        E = 3 * A % q
        X3 = (E * E - 2 * D) % q
        return (X3, (E * (D - X3) - 8 * C) % q, 2 * Y * Z % q)

    def _add(self, P, Qp):
        if P[2] == 0:
            return Qp
        if Qp[2] == 0:
            return P
        q = self.q
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Qp
        Z1Z1 = Z1 * Z1 % q
        Z2Z2 = Z2 * Z2 % q
        U1 = X1 * Z2Z2 % q
        U2 = X2 * Z1Z1 % q
        S1 = Y1 * Z2 * Z2Z2 % q
        S2 = Y2 * Z1 * Z1Z1 % q
        if U1 == U2:
            return self._double(P) if S1 == S2 else self._O
        H = (U2 - U1) % q
        Rr = (S2 - S1) % q
        HH = H * H % q
        HHH = H * HH % q
        V = U1 * HH % q
        X3 = (Rr * Rr - HHH - 2 * V) % q
        return (X3, (Rr * (V - X3) - S1 * HHH) % q, Z1 * Z2 * H % q)

    def _jac(self, pt: Affine):
        return self._O if pt is None else (pt[0], pt[1], 1)

    def _affine(self, P) -> Affine:
        X, Y, Z = P
        if Z == 0:
            return None
        zi = inv(Z, self.q)
        zi2 = zi * zi % self.q
        return (X * zi2 % self.q, Y * zi2 * zi % self.q)

    def on_curve(self, pt: Affine) -> bool:
        if pt is None:
            return True
        x, y = pt
        return (y * y - x * x * x - self.b) % self.q == 0

    def add(self, a: Affine, b: Affine) -> Affine:
        return self._affine(self._add(self._jac(a), self._jac(b)))

    def neg(self, a: Affine) -> Affine:
        return None if a is None else (a[0], (-a[1]) % self.q)

    def mul(self, pt: Affine, k: int) -> Affine:
        return self.msm([k], [pt])

    def msm(self, scalars: Sequence[int], points: Sequence[Affine]) -> Affine:
        """sum scalars[i] points[i]: one double-and-add chain over tens of
        terms; Pippenger's buckets from a few hundred."""
        terms = [(s % self.r, self._jac(p)) for s, p in zip(scalars, points)
                 if p is not None and s % self.r]
        if len(terms) > 256:
            return self._affine(self._pippenger(terms))
        acc = self._O
        for bit in range(self.r.bit_length() - 1, -1, -1):
            acc = self._double(acc)
            for s, P in terms:
                if (s >> bit) & 1:
                    acc = self._add(acc, P)
        return self._affine(acc)

    def _pippenger(self, terms):
        c = max(4, len(terms).bit_length() - 4)
        mask = (1 << c) - 1
        acc = self._O
        for w in range(-(-self.r.bit_length() // c) - 1, -1, -1):
            for _ in range(c):
                acc = self._double(acc)
            buckets = [self._O] * (1 << c)
            for s, P in terms:
                d = (s >> (c * w)) & mask
                if d:
                    buckets[d] = self._add(buckets[d], P)
            running, total = self._O, self._O
            for d in range(mask, 0, -1):
                running = self._add(running, buckets[d])
                total = self._add(total, running)
            acc = self._add(acc, total)
        return acc

    def point_from_bytes(self, b: bytes) -> Affine:
        """Raises ValueError on bytes that name no point."""
        if len(b) != 32:
            raise ValueError("a point takes 32 bytes")
        if b == bytes(32):
            return None
        buf = bytearray(b)
        sign = buf[31] >> 7
        buf[31] &= 0x7F
        x = int.from_bytes(bytes(buf), "little")
        if x >= self.q:
            raise ValueError("x is not canonical")
        y = sqrt((x * x * x + self.b) % self.q, self.q)
        if y is None:
            raise ValueError("x is on no point of the curve")
        if (y & 1) != sign:
            y = self.q - y
        return (x, y)

    def point_to_bytes(self, pt: Affine) -> bytes:
        if pt is None:
            return bytes(32)
        buf = bytearray(pt[0].to_bytes(32, "little"))
        if pt[1] & 1:
            buf[31] |= 0x80
        return bytes(buf)
