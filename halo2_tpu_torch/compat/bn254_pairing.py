"""BN254 (alt_bn128) optimal-ate pairing, host-side python ints.

Used only by the KZG verifier's final check (DualMSM::check,
halo2_backend/src/poly/kzg/msm.rs:188-206) — verification is explicitly
allowed to be slow relative to proving (kzg/strategy.rs:140-143), so this
favors clarity/correctness over speed: the Miller loop runs over the
untwisted curve E(Fq12) with affine line functions, and the final
exponentiation is a direct power by (q^12 - 1)/r.

Standard public curve constants (EIP-196/197 / BN254 spec).
"""

from __future__ import annotations

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
ATE_LOOP_COUNT = 29793968203157093288   # 6u + 2, u = 4965661367192848881

# G2 generator over Fq2 = Fq[i]/(i^2+1), coordinates (c0 + c1*i)
G2_X = (10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634)
G2_Y = (8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531)


class FQP:
    """Fq[x] / modulus_coeffs polynomial extension field."""

    __slots__ = ("coeffs",)
    degree = 0
    mod_coeffs = ()

    def __init__(self, coeffs):
        assert len(coeffs) == self.degree
        self.coeffs = [c % Q for c in coeffs]

    @classmethod
    def one(cls):
        return cls([1] + [0] * (cls.degree - 1))

    @classmethod
    def zero(cls):
        return cls([0] * cls.degree)

    def __add__(self, other):
        return type(self)([a + b for a, b in zip(self.coeffs, other.coeffs)])

    def __sub__(self, other):
        return type(self)([a - b for a, b in zip(self.coeffs, other.coeffs)])

    def __neg__(self):
        return type(self)([-a for a in self.coeffs])

    def __mul__(self, other):
        d = self.degree
        if isinstance(other, int):
            return type(self)([a * other for a in self.coeffs])
        tmp = [0] * (2 * d - 1)
        for i, a in enumerate(self.coeffs):
            if a:
                for j, b in enumerate(other.coeffs):
                    tmp[i + j] += a * b
        # reduce by x^d = -mod_coeffs
        for i in range(2 * d - 2, d - 1, -1):
            top = tmp[i] % Q
            if top:
                tmp[i] = 0
                for j, mc in enumerate(self.mod_coeffs):
                    tmp[i - d + j] -= top * mc
        return type(self)([c % Q for c in tmp[:d]])

    def __rmul__(self, other):
        return self.__mul__(other)

    def __eq__(self, other):
        return self.coeffs == other.coeffs

    def is_zero(self):
        return all(c == 0 for c in self.coeffs)

    def inv(self):
        """Extended Euclid over Fq[x]."""
        d = self.degree
        lm, hm = [1] + [0] * d, [0] * (d + 1)
        low = list(self.coeffs) + [0]
        high = list(self.mod_coeffs) + [1]

        def deg(p):
            dd = len(p) - 1
            while dd and p[dd] == 0:
                dd -= 1
            return dd

        def poly_rounded_div(a, b):
            dega, degb = deg(a), deg(b)
            temp = list(a)
            o = [0] * len(a)
            binv = pow(b[degb], Q - 2, Q)
            for i in range(dega - degb, -1, -1):
                o[i] = (o[i] + temp[degb + i] * binv) % Q
                for c in range(degb + 1):
                    temp[c + i] = (temp[c + i] - o[c]) % Q
            return [x % Q for x in o[: deg(o) + 1]]

        while deg(low):
            r = poly_rounded_div(high, low)
            r += [0] * (d + 1 - len(r))
            nm = list(hm)
            new = list(high)
            for i in range(d + 1):
                for j in range(d + 1 - i):
                    nm[i + j] = (nm[i + j] - lm[i] * r[j]) % Q
                    new[i + j] = (new[i + j] - low[i] * r[j]) % Q
            lm, low, hm, high = nm, new, lm, low
        linv = pow(low[0], Q - 2, Q)
        return type(self)([(c * linv) % Q for c in lm[:d]])

    def pow(self, e: int):
        result = type(self).one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def __repr__(self):
        return f"FQP{self.coeffs}"


class FQ2(FQP):
    degree = 2
    mod_coeffs = (1, 0)          # i^2 = -1


class FQ12(FQP):
    degree = 12
    mod_coeffs = (82, 0, 0, 0, 0, 0, -18 % Q, 0, 0, 0, 0, 0)
    # w^12 - 18 w^6 + 82 = 0, where w^6 = 9 + i


# ----------------------------------------------------------------------
# curve ops over a generic field (affine, b handled implicitly)
# ----------------------------------------------------------------------

def _double(pt):
    if pt is None:
        return None
    x, y = pt
    lam = (x * x * 3) * (y * 2).inv()
    nx = lam * lam - x - x
    ny = lam * (x - nx) - y
    return (nx, ny)


def _add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        return _double(p1)
    if x1 == x2:
        return None
    lam = (y2 - y1) * (x2 - x1).inv()
    nx = lam * lam - x1 - x2
    ny = lam * (x1 - nx) - y1
    return (nx, ny)


def _neg(pt):
    if pt is None:
        return None
    return (pt[0], -pt[1])


# untwist: (x', y') in E'(Fq2) -> E(Fq12) via x = x' w^-2... implemented as
# py_ecc does: embed Fq2 coeffs at positions scaled by w
def _twist_to_fq12(pt):
    if pt is None:
        return None
    x, y = pt
    # Fq2 element c0 + c1*i with i = w^6 - 9: embed into FQ12
    xc = [x.coeffs[0] - 9 * x.coeffs[1], x.coeffs[1]]
    yc = [y.coeffs[0] - 9 * y.coeffs[1], y.coeffs[1]]
    nx = FQ12([xc[0]] + [0] * 5 + [xc[1]] + [0] * 5)
    ny = FQ12([yc[0]] + [0] * 5 + [yc[1]] + [0] * 5)
    w = FQ12([0, 1] + [0] * 10)
    return (nx * w.pow(2), ny * w.pow(3))


def _g1_to_fq12(pt):
    if pt is None:
        return None
    x, y = pt
    return (FQ12([x] + [0] * 11), FQ12([y] + [0] * 11))


def _linefunc(p1, p2, t):
    """Evaluate the line through p1, p2 at t (all in E(Fq12))."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) * (x2 - x1).inv()
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = (x1 * x1 * 3) * (y1 * 2).inv()
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def miller_loop(q_pt, p_pt):
    """q in E(Fq12) (untwisted G2), p in E(Fq12) (embedded G1)."""
    if q_pt is None or p_pt is None:
        return FQ12.one()
    r = q_pt
    f = FQ12.one()
    # iterate bits of ATE_LOOP_COUNT from the second-highest down
    bits = bin(ATE_LOOP_COUNT)[2:]
    for bit in bits[1:]:
        f = f * f * _linefunc(r, r, p_pt)
        r = _double(r)
        if bit == "1":
            f = f * _linefunc(r, q_pt, p_pt)
            r = _add(r, q_pt)
    # frobenius twists
    q1 = (q_pt[0].pow(Q), q_pt[1].pow(Q))
    nq2 = (q1[0].pow(Q), -q1[1].pow(Q))
    f = f * _linefunc(r, q1, p_pt)
    r = _add(r, q1)
    f = f * _linefunc(r, nq2, p_pt)
    return f


_FINAL_EXP = (Q ** 12 - 1) // R


def pairing(q_g2, p_g1):
    """e(P, Q): p_g1 = (x, y) ints or None; q_g2 = ((x0,x1),(y0,y1)) or None.
    Returns FQ12."""
    if p_g1 is None or q_g2 is None:
        return FQ12.one()
    q12 = _twist_to_fq12((FQ2(list(q_g2[0])), FQ2(list(q_g2[1]))))
    p12 = _g1_to_fq12(p_g1)
    return miller_loop(q12, p12).pow(_FINAL_EXP)


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1; pairs of (g1_affine, g2_affine).

    Dispatches to the native C++ library (native/) when available —
    ~10x faster than the Python big-int path, same algorithm, validated
    against this module."""
    from .. import native
    nat = native.pairing_check(pairs)
    if nat is not None:
        return nat
    f = FQ12.one()
    for p_g1, q_g2 in pairs:
        if p_g1 is None or q_g2 is None:
            continue
        q12 = _twist_to_fq12((FQ2(list(q_g2[0])), FQ2(list(q_g2[1]))))
        p12 = _g1_to_fq12(p_g1)
        f = f * miller_loop(q12, p12)
    return f.pow(_FINAL_EXP) == FQ12.one()


# G2 scalar multiplication over Fq2 (for trusted-setup [s]G2)
def g2_generator():
    return (FQ2(list(G2_X)), FQ2(list(G2_Y)))


def g2_scalar_mul(pt, k: int):
    acc = None
    add = pt
    while k:
        if k & 1:
            acc = _add(acc, add)
        add = _double(add)
        k >>= 1
    return acc


def g2_to_ints(pt):
    if pt is None:
        return None
    return (tuple(pt[0].coeffs), tuple(pt[1].coeffs))


def g2_from_ints(t):
    if t is None:
        return None
    return (FQ2(list(t[0])), FQ2(list(t[1])))
