// Native host library for the verifier-side primitives the reference gets
// from halo2curves' compiled Rust: the BN254 pairing check
// (halo2_backend/src/poly/kzg/msm.rs:188-206 DualMSM::check) and Keccak-256
// for the EVM transcript (halo2_backend/src/transcript.rs:24-38).
//
// The pairing is the same algorithm as compat/bn254_pairing.py (py_ecc-style
// full-Fq12 embedding, generic final exponentiation) over 4x64-limb
// Montgomery arithmetic, which the Python module validates against.
// Build: g++ -O3 -shared -fPIC (driven by native/__init__.py).

#include <cstdint>
#include <cstring>
#include <cstddef>

using u64 = uint64_t;
using u128 = unsigned __int128;

// ---------------------------------------------------------------- Fq -----

struct Fq { u64 l[4]; };

static const Fq P    = {{0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
                         0xb85045b68181585dULL, 0x30644e72e131a029ULL}};
static const u64 N0  = 0x87d20782e4866389ULL;
static const Fq R2   = {{0xf32cfc5b538afa89ULL, 0xb5e71911d44501fbULL,
                         0x47ab1eff0a417ff6ULL, 0x06d89f71cab8351fULL}};
static const Fq MONE = {{0xd35d438dc58f0d9dULL, 0x0a78eb28f5c70b3dULL,
                         0x666ea36f7879462cULL, 0x0e0a77c19a07df2fULL}};
static const Fq ZERO = {{0, 0, 0, 0}};

static inline bool fq_geq(const Fq &a, const Fq &b) {
    for (int i = 3; i >= 0; i--) {
        if (a.l[i] > b.l[i]) return true;
        if (a.l[i] < b.l[i]) return false;
    }
    return true;  // equal
}

static inline bool fq_is_zero(const Fq &a) {
    return (a.l[0] | a.l[1] | a.l[2] | a.l[3]) == 0;
}

static inline bool fq_eq(const Fq &a, const Fq &b) {
    return a.l[0] == b.l[0] && a.l[1] == b.l[1] &&
           a.l[2] == b.l[2] && a.l[3] == b.l[3];
}

static inline Fq fq_sub(const Fq &a, const Fq &b) {
    Fq r;
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a.l[i] - b.l[i] - (u64)borrow;
        r.l[i] = (u64)d;
        borrow = (d >> 64) & 1;  // 1 if borrowed
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < 4; i++) {
            u128 s = (u128)r.l[i] + P.l[i] + (u64)carry;
            r.l[i] = (u64)s;
            carry = s >> 64;
        }
    }
    return r;
}

static inline Fq fq_add(const Fq &a, const Fq &b) {
    Fq r;
    u128 carry = 0;
    for (int i = 0; i < 4; i++) {
        u128 s = (u128)a.l[i] + b.l[i] + (u64)carry;
        r.l[i] = (u64)s;
        carry = s >> 64;
    }
    // p < 2^254 so a+b < 2^255: no limb-4 carry; reduce once if >= p
    if (carry || fq_geq(r, P)) {
        u128 borrow = 0;
        for (int i = 0; i < 4; i++) {
            u128 d = (u128)r.l[i] - P.l[i] - (u64)borrow;
            r.l[i] = (u64)d;
            borrow = (d >> 64) & 1;
        }
    }
    return r;
}

static inline Fq fq_neg(const Fq &a) {
    if (fq_is_zero(a)) return a;
    return fq_sub(ZERO, a);
}

// CIOS Montgomery multiplication; result < p (p is 254-bit so no overflow).
static inline Fq fq_mul(const Fq &a, const Fq &b) {
    u64 t[5] = {0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 cur = (u128)a.l[i] * b.l[j] + t[j] + (u64)carry;
            t[j] = (u64)cur;
            carry = cur >> 64;
        }
        u128 cur4 = (u128)t[4] + (u64)carry;
        u64 t5 = (u64)(cur4 >> 64);
        t[4] = (u64)cur4;

        u64 m = t[0] * N0;
        u128 c2 = ((u128)m * P.l[0] + t[0]) >> 64;
        for (int j = 1; j < 4; j++) {
            u128 cur = (u128)m * P.l[j] + t[j] + (u64)c2;
            t[j - 1] = (u64)cur;
            c2 = cur >> 64;
        }
        u128 cur3 = (u128)t[4] + (u64)c2;
        t[3] = (u64)cur3;
        t[4] = t5 + (u64)(cur3 >> 64);
    }
    Fq r = {{t[0], t[1], t[2], t[3]}};
    if (t[4] || fq_geq(r, P)) {
        u128 borrow = 0;
        for (int i = 0; i < 4; i++) {
            u128 d = (u128)r.l[i] - P.l[i] - (u64)borrow;
            r.l[i] = (u64)d;
            borrow = (d >> 64) & 1;
        }
    }
    return r;
}

static inline Fq fq_to_mont(const Fq &a) { return fq_mul(a, R2); }

static Fq fq_pow_bytes(const Fq &base, const uint8_t *exp, size_t len) {
    Fq result = MONE;
    for (size_t i = 0; i < len; i++) {
        for (int bit = 7; bit >= 0; bit--) {
            result = fq_mul(result, result);
            if ((exp[i] >> bit) & 1) result = fq_mul(result, base);
        }
    }
    return result;
}

// p - 2, big-endian, for Fermat inversion
static const uint8_t P_MINUS_2[32] = {
    0x30, 0x64, 0x4e, 0x72, 0xe1, 0x31, 0xa0, 0x29,
    0xb8, 0x50, 0x45, 0xb6, 0x81, 0x81, 0x58, 0x5d,
    0x97, 0x81, 0x6a, 0x91, 0x68, 0x71, 0xca, 0x8d,
    0x3c, 0x20, 0x8c, 0x16, 0xd8, 0x7c, 0xfd, 0x45};

static inline Fq fq_inv(const Fq &a) {
    return fq_pow_bytes(a, P_MINUS_2, 32);
}

static Fq fq_from_u64(u64 v) {
    Fq r = {{v, 0, 0, 0}};
    return fq_to_mont(r);
}

// --------------------------------------------------------------- Fq12 ----

// Fq[w] / (w^12 - 18 w^6 + 82); coefficients in Montgomery form.
struct Fq12 { Fq c[12]; };

static Fq MC82;   // to_mont(82)
static Fq MC18;   // to_mont(18)
static bool consts_init = false;

static void init_consts() {
    if (consts_init) return;
    MC82 = fq_from_u64(82);
    MC18 = fq_from_u64(18);
    consts_init = true;
}

static Fq12 fq12_zero() { Fq12 r; for (int i = 0; i < 12; i++) r.c[i] = ZERO; return r; }
static Fq12 fq12_one()  { Fq12 r = fq12_zero(); r.c[0] = MONE; return r; }

static inline Fq12 fq12_add(const Fq12 &a, const Fq12 &b) {
    Fq12 r;
    for (int i = 0; i < 12; i++) r.c[i] = fq_add(a.c[i], b.c[i]);
    return r;
}

static inline Fq12 fq12_sub(const Fq12 &a, const Fq12 &b) {
    Fq12 r;
    for (int i = 0; i < 12; i++) r.c[i] = fq_sub(a.c[i], b.c[i]);
    return r;
}

static inline Fq12 fq12_neg(const Fq12 &a) {
    Fq12 r;
    for (int i = 0; i < 12; i++) r.c[i] = fq_neg(a.c[i]);
    return r;
}

static bool fq12_eq(const Fq12 &a, const Fq12 &b) {
    for (int i = 0; i < 12; i++) if (!fq_eq(a.c[i], b.c[i])) return false;
    return true;
}

static Fq12 fq12_mul(const Fq12 &a, const Fq12 &b) {
    Fq tmp[23];
    for (int i = 0; i < 23; i++) tmp[i] = ZERO;
    for (int i = 0; i < 12; i++) {
        if (fq_is_zero(a.c[i])) continue;
        for (int j = 0; j < 12; j++) {
            tmp[i + j] = fq_add(tmp[i + j], fq_mul(a.c[i], b.c[j]));
        }
    }
    // reduce by w^12 = 18 w^6 - 82
    for (int i = 22; i >= 12; i--) {
        Fq top = tmp[i];
        if (fq_is_zero(top)) continue;
        tmp[i] = ZERO;
        tmp[i - 12] = fq_sub(tmp[i - 12], fq_mul(top, MC82));
        tmp[i - 6] = fq_add(tmp[i - 6], fq_mul(top, MC18));
    }
    Fq12 r;
    for (int i = 0; i < 12; i++) r.c[i] = tmp[i];
    return r;
}

static Fq12 fq12_scalar(const Fq12 &a, const Fq &s) {
    Fq12 r;
    for (int i = 0; i < 12; i++) r.c[i] = fq_mul(a.c[i], s);
    return r;
}

// extended Euclid over Fq[x] mod (w^12 - 18 w^6 + 82): port of
// compat/bn254_pairing.py FQP.inv
static int poly_deg(const Fq *p, int len) {
    int d = len - 1;
    while (d > 0 && fq_is_zero(p[d])) d--;
    return d;
}

static Fq12 fq12_inv(const Fq12 &a) {
    const int D = 12;
    Fq lm[D + 1], hm[D + 1], low[D + 1], high[D + 1];
    for (int i = 0; i <= D; i++) {
        lm[i] = ZERO; hm[i] = ZERO; low[i] = ZERO; high[i] = ZERO;
    }
    lm[0] = MONE;
    for (int i = 0; i < D; i++) low[i] = a.c[i];
    // modulus: 82 - 18 w^6 + w^12
    high[0] = MC82;
    high[6] = fq_neg(MC18);
    high[12] = MONE;

    while (poly_deg(low, D + 1) > 0) {
        // r = high div low (rounded poly division)
        Fq temp[D + 1], o[D + 1];
        for (int i = 0; i <= D; i++) { temp[i] = high[i]; o[i] = ZERO; }
        int dega = poly_deg(high, D + 1);
        int degb = poly_deg(low, D + 1);
        Fq binv = fq_inv(low[degb]);
        for (int i = dega - degb; i >= 0; i--) {
            Fq qc = fq_mul(temp[degb + i], binv);
            o[i] = fq_add(o[i], qc);
            for (int c = 0; c <= degb; c++) {
                temp[c + i] = fq_sub(temp[c + i], fq_mul(qc, low[c]));
            }
        }
        int degr = poly_deg(o, D + 1);

        Fq nm[D + 1], nw[D + 1];
        for (int i = 0; i <= D; i++) { nm[i] = hm[i]; nw[i] = high[i]; }
        for (int i = 0; i <= D; i++) {
            for (int j = 0; j + i <= D; j++) {
                if (j > degr) break;
                nm[i + j] = fq_sub(nm[i + j], fq_mul(lm[i], o[j]));
                nw[i + j] = fq_sub(nw[i + j], fq_mul(low[i], o[j]));
            }
        }
        for (int i = 0; i <= D; i++) {
            hm[i] = lm[i]; high[i] = low[i];
            lm[i] = nm[i]; low[i] = nw[i];
        }
    }
    Fq linv = fq_inv(low[0]);
    Fq12 r;
    for (int i = 0; i < D; i++) r.c[i] = fq_mul(lm[i], linv);
    return r;
}

static Fq12 fq12_pow_bytes(const Fq12 &base, const uint8_t *exp, size_t len) {
    Fq12 result = fq12_one();
    bool started = false;
    for (size_t i = 0; i < len; i++) {
        for (int bit = 7; bit >= 0; bit--) {
            if (started) result = fq12_mul(result, result);
            if ((exp[i] >> bit) & 1) {
                result = fq12_mul(result, base);
                started = true;
            }
        }
    }
    return result;
}

// --------------------------------------------------- curve over Fq12 -----

struct Pt { Fq12 x, y; bool inf; };

static Pt pt_double(const Pt &p) {
    if (p.inf) return p;
    // lam = 3 x^2 / (2 y)
    Fq12 x2 = fq12_mul(p.x, p.x);
    Fq12 num = fq12_add(fq12_add(x2, x2), x2);
    Fq12 den = fq12_add(p.y, p.y);
    Fq12 lam = fq12_mul(num, fq12_inv(den));
    Fq12 nx = fq12_sub(fq12_sub(fq12_mul(lam, lam), p.x), p.x);
    Fq12 ny = fq12_sub(fq12_mul(lam, fq12_sub(p.x, nx)), p.y);
    return {nx, ny, false};
}

static Pt pt_add(const Pt &a, const Pt &b) {
    if (a.inf) return b;
    if (b.inf) return a;
    if (fq12_eq(a.x, b.x)) {
        if (fq12_eq(a.y, b.y)) return pt_double(a);
        Pt r; r.inf = true; r.x = fq12_zero(); r.y = fq12_zero(); return r;
    }
    Fq12 lam = fq12_mul(fq12_sub(b.y, a.y), fq12_inv(fq12_sub(b.x, a.x)));
    Fq12 nx = fq12_sub(fq12_sub(fq12_mul(lam, lam), a.x), b.x);
    Fq12 ny = fq12_sub(fq12_mul(lam, fq12_sub(a.x, nx)), a.y);
    return {nx, ny, false};
}

// line through p1, p2 evaluated at t (compat/bn254_pairing.py _linefunc)
static Fq12 linefunc(const Pt &p1, const Pt &p2, const Pt &t) {
    if (!fq12_eq(p1.x, p2.x)) {
        Fq12 m = fq12_mul(fq12_sub(p2.y, p1.y),
                          fq12_inv(fq12_sub(p2.x, p1.x)));
        return fq12_sub(fq12_mul(m, fq12_sub(t.x, p1.x)),
                        fq12_sub(t.y, p1.y));
    }
    if (fq12_eq(p1.y, p2.y)) {
        Fq12 x2 = fq12_mul(p1.x, p1.x);
        Fq12 num = fq12_add(fq12_add(x2, x2), x2);
        Fq12 den = fq12_add(p1.y, p1.y);
        Fq12 m = fq12_mul(num, fq12_inv(den));
        return fq12_sub(fq12_mul(m, fq12_sub(t.x, p1.x)),
                        fq12_sub(t.y, p1.y));
    }
    return fq12_sub(t.x, p1.x);
}

// q, big-endian, for the Frobenius pows
static const uint8_t Q_BE[32] = {
    0x30, 0x64, 0x4e, 0x72, 0xe1, 0x31, 0xa0, 0x29,
    0xb8, 0x50, 0x45, 0xb6, 0x81, 0x81, 0x58, 0x5d,
    0x97, 0x81, 0x6a, 0x91, 0x68, 0x71, 0xca, 0x8d,
    0x3c, 0x20, 0x8c, 0x16, 0xd8, 0x7c, 0xfd, 0x47};

// ate loop count 6u+2 = 29793968203157093288 (65 bits — exceeds u64),
// big-endian bytes
static const uint8_t ATE_LOOP_BE[9] = {0x01, 0x9d, 0x79, 0x70, 0x39,
                                       0xbe, 0x76, 0x3b, 0xa8};
static const int ATE_BITS = 65;

static Fq12 miller_loop(const Pt &q, const Pt &p) {
    if (q.inf || p.inf) return fq12_one();
    Pt r = q;
    Fq12 f = fq12_one();
    // iterate bits below the MSB (bit ATE_BITS-2 down to 0)
    for (int i = ATE_BITS - 2; i >= 0; i--) {
        int byte = 8 - i / 8;
        int bit = (ATE_LOOP_BE[byte] >> (i % 8)) & 1;
        f = fq12_mul(fq12_mul(f, f), linefunc(r, r, p));
        r = pt_double(r);
        if (bit) {
            f = fq12_mul(f, linefunc(r, q, p));
            r = pt_add(r, q);
        }
    }
    Pt q1 = {fq12_pow_bytes(q.x, Q_BE, 32),
             fq12_pow_bytes(q.y, Q_BE, 32), false};
    Pt nq2 = {fq12_pow_bytes(q1.x, Q_BE, 32),
              fq12_neg(fq12_pow_bytes(q1.y, Q_BE, 32)), false};
    f = fq12_mul(f, linefunc(r, q1, p));
    r = pt_add(r, q1);
    f = fq12_mul(f, linefunc(r, nq2, p));
    return f;
}

// (q^12 - 1) / r, big-endian (2790 bits, 349 bytes)
static const uint8_t FINAL_EXP[] = {
0x2f,0x4b,0x6d,0xc9,0x70,0x20,0xfd,0xda,0xdf,0x10,0x7d,0x20,0xbc,0x84,0x2d,
0x43,0xbf,0x63,0x69,0xb1,0xff,0x6a,0x1c,0x71,0x01,0x5f,0x3f,0x7b,0xe2,0xe1,
0xe3,0x0a,0x73,0xbb,0x94,0xfe,0xc0,0xda,0xf1,0x54,0x66,0xb2,0x38,0x3a,0x5d,
0x3e,0xc3,0xd1,0x5a,0xd5,0x24,0xd8,0xf7,0x0c,0x54,0xef,0xee,0x1b,0xd8,0xc3,
0xb2,0x13,0x77,0xe5,0x63,0xa0,0x9a,0x1b,0x70,0x58,0x87,0xe7,0x2e,0xce,0xad,
0xde,0xa3,0x79,0x03,0x64,0xa6,0x1f,0x67,0x6b,0xaa,0xf9,0x77,0x87,0x0e,0x88,
0xd5,0xc6,0xc8,0xfe,0xf0,0x78,0x13,0x61,0xe4,0x43,0xae,0x77,0xf5,0xb6,0x3a,
0x2a,0x22,0x64,0x48,0x7f,0x29,0x40,0xa8,0xb1,0xdd,0xb3,0xd1,0x50,0x62,0xcd,
0x0f,0xb2,0x01,0x5d,0xfc,0x66,0x68,0x44,0x9a,0xed,0x3c,0xc4,0x8a,0x82,0xd0,
0xd6,0x02,0xd2,0x68,0xc7,0xda,0xab,0x6a,0x41,0x29,0x4c,0x0c,0xc4,0xeb,0xe5,
0x66,0x45,0x68,0xdf,0xc5,0x0e,0x16,0x48,0xa4,0x5a,0x4a,0x1e,0x3a,0x51,0x95,
0x84,0x6a,0x3e,0xd0,0x11,0xa3,0x37,0xa0,0x20,0x88,0xec,0x80,0xe0,0xeb,0xae,
0x87,0x55,0xcf,0xe1,0x07,0xac,0xf3,0xaa,0xfb,0x40,0x49,0x4e,0x40,0x6f,0x80,
0x42,0x16,0xbb,0x10,0xcf,0x43,0x0b,0x0f,0x37,0x85,0x6b,0x42,0xdb,0x8d,0xc5,
0x51,0x47,0x24,0xee,0x93,0xdf,0xb1,0x08,0x26,0xf0,0xdd,0x4a,0x03,0x64,0xb9,
0x58,0x02,0x91,0xd2,0xcd,0x65,0x66,0x48,0x14,0xfd,0xe3,0x7c,0xa8,0x0b,0xb4,
0xea,0x44,0xea,0xcc,0x5e,0x64,0x1b,0xba,0xdf,0x42,0x3f,0x9a,0x2c,0xbf,0x81,
0x3b,0x8d,0x14,0x5d,0xa9,0x00,0x29,0xba,0xee,0x7d,0xda,0xdd,0xa7,0x1c,0x7f,
0x38,0x11,0xc4,0x10,0x52,0x62,0x94,0x5b,0xba,0x16,0x68,0xc3,0xbe,0x69,0xa3,
0xc2,0x30,0x97,0x4d,0x83,0x56,0x18,0x41,0xd7,0x66,0xf9,0xc9,0xd5,0x70,0xbb,
0x7f,0xbe,0x04,0xc7,0xe8,0xa6,0xc3,0xc7,0x60,0xc0,0xde,0x81,0xde,0xf3,0x56,
0x92,0xda,0x36,0x11,0x02,0xb6,0xb9,0xb2,0xb9,0x18,0x83,0x7f,0xa9,0x78,0x96,
0xe8,0x4a,0xbb,0x40,0xa4,0xef,0xb7,0xe5,0x45,0x23,0xa4,0x86,0x96,0x4b,0x64,
0xca,0x86,0xf1,0x20};

// ----------------------------------------------------------- embedding ---

static Fq rd_fq(const u64 *w) {
    Fq r = {{w[0], w[1], w[2], w[3]}};
    return fq_to_mont(r);
}

// G1 (x, y) canonical -> E(Fq12)
static Pt embed_g1(const u64 *xy, bool inf) {
    Pt r;
    r.inf = inf;
    r.x = fq12_zero(); r.y = fq12_zero();
    if (!inf) { r.x.c[0] = rd_fq(xy); r.y.c[0] = rd_fq(xy + 4); }
    return r;
}

// G2 ((x0,x1),(y0,y1)) canonical -> untwisted E(Fq12):
// c0 + c1*i with i = w^6 - 9 embeds as (c0 - 9 c1) + c1 w^6, then x *= w^2,
// y *= w^3 (compat/bn254_pairing.py _twist_to_fq12)
static Fq12 embed_fq2(const u64 *c0c1, int wshift) {
    init_consts();
    Fq c0 = rd_fq(c0c1), c1 = rd_fq(c0c1 + 4);
    Fq nine = fq_from_u64(9);
    Fq a0 = fq_sub(c0, fq_mul(nine, c1));
    Fq12 r = fq12_zero();
    r.c[wshift] = a0;
    r.c[6 + wshift] = c1;
    return r;
}

static Pt embed_g2(const u64 *xyxy, bool inf) {
    Pt r;
    r.inf = inf;
    r.x = fq12_zero(); r.y = fq12_zero();
    if (!inf) {
        r.x = embed_fq2(xyxy, 2);
        r.y = embed_fq2(xyxy + 8, 3);
    }
    return r;
}

extern "C" {

// g1: n * 8 u64 words (x then y, 4 LE words each, canonical form)
// g2: n * 16 u64 words (x0, x1, y0, y1)
// inf: n bytes; nonzero -> skip pair (point at infinity)
// returns 1 iff prod e(P_i, Q_i) == 1
int bn254_pairing_check(const u64 *g1, const u64 *g2,
                        const uint8_t *inf, size_t n) {
    init_consts();
    Fq12 f = fq12_one();
    for (size_t i = 0; i < n; i++) {
        if (inf && inf[i]) continue;
        Pt p = embed_g1(g1 + 8 * i, false);
        Pt q = embed_g2(g2 + 16 * i, false);
        f = fq12_mul(f, miller_loop(q, p));
    }
    Fq12 e = fq12_pow_bytes(f, FINAL_EXP, sizeof(FINAL_EXP));
    return fq12_eq(e, fq12_one()) ? 1 : 0;
}

// single pairing, canonical Fq12 coefficient output (for tests):
// out = 12 * 4 u64 words
void bn254_pairing(const u64 *g1, const u64 *g2, u64 *out) {
    init_consts();
    Pt p = embed_g1(g1, false);
    Pt q = embed_g2(g2, false);
    Fq12 f = miller_loop(q, p);
    Fq12 e = fq12_pow_bytes(f, FINAL_EXP, sizeof(FINAL_EXP));
    // convert out of Montgomery form
    for (int i = 0; i < 12; i++) {
        Fq one_raw = {{1, 0, 0, 0}};
        Fq v = fq_mul(e.c[i], one_raw);
        for (int j = 0; j < 4; j++) out[4 * i + j] = v.l[j];
    }
}

// -------------------------------------------------- debug/test hooks -----

static Fq12 rd_fq12(const u64 *w) {
    Fq12 r;
    for (int i = 0; i < 12; i++) r.c[i] = rd_fq(w + 4 * i);
    return r;
}

static void wr_fq12(const Fq12 &e, u64 *out) {
    Fq one_raw = {{1, 0, 0, 0}};
    for (int i = 0; i < 12; i++) {
        Fq v = fq_mul(e.c[i], one_raw);
        for (int j = 0; j < 4; j++) out[4 * i + j] = v.l[j];
    }
}

void fq12_mul_dbg(const u64 *a, const u64 *b, u64 *out) {
    init_consts();
    wr_fq12(fq12_mul(rd_fq12(a), rd_fq12(b)), out);
}

void fq12_inv_dbg(const u64 *a, u64 *out) {
    init_consts();
    wr_fq12(fq12_inv(rd_fq12(a)), out);
}

void fq12_pow_q_dbg(const u64 *a, u64 *out) {
    init_consts();
    wr_fq12(fq12_pow_bytes(rd_fq12(a), Q_BE, 32), out);
}

// Miller loop only (no final exp), canonical in/out
void miller_dbg(const u64 *g1, const u64 *g2, u64 *out) {
    init_consts();
    Pt p = embed_g1(g1, false);
    Pt q = embed_g2(g2, false);
    wr_fq12(miller_loop(q, p), out);
}

// ------------------------------------------------------------- keccak ----

static const u64 KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int KECCAK_ROT[5][5] = {
    {0, 36, 3, 41, 18}, {1, 44, 10, 45, 2}, {62, 6, 43, 15, 61},
    {28, 55, 25, 21, 56}, {27, 20, 39, 8, 14}};

static inline u64 rotl64(u64 x, int n) {
    return n == 0 ? x : (x << n) | (x >> (64 - n));
}

static void keccak_f(u64 st[25]) {  // st[x + 5*y]
    for (int round = 0; round < 24; round++) {
        u64 c[5], d[5];
        for (int x = 0; x < 5; x++)
            c[x] = st[x] ^ st[x + 5] ^ st[x + 10] ^ st[x + 15] ^ st[x + 20];
        for (int x = 0; x < 5; x++)
            d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++) st[x + 5 * y] ^= d[x];
        u64 b[25];
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                b[y + 5 * ((2 * x + 3 * y) % 5)] =
                    rotl64(st[x + 5 * y], KECCAK_ROT[x][y]);
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                st[x + 5 * y] = b[x + 5 * y] ^
                    ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]);
        st[0] ^= KECCAK_RC[round];
    }
}

// Keccak-256 (original 0x01 padding, rate 136)
void keccak256(const uint8_t *data, size_t len, uint8_t out[32]) {
    u64 st[25];
    memset(st, 0, sizeof(st));
    const size_t rate = 136;
    size_t off = 0;
    while (len - off >= rate) {
        for (size_t i = 0; i < rate / 8; i++) {
            u64 w;
            memcpy(&w, data + off + 8 * i, 8);
            st[i] ^= w;
        }
        keccak_f(st);
        off += rate;
    }
    uint8_t block[136];
    memset(block, 0, rate);
    memcpy(block, data + off, len - off);
    block[len - off] = 0x01;
    block[rate - 1] |= 0x80;
    for (size_t i = 0; i < rate / 8; i++) {
        u64 w;
        memcpy(&w, block + 8 * i, 8);
        st[i] ^= w;
    }
    keccak_f(st);
    memcpy(out, st, 32);
}

}  // extern "C"
