// Column encoder of fields/field.py: a list of python ints -> the
// little-endian u32 words of each value, reduced into [0, p) by
// conditional subtraction where a modulus is given.  One pass, no Python
// object made, no exception raised: a value that is not an int, is
// negative or is >= 2^256 ends the pass with a failure code, and the
// caller serializes that list in Python instead.
//
// Called through ctypes.PyDLL, so with the interpreter lock held, on one
// thread.  On CPython 3.12 and 3.13 with 30-bit digits it reads an int's
// digits directly (the layout of cpython/longintrepr.h there); elsewhere,
// or built with -DH2_ENCODE_API, through _PyLong_AsByteArray (before 3.13)
// or PyLong_AsNativeBytes (3.13 on).
// Build: g++ -O3 -shared -fPIC -I<python include> (driven by native/__init__.py).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "words are written as little-endian limbs");

using u64 = uint64_t;
using u128 = unsigned __int128;

#if !defined(H2_ENCODE_API) && PY_VERSION_HEX >= 0x030C0000 && \
    PY_VERSION_HEX < 0x030E0000 && PYLONG_BITS_IN_DIGIT == 30
#define H2_ENCODE_DIGITS 1
#endif

// The most subtractions of p a value below 2^256 may need: 2^256 < 16 p for
// every modulus of the port (p > 2^252); a smaller p fails the pass.
static const int MAX_SUBTRACTIONS = 16;

// v (an int) as four little-endian 64-bit limbs; false where v < 0 or
// v >= 2^256.
static inline bool read_u256(PyObject *v, u64 out[4]) {
#ifdef H2_ENCODE_DIGITS
    const PyLongObject *o = reinterpret_cast<const PyLongObject *>(v);
    uintptr_t tag = o->long_value.lv_tag;
    if ((tag & _PyLong_SIGN_MASK) == 2) return false;        // negative
    size_t nd = tag >> _PyLong_NON_SIZE_BITS;
    const digit *d = o->long_value.ob_digit;
    if (nd > 9 || (nd == 9 && (d[8] >> 16))) return false;    // >= 2^256
    u64 l[5] = {0, 0, 0, 0, 0};
    for (size_t i = 0; i < nd; i++) {
        unsigned bit = 30 * (unsigned)i, w = bit >> 6, s = bit & 63;
        l[w] |= (u64)d[i] << s;
        if (s > 34) l[w + 1] |= (u64)d[i] >> (64 - s);
    }
    std::memcpy(out, l, 32);
    return true;
#elif PY_VERSION_HEX >= 0x030D0000
    Py_ssize_t need = PyLong_AsNativeBytes(
        v, out, 32,
        Py_ASNATIVEBYTES_LITTLE_ENDIAN | Py_ASNATIVEBYTES_UNSIGNED_BUFFER |
            Py_ASNATIVEBYTES_REJECT_NEGATIVE);
    if (need < 0) {
        PyErr_Clear();
        return false;
    }
    return need <= 32;
#else
    if (_PyLong_Sign(v) < 0) return false;
    size_t bits = _PyLong_NumBits(v);
    if (bits == (size_t)-1) {
        PyErr_Clear();
        return false;
    }
    if (bits > 256) return false;
    if (_PyLong_AsByteArray(reinterpret_cast<PyLongObject *>(v),
                            reinterpret_cast<unsigned char *>(out), 32,
                            /*little_endian=*/1, /*is_signed=*/0) < 0) {
        PyErr_Clear();
        return false;
    }
    return true;
#endif
}

static inline bool geq(const u64 a[4], const u64 b[4]) {
    for (int i = 3; i >= 0; i--)
        if (a[i] != b[i]) return a[i] > b[i];
    return true;
}

static inline void sub(u64 a[4], const u64 b[4]) {
    u64 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a[i] - b[i] - borrow;
        a[i] = (u64)d;
        borrow = (u64)(d >> 64) & 1;
    }
}

extern "C" {

// The first `rows` items of the list `vals` as (rows, 8) int32 words at
// `out`, each reduced mod the four-limb `p` unless p is null.  0 when
// every item was written; -1, with `out` partly written, at the first item
// that is not an int in [0, 2^256), or where `vals` is not a list of at
// least `rows` items.
int h2_encode_words(PyObject *vals, Py_ssize_t rows, int32_t *out,
                    const u64 *p) {
    if (!PyList_Check(vals) || rows < 0 || PyList_GET_SIZE(vals) < rows)
        return -1;
    for (Py_ssize_t i = 0; i < rows; i++) {
        PyObject *v = PyList_GET_ITEM(vals, i);
        u64 l[4];
        if (!PyLong_Check(v) || !read_u256(v, l)) return -1;
        if (p) {
            int k = 0;
            while (geq(l, p)) {
                if (++k > MAX_SUBTRACTIONS) return -1;
                sub(l, p);
            }
        }
        std::memcpy(out + 8 * i, l, 32);
    }
    return 0;
}

}  // extern "C"
