"""Keccak-256 as the EVM and sha3::Keccak256 compute it: the sponge over
Keccak-f[1600] at rate 136 bytes, with the original Keccak padding 0x01
... 0x80 (hashlib's sha3_256 pads with 0x06 and gives other digests)."""

from __future__ import annotations

RATE = 136
_MASK = (1 << 64) - 1
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]


def _rho_pi():
    """For lane i = x + 5 y: its rotation and the lane B it lands in, B[y,
    2x + 3y] = rot(A[x, y]), the offsets from the (x, y) walk of the
    Keccak reference."""
    rot = [0] * 25
    x, y = 1, 0
    for t in range(24):
        rot[x + 5 * y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    dest = [0] * 25
    for x in range(5):
        for y in range(5):
            dest[x + 5 * y] = y + 5 * ((2 * x + 3 * y) % 5)
    return rot, dest


_ROT, _DEST = _rho_pi()


def keccak_f(a: list) -> list:
    """Keccak-f[1600] on 25 lanes, lane x + 5 y, little-endian words."""
    for rc in _RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ (((c[(x + 1) % 5] << 1)
                                | (c[(x + 1) % 5] >> 63)) & _MASK)
             for x in range(5)]
        b = [0] * 25
        for i in range(25):
            v = a[i] ^ d[i % 5]
            r = _ROT[i]
            b[_DEST[i]] = ((v << r) | (v >> (64 - r))) & _MASK if r else v
        a = [b[i] ^ (~b[(i % 5 + 1) % 5 + 5 * (i // 5)]
                     & b[(i % 5 + 2) % 5 + 5 * (i // 5)]) for i in range(25)]
        a[0] ^= rc
    return a


class Keccak256:
    """Incremental Keccak-256: update, copy, digest (which leaves the
    state as it is)."""

    def __init__(self):
        self._lanes = [0] * 25
        self._buf = b""

    def copy(self) -> "Keccak256":
        other = Keccak256()
        other._lanes = list(self._lanes)
        other._buf = self._buf
        return other

    def _absorb_block(self, block: bytes):
        for i in range(RATE // 8):
            self._lanes[i] ^= int.from_bytes(block[8 * i:8 * i + 8],
                                             "little")
        self._lanes = keccak_f(self._lanes)

    def update(self, data: bytes) -> "Keccak256":
        buf = self._buf + bytes(data)
        full = len(buf) - len(buf) % RATE
        for off in range(0, full, RATE):
            self._absorb_block(buf[off:off + RATE])
        self._buf = buf[full:]
        return self

    def digest(self) -> bytes:
        last = bytearray(self._buf) + bytearray(RATE - len(self._buf))
        last[len(self._buf)] ^= 0x01
        last[RATE - 1] ^= 0x80
        tail = self.copy()
        tail._absorb_block(bytes(last))
        return b"".join(v.to_bytes(8, "little") for v in tail._lanes[:4])


def keccak256(data: bytes) -> bytes:
    return Keccak256().update(data).digest()
