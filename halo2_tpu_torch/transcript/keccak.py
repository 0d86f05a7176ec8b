"""Keccak-256 with the original Keccak padding 0x01 (not SHA3's 0x06), as
sha3::Keccak256 computes it for the EVM transcript (port of the JAX
reference's transcript/keccak.py; transcript.rs:24-38).  Python's hashlib
ships only SHA3, so the sponge (keccak-f[1600], rate 136) is written out
here; when the native host library builds, the message is buffered and
hashed in one native call instead (transcripts are a few KB).
"""

from __future__ import annotations

from .. import native

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROTC = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK = (1 << 64) - 1


def _rotl(x, n):
    return ((x << n) | (x >> (64 - n))) & _MASK


def _keccak_f(state):
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [state[x][0] ^ state[x][1] ^ state[x][2] ^ state[x][3]
             ^ state[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[x][y] ^= d[x]
        # rho and pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(state[x][y], _ROTC[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                state[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y])
                                         & b[(x + 2) % 5][y]) & _MASK
        # iota
        state[0][0] ^= rc
    return state


class Keccak256:
    """Incremental Keccak-256 with copy(), like sha3::Keccak256.

    With the native library, update() buffers the whole message and
    digest() hashes it in one native call; otherwise the pure-Python
    sponge absorbs as data arrives.  copy() copies the buffer or the
    sponge state, so a copy and its source diverge freely."""

    RATE = 136

    def __init__(self):
        self._state = [[0] * 5 for _ in range(5)]
        self._buf = b""
        self._native = native if native.get_lib() else None
        self._data = b"" if self._native else None

    def copy(self) -> "Keccak256":
        k = Keccak256.__new__(Keccak256)
        k._state = [row[:] for row in self._state]
        k._buf = self._buf
        k._native = self._native
        k._data = self._data
        return k

    def update(self, data: bytes) -> "Keccak256":
        if self._native is not None:
            self._data += bytes(data)
            return self
        self._buf += bytes(data)
        while len(self._buf) >= self.RATE:
            self._absorb(self._buf[: self.RATE])
            self._buf = self._buf[self.RATE:]
        return self

    def _absorb(self, block: bytes):
        for i in range(self.RATE // 8):
            lane = int.from_bytes(block[8 * i: 8 * i + 8], "little")
            self._state[i % 5][i // 5] ^= lane
        self._state = _keccak_f(self._state)

    def digest(self) -> bytes:
        if self._native is not None:
            return self._native.keccak256(self._data)
        pad_len = self.RATE - len(self._buf)
        if pad_len == 1:
            pad = b"\x81"
        else:
            pad = b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
        # absorb the padded final block(s) into a clone, leaving self as is
        clone = self.copy()
        clone._buf = b""
        data = self._buf + pad
        for off in range(0, len(data), self.RATE):
            clone._absorb(data[off: off + self.RATE])
        return b"".join(clone._state[i % 5][i // 5].to_bytes(8, "little")
                        for i in range(4))
