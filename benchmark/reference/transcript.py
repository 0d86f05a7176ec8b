"""halo2's Blake2b transcript, the verifier's side (halo2 transcript.rs):
a Blake2b-512 state personalised "Halo2-Transcript"; a point is absorbed
as 0x01 and its coordinates, a scalar as 0x02 and its bytes, both
little-endian; a challenge absorbs 0x00 and is the digest of a copy of the
state, read as a 512-bit little-endian integer modulo the scalar field's
order."""

from __future__ import annotations

import hashlib

from .curve import Curve


class TranscriptError(ValueError):
    """The proof's bytes end early or encode no point or scalar."""


class Blake2bRead:
    def __init__(self, curve: Curve, proof: bytes):
        self.curve = curve
        self._state = hashlib.blake2b(digest_size=64,
                                      person=b"Halo2-Transcript")
        self._proof = proof
        self._pos = 0

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._proof):
            raise TranscriptError("the proof ends early")
        out = self._proof[self._pos:self._pos + n]
        self._pos += n
        return out

    def at_end(self) -> bool:
        return self._pos == len(self._proof)

    def squeeze_challenge(self) -> int:
        self._state.update(b"\x00")
        return int.from_bytes(self._state.copy().digest(),
                              "little") % self.curve.r

    def common_point(self, pt):
        if pt is None:
            raise TranscriptError("the identity cannot enter a transcript")
        self._state.update(b"\x01")
        self._state.update(pt[0].to_bytes(32, "little"))
        self._state.update(pt[1].to_bytes(32, "little"))

    def common_scalar(self, s: int):
        self._state.update(b"\x02")
        self._state.update((s % self.curve.r).to_bytes(32, "little"))

    def read_point(self):
        try:
            pt = self.curve.point_from_bytes(self._take(32))
        except ValueError as e:
            raise TranscriptError(str(e)) from None
        self.common_point(pt)
        return pt

    def read_scalar(self) -> int:
        s = int.from_bytes(self._take(32), "little")
        if s >= self.curve.r:
            raise TranscriptError("a scalar is not canonical")
        self.common_scalar(s)
        return s
