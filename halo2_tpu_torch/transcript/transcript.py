"""Blake2b Fiat-Shamir transcripts, byte for byte the reference's
(halo2_tpu/transcript/transcript.py, itself a mirror of
halo2_backend/src/transcript.rs).  Host-side: scalars and point coordinates
travel as canonical python ints."""

from __future__ import annotations

import hashlib

BLAKE2B_PREFIX_CHALLENGE = b"\x00"
BLAKE2B_PREFIX_POINT = b"\x01"
BLAKE2B_PREFIX_SCALAR = b"\x02"


class _Blake2bBase:
    def __init__(self, curve):
        self.curve = curve
        self.Fq = curve.Fq
        self.Fr = curve.Fr
        self._state = hashlib.blake2b(digest_size=64,
                                      person=b"Halo2-Transcript")

    def squeeze_challenge(self) -> int:
        """Challenge255: absorb the challenge prefix, hash a copy."""
        self._state.update(BLAKE2B_PREFIX_CHALLENGE)
        return self.Fr.from_uniform_bytes(self._state.copy().digest())

    def common_point(self, pt):
        if pt is None:
            raise ValueError("cannot write points at infinity to the "
                             "transcript")
        x, y = pt
        self._state.update(BLAKE2B_PREFIX_POINT)
        self._state.update(self.Fq.to_repr(x))
        self._state.update(self.Fq.to_repr(y))

    def common_scalar(self, s: int):
        self._state.update(BLAKE2B_PREFIX_SCALAR)
        self._state.update(self.Fr.to_repr(s))


class Blake2bWrite(_Blake2bBase):
    """Prover side: writes to the proof stream and the hash state."""

    def __init__(self, curve):
        super().__init__(curve)
        self._proof = bytearray()

    def write_point(self, pt):
        self.common_point(pt)
        self._proof += self.curve.point_to_bytes(pt)

    def write_scalar(self, s: int):
        self.common_scalar(s)
        self._proof += self.Fr.to_repr(s)

    def finalize(self) -> bytes:
        return bytes(self._proof)


class Blake2bRead(_Blake2bBase):
    """Verifier side: reads from the proof stream into the hash state."""

    def __init__(self, curve, proof: bytes):
        super().__init__(curve)
        self._proof = proof
        self._pos = 0

    def _take(self, n: int) -> bytes:
        from .._shared import errors
        if self._pos + n > len(self._proof):
            raise errors().TranscriptError("proof stream exhausted")
        out = self._proof[self._pos: self._pos + n]
        self._pos += n
        return out

    def read_point(self):
        from .._shared import errors
        try:
            pt = self.curve.point_from_bytes(self._take(32))
        except ValueError as e:
            raise errors().TranscriptError(
                f"invalid point encoding in proof: {e}")
        self.common_point(pt)
        return pt

    def read_scalar(self) -> int:
        from .._shared import errors
        try:
            s = self.Fr.from_repr(self._take(32))
        except ValueError as e:
            raise errors().TranscriptError(
                f"invalid field element in proof: {e}")
        self.common_scalar(s)
        return s
