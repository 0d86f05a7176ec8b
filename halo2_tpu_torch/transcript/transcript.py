"""Fiat-Shamir transcripts, byte for byte the reference's (the JAX
reference's transcript/transcript.py, itself a mirror of
halo2_backend/src/transcript.rs): Blake2b, and Keccak256 for EVM
verifiers.  Host-side: scalars and point coordinates travel as canonical
python ints."""

from __future__ import annotations

import hashlib

from ..plonk.errors import TranscriptError
from .keccak import Keccak256

BLAKE2B_PREFIX_CHALLENGE = b"\x00"   # transcript.rs:15
BLAKE2B_PREFIX_POINT = b"\x01"       # transcript.rs:18
BLAKE2B_PREFIX_SCALAR = b"\x02"      # transcript.rs:21
KECCAK256_PREFIX_CHALLENGE = b"\x00"
KECCAK256_PREFIX_CHALLENGE_LO = b"\x0a"
KECCAK256_PREFIX_CHALLENGE_HI = b"\x0b"
KECCAK256_PREFIX_POINT = b"\x01"
KECCAK256_PREFIX_SCALAR = b"\x02"


class _TranscriptBase:
    """The protocol over a hash state that a mixin provides (`_init_state`,
    `_absorb`, the two prefixes and `_squeeze_bytes`)."""

    def __init__(self, curve):
        self.curve = curve
        self.Fq = curve.Fq
        self.Fr = curve.Fr
        self._init_state()

    def squeeze_challenge(self) -> int:
        """Challenge255 (transcript.rs:218-223,508-540)."""
        return self.Fr.from_uniform_bytes(self._squeeze_bytes())

    def common_point(self, pt):
        """Absorb an affine point; the identity is rejected
        (transcript.rs:225-237)."""
        if pt is None:
            raise ValueError("cannot write points at infinity to the "
                             "transcript")
        x, y = pt
        self._absorb(self.PREFIX_POINT)
        self._absorb(self.Fq.to_repr(x))
        self._absorb(self.Fq.to_repr(y))

    def common_scalar(self, s: int):
        self._absorb(self.PREFIX_SCALAR)
        self._absorb(self.Fr.to_repr(s))


class _Blake2bMixin:
    PREFIX_POINT = BLAKE2B_PREFIX_POINT
    PREFIX_SCALAR = BLAKE2B_PREFIX_SCALAR

    def _init_state(self):
        self._state = hashlib.blake2b(digest_size=64,
                                      person=b"Halo2-Transcript")

    def _absorb(self, data: bytes):
        self._state.update(data)

    def _squeeze_bytes(self) -> bytes:
        """Absorb the challenge prefix, hash a copy (transcript.rs:
        218-222)."""
        self._state.update(BLAKE2B_PREFIX_CHALLENGE)
        return self._state.copy().digest()


class _KeccakMixin:
    PREFIX_POINT = KECCAK256_PREFIX_POINT
    PREFIX_SCALAR = KECCAK256_PREFIX_SCALAR

    def _init_state(self):
        self._state = Keccak256()
        self._state.update(b"Halo2-Transcript")   # transcript.rs:141-143

    def _absorb(self, data: bytes):
        self._state.update(data)

    def _squeeze_bytes(self) -> bytes:
        """The lo and hi digests of two copies; their prefixes stay out of
        the growing state (transcript.rs:252-267)."""
        self._state.update(KECCAK256_PREFIX_CHALLENGE)
        lo = self._state.copy().update(KECCAK256_PREFIX_CHALLENGE_LO)
        hi = self._state.copy().update(KECCAK256_PREFIX_CHALLENGE_HI)
        return lo.digest() + hi.digest()


class _WriteBase(_TranscriptBase):
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


class _ReadBase(_TranscriptBase):
    """Verifier side: reads from the proof stream into the hash state."""

    def __init__(self, curve, proof: bytes):
        super().__init__(curve)
        self._proof = proof
        self._pos = 0

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._proof):
            raise TranscriptError("proof stream exhausted")
        out = self._proof[self._pos: self._pos + n]
        self._pos += n
        return out

    def read_point(self):
        try:
            pt = self.curve.point_from_bytes(self._take(32))
        except ValueError as e:
            raise TranscriptError(
                f"invalid point encoding in proof: {e}")
        self.common_point(pt)
        return pt

    def read_scalar(self) -> int:
        try:
            s = self.Fr.from_repr(self._take(32))
        except ValueError as e:
            raise TranscriptError(
                f"invalid field element in proof: {e}")
        self.common_scalar(s)
        return s

    def read_n_points(self, n: int):
        return [self.read_point() for _ in range(n)]

    def read_n_scalars(self, n: int):
        return [self.read_scalar() for _ in range(n)]


class Blake2bWrite(_Blake2bMixin, _WriteBase):
    pass


class Blake2bRead(_Blake2bMixin, _ReadBase):
    pass


class Keccak256Write(_KeccakMixin, _WriteBase):
    pass


class Keccak256Read(_KeccakMixin, _ReadBase):
    pass
