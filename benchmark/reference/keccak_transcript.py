"""halo2's Keccak256 transcript, the verifier's side (halo2 transcript.rs:
135-151, 247-289), for proofs an EVM contract verifies: a Keccak-256 state
that starts with b"Halo2-Transcript"; points and scalars are absorbed as
in the Blake2b transcript (0x01 and the coordinates, 0x02 and the bytes);
a challenge absorbs 0x00, then hashes two copies of the state, one with
0x0a (lo) and one with 0x0b (hi) appended, and reads lo || hi as a 512-bit
little-endian integer modulo the scalar field's order."""

from __future__ import annotations

from .curve import Curve
from .keccak import Keccak256
from .transcript import Blake2bRead


class Keccak256Read(Blake2bRead):
    def __init__(self, curve: Curve, proof: bytes):
        super().__init__(curve, proof)
        self._state = Keccak256().update(b"Halo2-Transcript")

    def squeeze_challenge(self) -> int:
        self._state.update(b"\x00")
        lo = self._state.copy().update(b"\x0a").digest()
        hi = self._state.copy().update(b"\x0b").digest()
        return int.from_bytes(lo + hi, "little") % self.curve.r
