"""Backend error taxonomy, mirroring halo2_backend/src/plonk/error.rs:9-31.

`VerifyError` is the umbrella for "this proof is invalid" conditions — the
only class `api.verify()` converts to `False`.  Anything else (including
AssertionError from internal invariants) propagates: an internal bug must
never masquerade as an invalid proof.
"""

from __future__ import annotations


class Error(Exception):
    """Base backend error (plonk/error.rs Error)."""


class VerifyError(Error):
    """Proof rejected: malformed transcript bytes, bad point/scalar
    encodings, or a failed final check (Error::Opening / Transcript)."""


class InvalidInstances(VerifyError):
    """Provided instances do not match the circuit (error.rs InvalidInstances)."""


class InstanceTooLarge(VerifyError):
    """An instance column exceeds usable rows (error.rs InstanceTooLarge)."""


class TranscriptError(VerifyError):
    """Malformed proof byte stream (error.rs Transcript(io::Error))."""


class OpeningError(VerifyError):
    """Multiopen check failed (error.rs Opening)."""


class BoundsFailure(Error):
    """Out-of-bounds index access (error.rs BoundsFailure)."""


class ConstraintSystemFailure(Error):
    """The constraint system is not satisfied (error.rs
    ConstraintSystemFailure)."""


class ColumnNotInPermutation(Error):
    """Column not included in the permutation argument
    (error.rs ColumnNotInPermutation)."""
