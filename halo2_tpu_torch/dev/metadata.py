"""Display metadata for dev diagnostics (port of the JAX reference's
dev/metadata.py) — the halo2_frontend
`dev/metadata.rs:50-230` wrappers: small value types that render failure
locations (which gate, which constraint, which region, which cell) the way
the reference's failure emitter does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class Gate:
    """metadata::Gate — index + name of a gate in the constraint system."""
    index: int
    name: str

    def __str__(self):
        return f"Gate {self.index} ('{self.name}')"


@dataclass(frozen=True)
class Constraint:
    """metadata::Constraint — a polynomial inside a gate."""
    gate: Gate
    index: int
    name: str

    def __str__(self):
        label = f" ('{self.name}')" if self.name else ""
        return f"Constraint {self.index}{label} in {self.gate}"


@dataclass(frozen=True)
class Region:
    """metadata::Region — index + name of a synthesis region."""
    index: int
    name: str

    def __str__(self):
        return f"Region {self.index} ('{self.name}')"


@dataclass(frozen=True)
class InRegion:
    """FailureLocation::InRegion (dev/failure.rs:23-40): region plus the
    offset of the failing row relative to the region's start.  Proxies
    `.name`/`.index` to the region for callers that treat the location as
    a region."""
    region: "Region"
    offset: int

    @property
    def name(self):
        return self.region.name

    @property
    def index(self):
        return self.region.index

    def __str__(self):
        return f"in {self.region} at offset {self.offset}"


@dataclass(frozen=True)
class OutsideRegion:
    """FailureLocation::OutsideRegion."""
    row: int

    def __str__(self):
        return f"outside any region, on row {self.row}"


@dataclass(frozen=True)
class VirtualCell:
    """metadata::VirtualCell — a (column, rotation) reference inside a
    constraint, rendered with the queried column kind."""
    column_kind: str
    column_index: int
    rotation: int

    def __str__(self):
        return (f"{self.column_kind}[{self.column_index}]"
                f"@{self.rotation:+d}" if self.rotation else
                f"{self.column_kind}[{self.column_index}]")
