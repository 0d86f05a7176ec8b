"""The reader of the column encoder's native share: the mean over the
proofs of the program's `encode_native` over that of `encode_wide`, and
None where a proof's record lacks either, as the record of a program
without the native pass does, or where no element took the 32-byte
path."""

from __future__ import annotations

import pytest

from benchmark.harness import Readings
from benchmark.metrics import encode_native_share

# two proofs' records: 100 wide elements a proof, 75 of them native on
# average
RECORDS = [
    {"encode_narrow": 300, "encode_wide": 100, "encode_native": 50,
     "kernel_launches": 1000},
    {"encode_narrow": 500, "encode_wide": 100, "encode_native": 100,
     "kernel_launches": 1000},
]


def test_reads_the_share_of_the_mean_over_the_proofs():
    assert encode_native_share.read(Readings(steps=RECORDS)) == \
        pytest.approx(75.0)


def test_all_native_reads_a_hundred():
    steps = [dict(s, encode_native=s["encode_wide"]) for s in RECORDS]
    assert encode_native_share.read(Readings(steps=steps)) == \
        pytest.approx(100.0)


@pytest.mark.parametrize("key", ["encode_native", "encode_wide"])
def test_finds_nothing_where_a_record_lacks_its_key(key):
    short = [dict(RECORDS[0]), RECORDS[1]]
    del short[0][key]
    assert encode_native_share.read(Readings(steps=short)) is None
    assert encode_native_share.read(Readings()) is None


def test_no_share_of_no_wide_element():
    steps = [dict(s, encode_wide=0, encode_native=0) for s in RECORDS]
    assert encode_native_share.read(Readings(steps=steps)) is None
