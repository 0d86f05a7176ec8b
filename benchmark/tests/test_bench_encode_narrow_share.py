"""The reader of the column encoder's narrow share: the mean over the
proofs of the program's `encode_narrow` and `encode_wide` counters, and
None where a proof's record lacks either, as the record of a program
without these counters does, or where nothing was encoded."""

from __future__ import annotations

import pytest

from benchmark.harness import Readings
from benchmark.metrics import encode_narrow_share

# two proofs' records: 400 narrow and 100 wide elements a proof on average
RECORDS = [
    {"encode_narrow": 300, "encode_wide": 100, "kernel_launches": 1000},
    {"encode_narrow": 500, "encode_wide": 100, "kernel_launches": 1000},
]


def test_reads_the_share_of_the_mean_over_the_proofs():
    assert encode_narrow_share.read(Readings(steps=RECORDS)) == \
        pytest.approx(80.0)


@pytest.mark.parametrize("key", ["encode_narrow", "encode_wide"])
def test_finds_nothing_where_a_record_lacks_its_key(key):
    short = [dict(RECORDS[0]), RECORDS[1]]
    del short[0][key]
    assert encode_narrow_share.read(Readings(steps=short)) is None
    assert encode_narrow_share.read(Readings()) is None


def test_no_share_of_nothing_encoded():
    steps = [dict(s, encode_narrow=0, encode_wide=0) for s in RECORDS]
    assert encode_narrow_share.read(Readings(steps=steps)) is None


def test_all_narrow_reads_a_hundred():
    steps = [dict(s, encode_wide=0) for s in RECORDS]
    assert encode_narrow_share.read(Readings(steps=steps)) == \
        pytest.approx(100.0)
