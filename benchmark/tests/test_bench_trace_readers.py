"""The readers of the program's record (`create_proof(timings=)`): each
returns its value, the mean over the proofs, from a synthetic `Readings`,
and None where a proof's record lacks a key it reads, as the record of a
program without these spans and counters does."""

from __future__ import annotations

import importlib

import pytest

from benchmark.harness import Readings

# two proofs' records: each reader's keys, and what it must read from them
RECORDS = [
    {"synthesis [T3-4]": 1.0, "blind [T3-4]": 0.25, "encode [T3-4]": 1.5,
     "set [T3-4]": 0.25, "msms [T3-4]": 0.25, "normalize+write [T3-4]": 0.5,
     "kernel_launches": 1000, "host_wait": 0.5, "msm_streamed": 400,
     "msm_added": 100},
    {"synthesis [T3-4]": 3.0, "blind [T3-4]": 0.75, "encode [T3-4]": 2.5,
     "set [T3-4]": 0.75, "msms [T3-4]": 0.75, "normalize+write [T3-4]": 0.5,
     "kernel_launches": 1000, "host_wait": 1.5, "msm_streamed": 400,
     "msm_added": 300},
]
READS = {
    "synthesis_s": (["synthesis [T3-4]"], 2.0),
    "encode_s": (["blind [T3-4]", "encode [T3-4]", "set [T3-4]"], 3.0),
    "advice_commit_s": (["msms [T3-4]", "normalize+write [T3-4]"], 1.0),
    "kernel_launches": (["kernel_launches"], 1000.0),
    "host_wait_s": (["host_wait"], 1.0),
    "msm_nonzero_share": (["msm_streamed", "msm_added"], 50.0),
}


def _reader(name: str):
    return importlib.import_module(f"benchmark.metrics.{name}")


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_reads_the_mean_over_the_proofs(name):
    assert _reader(name).read(Readings(steps=RECORDS)) == \
        pytest.approx(READS[name][1])


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_finds_nothing_where_a_record_lacks_its_key(name):
    keys, _ = READS[name]
    for key in keys:
        short = [dict(RECORDS[0]), RECORDS[1]]
        del short[0][key]
        assert _reader(name).read(Readings(steps=short)) is None
    assert _reader(name).read(Readings()) is None


def test_no_share_of_no_streamed_work():
    steps = [dict(s, msm_streamed=0, msm_added=0) for s in RECORDS]
    assert _reader("msm_nonzero_share").read(Readings(steps=steps)) is None
