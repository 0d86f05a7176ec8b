"""The `kzg-gwc` scheme's pieces outside a run: the readers of GWC's
spans (`gwc_divide_s`, `gwc_commit_s`), which find nothing in the record
of a program without them; the MSM work's digit count on 64-bit words
against `work.py`'s on python ints; the opening points a shape names."""

from __future__ import annotations

import random

import numpy as np
import pytest

from benchmark import harness, work
from benchmark.harness import Readings
from benchmark.metrics import gwc_commit_s, gwc_divide_s
from benchmark.reference import bn254
from benchmark.reference.shape import Shape

from .conftest import SMALL_K, config

SCHEME = harness.scheme_module(config("kzg-gwc-plonk_bench-k20"))

# two proofs' records: the GWC parts of each and what the readers read
RECORDS = [
    {"gwc_fold [T24+]": 0.25, "gwc_divide [T24+]": 0.5,
     "gwc_commit [T24+]": 1.0, "gwc_points": 2},
    {"gwc_fold [T24+]": 0.75, "gwc_divide [T24+]": 1.5,
     "gwc_commit [T24+]": 3.0, "gwc_points": 2},
]
READS = {gwc_divide_s: (["gwc_fold [T24+]", "gwc_divide [T24+]"], 1.5),
         gwc_commit_s: (["gwc_commit [T24+]"], 2.0)}


@pytest.mark.parametrize("reader", list(READS), ids=lambda m: m.__name__)
def test_reader_reads_the_mean_over_the_proofs(reader):
    assert reader.read(Readings(steps=RECORDS)) == \
        pytest.approx(READS[reader][1])


@pytest.mark.parametrize("reader", list(READS), ids=lambda m: m.__name__)
def test_reader_finds_nothing_without_the_gwc_spans(reader):
    keys, _ = READS[reader]
    for key in keys:
        short = [dict(RECORDS[0]), RECORDS[1]]
        del short[0][key]
        assert reader.read(Readings(steps=short)) is None
    # a SHPLONK proof's record, or the parent's, has none of them
    assert reader.read(Readings(steps=[{"multiopen [T24+]": 1.0}])) is None
    assert reader.read(Readings()) is None


@pytest.mark.parametrize("c", [6, 13])
def test_wide_digit_count_is_works(c):
    rng = random.Random(c)
    windows = work.n_windows(c, "bn254")
    vals = [rng.randrange(bn254.FR.p) for _ in range(300)]
    vals += [0, 1, (1 << c) - 1, 1 << (c - 1), (1 << (c - 1)) + 1,
             bn254.FR.p - 1, (1 << 254) - 1]
    assert SCHEME.nonzero_digits(vals, c, windows) == \
        sum(work._digits_int(v, c, windows) for v in vals)
    small = np.array([rng.randrange(1 << 16) for _ in range(300)], np.int64)
    assert SCHEME.nonzero_digits(small, c, windows) == \
        work.nonzero_digits(small, c, windows)
    assert SCHEME.nonzero_digits([], c, windows) == 0


@pytest.mark.parametrize("name, points", [
    ("kzg-gwc-plonk_bench-k20", 2),     # x, omega x
    ("kzg-lookup_heavy-k20", 3),        # and omega^-1 x
    ("ipa-plonk_api-k14", 4),           # and x_last: four permutation sets
])
def test_opening_points_of_a_shape(name, points):
    cfg = config(name)
    shape = Shape(cfg["shape"], SMALL_K, bn254.G1)
    assert SCHEME.opening_points(shape) == points


@pytest.mark.parametrize("name", ["kzg-gwc-plonk_bench-k20",
                                  "kzg-lookup_heavy-k20"])
def test_opening_points_are_the_provers(name):
    """The port's GWC prover counts as many points (`gwc_points`) on the
    circuit at a small k."""
    import torch
    from halo2_tpu_torch import api
    from halo2_tpu_torch.commit import ParamsKZG, ProverGWC
    from halo2_tpu_torch.fields import BN254_FR
    from halo2_tpu_torch.transcript import Keccak256Write
    torch.set_num_threads(1)
    cfg = dict(config(name), k=SMALL_K)
    shape = Shape(cfg["shape"], SMALL_K, bn254.G1)
    plain, program = harness.circuit_modules(cfg)
    rows = shape.usable_rows
    wit = plain.witness(SMALL_K, rows, rows, 3)
    circuit, kg = program.circuits(wit, rows, rows)
    params = ParamsKZG.setup(SMALL_K, s=5, device="cpu")
    pk = api.keygen(BN254_FR, params, SMALL_K, kg)
    record = {}
    api.create_proof(params, pk, [circuit], [wit["instance"]],
                     random.Random(1), transcript_cls=Keccak256Write,
                     multiopen_prover_cls=ProverGWC, timings=record)
    assert record["gwc_points"] == SCHEME.opening_points(shape)
