"""KZG on BN254, multi-opened with GWC, over a Keccak256 transcript: the
proofs an EVM contract verifies.

The parameters come from the configuration's fixed SRS seed, as in
`kzg-shplonk.py`.  The plain reference reads the proof with its own
Keccak-256 (`reference/keccak_transcript.py`), replays the PLONK
verifier to the query list (`reference/plonk.py::_queries`) and checks
the openings by GWC's G1 identity for the trapdoor s
(`reference/gwc.py`).  Its verifying key, about a hundred seconds of
python ints at 2^20 rows and 2^20 copies, is kept under
`.bench_cache/reference/` in the checkout, under the hash of everything it
is made from, so that only a checkout's first run makes it."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from benchmark import work
from benchmark.reference import bn254, gwc, plonk
from benchmark.reference.keccak_transcript import Keccak256Read
from benchmark.reference.srs import srs_secret
from benchmark.reference.transcript import TranscriptError
from benchmark.reference.vk import VerifyingKey, kzg_key

CURVE = "bn254"
TRANSCRIPT = "keccak256"
REFERENCE_CURVE = bn254.G1
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".bench_cache", "reference")
Rejected = plonk.Rejected


def program(config: dict, device):
    """(params, field, create_proof keyword arguments) on the port."""
    from halo2_tpu_torch.commit import ParamsKZG, ProverGWC
    from halo2_tpu_torch.fields import BN254_FR
    from halo2_tpu_torch.transcript import Keccak256Write
    params = ParamsKZG.setup(config["k"], s=srs_secret(config["srs_seed"]),
                             device=device)
    return params, BN254_FR, {"transcript_cls": Keccak256Write,
                              "multiopen_prover_cls": ProverGWC}


def reference_key(shape, config: dict, plain, rows: int,
                  cache_dir: str = CACHE) -> VerifyingKey:
    k = config["k"]
    s = srs_secret(config["srs_seed"])
    fixed = plain.fixed_columns(k, rows, shape.usable_rows)
    copies = plain.copies(k, rows)
    tag = hashlib.sha256(json.dumps(
        [shape.as_data(), [sorted(c.items()) for c in fixed], copies,
         s]).encode()).hexdigest()[:16]
    path = cache_dir and os.path.join(cache_dir, f"kzg-key-{tag}.json")
    if path and os.path.exists(path):
        with open(path) as f:
            comms, perm = json.load(f)
        return VerifyingKey([tuple(p) for p in comms],
                            [tuple(p) for p in perm],
                            extra={"s": s % REFERENCE_CURVE.r}).hash(shape)
    key = kzg_key(shape, s, fixed, copies)
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump([key.fixed_commitments, key.permutation_commitments],
                      f)
        os.replace(tmp, path)
    return key


def verify(shape, key: VerifyingKey, proof: bytes, instance):
    """Raises Rejected where the proof fails a check."""
    t = Keccak256Read(shape.curve, proof)
    try:
        queries = plonk._queries(shape, key, t, instance, None)
        gwc.gwc(key.extra["s"])(t, queries)
    except TranscriptError as e:
        raise Rejected(f"transcript: {e}") from None
    if not t.at_end():
        raise Rejected("bytes left after the opening")


def opening_points(shape) -> int:
    """The distinct points the queries name, one W each: every rotation
    of an advice or fixed query, x (the argument's products, h and the
    random polynomial), x_next for the products, x_last where there are
    several permutation sets, x_prev for a lookup's permuted input."""
    rots = {0} | {rot for kind in ("advice", "fixed")
                  for _col, rot in shape.queries[kind]}
    n_sets = -(-len(shape.permutation) // shape.chunk_len)
    if n_sets or shape.lookups:
        rots.add(1)
    if n_sets > 1:
        rots.add(-(shape.blinding_factors + 1))
    if shape.lookups:
        rots.add(-1)
    return len(rots)


def nonzero_digits(values, c: int, windows: int) -> int:
    """`work.nonzero_digits` for scalars below 2^256, on numpy's 64-bit
    words: the balanced base-2^c digits of a million full-width values
    in a second, where python ints take minutes."""
    vals = [int(v) for v in values]
    if not vals:
        return 0
    raw = b"".join(v.to_bytes(32, "little") for v in vals)
    limbs = np.frombuffer(raw, dtype="<u8").reshape(-1, 4)
    limbs = np.concatenate([limbs, np.zeros((len(vals), 1), np.uint64)],
                           axis=1)
    mask, half = np.uint64((1 << c) - 1), (1 << (c - 1))
    carry = np.zeros(len(vals), np.int64)
    total = 0
    for w in range(windows):
        bit = c * w
        lo, sh = divmod(bit, 64)
        if lo >= 4:
            d = carry
        else:
            d = limbs[:, lo] >> np.uint64(sh)
            if sh + c > 64:
                d = d | (limbs[:, lo + 1] << np.uint64(64 - sh))
            d = (d & mask).astype(np.int64) + carry
        carry = (d > half).astype(np.int64)
        total += int(np.count_nonzero(d - (carry << c)))
    return total


def msm_work(shape, advice, lookup_columns, instance) -> work.LayerWork:
    """The advice columns by their digits (witness rows, zeros, blinding
    rows), a lookup's two permuted columns by theirs, and dense n-point
    MSMs: the derived commitments and GWC's W a distinct point."""
    n = shape.n
    c = work.auto_c(n)
    windows = work.n_windows(c, CURVE)
    blind = (n - shape.usable_rows) * windows
    w = work.LayerWork()
    for col in range(shape.num_advice):
        work._msm(w, n, nonzero_digits(advice.get(col, []), c, windows)
                  + blind, CURVE, f"advice {col}")
    for li, (inp, table) in enumerate(lookup_columns):
        for name, vals in (("input", inp), ("table", list(table.values()))):
            work._msm(w, n, nonzero_digits(vals, c, windows) + blind, CURVE,
                      f"lookup {li} permuted {name}")
    dense = work.derived_commitments(shape) + opening_points(shape)
    for i in range(dense):
        work._msm(w, n, n * windows, CURVE, f"dense {i}")
    return w
