"""The unbaked fixed-base MSM (the ordering pass and kernel 8's plain
versions, the key sums, the per-window folds and the Horner combine)
against the JAX reference's `msm_stream_unbaked` on Vesta, for random,
16-bit, zero, equal and one-bucket scalars; and the elements that
`StreamMSM` counts as streamed and added.  BN254 is in test_torch_msm.py."""

import functools

import pytest
import torch

from halo2_tpu.curves import VESTA as REF_VESTA
from halo2_tpu.msm import stream_msm as ref_sm
from halo2_tpu_torch.curves import VESTA
from halo2_tpu_torch.msm import stream_msm as sm
from halo2_tpu_torch.msm.host_msm import host_msm
from test_torch_msm_order import KINDS, REF_LANES, points, scalars

# The plain versions run many small tensor ops: one thread per worker
# is as fast and leaves the other cores to the other test workers.
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def unbaked_pair():
    """A port unbaked table and the reference's over the same 64 Vesta
    points."""
    pts = points(VESTA, 64, 13)
    ours = sm.pack_base_stream_table(VESTA, VESTA.from_affine_ints(pts,
                                                                    "cpu"))
    theirs = ref_sm.pack_base_stream_table(
        REF_VESTA, REF_VESTA.from_affine_ints(pts), REF_LANES)
    return pts, ours, theirs


@pytest.mark.parametrize("kind", KINDS)
def test_msm_stream_unbaked_matches_reference_vesta(kind):
    pts, ours, theirs = unbaked_pair()
    vals = scalars(VESTA.Fr.p, len(pts), 14, kind)
    got = sm.msm_stream_unbaked(VESTA, VESTA.Fr.encode_ints(vals, "cpu"),
                                   ours)
    want = ref_sm.msm_stream_unbaked(REF_VESTA, REF_VESTA.Fr.encode_ints(vals),
                                     theirs, 6, REF_LANES)
    assert VESTA.to_affine_ints(got[None]) == \
        REF_VESTA.to_affine_ints(want[None])
    assert VESTA.to_affine_ints(got[None]) == [host_msm(VESTA, vals, pts)]


def test_stream_msm_counts_streamed_and_added():
    """streamed: nw n per call (shorter scalar columns are padded with
    zeros); added: the nonzero digits; summed over every descriptor by
    stream_counters() since reset_stream_counters()."""
    pts = points(VESTA, 40, 15)
    desc = sm.StreamMSM(VESTA, VESTA.from_affine_ints(pts, "cpu"))
    other = sm.StreamMSM(VESTA, VESTA.from_affine_ints(pts[:8], "cpu"))
    other(VESTA.Fr.encode_ints([3] * 8, "cpu"))
    sm.reset_stream_counters()
    want = 0
    for kind in ("16-bit", "one-bucket"):
        vals = scalars(VESTA.Fr.p, 30, 16, kind)
        s = VESTA.Fr.encode_ints(vals, "cpu")
        assert VESTA.to_affine_ints(desc(s)[None]) == \
            [host_msm(VESTA, vals, pts[:30])]
        want += int((sm.stream_keys(VESTA, s) >> 1).ne(0).sum())
    assert sm.stream_counters() == dict(streamed=2 * 43 * 40, added=want)
    other(VESTA.Fr.encode_ints([3] * 8, "cpu"))
    assert sm.stream_counters() == dict(streamed=2 * 43 * 40 + 43 * 8,
                                        added=want + 8)
    sm.reset_stream_counters()
    assert sm.stream_counters() == dict(streamed=0, added=0)
