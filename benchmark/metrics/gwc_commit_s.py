"""GWC's witness commitments (commit/gwc.py): one n-point MSM a distinct
opening point and its write into the transcript, the `gwc_commit` part
of `multiopen [T24+]`, seconds a proof."""

from ._steps import mean_of


def read(r):
    return mean_of(r, ["gwc_commit [T24+]"])
