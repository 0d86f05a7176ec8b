"""The fixed-base MSMs' useful share of their streamed work, in percent:
the (window, base) elements with a nonzero digit, which kernels D and 8
add, over the elements streamed (the program's `msm_added` and
`msm_streamed` counters)."""

from ._steps import mean_of


def read(r):
    streamed = mean_of(r, ["msm_streamed"])
    added = mean_of(r, ["msm_added"])
    if not streamed or added is None:
        return None
    return 100.0 * added / streamed
