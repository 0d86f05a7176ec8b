"""Seconds a proof the host spent blocked on the device: its waits for
the queue and its explicit device-to-host reads (the program's
`host_wait` counter)."""

from ._steps import mean_of


def read(r):
    return mean_of(r, ["host_wait"])
