"""The device's idle share of the traced proofs, in percent: 1 - (union of
the device's operation intervals) / (the proofs' wall time)."""


def read(r):
    if r.traced_wall_s <= 0 or r.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.traced_wall_s)
