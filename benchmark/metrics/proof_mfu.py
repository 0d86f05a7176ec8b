"""The whole proof's share of the card's peak, in percent: the least time
of all the work counted in the MSM and NTT layers (work.py) over the
traced proofs' wall time.  It bounds every kernel's share from above: a
later change that takes a kernel off the path silences that kernel's
roofline, not this one."""


def read(r):
    if r.traced_wall_s <= 0 or r.msm_work is None or r.ntt_work is None:
        return None
    least = (r.msm_work.seconds + r.ntt_work.seconds) * r.traced_proofs
    return 100.0 * least / r.traced_wall_s
