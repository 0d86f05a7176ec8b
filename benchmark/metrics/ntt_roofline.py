"""The NTT layer's share of its roofline, in percent: the least time of
the transforms the traced proofs need (work.ntt_work) over the device time
of the kernels launched inside the four EvaluationDomain transforms."""


def read(r):
    dev = r.layer_device_s.get("ntt", 0.0)
    if dev <= 0 or r.ntt_work is None:
        return None
    return 100.0 * r.ntt_work.seconds * r.traced_proofs / dev
