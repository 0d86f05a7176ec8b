"""The MSM layer's share of its roofline, in percent: the least time of
the MSM work the traced proofs need (work.msm_work) over the device time
of the kernels launched inside the layer's entry points."""


def read(r):
    dev = r.layer_device_s.get("msm", 0.0)
    if dev <= 0 or r.msm_work is None:
        return None
    return 100.0 * r.msm_work.seconds * r.traced_proofs / dev
