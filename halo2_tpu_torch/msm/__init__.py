from .msm import CachedMSM, msm, naive_msm, pippenger_msm, point_tree_sum
from .stream_msm import StreamMSM

__all__ = ["msm", "naive_msm", "pippenger_msm", "point_tree_sum",
           "CachedMSM", "StreamMSM"]
