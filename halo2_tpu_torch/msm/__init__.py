from .msm import msm, naive_msm, point_tree_sum
from .stream_msm import StreamMSM

__all__ = ["msm", "naive_msm", "point_tree_sum", "StreamMSM"]
