from .fused import FusedNTT
from .ntt import get_ntt, powers

__all__ = ["FusedNTT", "get_ntt", "powers"]
