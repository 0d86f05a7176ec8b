from .fused import FusedNTT
from .ntt import NTT, bit_reverse_indices, get_ntt, powers

__all__ = ["FusedNTT", "NTT", "bit_reverse_indices", "get_ntt", "powers"]
