from .keccak import Keccak256
from .transcript import (Blake2bRead, Blake2bWrite, Keccak256Read,
                         Keccak256Write)

__all__ = ["Blake2bRead", "Blake2bWrite", "Keccak256Read", "Keccak256Write",
           "Keccak256"]
