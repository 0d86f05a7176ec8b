from .transcript import Blake2bRead, Blake2bWrite

__all__ = ["Blake2bRead", "Blake2bWrite"]
