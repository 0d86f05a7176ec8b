from . import bn254_pairing
from .serde import (
    SerdeFormat, vk_write, vk_read, pk_write, pk_read, VERSION,
)

__all__ = ["bn254_pairing", "SerdeFormat", "vk_write", "vk_read",
           "pk_write", "pk_read", "VERSION"]
