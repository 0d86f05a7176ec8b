"""The card's peaks and what one Montgomery product costs: the yardstick of
every roofline share.

NVIDIA H100 SXM: 132 SMs at 1,980 MHz, 64 32-bit integer multiplies a clock
per SM (the CUDA guide's IMAD rate), 3.35 TB/s of HBM3.  A product in a
field of eight 32-bit words needs at least 136 multiplier instructions for
BN254 and 112 for the Pasta fields, whose modulus has three zero words
(schoolbook: 64 for a b, then per reduction word one for the quotient and
one per nonzero word of p)."""

SMS = 132
SM_CLOCK_HZ = 1.98e9
MULTIPLIES_PER_CLOCK_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
MULTIPLIES_PER_S = SMS * SM_CLOCK_HZ * MULTIPLIES_PER_CLOCK_PER_SM
PRODUCT_MULTIPLIES = {"bn254": 136, "vesta": 112, "pallas": 112}


def least_seconds(products: float, nbytes: float, curve: str):
    """(least time, the bound that sets it) for work of `products` field
    products that reads and writes `nbytes` bytes."""
    t_mul = products * PRODUCT_MULTIPLIES[curve] / MULTIPLIES_PER_S
    t_mem = nbytes / HBM_BYTES_PER_S
    return (t_mul, "multiplies") if t_mul >= t_mem else (t_mem, "bytes")
