"""State carried across from the JAX reference, as numpy arrays.

The reference stores a field element as 16 u16 limbs in uint32 lanes; the
port packs the same Montgomery value (R = 2^256 in both) two limbs per
32-bit word.  Nothing here imports JAX: callers hand over `np.asarray(x)`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..commit.kzg import ParamsKZG


def limbs_from_jax(arr) -> torch.Tensor:
    """(..., 16) u16-limb array -> (..., 8) int32 word tensor (CPU)."""
    a = np.asarray(arr).astype(np.uint32)
    w = a[..., 0::2] | (a[..., 1::2] << 16)
    return torch.from_numpy(np.ascontiguousarray(w).view(np.int32).copy())


def limbs_to_jax(t: torch.Tensor) -> np.ndarray:
    """(..., 8) int32 word tensor -> (..., 16) uint32 u16-limb array."""
    w = t.detach().to("cpu").contiguous().numpy().view(np.uint32)
    return np.stack([w & 0xFFFF, w >> 16], axis=-1).reshape(
        w.shape[:-1] + (16,)).astype(np.uint32)


def params_kzg_from_jax(params, device="cpu") -> ParamsKZG:
    """The port's ParamsKZG from a reference ParamsKZG: its g / g_lagrange
    point arrays and its G2 ints, on `device`."""
    return ParamsKZG(params.k,
                     limbs_from_jax(np.asarray(params.g)).to(device),
                     limbs_from_jax(np.asarray(params.g_lagrange)).to(device),
                     params.g2, params.s_g2, s_secret=params.s_secret)
