"""Kernels 14/15 (csrc/move.cu): the limb transposes (R, 16) -> (16, R) and
back, and the probe that times them on the card against
`.t().contiguous()`.

    python -m halo2_tpu_torch.tools.transpose_probe

Port of the JAX reference's tools/transpose_probe.py (`limb_T_fwd`,
`limb_T_bwd`).  Both directions are one tiled shared-memory transpose of a
2-D int32 matrix behind one C entry point, bound twice so each has its own
launch count; the plain version is `x.t().contiguous()`, taken only for a
CPU tensor.
"""

from __future__ import annotations

import torch

from .._build import I64, P, Kernel, stream_of
from . import card
from .alu_probe import random_u32

L = 16

_fwd_kernel = Kernel("h2_limb_T", [P, P, I64, I64, P], name="h2_limb_T_fwd")
_bwd_kernel = Kernel("h2_limb_T", [P, P, I64, I64, P], name="h2_limb_T_bwd")


def transpose_plain(x):
    return x.t().contiguous()


def _transpose(kernel, x):
    if x.device.type == "cpu":
        return transpose_plain(x)
    if x.device.type != "cuda" or x.dtype != torch.int32 or x.dim() != 2:
        raise ValueError(f"limb transpose: unsupported operand {x.device} "
                         f"{x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    rows, cols = x.shape
    out = torch.empty((cols, rows), dtype=torch.int32, device=x.device)
    kernel.launch(x.data_ptr(), out.data_ptr(), rows, cols, stream_of(out))
    return out


def limb_T_fwd(x):
    """(R, 16) -> (16, R) (any 2-D int32 matrix: its transpose)."""
    return _transpose(_fwd_kernel, x)


def limb_T_bwd(x):
    """(16, R) -> (R, 16) (any 2-D int32 matrix: its transpose)."""
    return _transpose(_bwd_kernel, x)


def main(r: int = 8 << 18) -> dict:
    """The reference's shape, R = 8 2^18 rows of 16 words: each direction
    against `.t().contiguous()`, word for word, all timed by CUDA events."""
    dev = card.require_cuda()
    print(card.name_and_power(), flush=True)
    x = random_u32((r, L), 0, dev)
    xt = transpose_plain(x)
    gb = 2 * r * L * 4 / 1e9
    out = {}
    for name, fn, arg, want in (("fwd", limb_T_fwd, x, xt),
                                ("bwd", limb_T_bwd, xt, x)):
        ok = torch.equal(fn(arg), want)
        ms = card.cuda_ms(lambda: fn(arg), 8)
        lib = card.cuda_ms(lambda: transpose_plain(arg), 8)
        print(f"{name}: kernel {ms:7.3f} ms ({gb / ms * 1e3:5.0f} GB/s); "
              f".t().contiguous() {lib:7.3f} ms ({gb / lib * 1e3:5.0f} GB/s); "
              f"equal={ok}", flush=True)
        out[name] = dict(ms=ms, library_ms=lib, equal=ok)
    return out


if __name__ == "__main__":
    main()
