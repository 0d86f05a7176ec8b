"""Kernel 13 (csrc/move.cu): a gather of table rows by index, and the probe
that times it on the card against `index_select`.

    python -m halo2_tpu_torch.tools.dma_gather_probe

Port of the JAX reference's tools/dma_gather_probe.py (`dma_gather`, which
pipelined one DMA per row from HBM into VMEM).  `gather_rows(idx, tbl)` is
out[i] = tbl[idx[i]] on int32 words; its plain version is
`tbl.index_select(0, idx)`, taken only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .._build import I32, I64, P, Kernel, stream_of
from . import card

_gather_kernel = Kernel("h2_gather_rows", [P, P, P, I64, I32, I64, P])


def gather_rows_plain(idx, tbl):
    return tbl.index_select(0, idx)


def gather_rows(idx, tbl):
    """(m,) int32 row indices into an (rows, width) int32 table -> (m, width)
    rows; on the card width must be 4 x a power of two (whole 16-byte
    pieces, a power of two of them per row)."""
    if idx.device.type == "cpu" and tbl.device.type == "cpu":
        return gather_rows_plain(idx, tbl)
    if idx.device != tbl.device or tbl.device.type != "cuda":
        raise ValueError(f"gather_rows on unsupported devices {idx.device}, "
                         f"{tbl.device}")
    width = tbl.shape[-1] if tbl.dim() == 2 else 0
    vecs = width // 4
    if idx.dtype != torch.int32 or idx.dim() != 1 or \
            tbl.dtype != torch.int32 or width % 4 or vecs & (vecs - 1) or \
            vecs == 0:
        raise ValueError(f"gather_rows: unsupported operands {idx.dtype} "
                         f"{tuple(idx.shape)}, {tbl.dtype} "
                         f"{tuple(tbl.shape)}")
    idx, tbl = idx.contiguous(), tbl.contiguous()
    out = torch.empty((idx.shape[0], width), dtype=torch.int32,
                      device=tbl.device)
    _gather_kernel.launch(idx.data_ptr(), tbl.data_ptr(), out.data_ptr(),
                          idx.shape[0], vecs.bit_length() - 1, tbl.shape[0],
                          stream_of(out))
    return out


def mk_tbl(rows: int, cols: int, device):
    """The reference's table: word (r, c) = r 2654435761 + c 40503 mod 2^32,
    as int32 bit patterns."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    v = (r * 2654435761 + c * 40503) & 0xFFFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def random_idx(m: int, rows: int, seed: int, device):
    """m int32 row indices below `rows` from a numpy seed."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, rows, size=m).astype(
        np.int32)).to(device)


def main(k: int = 18) -> dict:
    """The reference's shapes: M = 20 2^k rows gathered from a 2^k-row
    table, rows of 128 and 64 words; the kernel against `index_select`,
    word for word, and both timed by CUDA events."""
    dev = card.require_cuda()
    print(card.name_and_power(), flush=True)
    n_rows = 1 << k
    m = 20 * n_rows
    idx = random_idx(m, n_rows, 0, dev)
    out = {}
    for width in (128, 64):
        tbl = mk_tbl(n_rows, width, dev)
        ok = torch.equal(gather_rows(idx, tbl), gather_rows_plain(idx, tbl))
        ms = card.cuda_ms(lambda: gather_rows(idx, tbl), 5)
        lib = card.cuda_ms(lambda: gather_rows_plain(idx, tbl), 5)
        gb = (2 * m * width * 4 + 4 * m) / 1e9
        print(f"  w={width}: kernel {ms:8.3f} ms ({ms / m * 1e6:5.3f} ns/row, "
              f"{gb / ms * 1e3:6.0f} GB/s); index_select {lib:8.3f} ms "
              f"({gb / lib * 1e3:6.0f} GB/s); equal={ok}", flush=True)
        out[width] = dict(ms=ms, index_select_ms=lib, equal=ok)
    return out


if __name__ == "__main__":
    main()
