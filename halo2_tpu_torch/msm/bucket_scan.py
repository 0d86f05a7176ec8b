"""Signed-digit windows and the weighted bucket fold (the parts of
halo2_tpu/msm/bucket_scan.py that the fixed-base stream MSM uses)."""

from __future__ import annotations

import torch

from ..curves.curve import Curve
from .msm import point_tree_sum


def n_windows_for(Fr, c: int) -> int:
    """Windows of the signed-digit decomposition: c * nw >= bits + 2, so the
    top balanced digit absorbs the final carry."""
    return -(-(Fr.p.bit_length() + 2) // c)


def _signed_digits(Fr, scalars_mont, c: int):
    """Balanced base-2^c digits: scalar = sum_w d_w 2^(c w) with d_w in
    [-2^(c-1), 2^(c-1)].  Returns (keys, signs), both (nw, n): keys = |d_w|
    int32, signs bool."""
    assert 2 <= c <= 16
    w = Fr.from_mont(scalars_mont).to(torch.int64) & 0xFFFFFFFF
    n = w.shape[0]
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(n, 16)
    limbs = torch.cat([limbs, torch.zeros_like(limbs[:, :1])], dim=1)
    nw = n_windows_for(Fr, c)
    off = torch.arange(nw, device=w.device) * c
    li, sh = off // 16, off % 16
    raw = ((limbs[:, li] | (limbs[:, li + 1] << 16)) >> sh) & ((1 << c) - 1)
    half, full = 1 << (c - 1), 1 << c
    ds = []
    carry = torch.zeros(n, dtype=torch.int64, device=w.device)
    for i in range(nw):
        d = raw[:, i] + carry
        over = d >= half
        ds.append(torch.where(over, d - full, d))
        carry = over.to(torch.int64)
    ds = torch.stack(ds)
    return ds.abs().to(torch.int32), ds < 0


def weighted_bucket_fold(curve: Curve, buckets):
    """sum_{j >= 1} j B_j for buckets (nb, 3, 8).  Small spaces: two suffix
    sums (W(x) = suffix(suffix(x))[0] = sum (i+1) x_i); large spaces split
    j - 1 = Q h + l on an (H, Q) grid: Q (W(R) - S(R)) + W(C)."""
    dev = buckets.device

    def suffix(arr):
        k = arr.shape[0]
        ident = curve.identity((1,), dev)
        d = 1
        while True:
            shifted = torch.cat([arr[d:], ident.expand((min(d, k),) +
                                                       tuple(arr.shape[1:]))],
                                dim=0)[:k]
            arr = curve.add(arr, shifted)
            d *= 2
            if d >= k:
                return arr

    def W(arr):
        return suffix(suffix(arr))[0]

    b = buckets[1:]
    m = b.shape[0]
    if m <= 256:
        return W(b)
    qbits = m.bit_length() // 2
    Q = 1 << qbits
    H = -(-m // Q)
    if H * Q != m:
        b = torch.cat([b, curve.identity((H * Q - m,), dev)], dim=0)
    grid = b.reshape(H, Q, 3, b.shape[-1])
    R = point_tree_sum(curve, grid, 1)
    C = point_tree_sum(curve, grid, 0)
    SR = point_tree_sum(curve, R, 0)
    acc = curve.add(W(R), curve.neg(SR))
    for _ in range(qbits):
        acc = curve.double(acc)
    return curve.add(acc, W(C))
