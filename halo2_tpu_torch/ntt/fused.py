"""Four-step NTT around kernel C (csrc/ntt.cu), and kernel C's plain version.

Port of halo2_tpu/ntt/fused.py.  A transform of length m = n1 * n2 runs as
a base NTT over i1, a mid twiddle w^(k1 i2) (kernel A), a transpose, and a
base NTT over i2 (recursively, until the base fits one block).  The base
transform is kernel C: a Stockham NTT of up to 2^10 points held in shared
memory, which replaces the TPU's `_base_ntt` (VMEM, at most 2^7 points).

Data layout: (outer, m, inner, 8) words with the transform along axis 1, so
neither the first base pass nor the top level needs a transpose.
"""

from __future__ import annotations

import torch

from .._build import I32, I64, P, Kernel, stream_of
from ..fields.cuda_ops import NWORDS, limbs_for, to_limbs, to_words
from ..fields.field import Field

LOG_MAX_BASE = 10        # 2^10 elements x 32 B = 32 KB of shared memory

_ntt_kernel = Kernel("h2_ntt_base", [P, P, P, I32, I64, I64, P])


def stage_table(F: Field, wm: int, log_m: int, device) -> torch.Tensor:
    """Per-stage EXPANDED Stockham twiddles: row t holds wm^(r floor(j/r))
    for j < m/2, r = 2^t.  (max(log_m, 1), max(m/2, 1), 8) words."""
    half = max(1 << max(log_m - 1, 0), 1)
    pw = [1] * half
    for j in range(1, half):
        pw[j] = pw[j - 1] * wm % F.p
    rows = []
    for t in range(max(log_m, 1)):
        r = 1 << t
        rows.extend(pw[(j // r) * r] for j in range(half))
    return F.encode_ints(rows, device).reshape(max(log_m, 1), half, NWORDS)


def base_ntt_plain(F: Field, x, table, log_m: int):
    """Plain version of kernel C on (outer, m, inner, 8) words, int64 limbs."""
    L = limbs_for(F, x.device)
    outer, m, inner = x.shape[0], x.shape[1], x.shape[2]
    half = m // 2
    v = to_limbs(x)
    tw = to_limbs(table)
    for t in range(log_m):
        a, b = v[:, :half], v[:, half:]
        s = L.add(a, b)
        d = L.sub(a, b)
        if t < log_m - 1:
            d = L.mul(d, tw[t][None, :, None, :])
        l, r = m >> (t + 1), 1 << t
        v = torch.stack([s.reshape(outer, l, r, inner, 16),
                         d.reshape(outer, l, r, inner, 16)],
                        dim=2).reshape(outer, m, inner, 16)
    return to_words(v)


def base_ntt(F: Field, x, table, log_m: int):
    """Stockham NTT of size 2^log_m along axis 1 of (outer, m, inner, 8)."""
    if x.device.type == "cpu":
        return base_ntt_plain(F, x, table, log_m)
    if x.device.type != "cuda" or table.device != x.device:
        raise ValueError(f"NTT on unsupported devices {x.device}, "
                         f"{table.device}")
    if x.dtype != torch.int32 or x.dim() != 4 or x.shape[-1] != NWORDS \
            or x.shape[1] != (1 << log_m) or not 1 <= log_m <= LOG_MAX_BASE:
        raise ValueError(f"NTT base needs (outer, 2^{log_m}, inner, 8) int32 "
                         f"with 1 <= log_m <= {LOG_MAX_BASE}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if F.kernel_id != 0:
        raise ValueError("kernel C is built for BN254 Fr")
    x = x.contiguous()
    table = table.contiguous()
    out = torch.empty_like(x)
    _ntt_kernel.launch(x.data_ptr(), out.data_ptr(), table.data_ptr(),
                       log_m, x.shape[0], x.shape[2], stream_of(out))
    return out


class FusedNTT:
    """Tables plus the four-step transform for one (field, n, omega, device).
    The inverse includes the 1/n factor."""

    def __init__(self, F: Field, log_n: int, omega_int: int, device):
        assert pow(omega_int, 1 << log_n, F.p) == 1
        self.F = F
        self.log_n = log_n
        self.n = 1 << log_n
        self.device = device
        self.omega_int = omega_int
        self.omega_inv_int = pow(omega_int, F.p - 2, F.p)
        self.n_inv = F.encode_int(pow(self.n, F.p - 2, F.p), device)
        self._plan: dict = {}      # log_m -> ("base",) | ("split", l1, l2)
        self._tables: dict = {}    # (log_m, inv, kind) -> tensor
        self._make_plan(log_n)

    def _make_plan(self, log_m: int):
        if log_m in self._plan:
            return
        F = self.F
        for inv in (False, True):
            w = self.omega_inv_int if inv else self.omega_int
            wm = pow(w, self.n >> log_m, F.p)
            if log_m <= LOG_MAX_BASE:
                self._tables[(log_m, inv, "base")] = stage_table(
                    F, wm, log_m, self.device)
            else:
                l1 = min(LOG_MAX_BASE, (log_m + 1) // 2)
                n1, n2 = 1 << l1, 1 << (log_m - l1)
                from .ntt import powers
                full = powers(F, F.encode_int(wm, self.device), 1 << log_m)
                expo = (torch.arange(n1, device=self.device)[:, None]
                        * torch.arange(n2, device=self.device)[None, :]) \
                    % (1 << log_m)
                self._tables[(log_m, inv, "mid")] = full[expo]  # (n1, n2, 8)
        if log_m <= LOG_MAX_BASE:
            self._plan[log_m] = ("base",)
            return
        l1 = min(LOG_MAX_BASE, (log_m + 1) // 2)
        self._plan[log_m] = ("split", l1, log_m - l1)
        self._make_plan(l1)
        self._make_plan(log_m - l1)

    def _ntt_mid(self, x, log_m: int, inv: bool):
        """NTT along axis 1 of (outer, m, inner, 8)."""
        F = self.F
        plan = self._plan[log_m]
        if plan[0] == "base":
            if log_m == 0:
                return x
            return base_ntt(F, x, self._tables[(log_m, inv, "base")], log_m)
        _, l1, l2 = plan
        n1, n2 = 1 << l1, 1 << l2
        outer, inner = x.shape[0], x.shape[2]
        x = x.reshape(outer, n1, n2 * inner, NWORDS)
        x = self._ntt_mid(x, l1, inv)                          # over i1
        x = x.reshape(outer, n1, n2, inner, NWORDS)
        tw = self._tables[(log_m, inv, "mid")]                 # (n1, n2, 8)
        x = F.mul(x, tw[None, :, :, None, :])
        x = x.transpose(1, 2).contiguous()                     # (o, n2, n1, i)
        x = x.reshape(outer, n2, n1 * inner, NWORDS)
        x = self._ntt_mid(x, l2, inv)                          # over i2
        return x.reshape(outer, n2 * n1, inner, NWORDS)        # k2 n1 + k1

    def _transform(self, a, inv: bool):
        n = self.n
        assert a.shape[-2] == n, f"expected length {n}, got {tuple(a.shape)}"
        batch = a.shape[:-2]
        x = a.reshape(-1, n, 1, NWORDS)
        x = self._ntt_mid(x, self.log_n, inv).reshape(batch + (n, NWORDS))
        if inv:
            x = self.F.mul(x, self.n_inv)
        return x

    def forward(self, a):
        return self._transform(a, False)

    def inverse(self, a):
        return self._transform(a, True)
