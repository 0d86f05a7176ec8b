"""NTT over a mesh: the four-step decomposition with three all-to-all
exchanges (port of the JAX reference's dist/ntt.py).

View the length-n vector as an (n1, n2) matrix, i = i1 n2 + i2; then

    NTT_n(x)[k2 n1 + k1] = NTT_n2( w^(i2 k1) NTT_n1(x[:, i2])[k1] )[k2].

Each shard holds a slab of rows.  The first exchange turns row slabs into
column slabs, so the length-n1 transforms are local; the second returns to
row slabs for the length-n2 transforms; the third is the global transpose
that leaves the output in natural order, sharded on the rows it came in on.
Every local transform is the port's FusedNTT (kernel C) on the shard's
device: the length-n1 transforms read strided columns in place, and the
length-n2 transforms store their output transposed, so the third exchange
delivers natural order with no copy of its own.  The inter-step twiddle
w^(i2 k1) depends on the shard's slice of i2; each shard builds its own
table (`_col_powers`) and applies it with kernel A.  The inverse runs the
same pipeline on the inverse root, with 1/n on the last transform's store.

Unlike the reference's, these transforms take batched columns: (cols, n,
8) in one call.
"""

from __future__ import annotations

import torch

from ..fields.field import NWORDS, Field
from ..ntt import get_ntt, powers
from ..ntt.fused import BIG
from .mesh import Mesh, all_to_all, gather_rows, on_device, shard_rows


def _col_powers(F: Field, base, n: int):
    """Per-column power table: base (m, 8) -> (n, m, 8) with out[j, i] =
    base[i]^j, built by log(n) doubling rounds."""
    out = F.ones((1,) + tuple(base.shape[:-1]), base.device)
    cur = base
    while out.shape[0] < n:
        take = min(out.shape[0], n - out.shape[0])
        out = torch.cat([out, F.mul(out[:take], cur)], dim=0)
        cur = F.square(cur)
    return out


class ShardedNTT:
    """Distributed NTT over row-sharded (..., n, 8) data.

    Matches `get_ntt(F, log_n, device)` on the same data: forward maps
    coefficients (natural order) to evaluations at w^k (natural order);
    inverse includes the 1/n divisor.  The mesh size must divide both n1
    and n2."""

    def __init__(self, mesh: Mesh, F: Field, log_n: int,
                 omega_int: int | None = None, log_n1: int | None = None):
        self.mesh = mesh
        self.F = F
        self.log_n = log_n
        self.n = 1 << log_n
        self.n_dev = mesh.size
        p = F.p
        if omega_int is None:
            assert log_n <= F.S
            omega_int = pow(F.root_of_unity, 1 << (F.S - log_n), p)
        self.omega_int = omega_int
        self.omega_inv_int = pow(omega_int, p - 2, p)
        if log_n1 is None:
            log_n1 = max(log_n // 2, (self.n_dev - 1).bit_length())
        self.log_n1, self.log_n2 = log_n1, log_n - log_n1
        n1, n2 = 1 << self.log_n1, 1 << self.log_n2
        if n1 % self.n_dev or n2 % self.n_dev:
            raise ValueError(f"mesh size {self.n_dev} must divide n1={n1} "
                             f"and n2={n2}")
        self.n1, self.n2 = n1, n2
        # local transforms per device; their inverse tables (roots
        # w^-n2 and w^-n1) run the inverse pipeline
        self._ntt1, self._ntt2 = {}, {}
        for d in set(mesh.devices):
            with on_device(d):
                self._ntt1[d] = get_ntt(F, self.log_n1, d,
                                        omega_int=pow(omega_int, n2, p))
                self._ntt2[d] = get_ntt(F, self.log_n2, d,
                                        omega_int=pow(omega_int, n1, p))
        self._tw: dict = {}     # (global shard, inverse) -> (n1, n2/D, 8)
        self._n_inv: dict = {}  # device -> (3, 8) store factors 1/n

    def _twiddle(self, shard: int, dev, inverse: bool):
        """w^(i2 k1) for this shard's i2 slice: (n1, n2 / D, 8)."""
        key = (shard, inverse)
        tw = self._tw.get(key)
        if tw is None:
            F = self.F
            w = self.omega_inv_int if inverse else self.omega_int
            c2 = self.n2 // self.n_dev
            base = powers(F, F.encode_int(w, dev), self.n2)
            tw = self._tw[key] = _col_powers(
                F, base[shard * c2:(shard + 1) * c2], self.n1)
        return tw

    def _inv_store(self, dev):
        c = self._n_inv.get(dev)
        if c is None:
            c = self._n_inv[dev] = self._ntt2[dev]._const(
                (pow(self.n, self.F.p - 2, self.F.p),) * 3)
        return c

    def _local(self, slabs, inverse: bool):
        """The pipeline on this process's slabs, (cols, n / D, 8) each."""
        mesh, F = self.mesh, self.F
        n1, n2, D = self.n1, self.n2, self.n_dev
        c1, c2 = n1 // D, n2 // D
        cols = slabs[0].shape[0]
        x = [s.reshape(cols, c1, n2, NWORDS) for s in slabs]
        x = all_to_all(mesh, x, 2, 1)                      # (cols, n1, c2)
        for i, xi in enumerate(x):
            dev = xi.device
            with on_device(dev):
                # length-n1 transforms down the columns i2, read in place
                y = torch.empty_like(xi)
                self._ntt1[dev]._run(
                    xi.view(-1, NWORDS), y.view(-1, NWORDS), self.log_n1,
                    inverse, [(c2, 1, 0, 1, 0), (cols, n1 * c2, 0, n1 * c2, 0)],
                    (c2, 0, c2, 0), BIG, BIG, None, None)
                x[i] = F.mul(y, self._twiddle(mesh.first_shard + i, dev,
                                              inverse))
        x = all_to_all(mesh, x, 1, 2)                      # (cols, c1, n2)
        for i, xi in enumerate(x):
            dev = xi.device
            with on_device(dev):
                # length-n2 transforms along the rows, stored as (n2, c1)
                y = torch.empty((cols, n2, c1, NWORDS), dtype=xi.dtype,
                                device=dev)
                self._ntt2[dev]._run(
                    xi.view(-1, NWORDS), y.view(-1, NWORDS), self.log_n2,
                    inverse, [(c1, n2, 0, 1, 0), (cols, c1 * n2, 0, n2 * c1, 0)],
                    (1, 0, c1, 0), BIG, BIG, None,
                    self._inv_store(dev) if inverse else None)
                x[i] = y
        x = all_to_all(mesh, x, 1, 2)                      # (cols, c2, n1)
        return [xi.reshape(cols, c2 * n1, NWORDS) for xi in x]

    def _apply(self, a, inverse: bool):
        """a: a full (n, 8) or (cols, n, 8) tensor (the result comes back
        whole on its device) or this process's list of (cols, n / D, 8)
        or (n / D, 8) row slabs (the result is slabs too)."""
        if not torch.is_tensor(a):
            flat = a[0].dim() == 2
            out = self._local([s[None] if flat else s for s in a], inverse)
            return [o[0] for o in out] if flat else out
        if a.shape[-2] != self.n:
            raise ValueError(f"{tuple(a.shape)} for n={self.n}")
        x = a.reshape((-1, self.n, NWORDS))
        out = self._local(shard_rows(self.mesh, x, 1), inverse)
        return gather_rows(self.mesh, out, a.device, 1).reshape(a.shape)

    def forward(self, a):
        """Coefficients -> evaluations (natural order)."""
        return self._apply(a, False)

    def inverse(self, a):
        """Evaluations -> coefficients (includes 1/n)."""
        return self._apply(a, True)
