"""Evaluation domains (port of the JAX reference's poly/domain.py).

Every transform takes (..., n, 8) tensors and moves a whole column set in
one batched NTT; the constants (t-evaluation inverses, zeta patterns) live
on the domain's device.  After `set_mesh`, the transforms run through the
sharded NTT (dist/ntt.py), and the coset patterns, zero padding and
truncation that kernel C folds in on one device run as passes of their own.
"""

from __future__ import annotations

import torch

from ..fields.field import NWORDS, Field
from ..frontend.expression import Rotation
from ..ntt import get_ntt
from .poly import COEFF, EXTENDED, LAGRANGE, Poly, take

# Bytes of transform output per dispatch.  A transform keeps its input, its
# output and one scratch tensor of the output's size per split level live
# (two at 2^21 and above), so 1 GiB of output peaks near 3-4 GiB beside the
# k=18 prover state (~3 GB with both baked MSM tables), while letting the 24
# stacked fixed + sigma columns of plonk_api at k=18 (ext_n = 2^20, 32 MiB a
# column) go in one dispatch.
NTT_CHUNK_BYTES = 1 << 30


class EvaluationDomain:
    """Constants for the 2^k domain and the 2^extended_k coset domain
    (domain.rs:38-144), on `device`."""

    def __init__(self, F: Field, j: int, k: int, device):
        self.F = F
        self.k = k
        self.n = 1 << k
        self.device = device
        self.quotient_poly_degree = j - 1
        extended_k = k
        while (1 << extended_k) < self.n * self.quotient_poly_degree:
            extended_k += 1
        assert extended_k <= F.S
        self.extended_k = extended_k
        self.extended_n = 1 << extended_k
        p = F.p
        self.omega = pow(F.root_of_unity, 1 << (F.S - k), p)
        self.omega_inv = pow(self.omega, p - 2, p)
        self.extended_omega = pow(F.root_of_unity, 1 << (F.S - extended_k), p)
        self.extended_omega_inv = pow(self.extended_omega, p - 2, p)
        self.g_coset = F.zeta
        self.g_coset_inv = (F.zeta * F.zeta) % p
        self.barycentric_weight = pow(self.n, p - 2, p)

        t_evals = []
        orig = pow(F.zeta, self.n, p)
        step = pow(self.extended_omega, self.n, p)
        cur = orig
        while True:
            t_evals.append((cur - 1) % p)
            cur = (cur * step) % p
            if cur == orig:
                break
        assert len(t_evals) == 1 << (extended_k - k)
        self.t_evaluations_inv = F.encode_ints(
            [pow(t, p - 2, p) for t in t_evals], device)
        self._ntt = get_ntt(F, k, device)
        self._ntt_ext = get_ntt(F, extended_k, device)
        # the coset patterns zeta^(i mod 3) and, with 1/extended_n,
        # zeta^-(i mod 3), as python ints: kernel C multiplies by them on
        # its first pass's load and its last pass's store
        self._zeta_fwd = (1, self.g_coset, self.g_coset_inv)
        ext_n_inv = pow(self.extended_n, p - 2, p)
        self._zeta_inv = tuple(ext_n_inv * z % p
                               for z in (1, self.g_coset_inv, self.g_coset))
        self._mesh = None
        self._sharded: dict = {}    # log_n -> ShardedNTT

    def set_mesh(self, mesh):
        """Route every transform through the sharded NTT over `mesh` (the
        mesh size must divide the four-step splits of k and extended_k),
        or back to the one-device NTT with None."""
        from ..dist.ntt import ShardedNTT
        self._mesh = mesh
        self._sharded = {}
        if mesh is not None:
            self._sharded[self.k] = ShardedNTT(mesh, self.F, self.k,
                                               self.omega)
            self._sharded[self.extended_k] = ShardedNTT(
                mesh, self.F, self.extended_k, self.extended_omega)

    # ------------------------------------------------------------------
    # constructors (raw (..., n, 8) tensors, as the reference returns)
    # ------------------------------------------------------------------

    def empty_lagrange(self, batch=()):
        return self.F.zeros(tuple(batch) + (self.n,), self.device)

    def empty_coeff(self, batch=()):
        return self.F.zeros(tuple(batch) + (self.n,), self.device)

    def empty_extended(self, batch=()):
        return self.F.zeros(tuple(batch) + (self.extended_n,), self.device)

    def constant_lagrange(self, x: int):
        return self.F.full((self.n,), x, self.device)

    def constant_extended(self, x: int):
        return self.F.full((self.extended_n,), x, self.device)

    def get_quotient_poly_degree(self) -> int:
        return self.quotient_poly_degree

    # ------------------------------------------------------------------
    # transforms (batched over leading dims; polynomial axis -2)
    # ------------------------------------------------------------------

    def _chunk_batched(self, fn, a, out_rows: int):
        """One output tensor (..., out_rows, 8) for `a`'s batch dims, filled
        by fn(chunk, out_chunk) over chunks of at most NTT_CHUNK_BYTES of
        output columns."""
        batch = tuple(a.shape[:-2])
        out = torch.empty(batch + (out_rows, NWORDS), dtype=torch.int32,
                          device=a.device)
        flat = a.reshape((-1,) + tuple(a.shape[-2:]))
        flat_out = out.view(-1, out_rows, NWORDS)
        chunk = max(1, NTT_CHUNK_BYTES // (out_rows * NWORDS * 4))
        for i in range(0, flat.shape[0], chunk):
            fn(flat[i:i + chunk], flat_out[i:i + chunk])
        return out

    def _apply_sharded(self, log_n: int, inverse: bool, pre=None,
                       post=None):
        """fn(chunk, out_chunk) of the sharded transform of 2^log_n, with
        pre / post(c) applied to the chunk before / after it."""
        sn = self._sharded[log_n]

        def fn(c, o):
            c = pre(c) if pre is not None else c
            c = sn.inverse(c) if inverse else sn.forward(c)
            o.copy_(post(c) if post is not None else c)
        return fn

    def _distribute_zeta(self, a, pattern):
        """a times pattern[i % 3] along its rows (three python ints)."""
        n = a.shape[-2]
        scal = self.F.encode_ints(list(pattern), a.device)
        return self.F.mul(a, scal.repeat((n + 2) // 3, 1)[:n])

    def lagrange_to_coeff(self, a):
        a, typed = take(a, LAGRANGE, "lagrange_to_coeff")
        assert a.shape[-2] == self.n
        fn = (self._apply_sharded(self.k, True) if self._mesh is not None
              else lambda c, o: self._ntt._transform(c, True, out=o))
        out = self._chunk_batched(fn, a, self.n)
        return Poly.coeff(out) if typed else out

    def coeff_to_lagrange(self, a):
        a, typed = take(a, COEFF, "coeff_to_lagrange")
        assert a.shape[-2] == self.n
        fn = (self._apply_sharded(self.k, False) if self._mesh is not None
              else lambda c, o: self._ntt._transform(c, False, out=o))
        out = self._chunk_batched(fn, a, self.n)
        return Poly.lagrange(out) if typed else out

    def coeff_to_extended(self, a):
        """Coefficients -> evaluations over the zeta-coset extended domain
        (domain.rs:230-244): one transform whose first pass multiplies by
        the coset pattern and reads the rows from n on as zero."""
        a, typed = take(a, COEFF, "coeff_to_extended")
        assert a.shape[-2] == self.n
        if self._mesh is not None:
            def pad(c):
                c = self._distribute_zeta(c, self._zeta_fwd)
                zeros = c.new_zeros(c.shape[:-2] + (
                    self.extended_n - self.n, NWORDS))
                return torch.cat([c, zeros], dim=-2)
            fn = self._apply_sharded(self.extended_k, False, pre=pad)
        else:
            fn = lambda c, o: self._ntt_ext._transform(  # noqa: E731
                c, False, load=self._zeta_fwd, out=o)
        out = self._chunk_batched(fn, a, self.extended_n)
        return Poly.extended(out) if typed else out

    def extended_to_coeff(self, a):
        """Extended coset evaluations -> coefficients, truncated to
        n * quotient_poly_degree (domain.rs:271-293): one inverse transform
        whose last pass multiplies by 1/extended_n times the inverse coset
        pattern and writes only the rows kept."""
        a, typed = take(a, EXTENDED, "extended_to_coeff")
        assert a.shape[-2] == self.extended_n
        rows = self.n * self.quotient_poly_degree
        if self._mesh is not None:
            zeta_inv = (1, self.g_coset_inv, self.g_coset)
            fn = self._apply_sharded(
                self.extended_k, True, post=lambda c: self._distribute_zeta(
                    c[..., :rows, :], zeta_inv))
        else:
            fn = lambda c, o: self._ntt_ext._transform(  # noqa: E731
                c, True, store=self._zeta_inv, rows=rows, out=o)
        out = self._chunk_batched(fn, a, rows)
        return Poly.coeff(out) if typed else out

    def divide_by_vanishing_poly(self, a):
        a, typed = take(a, EXTENDED, "divide_by_vanishing_poly")
        assert a.shape[-2] == self.extended_n
        t = self.t_evaluations_inv
        out = self.F.mul(a, t.repeat(self.extended_n // t.shape[0], 1))
        return Poly.extended(out) if typed else out

    def rotate_extended(self, a, rotation):
        a, typed = take(a, EXTENDED, "rotate_extended")
        shift = (1 << (self.extended_k - self.k)) * rotation.i
        out = torch.roll(a, -shift, dims=-2)
        return Poly.extended(out) if typed else out

    def rotate_lagrange(self, a, rotation):
        a, typed = take(a, LAGRANGE, "rotate_lagrange")
        out = torch.roll(a, -rotation.i, dims=-2)
        return Poly.lagrange(out) if typed else out

    # ------------------------------------------------------------------
    # host-side scalar helpers
    # ------------------------------------------------------------------

    def rotate_omega_int(self, value: int, rotation) -> int:
        p = self.F.p
        if rotation.i >= 0:
            return (value * pow(self.omega, rotation.i, p)) % p
        return (value * pow(self.omega_inv, -rotation.i, p)) % p

    def l_i_range_int(self, x: int, xn: int, rotations) -> list:
        """Barycentric Lagrange evaluations l_i(x) (domain.rs:425-450)."""
        p = self.F.p
        common = ((xn - 1) * self.barycentric_weight) % p
        out = []
        for rot in rotations:
            r = rot if hasattr(rot, "i") else Rotation(rot)
            denom = (x - self.rotate_omega_int(1, r)) % p
            inv = pow(denom, p - 2, p)
            out.append(self.rotate_omega_int((inv * common) % p, r))
        return out
