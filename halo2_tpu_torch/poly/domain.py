"""Evaluation domains (port of halo2_tpu/poly/domain.py).

Every transform takes (..., n, 8) tensors and moves a whole column set in
one batched NTT; the constants (t-evaluation inverses, zeta patterns) live
on the domain's device.
"""

from __future__ import annotations

import torch

from halo2_tpu.frontend.expression import Rotation

from ..fields.field import NWORDS, Field
from ..ntt import get_ntt
from .poly import COEFF, EXTENDED, LAGRANGE, Poly, take

# Bytes of transform input per dispatch.  The four-step keeps about five
# input-sized tensors live (input, twiddled copy, transpose, two base
# outputs), so 1 GiB of input peaks near 5 GiB — a few percent of the
# H100's 80 GB beside the k=18 prover state (~3 GB with both baked MSM
# tables), while letting the 24 stacked fixed + sigma columns of
# plonk_api at k=18 (ext_n = 2^20, 32 MiB a column) go in one dispatch.
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
        self._zeta_fwd = F.encode_ints([1, self.g_coset, self.g_coset_inv],
                                       device)
        self._zeta_inv = F.encode_ints([1, self.g_coset_inv, self.g_coset],
                                       device)

    # ------------------------------------------------------------------
    # transforms (batched over leading dims; polynomial axis -2)
    # ------------------------------------------------------------------

    def _chunk_batched(self, fn, a, out_rows: int):
        """Apply `fn` over the batch dims of `a` in chunks of at most
        NTT_CHUNK_BYTES of output columns."""
        if a.dim() <= 2:
            return fn(a)
        per_col = out_rows * NWORDS * 4
        batch = 1
        for d in a.shape[:-2]:
            batch *= d
        chunk = max(1, NTT_CHUNK_BYTES // per_col)
        if batch <= chunk:
            return fn(a)
        flat = a.reshape((-1,) + tuple(a.shape[-2:]))
        out = torch.cat([fn(flat[i:i + chunk])
                         for i in range(0, batch, chunk)], dim=0)
        return out.reshape(tuple(a.shape[:-2]) + tuple(out.shape[-2:]))

    def lagrange_to_coeff(self, a):
        a, typed = take(a, LAGRANGE, "lagrange_to_coeff")
        assert a.shape[-2] == self.n
        out = self._chunk_batched(self._ntt.inverse, a, self.n)
        return Poly.coeff(out) if typed else out

    def coeff_to_lagrange(self, a):
        a, typed = take(a, COEFF, "coeff_to_lagrange")
        assert a.shape[-2] == self.n
        out = self._chunk_batched(self._ntt.forward, a, self.n)
        return Poly.lagrange(out) if typed else out

    def _distribute_zeta(self, a, pattern):
        n = a.shape[-2]
        scal = pattern.repeat((n + 2) // 3, 1)[:n]
        return self.F.mul(a, scal)

    def coeff_to_extended(self, a):
        """Coefficients -> evaluations over the zeta-coset extended domain
        (domain.rs:230-244)."""
        a, typed = take(a, COEFF, "coeff_to_extended")
        assert a.shape[-2] == self.n

        def one_chunk(c):
            c = self._distribute_zeta(c, self._zeta_fwd)
            pad = torch.zeros(tuple(c.shape[:-2]) +
                              (self.extended_n - self.n, NWORDS),
                              dtype=c.dtype, device=c.device)
            return self._ntt_ext.forward(torch.cat([c, pad], dim=-2))

        out = self._chunk_batched(one_chunk, a, self.extended_n)
        return Poly.extended(out) if typed else out

    def extended_to_coeff(self, a):
        """Extended coset evaluations -> coefficients, truncated to
        n * quotient_poly_degree (domain.rs:271-293)."""
        a, typed = take(a, EXTENDED, "extended_to_coeff")
        assert a.shape[-2] == self.extended_n

        def one_chunk(c):
            c = self._distribute_zeta(self._ntt_ext.inverse(c),
                                      self._zeta_inv)
            return c[..., : self.n * self.quotient_poly_degree, :]

        out = self._chunk_batched(one_chunk, a, self.extended_n)
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
