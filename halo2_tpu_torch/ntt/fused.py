"""Four-step NTT on kernel C (csrc/ntt.cu) alone, and kernel C's plain version.

Port of the JAX reference's ntt/fused.py.  A transform of length m = n1 n2
runs as a base NTT over i1 (index i = i1 n2 + i2) whose store multiplies by
the mid twiddle w^(i2 k1), then a base NTT over i2 that reads those rows and
writes output k = k2 n1 + k1 itself; the second half recurses until the
base fits one block.  Each base NTT is one launch of kernel C, a Stockham
NTT of up to 2^10 points per column in shared memory, which replaces the
TPU's `_base_ntt` (VMEM, at most 2^7 points) and the mid-twiddle product,
transpose, coset pattern, zero padding, 1/n product and truncation around
it: a pass describes where each column's elements lie (`NttPass`), and the
factors ride on its loads and stores.

Contract: `forward` / `inverse` equal the reference's transforms word for
word (`inverse` includes 1/n); `_transform` adds the domain's coset
patterns, zero rows and truncation.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from .._build import I32, P, Kernel, stream_of
from ..fields.cuda_ops import NWORDS, limbs_for, to_limbs, to_words, words
from ..fields.field import Field

LOG_MAX_BASE = 10        # a block holds 2^10 elements x 32 B
ELEMS = 1 << 10          # elements a block holds (columns x m)
MAX_COLS = 128           # columns a block holds
MAX_DIMS = 4             # batch dims a pass addresses
THREADS = 256            # a block's threads at m = 2^10 (C m / 4, >= 32)
BLOCKS_PER_SM = 2        # blocks a pass should give each SM at least
BUTTERFLIES_PER_ROUND = 4    # radix-4: two stages of two butterflies
# shared memory of a block at m = 2^10: one column's offsets (40 B), the
# data and the m/2 twiddles (32 B an element)
SMEM_BYTES = 40 + 32 * ELEMS + 32 * (ELEMS // 2)
BIG = 1 << 62            # a row bound that masks nothing

_P_FIELDS = ("src", "dst", "pw", "load_c", "store_c", "tw_lo", "tw_hi")
_L = ctypes.c_longlong


class _Args(ctypes.Structure):
    """csrc/ntt.cu's NttArgs: every field 8 bytes."""
    _fields_ = ([(f, ctypes.c_void_p) for f in _P_FIELDS] +
                [("log_m", _L), ("ndims", _L)] +
                [(f, _L * MAX_DIMS) for f in ("size", "src_s", "src_r",
                                              "dst_s", "dst_r")] +
                [(f, _L) for f in ("j_src_s", "j_src_r", "j_dst_s", "j_dst_r",
                                   "src_rows", "dst_rows", "tw_dim",
                                   "tw_log_lo", "tw_mask", "cols",
                                   "log_cols_per_block", "load_cols_fast",
                                   "store_cols_fast")])


_ntt_kernel = Kernel("h2_ntt_base", [I32, ctypes.POINTER(_Args), P])


@dataclass
class NttPass:
    """One launch of kernel C.  Column c is a point of `dims` (innermost
    first, each (size, src_stride, src_row, dst_stride, dst_row)); its
    element j lies at element offset sum idx_d src_stride_d + j j[0] of
    `src` and goes to sum idx_d dst_stride_d + j j[2] of `dst`.  An
    element's row (the same sums over the row strides, j[1] and j[3]) is its
    index in the whole transform's input or output: input rows >= src_rows
    read as zero and are multiplied by load[row % 3]; output rows >=
    dst_rows are not written, the others are multiplied by store[row % 3]
    and, with `twiddle` = (dim, log_n, log_lo, lo, hi), by w^e, e = j idx_dim
    mod 2^log_n, as lo[e mod 2^log_lo] hi[e >> log_lo]."""
    src: torch.Tensor
    dst: torch.Tensor
    powers: torch.Tensor          # W^e for e < max(m / 2, 1)
    log_m: int
    dims: tuple
    j: tuple
    src_rows: int = BIG
    dst_rows: int = BIG
    load: torch.Tensor = None     # (3, 8) or None
    store: torch.Tensor = None
    twiddle: tuple = None

    @property
    def cols(self) -> int:
        n = 1
        for d in self.dims:
            n *= d[0]
        return n

    def flags(self) -> tuple:
        return tuple(f for f, on in (("load", self.load is not None),
                                     ("pad", self.src_rows < BIG),
                                     ("store", self.store is not None),
                                     ("truncate", self.dst_rows < BIG),
                                     ("twiddle", self.twiddle is not None))
                     if on)


@functools.cache
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _log_cols(log_m: int, cols: int, sms: int) -> int:
    """log2 of the columns a block holds: up to ELEMS / m and MAX_COLS,
    halved while that leaves fewer than BLOCKS_PER_SM blocks on each of
    `sms` SMs."""
    want = min(MAX_COLS, ELEMS >> log_m)
    while want > 1 and cols < BLOCKS_PER_SM * sms * want:
        want //= 2
    return want.bit_length() - 1


def _column_index(p: NttPass, device):
    """Per column (dims[0] fastest): src offset, src row, dst offset, dst
    row and the twiddle dim's index, as int64 tensors."""
    cols = [torch.zeros(1, dtype=torch.int64, device=device)
            for _ in range(5)]
    tw_dim = p.twiddle[0] if p.twiddle is not None else -1
    for d in reversed(range(len(p.dims))):
        size, ss, sr, ds, dr = p.dims[d]
        i = torch.arange(size, dtype=torch.int64, device=device)
        steps = (ss, sr, ds, dr, 1 if d == tw_dim else 0)
        cols = [(c[:, None] + i[None, :] * s).reshape(-1)
                for c, s in zip(cols, steps)]
    return cols


def base_ntt_plain(F: Field, p: NttPass, chunk: int = 1 << 16):
    """Plain version of kernel C: writes p.dst as the kernel does (int64
    limbs, `chunk` elements at a time).  The transform is the reference's
    radix-2 Stockham schedule with the expanded stage twiddles
    powers[(j >> t) << t]."""
    dev = p.src.device
    L = limbs_for(F, dev)
    m = 1 << p.log_m
    half = m // 2
    src = p.src.reshape(-1, NWORDS)
    dst = p.dst.view(-1, NWORDS)
    so, sr, do, dr, ti = _column_index(p, dev)
    j = torch.arange(m, dtype=torch.int64, device=dev)
    pw = to_limbs(p.powers.reshape(-1, NWORDS))
    stage_tw = [pw[(torch.arange(half, device=dev) >> t) << t]
                for t in range(p.log_m)]
    load = to_limbs(p.load) if p.load is not None else None
    store = to_limbs(p.store) if p.store is not None else None
    if p.twiddle is not None:
        _, log_n, log_lo, lo, hi = p.twiddle
        lo, hi = to_limbs(lo), to_limbs(hi)
    step = max(1, chunk // m)
    for c0 in range(0, so.shape[0], step):
        c1 = min(c0 + step, so.shape[0])
        cols = c1 - c0
        row = sr[c0:c1, None] + j * p.j[1]
        ok = row < p.src_rows
        addr = torch.where(ok, so[c0:c1, None] + j * p.j[0], 0)
        v = to_limbs(src[addr.reshape(-1)]).reshape(cols, m, 16)
        v = torch.where(ok[..., None], v, 0)
        if load is not None:
            v = L.mul(v, load[row % 3])
        for t in range(p.log_m):
            a, b = v[:, :half], v[:, half:]
            s = L.add(a, b)
            d = L.sub(a, b)
            if t < p.log_m - 1:
                d = L.mul(d, stage_tw[t][None])
            l, r = m >> (t + 1), 1 << t
            v = torch.stack([s.reshape(cols, l, r, 16),
                             d.reshape(cols, l, r, 16)],
                            dim=2).reshape(cols, m, 16)
        row = dr[c0:c1, None] + j * p.j[3]
        if store is not None:
            v = L.mul(v, store[row % 3])
        if p.twiddle is not None:
            e = (j * ti[c0:c1, None]) & ((1 << log_n) - 1)
            lo_mask = (1 << log_lo) - 1
            v = L.mul(v, L.mul(lo[e & lo_mask], hi[e >> log_lo]))
        ok = row < p.dst_rows
        dst[(do[c0:c1, None] + j * p.j[2])[ok]] = to_words(v[ok])
    return p.dst


def _template(p: NttPass, sms: int) -> _Args:
    """The launch arguments of a pass's shape on a card of `sms` SMs, all
    but the tensors' addresses."""
    tw = p.twiddle[:3] if p.twiddle is not None else None
    return _template_of(p.log_m, tuple(p.dims), tuple(p.j), p.src_rows,
                        p.dst_rows, tw, sms)


@functools.lru_cache(maxsize=256)
def _template_of(log_m, dims, j, src_rows, dst_rows, tw, sms) -> _Args:
    """Checked and built once per shape (a transform's passes repeat
    theirs at every call); callers copy the result."""
    cols = 1
    for d in dims:
        cols *= d[0]
    if not 0 <= log_m <= LOG_MAX_BASE or not 1 <= len(dims) <= MAX_DIMS \
            or cols >= 1 << 31:
        raise ValueError(f"NTT pass needs 0 <= log_m <= {LOG_MAX_BASE}, "
                         f"1..{MAX_DIMS} dims and < 2^31 columns, got log_m "
                         f"{log_m}, {len(dims)} dims, {cols} columns")
    a = _Args()
    a.log_m, a.ndims = log_m, len(dims)
    for d, (size, ss, sr, ds, dr) in enumerate(dims):
        a.size[d], a.src_s[d], a.src_r[d], a.dst_s[d], a.dst_r[d] = \
            size, ss, sr, ds, dr
    a.j_src_s, a.j_src_r, a.j_dst_s, a.j_dst_r = j
    a.src_rows, a.dst_rows = src_rows, dst_rows
    a.tw_dim = -1
    if tw is not None:
        dim, log_n, log_lo = tw
        a.tw_dim, a.tw_log_lo, a.tw_mask = dim, log_lo, (1 << log_n) - 1
    a.cols = cols
    a.log_cols_per_block = _log_cols(log_m, cols, sms)
    inner = dims[0]
    a.load_cols_fast = int(inner[1] == 1 and j[0] != 1)
    a.store_cols_fast = int(inner[3] == 1 and j[2] != 1)
    return a


def base_ntt(F: Field, p: NttPass):
    """One pass of kernel C (see NttPass); writes p.dst and returns it."""
    if p.src.device.type == "cpu":
        return base_ntt_plain(F, p)
    if p.src.device.type != "cuda":
        raise ValueError(f"NTT on unsupported device {p.src.device}")
    tensors = [p.src, p.dst, p.powers, p.load, p.store] + (
        list(p.twiddle[3:]) if p.twiddle is not None else [None, None])
    dev = p.src.get_device()
    for t in tensors:
        if t is not None and (t.get_device() != dev or
                              t.dtype is not torch.int32 or
                              t.shape[-1] != NWORDS or
                              not t.is_contiguous()):
            raise ValueError(f"NTT pass needs contiguous (..., 8) int32 "
                             f"tensors on {p.src.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if p.powers.numel() != NWORDS * max(1 << max(p.log_m - 1, 0), 1):
        raise ValueError(f"NTT pass of 2^{p.log_m} needs "
                         f"{max(1 << max(p.log_m - 1, 0), 1)} powers")
    a = _Args.from_buffer_copy(_template(p, sm_count(dev)))
    if a.cols == 0:
        return p.dst
    (a.src, a.dst, a.pw, a.load_c, a.store_c, a.tw_lo, a.tw_hi) = (
        None if t is None else t.data_ptr() for t in tensors)
    _ntt_kernel.launch(F.kernel_id, ctypes.byref(a), stream_of(p.dst))
    return p.dst


def column_pass(ntt: "FusedNTT", x, log_m: int, inv: bool) -> NttPass:
    """A plain pass (no factors) of ntt's 2^log_m base along axis 1 of an
    (outer, m, inner, 8) tensor, into a new tensor of the same shape."""
    outer, m, inner = x.shape[0], x.shape[1], x.shape[2]
    return NttPass(x, torch.empty_like(x), ntt._tables[(log_m, inv)], log_m,
                   ((inner, 1, 0, 1, 0), (outer, m * inner, 0, m * inner, 0)),
                   (inner, 0, inner, 0))


def _powers_ints(p: int, base: int, n: int) -> list:
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * base % p
    return out


class FusedNTT:
    """Tables plus the four-step transform for one (field, n, omega, device).
    The inverse includes the 1/n factor.  `_log_max_base` caps the base
    (tests use a small cap for a plan of several levels)."""

    def __init__(self, F: Field, log_n: int, omega_int: int, device,
                 _log_max_base: int = LOG_MAX_BASE):
        assert pow(omega_int, 1 << log_n, F.p) == 1
        assert 1 <= _log_max_base <= LOG_MAX_BASE
        self.F = F
        self.log_n = log_n
        self.n = 1 << log_n
        self.device = device
        self.omega_int = omega_int
        self.omega_inv_int = pow(omega_int, F.p - 2, F.p)
        self.n_inv_int = pow(self.n, F.p - 2, F.p)
        self._cap = _log_max_base
        self._plan: dict = {}      # log_m -> ("base",) | ("split", l1, l2)
        self._tables: dict = {}    # (log_m, inv[, "mid"]) -> tensors
        self._consts: dict = {}    # three ints -> (3, 8) tensor
        self._make_plan(log_n)

    def _encode(self, vals) -> torch.Tensor:
        F = self.F
        return words([F.to_mont_int(v % F.p) for v in vals],
                     (len(vals), NWORDS)).to(self.device)

    def _make_plan(self, log_m: int):
        """Tables for every level: the base's m/2 powers of its root, and
        for a split level the mid twiddle's two tables, wm^e for e <
        2^log_lo and wm^(e 2^log_lo) for the rest of the exponent."""
        if log_m in self._plan:
            return
        p = self.F.p
        for inv in (False, True):
            w = self.omega_inv_int if inv else self.omega_int
            wm = pow(w, self.n >> log_m, p)
            if log_m <= self._cap:
                half = max(1 << max(log_m - 1, 0), 1)
                self._tables[(log_m, inv)] = self._encode(
                    _powers_ints(p, wm, half))
            else:
                log_lo = (log_m + 1) // 2
                self._tables[(log_m, inv, "mid")] = (
                    log_lo,
                    self._encode(_powers_ints(p, wm, 1 << log_lo)),
                    self._encode(_powers_ints(p, pow(wm, 1 << log_lo, p),
                                              1 << (log_m - log_lo))))
        if log_m <= self._cap:
            self._plan[log_m] = ("base",)
            return
        l1 = min(self._cap, (log_m + 1) // 2)
        self._plan[log_m] = ("split", l1, log_m - l1)
        self._make_plan(l1)
        self._make_plan(log_m - l1)

    def _const(self, vals):
        if vals is None:
            return None
        key = tuple(int(v) % self.F.p for v in vals)
        c = self._consts.get(key)
        if c is None:
            c = self._consts[key] = self._encode(list(key))
        return c

    def _run(self, src, dst, log_m: int, inv: bool, dims, j, src_rows,
             dst_rows, load, store):
        """NTT of 2^log_m along the columns `dims` of src into dst (strides
        and rows as in NttPass)."""
        F = self.F
        plan = self._plan[log_m]
        if plan[0] == "base":
            base_ntt(F, NttPass(src, dst, self._tables[(log_m, inv)], log_m,
                                tuple(dims), j, src_rows, dst_rows, load,
                                store))
            return
        _, l1, l2 = plan
        n1, n2, m = 1 << l1, 1 << l2, 1 << log_m
        js, jr, jds, jdr = j
        # scratch: per column (dims flattened, dims[0] fastest) k1 n2 + i2
        flat, t_strides = 1, []
        for d in dims:
            t_strides.append(flat * m)
            flat *= d[0]
        tmp = torch.empty(flat * m, NWORDS, dtype=torch.int32,
                          device=src.device)
        log_lo, lo, hi = self._tables[(log_m, inv, "mid")]
        # over i1 (columns i2, dims), times w^(i2 k1) on the store
        base_ntt(F, NttPass(
            src, tmp, self._tables[(l1, inv)], l1,
            ((n2, js, jr, 1, 0),) + tuple(
                (d[0], d[1], d[2], ts, 0) for d, ts in zip(dims, t_strides)),
            (n2 * js, n2 * jr, n2, 0), src_rows, BIG, load, None,
            (0, log_m, log_lo, lo, hi)))
        # over i2 (columns k1, dims), output k2 n1 + k1
        self._run(tmp, dst, l2, inv,
                  [(n1, n2, 0, jds, jdr)] + [
                      (d[0], ts, 0, d[3], d[4])
                      for d, ts in zip(dims, t_strides)],
                  (1, 0, n1 * jds, n1 * jdr), BIG, dst_rows, None, store)

    def _transform(self, a, inv: bool, load=None, store=None,
                   rows: int = None, out=None):
        """Transform of a: (..., n_in, 8) with n_in <= n, the rows from n_in
        on taken as zero; returns (..., rows or n, 8), the first rows of
        the output, written into `out` when given.  load / store: three
        ints c, input row i multiplied by c[i % 3] before / output row k by
        c[k % 3] after; the inverse's store defaults to 1/n."""
        n = self.n
        n_in = a.shape[-2]
        assert 0 < n_in <= n, f"at most {n} rows, got {tuple(a.shape)}"
        out_rows = n if rows is None else rows
        assert 0 < out_rows <= n
        if inv and store is None:
            store = (self.n_inv_int,) * 3
        batch = tuple(a.shape[:-2])
        b = 1
        for d in batch:
            b *= d
        src = a.reshape(-1, NWORDS)
        if out is None:
            out = torch.empty(batch + (out_rows, NWORDS), dtype=torch.int32,
                              device=a.device)
        assert out.shape == batch + (out_rows, NWORDS)
        dst = out.view(-1, NWORDS)
        if b:
            self._run(src, dst, self.log_n, inv,
                      [(b, n_in, 0, out_rows, 0)], (1, 1, 1, 1),
                      BIG if n_in == n else n_in,
                      BIG if out_rows == n else out_rows,
                      self._const(load), self._const(store))
        return out

    def forward(self, a):
        return self._transform(a, False)

    def inverse(self, a):
        return self._transform(a, True)
