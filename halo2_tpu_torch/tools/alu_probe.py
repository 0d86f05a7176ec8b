"""Kernels 10/11 and 12 (csrc/alu.cu): the integer-ALU rate probes, and the
probe that runs them on the card.

    python -m halo2_tpu_torch.tools.alu_probe

Port of the JAX reference's tools/alu_probe.py (`mont_repeat`,
`u32_mul_repeat`) and of bench.py's `mul_alu_kernel` (the same Montgomery
body over BN254 Fr).  A Montgomery product streamed from memory is bound by
bytes; `reps` dependent products per element inside one kernel are bound by
the card's integer multiplies, which is the rate every ALU bound in this
repo rests on.  The u32 chain v <- v b + 1 measures the raw multiply-add
issue rate beside it, and its wide form w <- lo(w) b + w (64-bit w) the
rate of the 32 x 32 -> 64-bit multiply-add, IMAD.WIDE, that most of the
carry-chain product's multiplies are.

Inputs to `mont_repeat` are canonical (< p) Montgomery words, as bench.py
makes them with `F.to_mont`.  The reference's probe feeds raw random 16-bit
limbs, most of them >= p, where its 16 x 16-bit body and the kernel's 32-bit
CIOS product need not agree.

Layouts: `mont_repeat` takes (n, 8) words (the reference's (16, n) u16
limbs are `compat/from_jax.limbs_from_jax` of their transpose);
`u32_mul_repeat` takes (8, n) int32 bit patterns, as the reference's (8, n)
uint32.  The wrappers take the plain versions only for CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._build import I32, I64, P, Kernel, stream_of
from ..fields import BN254_FQ
from ..fields.cuda_ops import MUL, NWORDS, binop_plain
from . import card

MASK32 = 0xFFFFFFFF
WIDE_CHAINS = 4        # independent chains a lane of kernel 12's wide form

_mont_kernel = Kernel("h2_mont_repeat", [I32, P, P, P, I64, I32, P])
_u32_kernel = Kernel("h2_u32_mul_repeat", [P, P, P, I64, I32, I32, P])


def random_elems(F, n: int, seed: int, device):
    """n canonical Montgomery elements (n, 8) from a numpy seed."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, NWORDS), dtype=np.uint64)
    words[:, 7] %= F.p >> 224            # below p's top word: canonical
    t = torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(device)
    return F.to_mont(t)


def random_u32(shape, seed: int, device):
    """int32 bit patterns of uniform u32 words from a numpy seed."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(device)


def _check_same(what: str, a, b, dtype, shape_ok: bool):
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"{what} on unsupported devices {a.device}, "
                         f"{b.device}")
    if a.dtype != dtype or b.dtype != dtype or a.shape != b.shape or \
            not shape_ok:
        raise ValueError(f"{what}: unsupported operands {a.dtype} "
                         f"{tuple(a.shape)}, {b.dtype} {tuple(b.shape)}")


# ----------------------------------------------------------------------
# kernel 10/11: repeated Montgomery products
# ----------------------------------------------------------------------

def mont_repeat_plain(F, a, b, reps: int):
    """`reps` calls of kernel A's plain product: a <- a b."""
    for _ in range(reps):
        a = binop_plain(F, MUL, a, b)
    return a


def mont_repeat(F, a, b, reps: int):
    """a <- a b (Montgomery, field F), `reps` times, on (n, 8) canonical
    words: kernel 10 for BN254 Fr, 11 for BN254 Fq (any field of kernel A
    runs)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_repeat_plain(F, a, b, reps)
    _check_same("mont_repeat", a, b, torch.int32,
                a.dim() == 2 and a.shape[-1] == NWORDS)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    _mont_kernel.launch(F.kernel_id, a.data_ptr(), b.data_ptr(),
                        out.data_ptr(), a.shape[0], reps, stream_of(out))
    return out


# ----------------------------------------------------------------------
# kernel 12: the u32 multiply-add chain
# ----------------------------------------------------------------------

def u32_mul_repeat_plain(a, b, reps: int, wide: bool = False):
    """v <- v b + 1 mod 2^32, `reps` times, in int64 (torch's CPU uint32
    lacks the arithmetic): b is split in 16-bit halves so that no product
    leaves int64.  wide: WIDE_CHAINS chains w_j <- lo(w_j) b + w_j mod
    2^64 from w_j = a + j, each w_j as two 32-bit words; the lane is the
    xor of every lo(w_j) and hi(w_j)."""
    v = a.to(torch.int64) & MASK32
    m = b.to(torch.int64) & MASK32
    lo, hi = m & 0xFFFF, m >> 16
    if not wide:
        for _ in range(reps):
            v = (v * lo + (((v * hi) & 0xFFFF) << 16) + 1) & MASK32
    else:
        w = v + torch.arange(WIDE_CHAINS, device=v.device).view(
            (-1,) + (1,) * v.dim())
        v, h = w & MASK32, w >> 32
        for _ in range(reps):
            x0, x1 = v & 0xFFFF, v >> 16
            mid = x1 * lo + x0 * hi
            low = x0 * lo + ((mid & 0xFFFF) << 16)
            s = (low & MASK32) + v
            h = (x1 * hi + (mid >> 16) + (low >> 32) + h + (s >> 32)) & MASK32
            v = s & MASK32
        v = functools.reduce(torch.bitwise_xor, (v ^ h).unbind(0))
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def u32_mul_repeat(a, b, reps: int, wide: bool = False):
    """v <- v b + 1 (wrapping u32), `reps` times, on int32 bit patterns of
    any shape (the reference's (8, n)); wide: the IMAD.WIDE chain of
    `u32_mul_repeat_plain`."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return u32_mul_repeat_plain(a, b, reps, wide)
    _check_same("u32_mul_repeat", a, b, torch.int32, True)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    _u32_kernel.launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                       reps, int(wide), stream_of(out))
    return out


# ----------------------------------------------------------------------
# the probe (the reference's sweep, on the card)
# ----------------------------------------------------------------------

def main(n: int = 1 << 21) -> dict:
    """The reference's sweep at n elements: Montgomery reps 1/4/16/64 (BN254
    Fq), u32 reps 64/256 (and 1,024, where loads and stores no longer
    overlap the chain) on (8, n) lanes, and the chained-dispatch comparison
    as 64 and 256 launches of kernel A; beside the u32 chain its IMAD.WIDE
    form at 1,024 steps of each of its chains.  Rates per clock use the card's
    maximum SM clock and the multiplies per product in kernel 11's SASS;
    each Montgomery rate is also given as a share of the rate at the
    product's least multiplies (`card.least_multiplies`) and the guide's
    IMAD rate."""
    dev = card.require_cuda()
    print(card.name_and_power(), flush=True)
    bound = card.Bounds(card.sass_multiplies(), card.max_sm_clock_mhz())
    F = BN254_FQ
    per_mul = card.mont_repeat_multiplies("Bn254Fq")
    least = card.least_multiplies(F)
    least_rate = bound.rate / least
    a, b = random_elems(F, n, 0, dev), random_elems(F, n, 1, dev)
    out = {"mont": [], "u32": [], "chained": [], "imad_per_product": per_mul,
           "least_multiplies": least,
           "guide_imad_per_clk_sm": card.IMAD_PER_CLK_SM}
    for reps in (1, 4, 16, 64):
        ms = card.cuda_ms(lambda: mont_repeat(F, a, b, reps))
        rate = n * reps / ms * 1e3
        imad = bound.imad_per_clk_sm(rate * per_mul)
        print(f"mont reps={reps:3d}: {ms:8.3f} ms  {rate / 1e9:6.2f} G "
              f"muls/s  {imad:5.1f} IMAD/clk/SM ({per_mul:g} per product, "
              f"guide {card.IMAD_PER_CLK_SM}); {rate / least_rate:.3f} of "
              f"the least-multiplies rate  (stream-once "
              f"{n * 96 / ms / 1e6:.0f} GB/s)", flush=True)
        out["mont"].append(dict(reps=reps, ms=ms, muls_per_s=rate,
                                imad_per_clk_sm=imad,
                                least_share=rate / least_rate))
    a8, b8 = random_u32((8, n), 2, dev), random_u32((8, n), 3, dev)
    for reps in (64, 256, 1024):
        ms = card.cuda_ms(lambda: u32_mul_repeat(a8, b8, reps))
        imad = bound.imad_per_clk_sm(8 * n * reps / ms * 1e3)
        print(f"u32 mul+add reps={reps}: {ms:8.3f} ms  "
              f"{8 * n * reps / ms / 1e9:.3f} T mul-adds/s  {imad:5.1f} "
              f"IMAD/clk/SM (guide {card.IMAD_PER_CLK_SM})", flush=True)
        out["u32"].append(dict(reps=reps, ms=ms, imad_per_clk_sm=imad))
    reps = 1024
    ms = card.cuda_ms(lambda: u32_mul_repeat(a8, b8, reps, wide=True))
    wide = bound.imad_per_clk_sm(WIDE_CHAINS * 8 * n * reps / ms * 1e3)
    print(f"IMAD.WIDE mul+add reps={reps}: {ms:8.3f} ms  {wide:5.1f} "
          f"IMAD.WIDE/clk/SM (u32 chain {out['u32'][-1]['imad_per_clk_sm']:.1f}"
          f")", flush=True)
    out["wide"] = dict(reps=reps, ms=ms, imad_wide_per_clk_sm=wide)
    for reps in (64, 256):
        def chain():
            x = a
            for _ in range(reps):
                x = F.mul(x, b)
            return x
        ms = card.cuda_ms(chain, 1)
        print(f"chained-dispatch reps={reps}: {ms:8.2f} ms  "
              f"{n * reps / ms / 1e6:6.2f} G muls/s (implied "
              f"{n * reps * 96 / ms / 1e6:.0f} GB/s)", flush=True)
        out["chained"].append(dict(reps=reps, ms=ms,
                                   muls_per_s=n * reps / ms * 1e3))
    return out


if __name__ == "__main__":
    main()
