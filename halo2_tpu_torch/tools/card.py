"""The card as the measurement scripts see it: its name, power limit and
clock (`nvidia-smi`), kernel time by CUDA events, and the bound of a
kernel's work, the least time the card could take for it.

bound = max(bytes / HBM rate, integer multiplies / (SMs x IMAD rate x
clock)), with each input byte read once and each output byte written once,
the multiplies per element counted in the built library's SASS, and the
card's maximum SM clock.  The
IMAD rate is the CUDA C++ Programming Guide's for compute capability 9.0;
the probes (`alu_probe.py`) measure the card's own beside it, and the
bounds keep the guide's.
"""

from __future__ import annotations

import functools
import os
import re
import subprocess

import torch

# H100 SXM: HBM3 rate (NVIDIA's data sheet); 32-bit integer multiply-adds
# per clock per SM for compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput table).
HBM_BYTES_PER_S = 3.35e12
N_SM = 132
IMAD_PER_CLK_SM = 64


def require_cuda() -> torch.device:
    """The card; a measurement with no card visible fails."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: this measures the card")
    return torch.device("cuda", 0)


def _smi(query: str, units: bool = True) -> str:
    fmt = "csv,noheader" + ("" if units else ",nounits")
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def name_and_power() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return _smi("name,power.limit")


def max_sm_clock_mhz() -> float:
    return float(_smi("clocks.max.sm", units=False))


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean time of fn() on the card by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn):
    """(fn(), its time on the card in ms), one run by CUDA events: for the
    plain versions, whose single run is both the reference output and the
    timing."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


@functools.lru_cache(maxsize=1)
def sass_multiplies() -> dict:
    """Integer multiply instructions (IMAD, IMAD.WIDE, IMAD.HI, ...; not the
    IMAD.MOV / IMAD.IADD / IMAD.SHL moves) of each kernel function in the
    built library's SASS, from cuobjdump (read once per process)."""
    from .. import _build
    _build.library()
    cub = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([cub, "-sass", _build.lib_path], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn and re.search(r"\bIMAD\b|\bIMAD\.", line) and not re.search(
                r"IMAD\.(MOV|IADD|SHL)", line):
            counts[fn] += 1
    if not counts:
        raise AssertionError("cuobjdump found no kernel functions")
    return counts


class Bounds:
    """bound_ms = max(bytes / HBM rate, multiplies / (SMs x rate x clock)),
    with the multiplies per element taken from the SASS and the guide's
    IMAD rate."""

    def __init__(self, mults: dict, clock_mhz: float):
        self.mults = mults
        self.clock_mhz = clock_mhz
        self.rate = N_SM * IMAD_PER_CLK_SM * clock_mhz * 1e6

    def per_elem(self, *parts) -> int:
        hits = [v for k, v in self.mults.items() if all(p in k for p in parts)]
        if len(hits) != 1:
            raise AssertionError(f"SASS function {parts}: {len(hits)} hits")
        return hits[0]

    def imad_per_clk_sm(self, imads_per_s: float) -> float:
        """A multiply rate per second as IMAD per clock per SM, at the
        card's maximum SM clock."""
        return imads_per_s / (N_SM * self.clock_mhz * 1e6)

    def __call__(self, bytes_moved: float, multiplies: float) -> dict:
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = multiplies / self.rate * 1e3
        return dict(bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=None, bytes_ms=t_bytes, ops_ms=t_ops)
