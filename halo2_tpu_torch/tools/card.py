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

The SASS census counts the multiplier's instructions by kind (IMAD,
IMAD.WIDE, IMAD.HI, IMAD.X) for each function and for each loop in it, so
that a kernel whose element loop sits beside set-up loops is counted per
element by that loop alone; `ptxas_report` reads the registers and spills
that the build's `ptxas -v` printed.
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


def device_ms(fn, reps: int = 10) -> float:
    """Mean device time of fn() by torch.profiler: the time of the device
    work it enqueues, without the host's dispatch, over reps calls after
    one warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total
               for e in prof.key_averages()) / 1e3 / reps


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


def imad_kind(opcode: str):
    """The multiply kind of a SASS opcode: IMAD, IMAD.WIDE, IMAD.HI or
    IMAD.X (with carry in), or None for what is not an integer multiply
    (the IMAD.MOV / IMAD.IADD / IMAD.SHL moves and every other opcode)."""
    if not opcode.startswith("IMAD") or re.search(r"\.(MOV|IADD|SHL)",
                                                  opcode):
        return None
    for kind in ("WIDE", "HI", "X"):
        if f".{kind}" in opcode:
            return f"IMAD.{kind}"
    return "IMAD"


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)(.*)")
_BRANCH = re.compile(r"\s*(0x[0-9a-f]+)")


def parse_sass(text: str) -> dict:
    """cuobjdump -sass text -> {function: {"kinds": {kind: n}, "loops":
    [{"start", "end", "kinds"}]}}.  A loop is a branch to an earlier
    address; its body is every instruction from the target to the branch,
    so an outer loop's counts include its inner loops'."""
    funcs, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            funcs[fn] = []
            continue
        m = _SASS_LINE.search(line)
        if fn is not None and m:
            funcs[fn].append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = {}
    for fn, ins in funcs.items():
        def kinds(lo, hi):
            c = {}
            for addr, op, _ in ins:
                k = imad_kind(op)
                if k and lo <= addr <= hi:
                    c[k] = c.get(k, 0) + 1
            return c
        loops = []
        for addr, op, rest in ins:
            b = _BRANCH.match(rest) if op.startswith("BRA") else None
            if b and int(b.group(1), 16) < addr:
                start = int(b.group(1), 16)
                loops.append(dict(start=start, end=addr,
                                  kinds=kinds(start, addr)))
        out[fn] = dict(kinds=kinds(0, 1 << 62), loops=loops)
    return out


@functools.lru_cache(maxsize=1)
def sass_report() -> dict:
    """`parse_sass` of the built library (cuobjdump, read once per
    process)."""
    from .. import _build
    _build.library()
    cub = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([cub, "-sass", _build.lib_path], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    report = parse_sass(out)
    if not report:
        raise AssertionError("cuobjdump found no kernel functions")
    return report


def sass_multiplies() -> dict:
    """Integer multiply instructions (IMAD, IMAD.WIDE, IMAD.HI, IMAD.X; not
    the IMAD.MOV / IMAD.IADD / IMAD.SHL moves) of each kernel function in
    the built library's SASS, all kinds together."""
    return {fn: sum(r["kinds"].values()) for fn, r in sass_report().items()}


def loop_multiplies(fn_parts) -> dict:
    """Multiplies by kind in the busiest loop of the one function whose
    name holds every string of fn_parts: the per-element count of a kernel
    whose element loop holds the work, where a count of the whole function
    would add its set-up and other loops."""
    hits = [r for fn, r in sass_report().items()
            if all(p in fn for p in fn_parts)]
    if len(hits) != 1 or not hits[0]["loops"]:
        raise AssertionError(f"SASS loop of {fn_parts}: {len(hits)} hits")
    return max((lp["kinds"] for lp in hits[0]["loops"]),
               key=lambda k: sum(k.values()))


def mont_repeat_multiplies(tag: str) -> float:
    """Kernel 10/11's multiplier instructions per product over the field
    `tag` (its SASS name, e.g. "Bn254Fr"): its reps loop, which holds one
    product for each of a thread's elements, over those elements."""
    from .. import _build
    per_thread = _build.library().h2_mont_elems_per_thread()
    return sum(loop_multiplies(("k_mont_repeat", tag)).values()) / per_thread


def least_multiplies(F) -> int:
    """Multiplier instructions an 8-word schoolbook Montgomery product over
    F needs at least, however it is scheduled: a b's 64 word products, then
    per word of the reduction one for its quotient and one per nonzero
    word of p (Pasta's p has three zero words).  136 for both BN254 fields.
    A product that multiplies fewer words (Karatsuba, or one on the FP64
    pipe) is not held to it and needs a count of its own."""
    nonzero = sum(1 for i in range(8) if (F.p >> (32 * i)) & 0xFFFFFFFF)
    return 64 + 8 * (1 + nonzero)


def ptxas_report() -> dict:
    """Registers, spill stores and loads, and stack of each kernel function,
    from the `ptxas -v` log the build keeps beside the library."""
    from .. import _build
    _build.library()
    out, fn = {}, None
    with open(_build.lib_path + ".ptxas") as f:
        for line in f:
            m = re.search(r"(?:Compiling entry function '|Function properties "
                          r"for )(\w+)", line)
            if m:
                fn = m.group(1)
                out.setdefault(fn, {})
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and fn:
                out[fn].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                out[fn]["registers"] = int(m.group(1))
    return out


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
