"""The prover's spans and counters: one record a proof.

`api.create_proof(..., timings=record)` fills the caller's dict `record`
with seconds under each span's name (`SPANS`) and with the proof's
counters (`COUNTERS`), each added to what the dict already holds; a span
that closes several times in a proof (once a phase or a circuit) sums.
The spans nest as `SPANS` says: a step of the proof is a top-level span,
and its children split it, so a child's seconds are part of its parent's.

  kernel_launches  launches of the port's own kernels (`_build.Kernel`);
                   PyTorch's own operations are not counted
  msm_streamed     (window, base) elements the fixed-base MSMs streamed
  msm_added        those of them with a nonzero digit, the ones added
                   (`msm.stream_msm.stream_counters()`)
  host_wait        seconds the host spent blocked on the device: in
                   `_sync` and in `to_host`, the program's explicit
                   device-to-host reads (the copy included)

With a record, each span waits for the device's queued work at its close,
so that a step is charged the device work it queued.  Without one, the
spans read the clock and never wait.  `HALO2_TPU_STEP_TIMINGS=1` prints,
as they close, the reference's lines of the spans in `LINES` (and waits as
a record does).

The clock is `time.time()`, the clock of `torch.profiler`'s host timeline,
so a span's bounds can be placed on a profile.  Inside `profiler_ranges()`
each span is also a `torch.profiler.record_function("halo2[<name>]")`
range, the reference's name form; off by default, since the profiler
mirrors every range onto the device's timeline.  No span draws from the
proof's RNG: the proof bytes are the same with or without a record or
ranges.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

T34 = "witness+advice_commits [T3-4]"
T911 = "grand_products [T9-11]"

# record key -> the key of the span it nests in (None: a step of the proof)
SPANS = {
    "instances [T1-2]": None,
    T34: None,
    "synthesis [T3-4]": T34,
    "blind [T3-4]": T34,
    "encode [T3-4]": T34,
    "msms [T3-4]": T34,
    "normalize+write [T3-4]": T34,
    "set [T3-4]": T34,
    "lookup_permute [T5-6]": None,
    T911: None,
    "permutation_commit [T9]": T911,
    "lookup_products [T10]": T911,
    "shuffle_products [T11]": T911,
    "vanishing_random [T12]": None,
    "evaluate_h [T13]": None,
    "h_pieces [T14]": None,
    "evals [T15-23]": None,
    "multiopen [T24+]": None,
}

# the reference's HALO2_TPU_STEP_TIMINGS label of the spans that print one
LINES = {
    "encode [T3-4]": "[commit_phase] encode",
    "msms [T3-4]": "[commit_phase] msms",
    "normalize+write [T3-4]": "[commit_phase] normalize+write",
    "set [T3-4]": "[commit_phase] set",
    "permutation_commit [T9]": "[T9] permutation_commit",
    "lookup_products [T10]": "[T10] lookup_products",
    "shuffle_products [T11]": "[T11] shuffle_products",
}

COUNTERS = ("kernel_launches", "msm_streamed", "msm_added", "host_wait")

_HOST_WAIT = [0.0]      # seconds in _sync and to_host since import
_RANGES = [0]           # depth of profiler_ranges()


def _sync(device: torch.device):
    """Waits for the work queued on `device` (a CUDA card), into
    host_wait."""
    if device.type == "cuda":
        t0 = time.time()
        torch.cuda.synchronize(device)
        _HOST_WAIT[0] += time.time() - t0


def to_host(t: torch.Tensor) -> torch.Tensor:
    """`t` on the CPU.  A read from a card waits for the work that writes
    `t`: its time goes into host_wait."""
    if t.device.type == "cpu":
        return t
    t0 = time.time()
    out = t.to("cpu")
    _HOST_WAIT[0] += time.time() - t0
    return out


@contextlib.contextmanager
def profiler_ranges():
    """Within it, every span is also a `halo2[<name>]` profiler range."""
    _RANGES[0] += 1
    try:
        yield
    finally:
        _RANGES[0] -= 1


def _counters() -> dict:
    """The process's counters so far, under their record keys.  Reading
    the MSM's count waits for the device."""
    from . import _build
    from .msm import stream_msm
    msm = stream_msm.stream_counters()
    return {"kernel_launches": sum(_build.launch_counts().values()),
            "msm_streamed": msm["streamed"], "msm_added": msm["added"],
            "host_wait": _HOST_WAIT[0]}


class Trace:
    """One proof's spans, open as a stack, summed into `record`: the
    caller's dict, or a dict of its own where the caller keeps none."""

    def __init__(self, record: dict = None, device="cpu"):
        self.lines = os.environ.get("HALO2_TPU_STEP_TIMINGS") == "1"
        self.keep = record is not None
        self.wait = self.keep or self.lines
        self.record = record if record is not None else {}
        self.device = torch.device(device)
        self._open = []         # [name, start, profiler range or None]

    def open(self, name: str):
        parent = self._open[-1][0] if self._open else None
        if parent is not None and parent != SPANS[name]:
            raise RuntimeError(f"span {name!r} opened inside {parent!r}")
        rng = None
        if _RANGES[0]:
            rng = torch.profiler.record_function(f"halo2[{name}]")
            rng.__enter__()
        self._open.append([name, time.time(), rng])

    def close(self, name: str):
        if not self._open or self._open[-1][0] != name:
            raise RuntimeError(f"span {name!r} is not the innermost open")
        _, start, rng = self._open.pop()
        if self.wait:
            _sync(self.device)
        secs = time.time() - start
        self.record[name] = self.record.get(name, 0.0) + secs
        if rng is not None:
            rng.__exit__(None, None, None)
        if self.lines and name in LINES:
            print(f"    {LINES[name]}: {secs:.2f}s", flush=True)

    @contextlib.contextmanager
    def span(self, name: str):
        self.open(name)
        yield
        self.close(name)

    @contextlib.contextmanager
    def proof(self):
        """Around one whole proof: adds the counters' growth over it to a
        kept record.  Spans left open by an error are dropped."""
        before = _counters() if self.keep else None
        try:
            yield
        finally:
            while self._open:
                rng = self._open.pop()[2]
                if rng is not None:
                    rng.__exit__(None, None, None)
        if self.keep:
            for key, v in _counters().items():
                self.record[key] = self.record.get(key, 0) + v - before[key]
