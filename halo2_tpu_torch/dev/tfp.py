"""TracingFloorPlanner (port of the JAX reference's dev/tfp.py;
halo2_frontend/src/dev/tfp.rs:17-120): wraps any
assignment sink, emitting a structured log line for every region entry,
cell assignment, selector enable, and copy — the synthesis-determinism
debugging tool."""

from __future__ import annotations

import logging
from typing import Any

logger = logging.getLogger("halo2_tpu_torch.tfp")


class TracingAssignment:
    """Proxy sink that logs every Assignment call before forwarding."""

    def __init__(self, inner: Any, log_fn=None):
        self._inner = inner
        self._log = log_fn or (lambda msg: logger.debug(msg))
        self._region = None

    def enter_region(self, name):
        self._log(f"enter_region: {name}")
        self._region = name
        self._inner.enter_region(name)

    def exit_region(self):
        self._log(f"exit_region: {self._region}")
        self._region = None
        self._inner.exit_region()

    def push_namespace(self, name):
        self._log(f"push_namespace: {name}")
        push = getattr(self._inner, "push_namespace", None)
        if push is not None:
            push(name)

    def pop_namespace(self, gadget_name):
        # gadget_name is the namespace opener's qualified function name —
        # the tfp.rs analog of the gadget-traces symbol (circuit.rs:948)
        self._log(f"pop_namespace: gadget={gadget_name}")
        pop = getattr(self._inner, "pop_namespace", None)
        if pop is not None:
            pop(gadget_name)

    def enable_selector(self, selector, row):
        self._log(f"enable_selector: sel[{selector.index}] row={row}")
        self._inner.enable_selector(selector, row)

    def query_instance(self, column, row):
        self._log(f"query_instance: {column} row={row}")
        return self._inner.query_instance(column, row)

    def assign_advice(self, column, row, value):
        self._log(f"assign_advice: {column} row={row} known={value.is_known()}")
        self._inner.assign_advice(column, row, value)

    def assign_fixed(self, column, row, value):
        self._log(f"assign_fixed: {column} row={row}")
        self._inner.assign_fixed(column, row, value)

    def copy(self, lcol, lrow, rcol, rrow):
        self._log(f"copy: {lcol}@{lrow} <-> {rcol}@{rrow}")
        self._inner.copy(lcol, lrow, rcol, rrow)

    def get_challenge(self, challenge):
        self._log(f"get_challenge: {challenge.index}")
        return self._inner.get_challenge(challenge)

    @property
    def usable_rows(self):
        return self._inner.usable_rows


class TracingFloorPlanner:
    """Drop-in floor planner: set `circuit.floor_planner = TracingFloorPlanner
    (inner_planner, log_fn)` to trace synthesis."""

    def __init__(self, inner_planner, log_fn=None):
        self.inner = inner_planner
        self.log_fn = log_fn

    def synthesize(self, assignment, circuit, config, constants):
        traced = TracingAssignment(assignment, self.log_fn)
        self.inner.synthesize(traced, circuit, config, constants)
