"""Circuit layout rendering + gadget dot graph (port of the JAX
reference's dev/graph.py).

Parity tier for halo2_frontend/src/dev/graph.rs and graph/layout.rs
("dev-graph" feature): `CircuitLayout.render` draws the column/region/cell
matrix picture (matplotlib instead of plotters), `circuit_dot_graph` emits a
Graphviz description of the synthesis region tree.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..frontend.circuit import Circuit, Value, NotEnoughRowsAvailable, configure_circuit
from ..frontend.constraint_system import ConstraintSystem
from ..frontend.expression import ADVICE, FIXED, INSTANCE, Column, Selector


@dataclass
class RegionInfo:
    """Geometry of one region (graph/layout.rs Region)."""
    name: str
    columns: Set[Tuple[str, int]] = field(default_factory=set)
    rows: Set[int] = field(default_factory=set)
    cells: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def start(self) -> Optional[int]:
        return min(self.rows) if self.rows else None

    @property
    def end(self) -> Optional[int]:
        return max(self.rows) if self.rows else None


class _LayoutRecorder:
    """Assignment sink recording region geometry only."""

    def __init__(self, k: int, cs: ConstraintSystem):
        self.n = 1 << k
        self.k = k
        self.cs = cs
        self.usable_rows = self.n - (cs.blinding_factors() + 1)
        self.regions: List[RegionInfo] = []
        self.loose_cells: List[Tuple[str, int, int]] = []
        self.selectors_used: Set[int] = set()
        self.current: Optional[RegionInfo] = None
        self.total_rows = 0

    def _record(self, kind: str, index: int, row: int):
        self.total_rows = max(self.total_rows, row + 1)
        if self.current is not None:
            self.current.columns.add((kind, index))
            self.current.rows.add(row)
            self.current.cells.append((kind, index, row))
        else:
            self.loose_cells.append((kind, index, row))

    # Assignment protocol ------------------------------------------------

    def enter_region(self, name):
        self.current = RegionInfo(str(name))

    def exit_region(self):
        if self.current is not None:
            self.regions.append(self.current)
        self.current = None

    def enable_selector(self, selector: Selector, row: int):
        self.selectors_used.add(selector.index)
        self._record("selector", selector.index, row)

    def query_instance(self, column: Column, row: int) -> Value:
        return Value.unknown()

    def assign_advice(self, column: Column, row: int, value: Value):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        self._record(ADVICE, column.index, row)

    def assign_fixed(self, column: Column, row: int, value: Value):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        self._record(FIXED, column.index, row)

    def copy(self, lcol, lrow, rcol, rrow):
        pass

    def get_challenge(self, challenge) -> Value:
        return Value.unknown()


class CircuitLayout:
    """Render the circuit layout picture (graph/layout.rs CircuitLayout)."""

    def __init__(self, show_labels: bool = True, show_cells: bool = True):
        self.show_labels = show_labels
        self.show_cells = show_cells

    @staticmethod
    def measure(k: int, circuit: Circuit):
        """Synthesize into a recorder; returns (recorder, cs)."""
        cs = ConstraintSystem()
        config = configure_circuit(circuit, cs)
        recorder = _LayoutRecorder(k, cs)
        circuit.floor_planner.synthesize(
            recorder, circuit.without_witnesses(), config, cs.constants)
        return recorder, cs

    def render(self, k: int, circuit: Circuit, path: str):
        """Write a PNG/SVG layout picture to `path`.  Needs matplotlib,
        imported here so that the rest of the module runs without it."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.patches import Rectangle

        recorder, cs = self.measure(k, circuit)

        # column order: instance | advice | fixed+selector (layout.rs style)
        col_order: Dict[Tuple[str, int], int] = {}
        x = 0
        for i in range(cs.num_instance_columns):
            col_order[(INSTANCE, i)] = x
            x += 1
        n_inst = x
        for i in range(cs.num_advice_columns):
            col_order[(ADVICE, i)] = x
            x += 1
        n_adv = x
        for i in range(cs.num_fixed_columns):
            col_order[(FIXED, i)] = x
            x += 1
        for i in sorted(recorder.selectors_used):
            col_order[("selector", i)] = x
            x += 1
        n_cols = x
        rows = max(recorder.total_rows, 1)

        fig, ax = plt.subplots(
            figsize=(max(4, n_cols * 0.6), max(4, rows * 0.18)))
        # column class bands
        ax.add_patch(Rectangle((0, 0), n_inst, rows,
                               color="#ffffff", zorder=0))
        ax.add_patch(Rectangle((n_inst, 0), n_adv - n_inst, rows,
                               color="#fdf2f2", zorder=0))
        ax.add_patch(Rectangle((n_adv, 0), n_cols - n_adv, rows,
                               color="#f0f4fa", zorder=0))

        cmap = plt.get_cmap("tab20")
        for ri, region in enumerate(recorder.regions):
            if not region.rows:
                continue
            color = cmap(ri % 20)
            xs = [col_order[c] for c in region.columns if c in col_order]
            if not xs:
                continue
            x0, x1 = min(xs), max(xs) + 1
            y0, y1 = region.start, region.end + 1
            ax.add_patch(Rectangle((x0, y0), x1 - x0, y1 - y0,
                                   facecolor=color, alpha=0.35,
                                   edgecolor=color, lw=1.2, zorder=1))
            if self.show_labels:
                ax.text(x0 + 0.05, y0 + 0.3, region.name, fontsize=6,
                        zorder=3)
            if self.show_cells:
                for kind, idx, row in region.cells:
                    cx = col_order.get((kind, idx))
                    if cx is not None:
                        ax.add_patch(Rectangle((cx, row), 1, 1,
                                               facecolor=color, alpha=0.8,
                                               zorder=2))
        for kind, idx, row in recorder.loose_cells:
            cx = col_order.get((kind, idx))
            if cx is not None:
                ax.add_patch(Rectangle((cx, row), 1, 1,
                                       facecolor="#888888", alpha=0.6,
                                       zorder=2))

        ax.set_xlim(0, n_cols)
        ax.set_ylim(rows, 0)
        ax.set_xticks([c + 0.5 for c in range(n_cols)])
        ax.set_xticklabels(
            [f"{kind[:1]}{idx}" for (kind, idx), _ in
             sorted(col_order.items(), key=lambda kv: kv[1])],
            fontsize=6)
        ax.set_ylabel("row")
        ax.set_title(f"circuit layout, k={k} "
                     f"({len(recorder.regions)} regions)")
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return recorder


def circuit_dot_graph(k: int, circuit: Circuit) -> str:
    """Graphviz description of the synthesis region tree
    (dev/graph.rs circuit_dot_graph)."""
    recorder, _cs = CircuitLayout.measure(k, circuit)
    lines = ["digraph circuit {", '  root [label="synthesize"];']
    for i, region in enumerate(recorder.regions):
        span = (f"rows {region.start}..{region.end}"
                if region.rows else "empty")
        label = region.name.replace('"', "'")
        lines.append(f'  r{i} [label="{label}\\n{span}"];')
        lines.append(f"  root -> r{i};")
    lines.append("}")
    return "\n".join(lines)
