"""Model-vs-measured drift detection for the decode hot loop.

Port of ``repro.obs.drift``. The port's ``core.perf_model`` prices the
paged and dense decode attention on the H100 (``numa.H100``); nothing else
says when those constants drift from what the card does. This module is
the hook that keeps them honest:

  * :class:`DriftCollector` rides inside ``LLMEngine.step`` (when
    telemetry is on) and folds each measured decode sync's wall time,
    amortized over its live ticks, into a ``(batch, context-bucket)``
    cell: a bounded-memory histogram per cell.
  * :meth:`DriftCollector.report` puts each cell's measured p50 / mean
    beside the model's prediction for that (batch, mean context):
    ``ratio = measured / modeled``. The models price the attention kernel
    only, not the whole tick (weights, sampler, host sync), so on the card
    the ratio reads far above 1; its trend per cell across changes is the
    signal, not its absolute value.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.obs.metrics import Histogram

__all__ = ["DriftCollector", "DriftReport", "NullDriftCollector",
           "context_bucket"]

#: Sub-microsecond modeled times are treated as "model says free" and
#: reported with ratio None instead of a division blow-up, the same
#: near-zero discipline as ``SchedulerStats``.
MIN_MODELED_S = 1e-9


def context_bucket(mean_len: float) -> int:
    """Bucket a live mean context length to the next power of two (>= 1),
    so cells stay few and stable as batches age."""
    n = max(int(mean_len), 1)
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass
class _Cell:
    """One (batch, context-bucket) calibration cell."""

    hist: Histogram
    len_sum: float = 0.0

    def mean_len(self) -> float:
        return self.len_sum / self.hist.count if self.hist.count else 0.0


class DriftCollector:
    """Measured decode-step times, bucketed by (batch, context)."""

    enabled = True

    def __init__(self):
        self._cells: Dict[Tuple[int, int], _Cell] = {}

    def record(self, batch: int, mean_len: float, seconds: float,
               ticks: int = 1) -> None:
        """Fold one measured decode launch into its cell.

        ``ticks`` is the number of live decode ticks the sync ran (the
        ``steps_per_sync`` hot loop syncs the host once per N tokens):
        the wall time is amortized to ``seconds / ticks`` per tick and
        observed ``ticks`` times, so per-tick cells stay comparable
        across N and the sample count keeps meaning "decode ticks"."""
        ticks = max(int(ticks), 1)
        key = (int(batch), context_bucket(mean_len))
        cell = self._cells.get(key)
        if cell is None:
            cell = self._cells[key] = _Cell(
                Histogram(f"decode_step_b{key[0]}_ctx{key[1]}")
            )
        per_tick = seconds / ticks
        for _ in range(ticks):
            cell.hist.observe(per_tick)
            cell.len_sum += float(mean_len)

    @property
    def num_samples(self) -> int:
        return sum(c.hist.count for c in self._cells.values())

    def reset(self) -> None:
        self._cells.clear()

    def report(
        self, model_fn: Callable[[int, float], float]
    ) -> "DriftReport":
        """Calibration table: measured vs ``model_fn(batch, mean_len)``
        seconds per decode step, one row per populated cell."""
        rows: List[Dict] = []
        for (batch, ctx), cell in sorted(self._cells.items()):
            mean_len = cell.mean_len()
            modeled = float(model_fn(batch, mean_len))
            measured = cell.hist.quantile(0.5)
            rows.append({
                "batch": batch,
                "ctx_bucket": ctx,
                "mean_len": mean_len,
                "samples": cell.hist.count,
                "measured_p50_s": measured,
                "measured_mean_s": cell.hist.mean,
                "measured_p99_s": cell.hist.quantile(0.99),
                "modeled_s": modeled,
                "ratio": (measured / modeled) if modeled > MIN_MODELED_S
                         else None,
            })
        return DriftReport(rows=rows)


@dataclasses.dataclass
class DriftReport:
    """The calibration table (one row per (batch, context) cell)."""

    rows: List[Dict]

    def to_dict(self) -> Dict:
        return {"rows": self.rows}

    def worst_ratio(self) -> Optional[float]:
        """The cell furthest from the model (max measured/modeled), or
        None when no cell has a usable modeled time."""
        ratios = [r["ratio"] for r in self.rows if r["ratio"] is not None]
        return max(ratios) if ratios else None

    def render(self) -> str:
        """Fixed-width calibration table for logs/CI."""
        if not self.rows:
            return "drift: no decode samples recorded"
        cols = ("batch", "ctx", "n", "measured p50", "modeled", "ratio")
        lines = [
            "Drift: measured decode step vs perf_model prediction",
            "  ".join(f"{c:>12}" for c in cols),
        ]
        for r in self.rows:
            ratio = f"{r['ratio']:.1f}x" if r["ratio"] is not None else "n/a"
            lines.append("  ".join(f"{v:>12}" for v in (
                r["batch"], r["ctx_bucket"], r["samples"],
                f"{r['measured_p50_s'] * 1e3:.3f}ms",
                f"{r['modeled_s'] * 1e6:.2f}us", ratio,
            )))
        return "\n".join(lines)


class NullDriftCollector(DriftCollector):
    """Disabled collector: ``record`` does nothing, reports are empty."""

    enabled = False

    def record(self, batch: int, mean_len: float, seconds: float,
               ticks: int = 1) -> None:
        pass
