"""Fault-tolerance primitives of the trainer.

Port of the part of ``repro.distributed.fault_tolerance`` that one device
uses (standard library only):

  * ``StragglerWatchdog`` — per-step wall-time EMA and deadline; on a
    breach it records the event and calls the (pluggable) mitigation hook;
  * ``StepFailure`` — the exception the trainer's retry loop recognizes;
    fault injection in tests raises it to exercise restore-and-replay;
  * ``StateWriteFailure`` — a failure after the step began writing the
    state in place (the port's step updates in place; the JAX one does not);
  * ``failure_injector`` — the test hook that raises it.

``HeartbeatFile`` and the mesh helpers wait for the distributed port
(ROADMAP Queue A 8).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional


class StepFailure(RuntimeError):
    """A step-level fault (collective timeout, preemption, injected)."""


class StateWriteFailure(Exception):
    """A step failed after it had begun to write the state in place: in the
    AdamW update, or at the sync after it, where an asynchronous device
    error may come from the update's own kernels. Replaying the step on that
    state would apply the update twice, so the trainer replays it only from
    a restored checkpoint."""


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    deadline: float


class StragglerWatchdog:
    """EMA-based step-deadline detector with pluggable mitigation."""

    def __init__(
        self,
        deadline_factor: float = 3.0,
        ema_alpha: float = 0.1,
        warmup_steps: int = 3,
        on_straggler: Optional[Callable[[StragglerEvent], None]] = None,
    ):
        self.deadline_factor = deadline_factor
        self.ema_alpha = ema_alpha
        self.warmup_steps = warmup_steps
        self.on_straggler = on_straggler
        self.ema: Optional[float] = None
        self.observed = 0
        self.events: List[StragglerEvent] = []

    @property
    def straggler_count(self) -> int:
        return len(self.events)

    @property
    def deadline(self) -> Optional[float]:
        if self.ema is None or self.observed < self.warmup_steps:
            return None
        return self.deadline_factor * self.ema

    def observe(self, step: int, duration: float) -> bool:
        """Returns True if this step breached the deadline."""
        breach = False
        dl = self.deadline
        if dl is not None and duration > dl:
            ev = StragglerEvent(step=step, duration=duration, deadline=dl)
            self.events.append(ev)
            if self.on_straggler:
                self.on_straggler(ev)
            breach = True
            # Breaching steps do not poison the EMA.
        else:
            self.ema = (
                duration
                if self.ema is None
                else (1 - self.ema_alpha) * self.ema + self.ema_alpha * duration
            )
        self.observed += 1
        return breach


def failure_injector(fail_at_steps, exc=StepFailure):
    """Test helper: raises at the given steps exactly once each."""
    remaining = set(fail_at_steps)

    def hook(step: int):
        if step in remaining:
            remaining.discard(step)
            raise exc(f"injected failure at step {step}")

    return hook
