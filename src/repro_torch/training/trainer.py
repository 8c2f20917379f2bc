"""Fault-tolerant training loop.

Port of ``repro.training.trainer``. Beyond calling the train step:
  * periodic checkpoints (atomic, optionally asynchronous; the data
    position rides in meta); the last one of a run is written before
    ``run`` returns, so a caller that resumes right after finds it;
  * auto-resume from the latest valid checkpoint;
  * step retry with restore-on-failure: a ``StepFailure`` or
    ``RuntimeError`` is logged, the last checkpoint is reloaded and the
    step replayed (deterministic data makes the replay exact); after
    ``max_retries`` the error propagates. The port's step writes the state
    in place, so a ``StateWriteFailure`` (the update failed part-way, or an
    error surfaced at the sync after it) is replayed only from a restored
    checkpoint; with none to restore it propagates;
  * straggler watchdog over per-step wall time;
  * throughput metrics (tokens/s, step time), on the host clock after a
    device sync (``torch.cuda.synchronize`` takes the place of
    ``jax.block_until_ready``).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.distributed.fault_tolerance import (
    StateWriteFailure,
    StepFailure,
    StragglerWatchdog,
)

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_async: bool = True
    keep_last: int = 3
    log_every: int = 10
    max_retries: int = 3
    deadline_factor: float = 3.0


def _sync(metrics: Dict[str, Any]) -> None:
    """Wait for the step's kernels. An error that surfaces here may come
    from the update's own kernels, after the state was written."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            try:
                torch.cuda.synchronize(v.device)
            except RuntimeError as e:
                raise StateWriteFailure(f"device error at the step's sync: {e}") from e
            return


class Trainer:
    def __init__(
        self,
        step_fn: Callable,            # (state, batch) -> (state, metrics)
        state: Any,
        pipeline,                     # data pipeline with .batch_at(step)
        cfg: TrainerConfig,
        *,
        put_batch: Callable = lambda b: b,   # host batch -> device tensors
    ):
        self.step_fn = step_fn
        self.state = state
        self.pipeline = pipeline
        self.cfg = cfg
        self.put_batch = put_batch
        self.step = 0
        self.retries = 0
        self.watchdog = StragglerWatchdog(deadline_factor=cfg.deadline_factor)
        self.history: list = []

    # -- checkpoint plumbing ---------------------------------------------

    def try_resume(self) -> bool:
        if not self.cfg.ckpt_dir:
            return False
        latest = ckpt_lib.latest_step(self.cfg.ckpt_dir)
        if latest is None:
            return False
        self.state, meta, _ = ckpt_lib.restore(self.cfg.ckpt_dir, self.state)
        self.step = int(meta.get("data_step", latest))
        log.info("resumed from checkpoint step=%d", self.step)
        return True

    def _save(self, async_write: bool):
        ckpt_lib.save(self.cfg.ckpt_dir, self.step, self.state,
                      meta={"data_step": self.step}, async_write=async_write,
                      keep_last=self.cfg.keep_last)

    # -- the loop ----------------------------------------------------------

    def run(self, inject_failure: Optional[Callable[[int], None]] = None
            ) -> Dict[str, float]:
        last_metrics: Dict[str, float] = {}
        while self.step < self.cfg.total_steps:
            batch = self.put_batch(self.pipeline.batch_at(self.step))
            retries = 0
            while True:
                t0 = time.perf_counter()
                try:
                    if inject_failure is not None:
                        inject_failure(self.step)
                    new_state, metrics = self.step_fn(self.state, batch)
                    _sync(metrics)
                    break
                except (StepFailure, RuntimeError, StateWriteFailure) as e:
                    retries += 1
                    self.retries += 1
                    log.warning("step %d failed (%s); retry %d", self.step, e, retries)
                    restorable = bool(self.cfg.ckpt_dir) and ckpt_lib.latest_step(
                        self.cfg.ckpt_dir) is not None
                    if retries > self.cfg.max_retries or (
                            isinstance(e, StateWriteFailure) and not restorable):
                        raise
                    # transient-fault recovery: reload the last good state
                    if restorable:
                        self.state, meta, _ = ckpt_lib.restore(self.cfg.ckpt_dir, self.state)
                        self.step = int(meta.get("data_step", self.step))
                        batch = self.put_batch(self.pipeline.batch_at(self.step))
            dt = time.perf_counter() - t0
            self.watchdog.observe(self.step, dt)
            self.state = new_state
            self.step += 1

            last_metrics = {k: float(v) for k, v in metrics.items()}
            last_metrics["step_time_s"] = dt
            tokens = last_metrics.get("tokens", 0.0)
            if tokens:
                last_metrics["tokens_per_s"] = tokens / dt
            self.history.append({"step": self.step, **last_metrics})
            if self.step % self.cfg.log_every == 0:
                log.info(
                    "step %d loss=%.4f acc=%.3f %.0f tok/s stragglers=%d",
                    self.step,
                    last_metrics.get("loss", float("nan")),
                    last_metrics.get("accuracy", 0.0),
                    last_metrics.get("tokens_per_s", 0.0),
                    self.watchdog.straggler_count,
                )
            if self.cfg.ckpt_dir and self.step % self.cfg.ckpt_every == 0:
                self._save(self.cfg.ckpt_async)
        if self.cfg.ckpt_dir:
            self._save(False)
        return last_metrics
