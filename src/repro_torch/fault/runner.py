"""Fault-tolerant training runner: the port of ``repro.fault.runner``.

Wraps any (state, batch) -> (state, metrics) step with the failure
semantics large fleets need:

  * periodic async checkpoints (CheckpointManager);
  * NaN/Inf loss -> rollback to the last checkpoint and *skip* the bad
    data window (data iterator is seekable by step);
  * exceptions from the step (device loss on real fleets, injected
    faults in tests) -> bounded retries with rollback;
  * SIGTERM/preemption -> final checkpoint before exit;
  * straggler monitor hook (per-step wall time EMA).

Checkpoints store whole host arrays; a restore puts each tensor where
the runner's state has it (``checkpoint.py`` takes ``device=`` for
another device). The runner itself is device-agnostic.

The runner keeps ``self.state`` as it was before a step that it drops
(a non-finite loss, an exception mid-step): it assigns a step's result
only after reading that step's loss, and the steps it runs return new
tensors and leave their input alone (``train/steps.py``). The loss is
read once a step through ``core/sync.host_read``: one counted sync a
step, allowed under sync debug mode "error".
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.sync import host_read
from repro_torch.fault.stragglers import StragglerMonitor
from repro_torch.obs.registry import REGISTRY


@dataclasses.dataclass
class RunnerConfig:
    ckpt_dir: str
    ckpt_every: int = 100
    keep: int = 3
    max_retries: int = 3
    nan_tolerance: int = 0          # consecutive non-finite losses allowed
    handle_sigterm: bool = True


class FaultTolerantRunner:
    def __init__(self, step_fn: Callable, state, make_batch: Callable[[int], object],
                 cfg: RunnerConfig):
        """make_batch(step) must be deterministic/seekable so that replay
        after rollback re-reads the same data (or skips it)."""
        self.step_fn = step_fn
        self.state = state
        self.make_batch = make_batch
        self.cfg = cfg
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep,
                                      every=cfg.ckpt_every)
        self.monitor = StragglerMonitor()
        self.step = 0
        self.events: list[tuple] = []    # (step, kind, info) audit log
        # every audit event also counts into the process registry
        # (fault.events{kind=...}), so the serving stack's stats()
        # surfaces training-side fault state (docs/OBSERVABILITY.md)
        self._event_counter = REGISTRY.counter(
            "fault.events", "fault-tolerance audit events by kind")
        self._steps_counter = REGISTRY.counter(
            "fault.steps", "training steps completed")
        self._preempted = False
        if cfg.handle_sigterm:
            try:
                signal.signal(signal.SIGTERM, self._on_sigterm)
            except ValueError:
                pass                      # non-main thread (tests)

    def _on_sigterm(self, *_):
        self._preempted = True

    def _event(self, step: int, kind: str, info=None) -> None:
        self.events.append((step, kind, info))
        self._event_counter.inc(1, kind=kind)

    def restore(self):
        state, step = self.ckpt.restore_latest(self.state)
        if state is not None:
            self.state, self.step = state, step
            self._event(step, "restored")
        return self.step

    def run(self, n_steps: int, on_metrics: Callable | None = None):
        retries = 0
        bad_streak = 0
        while self.step < n_steps:
            if self._preempted:
                self.ckpt.maybe_save(self.step, self.state, force=True)
                self.ckpt.wait()
                self._event(self.step, "preempted")
                return self.state
            t0 = time.perf_counter()
            try:
                batch = self.make_batch(self.step)
                new_state, metrics = self.step_fn(self.state, batch)
                loss = metrics["loss"]
                loss = float(host_read(loss) if isinstance(loss, torch.Tensor)
                             else np.asarray(loss))
                if not np.isfinite(loss):
                    bad_streak += 1
                    self._event(self.step, "nan_loss", loss)
                    if bad_streak > self.cfg.nan_tolerance:
                        self._rollback(skip_past=self.step + 1)
                        bad_streak = 0
                        continue
                else:
                    bad_streak = 0
                self.state = new_state
                self.step += 1
                retries = 0
                self._steps_counter.inc(1)
                self.monitor.record(time.perf_counter() - t0)
                self.ckpt.maybe_save(self.step, self.state)
                if on_metrics:
                    on_metrics(self.step, metrics)
            except FloatingPointError:
                raise
            except Exception as e:     # device failure / injected fault
                retries += 1
                self._event(self.step, "step_failure", repr(e))
                if retries > self.cfg.max_retries:
                    self.ckpt.wait()
                    raise
                self._rollback()
        self.ckpt.maybe_save(self.step, self.state, force=True)
        self.ckpt.wait()
        return self.state

    def _rollback(self, skip_past: int | None = None):
        state, step = self.ckpt.restore_latest(self.state)
        if state is not None:
            self.state = state
            self.step = max(step, skip_past or 0)
        elif skip_past is not None:
            self.step = skip_past        # no checkpoint yet: just skip data
        self._event(self.step, "rollback")
