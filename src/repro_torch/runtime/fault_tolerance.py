"""Fault tolerance for a step loop: restart from checkpoints, and a
straggler watchdog (``repro/runtime/fault_tolerance.py``).

  * ``FaultTolerantRunner`` wraps the loop: when a step raises, it
    restores the newest usable checkpoint (newest first over
    ``Checkpointer.steps()``; with none, a snapshot of the initial state)
    and replays from there, within a bound of restarts.  A kernel that
    fails to build or launch (``KernelBuildError``, ``KernelLaunchError``)
    is re-raised at once: a restart cannot mend it.
  * ``StragglerWatchdog`` tracks the mean and variance of step times and
    flags a step beyond k sigma; serving shares it per batch bucket.

One card: the reference's ``shardings`` have no meaning here, so the
runner restores onto ``device`` instead.
"""
from __future__ import annotations

import copy
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.kernels._build import KERNEL_ERRORS

log = logging.getLogger("repro_torch.ft")


def _snapshot(state):
    """Deep copy of a state tree.  Tensors are cloned (detached) and numpy
    arrays copied, so a step that changes its state in place cannot poison
    the replay baseline.  A leaf that refuses to be copied keeps the bare
    reference (the snapshot is best-effort, as the reference's)."""
    if isinstance(state, torch.Tensor):
        return state.detach().clone()
    if isinstance(state, np.ndarray):
        return state.copy()
    if isinstance(state, dict):
        return type(state)((k, _snapshot(v)) for k, v in state.items())
    if isinstance(state, (list, tuple)) and not hasattr(state, "_fields"):
        return type(state)(_snapshot(v) for v in state)
    try:
        return copy.deepcopy(state)
    except Exception:  # noqa: BLE001 — best-effort by contract
        return state


@dataclass
class StragglerWatchdog:
    k_sigma: float = 4.0
    warmup: int = 5
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    _n: int = 0
    _mean: float = 0.0
    _m2: float = 0.0
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """True when the step is a straggler (Welford's running mean and
        variance; none is flagged during the warm-up)."""
        self._n += 1
        delta = dt - self._mean
        self._mean += delta / self._n
        self._m2 += delta * (dt - self._mean)
        if self._n <= self.warmup:
            return False
        var = self._m2 / max(self._n - 1, 1)
        sigma = max(var ** 0.5, 1e-9)
        if dt > self._mean + self.k_sigma * sigma and dt > 1.5 * self._mean:
            self.flagged.append((step, dt))
            log.warning("straggler: step %d took %.3fs (mean %.3fs)",
                        step, dt, self._mean)
            if self.on_straggler:
                self.on_straggler(step, dt, self._mean)
            return True
        return False


class StepFailure(RuntimeError):
    pass


@dataclass
class FaultTolerantRunner:
    """Runs ``total_steps`` of ``step_fn(state, step) -> (state,
    metrics)`` with checkpoint/restart semantics: a checkpoint every
    ``save_every`` steps and at the end (``keep`` of them kept), at most
    ``max_restarts`` restarts, each after ``backoff_s * 2**restarts``
    seconds (at most 60; 0 for none)."""
    checkpointer: Any
    save_every: int = 100
    max_restarts: int = 5
    backoff_s: float = 0.0
    keep: int = 3
    watchdog: StragglerWatchdog = field(default_factory=StragglerWatchdog)

    def run(self, state, step_fn: Callable, total_steps: int,
            start_step: int = 0, device=None):
        """Returns (the step reached, the state).  A restore fills the
        structure of the current state with tensors on ``device``
        (default: each leaf's own)."""
        # the INITIAL state: a restart with nothing checkpointed replays
        # from here, not from the state bound before the failing step
        initial_state = _snapshot(state)
        step = start_step
        restarts = 0
        while step < total_steps:
            try:
                t0 = time.time()
                state, _ = step_fn(state, step)
                self.watchdog.observe(step, time.time() - t0)
                step += 1
                if step % self.save_every == 0 or step == total_steps:
                    self.checkpointer.save(step, state)
                    self.checkpointer.gc(self.keep)
            except KERNEL_ERRORS:
                raise
            except (StepFailure, RuntimeError, ValueError) as e:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                log.warning("step %d failed (%s); restart %d/%d from latest "
                            "checkpoint", step, e, restarts, self.max_restarts)
                if self.backoff_s:
                    time.sleep(min(self.backoff_s * 2 ** restarts, 60.0))
                # the write in flight finishes first, so the restart sees
                # it (a write that failed leaves the older checkpoints)
                try:
                    self.checkpointer.wait()
                except RuntimeError as write_err:
                    log.warning("checkpoint write failed (%s)", write_err)
                # newest first over every checkpoint on disk: one that
                # fails validation (a torn write, a bad manifest) falls
                # back to the next-oldest
                restored = False
                for s in reversed(self.checkpointer.steps()):
                    try:
                        step, state = self.checkpointer.restore(
                            state, step=s, device=device)
                        restored = True
                        break
                    except Exception as restore_err:  # noqa: BLE001
                        log.warning(
                            "checkpoint step %d unusable (%s); trying "
                            "next-oldest", s, restore_err)
                if not restored:
                    # a fresh copy, not the snapshot itself: a step that
                    # mutates in place must not poison a LATER reset
                    step, state = start_step, _snapshot(initial_state)
        self.checkpointer.wait()
        return step, state
