"""Fault tolerance on one device: restart-exact recovery, stragglers.

``run_with_recovery`` is the driver loop: it catches a failed step,
restores the latest checkpoint and resumes from its step — exactly,
because the data pipeline is a pure function of the step and the
step's entropy key is a pure function of (run key, step).
``StepTimer`` flags step-time outliers by a robust z-score.  Elastic
re-planning onto a smaller mesh (the reference's ``elastic_replan``,
``surviving_topology``) comes with the multi-device slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.checkpoint import Checkpointer
from repro_torch.core.rounding import fold_key
from repro_torch.core.tree import tree_leaves


@dataclass
class StepTimer:
    window: int = 50
    threshold: float = 3.0          # robust z-score
    times: list = field(default_factory=list)
    stragglers: list = field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        hist = self.times[-self.window:]
        if len(hist) < 10:
            return False
        med = float(np.median(hist))
        mad = float(np.median(np.abs(np.array(hist) - med))) + 1e-9
        z = (dt - med) / (1.4826 * mad)
        if z > self.threshold:
            self.stragglers.append((step, dt, z))
            return True
        return False


def run_with_recovery(*, step_fn: Callable, state: Any, batches: Callable,
                      ckpt: Optional[Checkpointer], meta: dict, n_steps: int,
                      checkpoint_every: int = 50, key: int = 0,
                      max_failures: int = 3,
                      on_metrics: Optional[Callable] = None,
                      fail_injector: Optional[Callable] = None) -> Any:
    """Run steps state["step"] .. n_steps - 1, checkpointing every
    `checkpoint_every` steps and at the end.

    batches: step -> batch (pure).  step_fn(state, batch, key) ->
    (state, metrics); reading the metrics waits for the device, so a
    step's time covers its work.  fail_injector: step -> None or raise (test hook).
    On a failure it restores the latest checkpoint onto the state's
    device and replays from its step.  Without a checkpointer (`ckpt`
    None) nothing is saved and a failed step raises.
    """
    timer = StepTimer()
    failures = 0
    step = int(state["step"])
    while step < n_steps:
        try:
            if fail_injector is not None:
                fail_injector(step)
            t0 = time.monotonic()
            state, metrics = step_fn(state, batches(step),
                                     fold_key(key, step))
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0
            timer.record(step, dt)
            if on_metrics is not None:
                on_metrics(step, metrics, dt)
            step += 1
            if ckpt is not None and step % checkpoint_every == 0:
                ckpt.save(step, state, meta)
        except Exception:
            failures += 1
            if failures > max_failures or ckpt is None \
                    or ckpt.latest_step() is None:
                raise
            ckpt.wait()
            dev = tree_leaves(state["params"])[0][1].device
            state, step, _ = ckpt.restore(device=dev)
    if ckpt is not None:
        ckpt.save(n_steps, state, meta, blocking=True)
    return state

