"""Fault tolerance: straggler monitor, elastic mesh planning and crash
recovery (port of ``repro/distributed/ft.py``).

* ``StepMonitor`` — EMA of step time; flags steps slower than
  ``straggler_factor`` x EMA.
* ``run_with_recovery`` — wraps the train loop: on any exception an
  emergency checkpoint is attempted and the loop resumes from the last
  published checkpoint, up to ``max_restarts`` times.
* ``plan_elastic_mesh`` — the largest (data, model) shape for the
  surviving device count that keeps the model-parallel degree.

A step's time is host time: the caller reads a value of the step (a
synchronising ``float(loss)``) before :meth:`StepMonitor.stop`, so the
time covers the device's work.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = ["StepMonitor", "run_with_recovery", "plan_elastic_mesh"]


@dataclass
class StepMonitor:
    ema_decay: float = 0.9
    straggler_factor: float = 2.0
    ema: float | None = None
    slow_steps: list = field(default_factory=list)
    _t0: float | None = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int) -> dict:
        dt = time.monotonic() - self._t0
        straggler = False
        if self.ema is not None and dt > self.straggler_factor * self.ema:
            straggler = True
            self.slow_steps.append((step, dt, self.ema))
        self.ema = dt if self.ema is None else (
            self.ema_decay * self.ema + (1 - self.ema_decay) * dt
        )
        return {"step_time": dt, "ema": self.ema, "straggler": straggler}


def plan_elastic_mesh(n_devices: int, model_parallel: int):
    """Largest (data, model) shape for the surviving device count,
    preserving the model-parallel degree (params must still fit)."""
    if n_devices < model_parallel:
        raise RuntimeError(
            f"{n_devices} devices cannot sustain model_parallel={model_parallel}"
        )
    return (n_devices // model_parallel, model_parallel)


def run_with_recovery(make_loop, *, save_emergency, restore_latest, max_restarts: int = 2):
    """Run ``make_loop(initial_state) -> final_state`` with
    checkpoint-on-failure and resume.  ``save_emergency(state_or_none)``
    persists what it can; ``restore_latest()`` returns the state to
    resume from."""
    restarts = 0
    state = restore_latest()
    while True:
        try:
            return make_loop(state)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 - any step failure
            restarts += 1
            try:
                save_emergency(None)
            except Exception:  # noqa: BLE001
                pass
            if restarts > max_restarts:
                raise RuntimeError(f"train loop failed {restarts} times; giving up") from e
            state = restore_latest()
