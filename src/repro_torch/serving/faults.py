"""Fault injection + step watchdog for the serving path.

The serving analogue of the reference's ``runtime/cluster_sim.py``: a
:class:`ServeFaultPlan` declares *what* goes wrong (a step exception, NaN
logits, a slow step, forced page pressure, a failing bucket compile) and
*when* (scheduler step index / shape bucket), and a :class:`FaultInjector`
fires those faults into a live :class:`~repro_torch.serving.Scheduler`.
Injected faults enter the same detection + recovery ladder real failures
do (fallback re-run → recompute-from-tokens → typed ``failed`` finishes),
so the tests that drive a plan through the scheduler exercise the
production recovery code. On the card the ladder takes only what
:func:`degrades` admits: a planted fault, or non-finite logits (which
recompute through the same kernels). A kernel that fails to build or
launch there raises out of the compiler and the scheduler.

Detection is centralized in :class:`StepWatchdog`, which wraps a
:class:`HeartbeatMonitor` — a copy of the reference trainer's
(``repro/runtime/trainer.py``), the duration-median straggler/deadline
machinery that guards training steps there — and every detected fault
lands as a typed event in ``watchdog.events`` (mirroring
``Compiled.report``'s typed entries).

Slow steps are *simulated*: the injector hands the scheduler a duration
multiplier instead of sleeping, so the watchdog sees a straggling step
without the test suite paying wall-clock time.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch


class HeartbeatMonitor:
    """Tracks per-step durations; flags stragglers and missed deadlines
    (the reference trainer's monitor, kept here until the runtime is
    ported)."""

    def __init__(self, deadline_s: float, straggler_factor: float):
        self.deadline_s = deadline_s
        self.straggler_factor = straggler_factor
        self.durations = []
        self.events = []
        self.host_status = {}  # host -> last status ("ok|straggler|dead")

    def record(self, host: int, duration: float):
        self.durations.append(duration)
        if duration > self.deadline_s:
            self.events.append(("dead", host, duration))
            self.host_status[host] = "dead"
            return "dead"
        # dead hosts record inf/NaN durations; those must not enter the
        # straggler median or one death inflates the threshold forever
        finite = [d for d in self.durations[-32:] if np.isfinite(d)]
        med = float(np.median(finite)) if finite else duration
        if len(finite) >= 4 and duration > self.straggler_factor * med:
            self.events.append(("straggler", host, duration))
            self.host_status[host] = "straggler"
            return "straggler"
        self.host_status[host] = "ok"
        return "ok"


class StepFault(RuntimeError):
    """A typed serving-step fault (injected or detected)."""

    def __init__(self, kind: str, detail: str = ""):
        super().__init__(f"{kind}: {detail}" if detail else kind)
        self.kind = kind
        self.detail = detail


def degrades(error: BaseException, device) -> bool:
    """Whether the serving ladder may answer ``error`` by degrading (the
    interpreter rung, a recompute) instead of raising it. On the CPU every
    step or compile error degrades. On the card only a fault the injection
    harness planted (a :class:`StepFault`) does: a generated or hand-written
    kernel that fails to build or launch there is an error, and serving the
    step's plain version in its place would hide it."""
    return isinstance(error, StepFault) or torch.device(device).type != "cuda"


class StepWatchdog:
    """HeartbeatMonitor-backed detection for compiled decode steps.

    ``record`` feeds per-step durations to the shared monitor (host 0 —
    the serving process) and keeps a typed event log; ``fault`` logs
    detected step faults (exceptions, NaN logits, recoveries) in the
    same stream so ``Scheduler.stats()`` can report one timeline.
    """

    def __init__(self, deadline_s: float = 60.0,
                 straggler_factor: float = 4.0,
                 monitor: Optional[HeartbeatMonitor] = None):
        self.monitor = monitor or HeartbeatMonitor(deadline_s,
                                                   straggler_factor)
        self.events: List[dict] = []

    def record(self, step: int, duration: float) -> str:
        """Feed one step duration; returns ``ok | straggler | dead``."""
        status = self.monitor.record(0, duration)
        if status != "ok":
            self.events.append({"kind": status, "step": step,
                                "duration": duration})
        return status

    def fault(self, step: int, kind: str, detail: str = ""):
        self.events.append({"kind": kind, "step": step, "detail": detail})

    def faults_of(self, kind: str) -> List[dict]:
        return [e for e in self.events if e["kind"] == kind]


@dataclasses.dataclass
class ServeFaultPlan:
    """Declarative serving fault plan (cluster_sim.FaultPlan analogue).

    All ``*_at`` fields are scheduler step indices (``Scheduler.n_steps``
    at fire time). One-shot faults fire exactly once even if the step is
    re-run through the fallback path; ``*_persistent`` re-arms them on
    every attempt from the trigger step onward (exercising the
    repeatedly-failing → ``failed`` path).
    """
    #: raise a StepFault out of the compiled step call
    step_exception_at: Optional[int] = None
    exception_persistent: bool = False
    #: overwrite (a slice of) the step's logits with NaN after it runs
    nan_logits_at: Optional[int] = None
    nan_slots: Optional[Tuple[int, ...]] = None  # None -> every lane
    nan_persistent: bool = False
    #: report the step's duration multiplied (watchdog sees a straggler)
    slow_step_at: Optional[int] = None
    slow_factor: float = 20.0
    #: seize free pages (no reservation accounting) to force preemption
    page_pressure_at: Optional[int] = None
    page_pressure_pages: int = 0  # 0 -> every free page
    page_pressure_release_at: Optional[int] = None
    #: fail the grid compile of these (B, ctx) buckets ("all" = any)
    compile_fail_buckets: Tuple = ()
    compile_fail_times: int = 1


class FaultInjector:
    """Fires a :class:`ServeFaultPlan` into a running scheduler.

    The scheduler calls the three hooks itself (`on_step_begin`,
    `on_execute`, `corrupt_logits`/`slow_factor_for`); `attach` wires the
    compile-failure hook into the scheduler's DecodeStepCompiler. Every
    fired fault is logged in ``events``.
    """

    def __init__(self, plan: ServeFaultPlan):
        self.plan = plan
        self.events: List[dict] = []
        self._fired: set = set()
        self._seized: List[int] = []
        self._compile_fails = 0
        self._pool = None

    def attach(self, scheduler):
        scheduler.compiler.compile_fault = self.compile_fault
        self._pool = scheduler.pool

    def _fire_once(self, name: str) -> bool:
        if name in self._fired:
            return False
        self._fired.add(name)
        return True

    # -- hooks ----------------------------------------------------------
    def on_step_begin(self, step: int, scheduler):
        """Pre-admission faults: seize/release pool pages. While the
        pressure window is open the pool is re-drained every step (pages
        freed by finishing requests would otherwise refill it), so any
        page-boundary crossing inside the window is guaranteed to hit an
        empty pool and take the preemption path."""
        plan = self.plan
        if (plan.page_pressure_release_at is not None
                and step >= plan.page_pressure_release_at and self._seized):
            scheduler.pool.release(self._seized)
            self.events.append({"kind": "page_pressure_release",
                                "step": step,
                                "released": len(self._seized)})
            self._seized = []
            self._fired.add("page_pressure_window")
        elif (plan.page_pressure_at is not None
                and step >= plan.page_pressure_at
                and "page_pressure_window" not in self._fired):
            want = plan.page_pressure_pages
            if want > 0 and self._seized:
                return  # fixed-count pressure: seize once only
            taken = scheduler.pool.seize(want)
            if taken:
                self._seized.extend(taken)
                self.events.append({"kind": "page_pressure", "step": step,
                                    "seized": len(taken)})
            if plan.page_pressure_release_at is None:
                # no release scheduled: one-shot seize, don't re-drain
                self._fired.add("page_pressure_window")

    def on_execute(self, step: int, retry: bool = False):
        """Called immediately before each step execution attempt."""
        plan = self.plan
        if plan.step_exception_at is None:
            return
        if plan.exception_persistent:
            if step >= plan.step_exception_at:
                self.events.append({"kind": "step_exception", "step": step,
                                    "retry": retry})
                raise StepFault("injected_step_exception",
                                f"persistent from step "
                                f"{plan.step_exception_at}")
        elif (step == plan.step_exception_at and not retry
              and self._fire_once("step_exception")):
            self.events.append({"kind": "step_exception", "step": step,
                                "retry": retry})
            raise StepFault("injected_step_exception", f"at step {step}")

    def corrupt_logits(self, step: int, rows: np.ndarray) -> np.ndarray:
        """Post-execution logits corruption (NaN injection)."""
        plan = self.plan
        if plan.nan_logits_at is None:
            return rows
        fire = (step >= plan.nan_logits_at if plan.nan_persistent
                else step == plan.nan_logits_at
                and self._fire_once("nan_logits"))
        if not fire:
            return rows
        rows = rows.copy()
        if plan.nan_slots is None:
            rows[:] = np.nan
        else:
            for s in plan.nan_slots:
                if s < rows.shape[0]:
                    rows[s] = np.nan
        self.events.append({"kind": "nan_logits", "step": step,
                            "slots": plan.nan_slots})
        return rows

    def slow_factor_for(self, step: int) -> float:
        plan = self.plan
        if (plan.slow_step_at is not None and step == plan.slow_step_at
                and self._fire_once("slow_step")):
            self.events.append({"kind": "slow_step", "step": step,
                                "factor": plan.slow_factor})
            return plan.slow_factor
        return 1.0

    def compile_fault(self, B: int, ctx: int):
        """Installed as DecodeStepCompiler.compile_fault by ``attach``."""
        plan = self.plan
        if not plan.compile_fail_buckets:
            return
        hit = (plan.compile_fail_buckets == "all"
               or (B, ctx) in plan.compile_fail_buckets)
        if hit and self._compile_fails < plan.compile_fail_times:
            self._compile_fails += 1
            self.events.append({"kind": "compile_failure",
                                "bucket": (B, ctx)})
            raise StepFault("injected_compile_failure",
                            f"bucket ({B}, {ctx})")
