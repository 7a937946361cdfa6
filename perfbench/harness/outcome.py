"""What a driver hands back to ``run.py``, and what a metric reader reads."""

from dataclasses import dataclass, field
from typing import Optional

from .trace import Trace


@dataclass
class Outcome:
    metrics: dict          # end-to-end values by name
    checks: dict           # {number: {'value', 'limit'}}
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Optional[Trace] = None
    # what the profiled stretch did, from the harness's records and the
    # program's counters (see the drivers)
    record: dict = field(default_factory=dict)
    # where each compared number was read (a leaf), for standard error
    where: dict = field(default_factory=dict)
    # seconds of each set-up phase
    phases: dict = field(default_factory=dict)
    # the window's epoch or request times, in order, for standard error
    notes: dict = field(default_factory=dict)


@dataclass
class ReadContext:
    config: dict
    traffic: dict
    trace: Optional[Trace]
    record: dict


def phase_seconds(marks) -> dict:
    """``{phase: seconds}`` from ``[(phase, time at its end)]``, the first
    entry the start."""
    return {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}
