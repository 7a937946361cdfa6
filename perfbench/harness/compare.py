"""The numbers that decide ``correct``, each held to its limit.

Norms are compared leaf by leaf: the gap between the program's norm of a
leaf and the reference's, over the reference's norm of that same leaf; the
worst leaf is the reading. A leaf whose reference gradient is under
``ROUNDING_SHARE`` of the median leaf's is left out: such a gradient is
float32's round-off, and so are Adam's steps on it."""

import math
import statistics

ROUNDING_SHARE = 1e-6


def norm_gap(program: dict, reference: dict, leaves=None):
    """``(worst gap, its leaf)`` over ``leaves`` (default: all); a leaf the
    program lacks reads infinity."""
    worst, where = 0.0, None
    for leaf in (leaves if leaves is not None else reference):
        ref = reference[leaf]
        got = program.get(leaf)
        gap = math.inf if got is None or not math.isfinite(got) else \
            abs(got - ref) / ref
        if gap > worst or where is None:
            worst, where = gap, leaf
    return worst, where


def moved_leaves(grad_norms: dict, share: float = ROUNDING_SHARE):
    """Leaves whose reference gradient is at least ``share`` of the median
    leaf's."""
    median = statistics.median(grad_norms.values())
    return [k for k, v in grad_norms.items() if v >= share * median]


def relative_gap(program, reference) -> float:
    """The largest ``|p - r| / |r|`` over paired values."""
    worst = 0.0
    for p, r in zip(program, reference):
        gap = math.inf if p is None or not math.isfinite(p) else \
            abs(p - r) / abs(r)
        worst = max(worst, gap)
    if len(program) != len(reference):
        worst = math.inf
    return worst


def checks(readings: dict, limits: dict) -> dict:
    """``{number: {'value', 'limit'}}`` of every limit; a number the run
    could not read counts as infinite."""
    return {k: {'value': readings.get(k, math.inf), 'limit': limits[k]}
            for k in limits}


def all_within(result: dict) -> bool:
    return all(math.isfinite(c['value']) and c['value'] <= c['limit']
               for c in result.values())
