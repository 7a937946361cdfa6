"""The numbers that decide ``correct``, each held to its limit.

Norms are compared leaf by leaf: the gap between the program's norm of a
leaf and the reference's, over the larger of the reference's norm of that
leaf and of the median leaf, since some gradients are all but zero. The
worst leaf is one reading (``norm_gap``); the lower quartile of the
leaves' gaps another (``quartile_gap``): steady where the worst and the
median leaf swing, since float32 that rounds a pre-activation across a
ReLU's 0 moves every leaf behind that ReLU, on some seeds and not on
others, while a product in a lower precision moves every leaf on every
seed. A leaf whose reference gradient is under ``ROUNDING_SHARE`` of the
median leaf's is left out: such a gradient is round-off, and so are
Adam's steps on it. ``own=True`` takes a leaf's gap over its own norm,
which a small leaf's fault shows in where the median leaf's norm would
hide it."""

import math
import statistics

ROUNDING_SHARE = 1e-3


def leaf_gaps(program: dict, reference: dict, leaves=None,
              own: bool = False) -> dict:
    """``{leaf: gap}`` over ``leaves`` (default: all), each gap over the
    larger of the leaf's reference norm and the median leaf's among
    ``leaves`` (``own``: over the leaf's own); a leaf the program lacks
    reads infinity."""
    leaves = list(leaves if leaves is not None else reference)
    median = 0.0 if own else statistics.median(reference[k] for k in leaves)
    gaps = {}
    for leaf in leaves:
        ref = reference[leaf]
        got = program.get(leaf)
        gaps[leaf] = math.inf if got is None or not math.isfinite(got) \
            else abs(got - ref) / max(ref, median)
    return gaps


def norm_gap(program: dict, reference: dict, leaves=None,
             own: bool = False):
    """``(worst gap, its leaf)`` over ``leaves`` (default: all)."""
    worst, where = 0.0, None
    for leaf, gap in leaf_gaps(program, reference, leaves, own).items():
        if gap > worst or where is None:
            worst, where = gap, leaf
    return worst, where


def quartile_gap(program: dict, reference: dict, leaves=None) -> float:
    """The lower quartile (``statistics.quantiles``, n=4) of the leaves'
    gaps over ``leaves`` (default: all)."""
    gaps = list(leaf_gaps(program, reference, leaves).values())
    low = statistics.quantiles(gaps, n=4)[0] if len(gaps) > 1 else gaps[0]
    return math.inf if math.isnan(low) else low  # between two infinities


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
