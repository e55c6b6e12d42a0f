"""route.tiled_passes_per_refresh: the solver passes a refresh's step makes
on the tiled route, B3 + B4 (the program's ``route.tiled_passes`` counter,
``ops/fdtd_fused.py::pipeline_auto`` and ``pipeline_auto_batch``), per
refresh: 1 for one float32 view on the card (``fdtd_fused.route_tiled``),
one a view above ``TILED_MIN_CELLS``; none for a batched B1 pass.

Read from the program's own step records (``utils/profiling.py::steps``),
not from the trace: the steps after the last one a profiler recorded, which
is the traced run's unprofiled remainder. None without a traced window,
where the program keeps no records, with fewer than ``LEAST`` such steps,
or where none of them holds the counter (a program without it, or whose
every pass ran B1 + B2).

Layer: Route. It moves ``refreshes_per_s``: it says which solver a cell's
refresh ran, so a change of route shows beside the rate it moved.
"""

UNIT = "passes"
MOVES = "refreshes_per_s"
SPANS: dict = {}
# the fewest unprofiled steps read
LEAST = 100
COUNTER = "route.tiled_passes"


def _steps():
    """The program's step records after the last one a profiler recorded
    (the traced window's unprofiled remainder); None where the program
    keeps none, or fewer than :data:`LEAST`."""
    from planeverb_tpu_torch.utils import profiling

    if not hasattr(profiling, "steps"):
        return None
    ring = profiling.steps()
    last = max((i for i, s in enumerate(ring) if s.profiled), default=-1)
    tail = ring[last + 1:]
    return tail if len(tail) >= LEAST else None


def read(trace, info):
    steps = _steps() if trace.refreshes else None
    if steps is None or not any(COUNTER in s.counters for s in steps):
        return None
    return sum(s.counters.get(COUNTER, 0) for s in steps) / len(steps)
