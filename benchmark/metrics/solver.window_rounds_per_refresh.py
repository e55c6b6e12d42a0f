"""solver.window_rounds_per_refresh: the window-rounds a refresh's B3
passes wait for (the program's ``solver.window_rounds`` counter,
``ops/fdtd_tiled.py::fdtd_sim_tiled``: each pass on the card adds its rounds
times the windows its busiest SM steps in a round), per refresh. The grid
barrier ends a round when the busiest SM is done, so this is the length of
a pass's critical path in windows, which B3's round plan lowers.

Read from the program's own step records (``utils/profiling.py::steps``),
not from the trace: the steps after the last one a profiler recorded, which
is the traced run's unprofiled remainder. None without a traced window,
where the program keeps no records, with fewer than ``LEAST`` such steps,
or where none of them holds the counter (a program without it, or whose
every pass ran B1 + B2).

Layer: the solver. It moves ``refreshes_per_s``: at 126 m B3 takes most of
a refresh.
"""

UNIT = "window-rounds"
MOVES = "refreshes_per_s"
SPANS: dict = {}
# the fewest unprofiled steps read
LEAST = 100
COUNTER = "solver.window_rounds"


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
