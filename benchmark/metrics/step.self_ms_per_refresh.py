"""step.self_ms_per_refresh: the host's time in ``Context.step`` outside its
``fields``, ``simulate+analyze`` and ``publish`` spans (the ``step`` span's
self time: the listener and geometry snapshots, the wanted cells), per
refresh, in ms.

Read from the program's own step records (``utils/profiling.py::steps``),
not from the trace: the steps after the last one a profiler recorded, which
is the traced run's unprofiled remainder, so the profiler's own cost is not
in it. A host clock: where the host does not wait for the card, it times
the enqueue of the card's work.
None without a traced window, where the program keeps no records, or with
fewer than ``LEAST`` such steps.

Layer: Engine step. It moves ``refreshes_per_s``.
"""

UNIT = "ms"
MOVES = "refreshes_per_s"
SPANS: dict = {}
# the fewest unprofiled steps read
LEAST = 100


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
    if steps is None:
        return None
    return sum(s.self_ns("step") for s in steps) * 1e-6 / len(steps)
