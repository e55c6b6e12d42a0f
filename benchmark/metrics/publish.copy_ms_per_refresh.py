"""publish.copy_ms_per_refresh: the card's time in the step's host copy:
every copy (``gpu_memcpy``) launched inside the program's ``fetch`` span
(``core/context.py::Context.step``: the packed grids' ``.cpu()``, or the
emitters' rows on cells publish), per traced refresh, in ms.

Layer: Publish. It moves ``refreshes_per_s``: the step waits for the copy.
None where the trace has no ``fetch`` span (a program without it) or no
device.
"""

UNIT = "ms"
MOVES = "refreshes_per_s"
# the program's own span bounds the copy; no program function is wrapped
SPANS: dict = {}


def read(trace, info):
    if (not trace.device or trace.refreshes == 0
            or not any(n == "fetch" for n, _, _ in trace.spans)):
        return None
    us = sum(e - s for cat, _, s, e, span in trace.device
             if cat == "gpu_memcpy" and span == "fetch")
    return us * 1e-3 / trace.refreshes
