"""query.host_ms_per_refresh: the host's time reading every emitter's
parameters for every view (``core/context.py::Context.get_output`` ->
``result_at``), the harness's own span around step 4 of a refresh, per
refresh, in ms.

Layer: queries. It moves ``refresh_ms_p95``: the reads are the tail of
every refresh, after the step.
"""

UNIT = "ms"
MOVES = "refresh_ms_p95"
SPANS: dict = {}


def read(trace, info):
    if trace.refreshes == 0 or not any(n == "query"
                                       for n, _, _ in trace.spans):
        return None
    return trace.host_us("query") * 1e-3 / trace.refreshes
