"""query.host_ms_per_refresh: the host's time reading every emitter's
parameters for every view (``core/context.py::Context.get_output`` ->
``result_at``), the harness's own span around step 4 of a refresh, per
refresh, in ms.

Layer: queries. It moves ``refreshes_per_s``: the reads end every
refresh, after the step, and are reported in every cell (the tail,
``refresh_ms_p95``, is end to end in only some).
"""

UNIT = "ms"
MOVES = "refreshes_per_s"
SPANS: dict = {}


def read(trace, info):
    if trace.refreshes == 0 or not any(n == "query"
                                       for n, _, _ in trace.spans):
        return None
    return trace.host_us("query") * 1e-3 / trace.refreshes
