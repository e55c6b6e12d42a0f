"""route.idle_ms_per_refresh: the card's idle time while the host's
innermost span was the route's own (``route``,
``ops/fdtd_fused.py::pipeline_auto`` and ``pipeline_auto_batch``, or its
``view`` span around each view's B3 + B4 pass on the tiled route), per
traced refresh, in ms: the host's time between the per-view passes and
before the assembly, outside the solver's and the analysis's spans.

Read from the device trace (``tracing.Trace.idle_by_span``). None without a
device or a traced refresh, or where the trace has no ``route`` span (a
program without the route's span). A program that opens ``route`` but not
``view`` reads the same time, all of it under ``route``.

Layer: Route. It moves ``refreshes_per_s``: the card waits for the host
there.
"""

UNIT = "ms"
MOVES = "refreshes_per_s"
# the program's own spans bound the route; no program function is wrapped
SPANS: dict = {}
ROUTE_SPANS = ("route", "view")


def read(trace, info):
    if (not trace.device or trace.refreshes == 0
            or not any(n == "route" for n, _, _ in trace.spans)):
        return None
    idle = trace.idle_by_span()
    return sum(idle.get(n, 0.0) for n in ROUTE_SPANS) * 1e-3 / trace.refreshes
