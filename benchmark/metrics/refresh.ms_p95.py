"""refresh.ms_p95: the 95th percentile (``statistics.quantiles(n=100,
method="inclusive")``) of the host-clock latency of the refreshes of a
traced run's window that the profiler did not trace (the window's first
refreshes are traced and run slower), in ms.

It is ``refresh_ms_p95`` read as a per-layer metric, in the cells where the
end-to-end metric spreads past any bound the check allows: there the host
slows in episodes of seconds that move the tail between runs, so it is
recorded and not judged.

Layer: refresh (the harness's loop, ``drive.Program.refresh``). It moves
``refreshes_per_s``: slow refreshes lower the rate.
"""

import statistics

UNIT = "ms"
MOVES = "refreshes_per_s"
SPANS: dict = {}


def read(trace, info):
    lat = info.get("refresh_ms_untraced")
    if not lat or len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94]
