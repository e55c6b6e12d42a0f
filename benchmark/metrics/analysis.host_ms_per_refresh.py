"""analysis.host_ms_per_refresh: the host's time inside parameter assembly
and DOA, ``ops/analyzer.py::analyze_moments`` (which calls
``ops/doa.py``), per refresh, in ms: once a view.

Layer: assembly + DOA. It moves ``refreshes_per_s``: the assembly is
host-bound (its torch operations' enqueue), so its host time is what a
fused or graphed assembly would cut.
"""

UNIT = "ms"
MOVES = "refreshes_per_s"
SPANS = {"analysis": ["planeverb_tpu_torch.ops.analyzer:analyze_moments"]}


def read(trace, info):
    if trace.refreshes == 0 or not any(n == "analysis"
                                       for n, _, _ in trace.spans):
        return None
    return trace.host_us("analysis") * 1e-3 / trace.refreshes
