"""analysis.launches_per_refresh: kernels the card ran that were launched
inside ``ops/analyzer.py::analyze_moments`` (assembly and DOA), per
refresh.

Layer: assembly + DOA. It moves ``refreshes_per_s``: each launch costs the
host its enqueue; this count is what fusion or a CUDA graph would cut.
"""

UNIT = "launches"
MOVES = "refreshes_per_s"
SPANS = {"analysis": ["planeverb_tpu_torch.ops.analyzer:analyze_moments"]}


def read(trace, info):
    if not trace.device or trace.refreshes == 0:
        return None
    return len(trace.kernels("analysis")) / trace.refreshes
