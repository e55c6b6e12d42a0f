"""voxelize.host_ms_per_refresh: the host's time inside
``ops/voxelize.py::voxelize``, per refresh, in ms.

Layer: voxelize, which runs only when the geometry changed: every refresh of
a moving door, none in static scenes. It moves ``refreshes_per_s``.
"""

UNIT = "ms"
MOVES = "refreshes_per_s"
SPANS = {"voxelize": ["planeverb_tpu_torch.ops.voxelize:voxelize"]}


def read(trace, info):
    if trace.refreshes == 0 or not any(n == "voxelize"
                                       for n, _, _ in trace.spans):
        return None
    return trace.host_us("voxelize") * 1e-3 / trace.refreshes
