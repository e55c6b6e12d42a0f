"""solver.roofline_pct: the solver's least time on the card over its device
time, in %, per refresh.

Layer: the solver, ``ops/fdtd_fused.py`` (B1 + B2, up to 192^2 cells) and
``ops/fdtd_tiled.py`` (B3 + B4 above). The numerator is
``benchmark/roofline.py``'s bound for the refresh's views (the layer's
inputs read once, its outputs written once); the denominator the device
time of every kernel launched inside the solver's spans (the kernels, and
the wrappers' own torch operations such as B1's coefficient fold), per
refresh. It moves ``refreshes_per_s``.
"""

from benchmark import roofline

UNIT = "%"
MOVES = "refreshes_per_s"
SPANS = {"solver": [
    "planeverb_tpu_torch.ops.fdtd_fused:fdtd_sim",
    "planeverb_tpu_torch.ops.fdtd_fused:fdtd_sim_batch",
    "planeverb_tpu_torch.ops.fdtd_fused:rt60_moments",
    "planeverb_tpu_torch.ops.fdtd_fused:rt60_moments_batch",
    "planeverb_tpu_torch.ops.fdtd_tiled:fdtd_sim_tiled",
    "planeverb_tpu_torch.ops.fdtd_tiled:rt60_moments_tiled",
]}


def read(trace, info):
    ks = trace.kernels("solver")
    if not ks or trace.refreshes == 0:
        return None
    device_s = sum(e - s for _, _, s, e, _ in ks) * 1e-6 / trace.refreshes
    bound = roofline.solver_bound_s(info["cells"], info["steps"],
                                    info["views"], info["state_bytes"])
    return 100.0 * bound / device_s
