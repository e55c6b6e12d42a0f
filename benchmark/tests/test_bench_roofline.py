"""The solver's work counts, pinned to the bounds the kernels' table in
PERF.md gives (``chip_smoke.py:572-594``'s terms)."""

import pytest

from benchmark import reference, roofline


def _ms(work):
    return roofline.bound_s(*work)[0] * 1e3


@pytest.mark.parametrize("world,sim_ms,moments_ms", [
    (25.0, 0.053, 0.052),      # B1, B2 at 192^2 x 1187
    (126.0, 2.240, 2.229),     # B3, B4 at 964^2 x 2006
])
def test_bounds_match_the_kernel_table(world, sim_ms, moments_ms):
    g = reference.grid(world, world, 750)
    cells = g.nx * g.ny
    assert round(_ms(roofline.sim_work(cells, g.steps)), 3) == sim_ms
    assert round(_ms(roofline.moments_work(cells, g.steps)), 3) == moments_ms
    assert roofline.bound_s(*roofline.sim_work(cells, g.steps))[1] == "bytes"


def test_solver_counts_the_recording_once():
    g = reference.grid(25.0, 25.0, 750)
    cells = g.nx * g.ny
    sim = roofline.sim_work(cells, g.steps, 4)
    solver = roofline.solver_work(cells, g.steps, 4)
    # the moments add only their two output planes a view
    assert solver[0] - sim[0] == 4 * 2 * 4 * cells
    assert roofline.solver_bound_s(cells, g.steps, 4) == pytest.approx(
        solver[0] / roofline.HBM_BYTES_PER_S)
