"""The solver's least time on one H100: the work a refresh's simulation and
RT60 moments need, over the card's peaks.

The terms are those of ``chip_smoke.py:572-594`` (``_bound``, ``_sim_bound``
and ``_moments_bound``), copied here so that the yardstick stays with the
benchmark. The solver layer is counted as one piece of work, whichever
kernels run it (B1 + B2 up to 192^2 cells, B3 + B4 above):

- its inputs read once: beta and the six folded coefficient planes (state
  type), and the pulse (float32);
- its outputs written once, for each view: the recording (state type), the
  six float32 accumulator planes (onset, flux x and y, the three windowed
  energies), and the float32 moments s0 and s1.

The recording is not counted again as read by the moments, so a change that
fuses the two passes is judged on the same work.
"""

from __future__ import annotations

# NVIDIA's H100 SXM data sheet: HBM bytes a second, and float32 operations a
# second outside the tensor cores (the solver computes in float32, its bf16
# mode included)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations a cell and step of the simulation, and a recorded sample of the
# moments (the JAX kernels' cost estimates: 40 flops; 8 flops and a log)
SIM_OPS = 40
MOMENTS_OPS = 9


def bound_s(moved_bytes: float, ops: float) -> tuple[float, str]:
    """(seconds, what bounds them): the larger of the bytes over the memory
    rate and the operations over the float32 rate."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sim_work(cells: int, steps: int, views: int = 1,
             state_bytes: int = 4) -> tuple[int, int]:
    """(bytes, operations) of one simulation pass (B1 or B3) for ``views``
    listeners: ``chip_smoke.py::_sim_bound``."""
    moved = (7 * state_bytes * cells + 4 * steps
             + views * (state_bytes * steps * cells + 6 * 4 * cells))
    return moved, SIM_OPS * views * steps * cells


def moments_work(cells: int, steps: int, views: int = 1,
                 rec_bytes: int = 4) -> tuple[int, int]:
    """(bytes, operations) of the moments pass alone (B2 or B4): each
    recording and onset read, s0 and s1 written:
    ``chip_smoke.py::_moments_bound``."""
    moved = views * (rec_bytes * steps * cells + 3 * 4 * cells)
    return moved, MOMENTS_OPS * views * steps * cells


def solver_work(cells: int, steps: int, views: int = 1,
                state_bytes: int = 4) -> tuple[int, int]:
    """(bytes, operations) of the solver layer for one refresh: the
    simulation's inputs and outputs, plus the moments' two output planes;
    the recording and onset are not read again."""
    sim_bytes, sim_ops = sim_work(cells, steps, views, state_bytes)
    _, mom_ops = moments_work(cells, steps, views)
    return sim_bytes + views * 2 * 4 * cells, sim_ops + mom_ops


def solver_bound_s(cells: int, steps: int, views: int = 1,
                   state_bytes: int = 4) -> float:
    """The solver layer's least seconds a refresh on one H100."""
    return bound_s(*solver_work(cells, steps, views, state_bytes))[0]
