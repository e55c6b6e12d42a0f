"""2D FDTD acoustic wave solver — plain PyTorch version.

Counterpart of ``planeverb_tpu/ops/fdtd.py`` (semantics per the reference
ProjectPlaneverb/src/FDTD/FDTD.cpp:87-236):

  - SoA fields ``p/vx/vy`` as exactly [nx, ny] float32 tensors.
  - One fused update per timestep: pressure, both velocity components with
    wall-admittance terms, first-order impedance absorbing edges, recording,
    and source injection at the *listener* cell (acoustic reciprocity: one
    sim yields the IR from every source cell to the listener).
  - Only the pressure field is recorded ([T, nx, ny]); the source-directivity
    flux and the onset are accumulated inside the loop.

The time loop itself is the B1 kernel's plain version in
``ops/fdtd_fused.py``; :func:`simulate` is its JAX-shaped entry point.
Every function here is device-agnostic torch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from planeverb_tpu_torch.config import GridParams

__all__ = ["FdtdResult", "simulate", "admittance", "stencil_coefficients",
           "coefficients_from_fields", "fdtd_step_folded"]


class FdtdResult(NamedTuple):
    """Output of one simulation pass.

    pressure: [T, nx, ny] recorded pressure field (the impulse responses)
    onset:    [nx, ny] first sample where |p| crossed the audible threshold
              (float32; +inf where never crossed)
    flux_x:   [nx, ny] sum of p*vx over the source-directivity window
    flux_y:   [nx, ny] sum of p*vy over the source-directivity window
    """

    pressure: torch.Tensor
    onset: torch.Tensor
    flux_x: torch.Tensor
    flux_y: torch.Tensor


def admittance(reflection: torch.Tensor) -> torch.Tensor:
    """Wall admittance Y = (1-R)/(1+R) from reflection coefficient R
    (FDTD.cpp:158-159)."""
    return (1.0 - reflection) / (1.0 + reflection)


def stencil_coefficients(beta, Y, b_xm, y_xm, b_ym, y_ym, gi, gj,
                         gx: int, gy: int, absorbing: bool = True):
    """Fold wall admittance AND the outer-edge impedance ABC into six static
    per-cell coefficients, so each velocity update is three multiply-adds:

        air = v - C * (p - p_m)
        v'  = A * air + B * p + D * p_m

    At every cell at most one of the reference's update paths is active
    (interior / wall-left / wall-right / edge ABC, FDTD.cpp:143-223), and the
    gating masks are exact 0/1 floats, so this factoring is bit-identical to
    evaluating the branchy form.

    Args:
      beta, Y: [nx, ny] air flags and admittance.
      b_xm/y_xm/b_ym/y_ym: beta/Y shifted one cell back along x/y (zeros
        shifted in at the global edge).
      gi, gj: integer cell coordinates per array slot.
      gx, gy: analysis-grid dims (edge rows/cols of the update).
    """
    w_x = (b_xm - beta) * (beta * y_xm + b_xm * Y)
    a_x = beta * b_xm
    bc_x = w_x * beta
    d_x = w_x * b_xm
    w_y = (b_ym - beta) * (beta * y_ym + b_ym * Y)
    a_y = beta * b_ym
    bc_y = w_y * beta
    d_y = w_y * b_ym

    row0 = gi == 0
    rowg = gi == gx
    col0 = gj == 0
    colg = gj == gy
    zero = torch.zeros_like(beta)
    if absorbing:
        # first-order impedance ABC: v = -p on the leading edge, v = +p_m on
        # the trailing edge, masked to the in-grid span (FDTD.cpp:201-223)
        in_gy = (gj < gy).to(beta.dtype).expand_as(beta)
        in_gx = (gi < gx).to(beta.dtype).expand_as(beta)
        eb_x, ed_x = -in_gy, in_gy
        eb_y, ed_y = -in_gx, in_gx
    else:
        # rigid (fully reflecting) outer walls: v = 0. The reference declares
        # pv_ReflectingBoundary but never implements it (PvTypes.h:33-36).
        eb_x = ed_x = eb_y = ed_y = zero
    a_x = torch.where(row0 | rowg, zero, a_x)
    b_x = torch.where(row0, eb_x, torch.where(rowg, zero, bc_x))
    d_x = torch.where(rowg, ed_x, torch.where(row0, zero, d_x))
    a_y = torch.where(col0 | colg, zero, a_y)
    b_y = torch.where(col0, eb_y, torch.where(colg, zero, bc_y))
    d_y = torch.where(colg, ed_y, torch.where(col0, zero, d_y))
    return a_x, b_x, d_x, a_y, b_y, d_y


def coefficients_from_fields(beta, Y, gx: int, gy: int, absorbing: bool):
    """stencil_coefficients for the single-array layout (array coordinates
    are global coordinates; backward shifts are zero-padded slices)."""
    nx, ny = beta.shape
    b_xm = F.pad(beta[:-1], (0, 0, 1, 0))
    y_xm = F.pad(Y[:-1], (0, 0, 1, 0))
    b_ym = F.pad(beta[:, :-1], (1, 0))
    y_ym = F.pad(Y[:, :-1], (1, 0))
    gi = torch.arange(nx, device=beta.device).view(nx, 1)
    gj = torch.arange(ny, device=beta.device).view(1, ny)
    return stencil_coefficients(beta, Y, b_xm, y_xm, b_ym, y_ym, gi, gj,
                                gx, gy, absorbing)


def fdtd_step_folded(p, vx, vy, beta, coefs, courant: float):
    """One fused FDTD timestep with prefolded coefficients. Returns
    (p, vx, vy) post-update, post-edge-ABC (the ABC lives in ``coefs``);
    the returned ``p`` is this step's pressure before source injection."""
    a_x, b_x, d_x, a_y, b_y, d_y = coefs

    # -- pressure update: p = beta * (p - C * div v)   (FDTD.cpp:124-141)
    vx_xp = F.pad(vx[1:], (0, 0, 0, 1))
    vy_yp = F.pad(vy[:, 1:], (0, 1))
    div = (vx_xp - vx) + (vy_yp - vy)
    p = beta * (p - courant * div)

    # -- velocity updates incl. walls and edge ABC     (FDTD.cpp:143-223)
    p_xm = F.pad(p[:-1], (0, 0, 1, 0))
    air = vx - courant * (p - p_xm)
    vx = a_x * air + b_x * p + d_x * p_xm

    p_ym = F.pad(p[:, :-1], (1, 0))
    air = vy - courant * (p - p_ym)
    vy = a_y * air + b_y * p + d_y * p_ym
    return p, vx, vy


def simulate(params: GridParams, beta, reflection, pulse,
             listener_ix: int, listener_iy: int) -> FdtdResult:
    """Run one full simulation pass (GenerateResponse analog).

    The plain time loop: the B1 kernel's plain version
    (``ops/fdtd_fused.py::fdtd_sim_reference``) without its windowed
    energies, on the fields' device.

    Args:
      params: static grid parameters.
      beta: [nx, ny] float32 air flags.
      reflection: [nx, ny] float32 reflection coefficients R.
      pulse: [T] float32 source pulse.
      listener_ix, listener_iy: listener cell indices.
    """
    from planeverb_tpu_torch.ops.fdtd_fused import fdtd_sim_reference

    res, _ = fdtd_sim_reference(params, beta, reflection, pulse,
                                listener_ix, listener_iy)
    return res
