"""B3/B4 plain versions (ops/fdtd_tiled.py) on the CPU.

The CUDA kernels need the card; ``chip_smoke.py`` holds each one to these
plain versions there. Here, on SmallRoom at 275 Hz (29 x 29 cells, as in
tests/test_fdtd_tiled.py):

  - the tiled plain versions are ``torch.equal`` to the untiled ones
    (``fdtd_fused.fdtd_sim_reference``, ``rt60_moments_reference``) on
    every output: the tiling must not change a bit;
  - they are held to the JAX tiled Pallas kernels in interpret mode at the
    C1 bound (recording, flux and energies max-abs <= 1e-6 of the peak,
    onset exactly equal; XLA contracts multiply-adds into FMAs, eager
    PyTorch does not) and the moments at scale-relative 1e-5 (the bound the
    JAX package holds its own tiled kernel to).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from planeverb_tpu.ops import fdtd_tiled as jtiled
from planeverb_tpu.ops import voxelize as jvox
from planeverb_tpu.scene import demo_scene
from planeverb_tpu_torch import config as tcfg
from planeverb_tpu_torch.convert import fields_from_numpy
from planeverb_tpu_torch.ops import fdtd_fused, fdtd_tiled

CFG = tcfg.PlaneverbConfig(10.0, 10.0, 275)
# (T, tile, halo); with 8 x 8 tiles the listener cell (14, 14) lies 2 cells
# from a tile edge, inside the halo of its neighbours' windows
CASES = [(70, (8, 8), 4), (33, (16, 8), 3), (64, (24, 16), 8),
         (70, (32, 32), 16)]
OUTPUTS = ("pressure", "onset", "flux_x", "flux_y", "e_dry", "e_wet",
           "e_total")


def _setup(T):
    p = dataclasses.replace(tcfg.compute_grid_params(CFG), response_length=T)
    beta, refl = jvox.voxelize_np(p, demo_scene("SmallRoom").boxes)
    pulse = oracle.gaussian_pulse(p)[:T]
    lix, liy = p.world_to_cell(5.0, 5.0)
    return p, (beta, refl, pulse), (lix, liy)


def _named(res, energies):
    return dict(zip(OUTPUTS, (*res, *energies)))


@pytest.mark.parametrize("T,tile,halo", CASES,
                         ids=[f"T{c[0]}-{c[1][0]}x{c[1][1]}-k{c[2]}"
                              for c in CASES])
def test_tiled_reference_equals_untiled(T, tile, halo):
    p, arrays, (lix, liy) = _setup(T)
    b, r, pl = fields_from_numpy(*arrays, device="cpu")
    ref = _named(*fdtd_fused.fdtd_sim_reference(p, b, r, pl, lix, liy))
    got = _named(*fdtd_tiled.fdtd_sim_tiled_reference(
        p, b, r, pl, lix, liy, tile=tile, halo=halo))
    assert got["pressure"].shape == (T, p.nx, p.ny)
    for name in OUTPUTS:
        assert torch.equal(got[name], ref[name]), name
    if tile == (8, 8):
        ntx = -(-p.nx // 8)
        slots = fdtd_tiled._listener_slots(lix, liy, p.nx, p.ny, 8, 8, halo,
                                           ntx, ntx)
        assert len(slots[0]) > 1   # halo copies were injected too


def test_tiled_reference_listener_outside_field():
    """A listener outside the field injects nothing, in any window."""
    p, arrays, _ = _setup(33)
    b, r, pl = fields_from_numpy(*arrays, device="cpu")
    for lix, liy in ((-1, 3), (p.nx, 0), (2, p.ny + 5)):
        ref = _named(*fdtd_fused.fdtd_sim_reference(p, b, r, pl, lix, liy))
        got = _named(*fdtd_tiled.fdtd_sim_tiled_reference(
            p, b, r, pl, lix, liy, tile=(8, 16), halo=3))
        for name in OUTPUTS:
            assert torch.equal(got[name], ref[name]), (lix, liy, name)


def _close(got, ref, rel, name):
    scale = np.abs(ref).max() + 1e-30
    assert np.abs(got.numpy() - ref).max() <= rel * scale, name


@pytest.mark.parametrize("band,halo,T", [(16, 4, 70), (8, 3, 33),
                                         (24, 8, 64)])
def test_tiled_reference_matches_pallas(band, halo, T):
    p, (beta, refl, pulse), (lix, liy) = _setup(T)
    jres, jen = jtiled.simulate_tiled(
        p, jnp.asarray(beta), jnp.asarray(refl), jnp.asarray(pulse),
        jnp.int32(lix), jnp.int32(liy), band_rows=band, halo=halo,
        interpret=True)
    ref = {k: np.asarray(v)[..., :p.nx, :p.ny]
           for k, v in _named(jres, jen).items()}
    b, r, pl = fields_from_numpy(beta, refl, pulse, device="cpu")
    got = _named(*fdtd_tiled.fdtd_sim_tiled_reference(
        p, b, r, pl, lix, liy, tile=band, halo=halo))
    np.testing.assert_array_equal(got["onset"].numpy(), ref["onset"])
    for name in OUTPUTS:
        if name != "onset":
            _close(got[name], ref[name], 1e-6, name)


@pytest.mark.parametrize("chunk", [1, 7, 32, 128])
def test_tiled_moments_reference_equals_untiled(chunk):
    """Chunks that divide T (1, 7 of 70) and chunks that do not (32, and
    128 > T)."""
    p, arrays, (lix, liy) = _setup(70)
    b, r, pl = fields_from_numpy(*arrays, device="cpu")
    res, _ = fdtd_fused.fdtd_sim_reference(p, b, r, pl, lix, liy)
    assert torch.isinf(res.onset).any()    # the +inf sentinel is exercised
    ref = fdtd_fused.rt60_moments_reference(p, res.pressure, res.onset)
    got = fdtd_tiled.rt60_moments_tiled_reference(p, res.pressure,
                                                  res.onset, chunk=chunk)
    for a, g in zip(ref, got):
        assert torch.equal(a, g)
        assert torch.isfinite(g).all()


def test_tiled_moments_match_pallas():
    p, (beta, refl, pulse), (lix, liy) = _setup(70)
    _, jm = jtiled.simulate_moments_tiled(
        p, jnp.asarray(beta), jnp.asarray(refl), jnp.asarray(pulse),
        jnp.int32(lix), jnp.int32(liy), band_rows=16, halo=4,
        interpret=True)
    b, r, pl = fields_from_numpy(beta, refl, pulse, device="cpu")
    _, m = fdtd_tiled.simulate_moments_tiled_reference(
        p, b, r, pl, lix, liy, tile=16, halo=4, chunk=4)
    for name in ("e_dry", "e_wet", "e_total", "s0", "s1"):
        _close(getattr(m, name), np.asarray(getattr(jm, name))
               [:p.nx, :p.ny], 1e-5, name)


def test_cpu_wrappers_take_plain_path():
    p, arrays, (lix, liy) = _setup(33)
    b, r, pl = fields_from_numpy(*arrays, device="cpu")
    fdtd_fused.reset_launch_counts()
    res, mom = fdtd_tiled.simulate_moments_tiled(p, b, r, pl, lix, liy,
                                                 tile=(16, 8), halo=3,
                                                 chunk=5)
    ref, rmom = fdtd_fused.simulate_moments_fused_reference(p, b, r, pl,
                                                            lix, liy)
    assert fdtd_tiled.fdtd_sim_tiled.launches == 0
    assert fdtd_tiled.rt60_moments_tiled.launches == 0
    for a, g in zip((*ref, *rmom), (*res, *mom)):
        assert torch.equal(a, g)


def test_other_devices_raise():
    p, arrays, (lix, liy) = _setup(33)
    b, r, pl = fields_from_numpy(*arrays, device="cpu")
    with pytest.raises(ValueError, match="meta"):
        fdtd_tiled.fdtd_sim_tiled(p, b.to("meta"), r.to("meta"),
                                  pl.to("meta"), lix, liy)
    rec = torch.zeros((33, p.nx, p.ny), device="meta")
    with pytest.raises(ValueError, match="meta"):
        fdtd_tiled.rt60_moments_tiled(p, rec, b.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        fdtd_tiled.fdtd_sim_tiled(p, b, r.to("meta"), pl, lix, liy)
    with pytest.raises(ValueError, match="float32"):
        fdtd_tiled.fdtd_sim_tiled(p, b.double(), r, pl, lix, liy)
    with pytest.raises(ValueError, match=">= 1"):
        fdtd_tiled.fdtd_sim_tiled(p, b, r, pl, lix, liy, tile=0)
    with pytest.raises(ValueError, match=">= 1"):
        fdtd_tiled.rt60_moments_tiled(p, torch.zeros_like(rec, device="cpu"),
                                      b, chunk=0)
    assert fdtd_tiled.fdtd_sim_tiled.launches == 0
    assert fdtd_tiled.rt60_moments_tiled.launches == 0


def test_routing_threshold(monkeypatch):
    """The headline (192^2) stays on B1 + B2; 459^2 and 964^2 go tiled;
    pipeline_auto follows TILED_MIN_CELLS on the CPU too."""
    cells = {s: tcfg.compute_grid_params(tcfg.PlaneverbConfig(s, s, 750))
             for s in (25.0, 60.0, 126.0)}
    assert not fdtd_fused._use_tiled(cells[25.0])
    assert fdtd_fused._use_tiled(cells[60.0])
    assert fdtd_fused._use_tiled(cells[126.0])

    p, arrays, (lix, liy) = _setup(33)
    b, r, pl = fields_from_numpy(*arrays, device="cpu")
    calls = []
    real = fdtd_tiled.simulate_moments_tiled

    def spy(*args, **kwargs):
        calls.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(fdtd_tiled, "simulate_moments_tiled", spy)
    untiled = fdtd_fused.pipeline_auto(p, b, r, pl, lix, liy, 0.02, 5.0, 5.0)
    assert calls == []
    monkeypatch.setattr(fdtd_fused, "TILED_MIN_CELLS", 0)
    tiled = fdtd_fused.pipeline_auto(p, b, r, pl, lix, liy, 0.02, 5.0, 5.0)
    assert calls == [p]
    for a, g in zip((*untiled[0], *untiled[1]), (*tiled[0], *tiled[1])):
        assert torch.equal(a, g)


def test_pick_tile():
    """On a 132-SM card the tile model picks what the H100 measured
    fastest: 32 x 32 at 192^2 and 261^2 (32 x 64 tiles would leave most
    SMs idle), 32 x 64 at 459^2 and 964^2."""
    picks = {n: fdtd_tiled.pick_tile(n, n, 8, 132)
             for n in (192, 261, 459, 964)}
    assert picks == {192: (32, 32), 261: (32, 32), 459: (32, 64),
                     964: (32, 64)}
    assert fdtd_tiled.pick_tile(29, 29, 8, 132) == (32, 32)
    assert fdtd_tiled.pick_tile(964, 964, 8, 1) == (32, 64)
