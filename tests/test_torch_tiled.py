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
F32, BF16 = torch.float32, torch.bfloat16
HEADLINE = 192 * 192
SINGLE = fdtd_fused.TILED_SINGLE_MIN_CELLS
# Every round depth the card's plan can take, each with the plans of a 32 x
# 64 and a 32 x 32 window (fdtd_tiled.PLANS)
RULE_PLANS = [plan for plan in fdtd_tiled.PLANS
              if fdtd_tiled.block_shape(*plan) in ((64, 8), (32, 8))]
# (T, tile, halo); with 8 x 8 tiles the listener cell (14, 14) lies 2 cells
# from a tile edge, inside the halo of its neighbours' windows
CASES = [(70, (8, 8), 4), (33, (16, 8), 3), (64, (24, 16), 8),
         (70, (32, 32), 16),
         *((70, plan[:2], plan[2]) for plan in RULE_PLANS)]
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
    """By TILED_MIN_CELLS, the rule of the CPU, of batches and of bf16
    passes, the headline (192^2) stays on B1 + B2 and 459^2 and 964^2 go
    tiled (on the card one float32 listener goes tiled from
    TILED_SINGLE_MIN_CELLS: test_route_tiled_rule); pipeline_auto follows
    TILED_MIN_CELLS on the CPU, the two routes bit-equal."""
    cells = {s: tcfg.compute_grid_params(tcfg.PlaneverbConfig(s, s, 750))
             for s in (25.0, 60.0, 126.0)}
    for size, tiled in ((25.0, False), (60.0, True), (126.0, True)):
        q = cells[size]
        for listeners, dtype in ((1, F32), (4, F32), (1, BF16)):
            assert fdtd_fused.route_tiled(q.nx * q.ny, listeners, dtype,
                                          False) is tiled

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


@pytest.mark.parametrize("cells,listeners,dtype,card,tiled", [
    (HEADLINE, 1, F32, True, True),
    (SINGLE, 1, F32, True, True),
    (SINGLE - 1, 1, F32, True, False),       # under the threshold: B1
    (HEADLINE, 1, BF16, True, False),        # the tiled route is float32
    (HEADLINE, 4, F32, True, False),         # a batch: one batched B1
    (HEADLINE, 1, F32, False, False),        # the CPU: TILED_MIN_CELLS
    (HEADLINE + 1, 1, F32, False, True),
    (459 * 459, 4, F32, True, True),         # above it: always tiled
    (459 * 459, 1, BF16, True, True),
], ids=["headline", "threshold", "under", "bf16", "batch", "cpu",
        "cpu-above", "batch-above", "bf16-above"])
def test_route_tiled_rule(cells, listeners, dtype, card, tiled):
    """One float32 listener on the card takes B3 + B4 from
    TILED_SINGLE_MIN_CELLS; everything else keeps TILED_MIN_CELLS."""
    assert 0 < SINGLE <= fdtd_fused.TILED_MIN_CELLS
    assert fdtd_fused.route_tiled(cells, listeners, dtype, card) is tiled


def _spy_solvers(monkeypatch):
    """Every B3 and B1 pass the routers run, by name, in order."""
    calls = []
    for module, name in ((fdtd_tiled, "fdtd_sim_tiled"),
                         (fdtd_fused, "fdtd_sim"),
                         (fdtd_fused, "fdtd_sim_batch")):
        def wrapped(*args, _real=getattr(module, name), _name=name,
                    **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)
    return calls


def test_single_listener_rule_leaves_batches_alone(monkeypatch):
    """With the single-listener rule sending every pass of one float32
    listener to B3 + B4 (route_tiled as on the card, from 0 cells),
    pipeline_auto and simulate_auto go tiled, while pipeline_auto_batch
    and ops/batch.py keep the batched B1 for two listeners."""
    from planeverb_tpu_torch.ops import batch as tbatch

    p, arrays, (lix, liy) = _setup(19)
    b, r, pl = fields_from_numpy(*arrays, device="cpu")
    calls = _spy_solvers(monkeypatch)
    real = fdtd_fused.route_tiled
    monkeypatch.setattr(fdtd_fused, "TILED_SINGLE_MIN_CELLS", 0)
    monkeypatch.setattr(fdtd_fused, "route_tiled",
                        lambda cells, listeners, dtype, card:
                        real(cells, listeners, dtype, True))
    cells = [(lix, liy), (lix - 2, liy + 1)]
    out = fdtd_fused.pipeline_auto_batch(p, b, r, pl, cells, 0.02,
                                         [(5.0, 5.0), (4.0, 5.5)])
    res = tbatch.simulate_listeners_auto(p, b, r, pl, [lix, lix - 2],
                                         [liy, liy + 1])
    assert calls == ["fdtd_sim_batch"] * 2
    assert out.occlusion.shape[0] == res.onset.shape[0] == 2
    fdtd_fused.simulate_auto(p, b, r, pl, lix, liy)
    fdtd_fused.pipeline_auto(p, b, r, pl, lix, liy, 0.02, 5.0, 5.0)
    assert calls[2:] == ["fdtd_sim_tiled", "fdtd_sim_tiled"]


def _run_router(name, p, b, r, pl, cells):
    from planeverb_tpu_torch.ops import batch as tbatch

    (lix, liy), lpos = cells[0], [(5.0, 5.0), (4.0, 5.5)]
    if name == "pipeline_auto":
        return fdtd_fused.pipeline_auto(p, b, r, pl, lix, liy, 0.02,
                                        *lpos[0])
    if name == "pipeline_auto_batch":
        return fdtd_fused.pipeline_auto_batch(p, b, r, pl, cells, 0.02,
                                              lpos)
    if name == "simulate_auto":
        return fdtd_fused.simulate_auto(p, b, r, pl, lix, liy)
    return tbatch.simulate_listeners_auto(p, b, r, pl,
                                          [c[0] for c in cells],
                                          [c[1] for c in cells])


@pytest.mark.parametrize("tiled", [True, False], ids=["tiled", "b1"])
@pytest.mark.parametrize("router,views", [
    ("pipeline_auto", 1), ("pipeline_auto_batch", 2), ("simulate_auto", 1),
    ("simulate_listeners_auto", 2)])
def test_routers_run_the_route_they_are_told(monkeypatch, router, views,
                                             tiled):
    """Each of the four routers asks route_tiled, with its own listener
    count, and runs what it answers: one B3 pass a listener, or B1 (one
    batched pass for several listeners)."""
    p, arrays, (lix, liy) = _setup(19)
    b, r, pl = fields_from_numpy(*arrays, device="cpu")
    cells = [(lix, liy), (lix - 2, liy + 1)][:views]
    asked = []
    monkeypatch.setattr(fdtd_fused, "route_tiled",
                        lambda *a: asked.append(a) or tiled)
    calls = _spy_solvers(monkeypatch)
    _run_router(router, p, b, r, pl, cells)
    assert asked == [(p.nx * p.ny, views, F32, False)]
    if tiled:
        assert calls == ["fdtd_sim_tiled"] * views
    else:
        assert calls == ["fdtd_sim" if views == 1 else "fdtd_sim_batch"]


# an H100's SMs and the shared memory a block may opt into (227 KB)
H100_SMS, H100_OPTIN = 132, 227 * 1024


def _plan(n, T):
    return fdtd_tiled.plan_tiled(n, n, T, H100_SMS, H100_OPTIN)


def test_pick_tile():
    """On a 132-SM card the plan model picks what the H100 measured
    fastest of all 111 plans (probe_tiled.py): 22 x 54 at k = 5 at 964^2
    (792 = 6 x 132 windows: no tail round), 46 x 18 at k = 7 at 459^2; at
    192^2 20 x 16 at k = 8, within 1.2 % of the fastest; one round of at
    most one window an SM on the small grids."""
    picks = {n: _plan(n, T) for n, T in ((65, 1187), (192, 1187),
                                         (459, 1470), (964, 2006))}
    assert picks == {65: (4, 16, 8), 192: (20, 16, 8), 459: (46, 18, 7),
                     964: (22, 54, 5)}
    assert fdtd_tiled.window_rounds(964, 964, 2006, picks[964], 132) == 2412
    assert fdtd_tiled.window_rounds(192, 192, 1187, picks[192], 132) == 149
    # the plan B3 ran before: 931 windows, 7 SMs step an eighth every round
    assert fdtd_tiled.window_rounds(964, 964, 2006, (20, 52, 6), 132) == 2680
    assert fdtd_tiled.window_rounds(192, 192, 1187, (20, 20, 6), 132) == 198
    assert _plan(29, 70) in fdtd_tiled.PLANS
    # one SM steps every window, one after another: the fewest window cells
    # a round, whatever the tail
    one = fdtd_tiled.plan_tiled(964, 964, 2006, 1, H100_OPTIN)
    assert fdtd_tiled.plan_cost(964, 964, 2006, one, 1, H100_OPTIN) == min(
        fdtd_tiled.plan_cost(964, 964, 2006, plan, 1, H100_OPTIN)
        for plan in fdtd_tiled.PLANS)


def test_plan_without_a_tail():
    """A field whose windows are an exact multiple of the SM count has no
    tail: the busiest SM steps windows / SMs, and one cell more (a row of
    windows more) never costs less."""
    plan = (22, 54, 5)
    nx, ny = 22 * 12, 54 * 11          # 132 windows
    for sms, busiest in ((132, 1), (66, 2), (44, 3)):
        assert fdtd_tiled.window_rounds(nx, ny, 2006, plan, sms) == (
            402 * busiest)
        for more in ((nx + 1, ny), (nx, ny + 1)):
            assert fdtd_tiled.window_rounds(*more, 2006, plan, sms) > (
                402 * busiest)
            assert fdtd_tiled.plan_cost(*more, 2006, plan, sms,
                                        H100_OPTIN) > fdtd_tiled.plan_cost(
                nx, ny, 2006, plan, sms, H100_OPTIN)


@pytest.mark.parametrize("n", [16, 29, 65, 96, 128, 160, 192, 261, 320,
                               459, 640, 800, 964])
def test_plan_fits_the_kernel(n):
    """Every plan the rule returns for the engine's grids (up to 964^2)
    fits the kernel's thread bound and keeps its accumulators in shared
    memory; above ~1100^2 none can, and the pick still fits the bound."""
    T = 1187 if n <= 192 else 2006
    plan = _plan(n, T)
    lanes, runs = fdtd_tiled.block_shape(*plan)
    assert lanes * runs <= fdtd_tiled.MAX_THREADS
    assert plan[2] in fdtd_tiled.K_RANGE
    assert fdtd_tiled.acc_fits(n, n, plan, H100_SMS, H100_OPTIN)
    big = _plan(1400, 2200)
    assert not fdtd_tiled.acc_fits(1400, 1400, big, H100_SMS, H100_OPTIN)
    assert fdtd_tiled.block_shape(*big)[0] * fdtd_tiled.block_shape(
        *big)[1] <= fdtd_tiled.MAX_THREADS


def test_acc_fits_mirrors_the_launcher():
    """The launcher's shared-memory rule (csrc/windows.cuh acc_fits): the
    block's edges and a [6][tile cells] float slot a tile it steps; at
    964^2 the old plan's 8 slots of 20 x 52 take 204,288 bytes, 22 x 54's 6
    slots 175,680."""
    def smem(n, plan):
        tx, ty, k = plan
        lanes, runs = fdtd_tiled.block_shape(tx, ty, k)
        windows = -(-n // tx) * -(-n // ty)
        per_block = -(-windows // min(windows, H100_SMS))
        edges = 2 * runs * lanes + 2 * (lanes // 32) * runs * fdtd_tiled.RUN
        return 4 * (edges + per_block * 6 * tx * ty)

    assert smem(964, (20, 52, 6)) == 204288
    assert smem(964, (22, 54, 5)) == 175680
    for plan in fdtd_tiled.PLANS:
        need = smem(964, plan)
        assert fdtd_tiled.acc_fits(964, 964, plan, H100_SMS, need)
        assert not fdtd_tiled.acc_fits(964, 964, plan, H100_SMS, need - 1)


def test_card_pass_counts_its_window_rounds(monkeypatch):
    """On the card fdtd_sim_tiled launches the plan_tiled plan for the
    field and adds its window-rounds to the step's solver.window_rounds
    counter; a plan given whole is launched as given. (The launch is the
    plain version here, and the card's properties an H100's.)"""
    from planeverb_tpu_torch.utils import profiling

    p, arrays, (lix, liy) = _setup(70)
    b, r, pl = fields_from_numpy(*arrays, device="cpu")
    launched = []

    def launch(params, beta, refl, pulse, lix, liy, tx, ty, k):
        launched.append((tx, ty, k))
        return fdtd_tiled.fdtd_sim_tiled_reference(
            params, beta, refl, pulse, lix, liy, tile=(tx, ty), halo=k)

    props = type("Props", (), {"multi_processor_count": H100_SMS,
                               "shared_memory_per_block_optin": H100_OPTIN})
    monkeypatch.setattr(fdtd_tiled, "on_card", lambda *a: True)
    monkeypatch.setattr(fdtd_tiled, "_launch_fdtd_sim_tiled", launch)
    monkeypatch.setattr(fdtd_tiled.torch.cuda, "get_device_properties",
                        lambda dev: props)
    ref = _named(*fdtd_fused.fdtd_sim_reference(p, b, r, pl, lix, liy))
    timer = profiling.StageTimer()
    with timer.step(7):
        got = _named(*fdtd_tiled.fdtd_sim_tiled(p, b, r, pl, lix, liy))
        fdtd_tiled.fdtd_sim_tiled(p, b, r, pl, lix, liy, tile=(8, 8),
                                  halo=4)
    plan = _plan(p.nx, 70)
    assert launched == [plan, (8, 8, 4)]
    want = (fdtd_tiled.window_rounds(p.nx, p.ny, 70, plan, H100_SMS)
            + fdtd_tiled.window_rounds(p.nx, p.ny, 70, (8, 8, 4), H100_SMS))
    assert profiling.steps()[-1].counters["solver.window_rounds"] == want
    for name in OUTPUTS:
        assert torch.equal(got[name], ref[name]), name


@pytest.mark.parametrize("tile,k,shape", [
    ((20, 52), 6, (64, 8)),      # a 32 x 64 window, 512 threads
    ((20, 20), 6, (32, 8)),      # 32 x 32, 256 threads
    ((17, 33), 5, (64, 7)),      # 27 x 43: lanes and runs rounded up
])
def test_block_shape(tile, k, shape):
    """A block on the card is a thread a window column, rounded up to whole
    warps, by runs of RUN rows; every plan B3 chooses from stays within its
    thread bound."""
    lanes, runs = fdtd_tiled.block_shape(*tile, k)
    assert (lanes, runs) == shape
    assert lanes % 32 == 0 and lanes >= tile[1] + 2 * k
    assert runs * fdtd_tiled.RUN >= tile[0] + 2 * k
    for plan in fdtd_tiled.PLANS:
        lanes, runs = fdtd_tiled.block_shape(*plan)
        assert lanes * runs <= fdtd_tiled.MAX_THREADS


# rigid outer walls: the fold's edge terms without the ABC (the B3 kernel
# folds them itself, as B6 does)
RIGID_CASES = [(70, (8, 8), 4), (33, (16, 8), 3),
               *((70, plan[:2], plan[2]) for plan in RULE_PLANS)]


@pytest.mark.parametrize("T,tile,halo", RIGID_CASES,
                         ids=[f"T{c[0]}-{c[1][0]}x{c[1][1]}-k{c[2]}"
                              for c in RIGID_CASES])
def test_tiled_reference_equals_untiled_rigid(T, tile, halo):
    """With grid_boundary_type REFLECTING the tiled plain version is
    torch.equal to the untiled one, and differs from the absorbing run: an
    open field (no walls), so the pulse reaches the grid's edges."""
    p, (beta, refl, pulse), (lix, liy) = _setup(T)
    rigid = dataclasses.replace(p, boundary_type=tcfg.BoundaryType.REFLECTING)
    b, r, pl = fields_from_numpy(np.ones_like(beta), np.zeros_like(refl),
                                 pulse, device="cpu")
    ref = _named(*fdtd_fused.fdtd_sim_reference(rigid, b, r, pl, lix, liy))
    got = _named(*fdtd_tiled.fdtd_sim_tiled_reference(
        rigid, b, r, pl, lix, liy, tile=tile, halo=halo))
    for name in OUTPUTS:
        assert torch.equal(got[name], ref[name]), name
    absorbing = fdtd_fused.fdtd_sim_reference(p, b, r, pl, lix, liy)[0]
    assert not torch.equal(got["pressure"], absorbing.pressure)


def test_probe_variant_needs_the_card():
    """fdtd_sim_tiled_probe (0-step rounds, accumulators forced to global
    memory) has no plain version: a CPU tensor raises, and no wrapper's
    launch count moves."""
    p, arrays, (lix, liy) = _setup(33)
    b, r, pl = fields_from_numpy(*arrays, device="cpu")
    fdtd_fused.reset_launch_counts()
    for opts in ({"dry": True}, {"global_acc": True}, {}):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fdtd_tiled.fdtd_sim_tiled_probe(p, b, r, pl, lix, liy, (16, 8),
                                            3, **opts)
    assert fdtd_tiled.fdtd_sim_tiled.launches == 0
