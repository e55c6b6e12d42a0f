"""The port's entry hooks (planeverb_tpu_torch/entry.py) on the CPU.

``entry(device="cpu")``'s step against the JAX package's
``__graft_entry__.entry()`` step on the same inputs at the golden
tolerances of tests/test_golden_scenes.py, ``dryrun_multichip`` on CPU
meshes (its own checks raise on a failure), and the refusal of a CUDA
request without a card.
"""

import numpy as np
import pytest
import torch

from planeverb_tpu_torch.entry import dryrun_multichip, entry

# the golden tolerances (rtol, atol) of tests/test_golden_scenes.py
GOLDEN = {"occlusion": (2e-4, 1e-5), "wet_gain": (2e-4, 1e-5),
          "lowpass": (2e-4, 1e-2), "rt60": (5e-3, 0.0),
          "source_directivity": (1e-3, 1e-4), "direction": (0.0, 1e-4)}


def test_entry_matches_the_jax_entry():
    import __graft_entry__ as jentry

    fn, args = entry(device="cpu")
    jfn, jargs = jentry.entry()
    for a, j in zip(args[:3], jargs[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    assert args[3:5] == tuple(int(v) for v in jargs[3:5])
    out = fn(*args)
    want = jfn(*jargs)
    for name, (rtol, atol) in GOLDEN.items():
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_on_the_cpu(n):
    line = dryrun_multichip(n, device="cpu")
    assert line.endswith(" ok") and f"* {n}" not in line
    assert line.count("'cpu'") == n


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_source_split_render_matches_one_render(shape):
    """The dry run's DSP block with its sources split over the mesh's x
    rows (one render_block a row, the buses summed on the first device)
    against one render_block call, at 5e-5 of each bus's peak."""
    from planeverb_tpu_torch.config import PlaneverbDSPConfig
    from planeverb_tpu_torch.dsp import SourceParams, init_state, render_block
    from planeverb_tpu_torch.entry import (DSP_SPLIT_REL_TOL, _bus_rel,
                                           _render_by_rows)
    from planeverb_tpu_torch.parallel import grid_mesh

    rng = np.random.default_rng(13)
    s, frames = 32, 512

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    def unit(n):
        v = rng.normal(size=(n, 2))
        return f32(v / np.linalg.norm(v, axis=1, keepdims=True))

    target = SourceParams(
        occlusion=f32(rng.uniform(0.05, 1.0, s)),
        wet_gain=f32(rng.uniform(0.05, 1.0, s)),
        rt60=f32(rng.uniform(0.1, 3.0, s)),
        lowpass=f32(rng.uniform(100.0, 20000.0, s)),
        direction=unit(s), position=f32(rng.uniform(-10.0, 10.0, (s, 2))),
        forward=unit(s), directivity=unit(s),
        pattern=torch.as_tensor(rng.integers(0, 2, s), dtype=torch.int32))
    audio = f32(rng.uniform(-0.5, 0.5, (s, frames, 2)))
    cfg = PlaneverbDSPConfig(max_callback_length=frames)
    state = init_state(s, "cpu")
    listener = ([1.0, 0.0, 2.0], [0.6, 0.0, 0.8])
    mesh = grid_mesh(["cpu"] * 4, shape)
    buses = _render_by_rows(cfg, audio, target, state, *listener, mesh)
    one, _ = render_block(cfg, audio, target, state, *listener)
    assert all(b.shape == (frames, 2) for b in buses)
    assert _bus_rel(buses, one) <= DSP_SPLIT_REL_TOL
    with pytest.raises(ValueError, match="do not split"):
        _render_by_rows(cfg, audio[:3], target, state, *listener, mesh)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(4)
