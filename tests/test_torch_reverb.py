"""The port's reverb (planeverb_tpu_torch.dsp.reverb: D2's plain version,
``reverb_scan_many`` and ``mix_output``) and convolver against the JAX
package's on the CPU, from the same inputs and the same carried state
(convert.reverb_state_from_numpy), over several blocks, a 4096-sample
block, and a state carried to just before the counter's wrap at
lcm(lc, la).

Tolerance (ROADMAP C1, DSP row): the comb sum's order (the port adds the
four combs left to right, XLA reduces them its own way) and XLA's fused
multiply-adds move the wet output by up to 6e-8 of its peak over 4096
samples; held at 1e-6 of the peak, the rings and memories at 1e-6
absolute, the counter exactly.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from planeverb_tpu.dsp import convolver as jconv
from planeverb_tpu.dsp import reverb as jrv
from planeverb_tpu_torch.convert import reverb_state_from_numpy
from planeverb_tpu_torch.dsp import convolver as tconv
from planeverb_tpu_torch.dsp import reverb as trv

FS = 22050            # halves the rings against 44.1 kHz; the same math
REL = 1e-6


def _assert_close(got, want, what):
    want = np.asarray(want)
    peak = max(np.abs(want).max(), 1e-30)
    diff = np.abs(np.asarray(got) - want).max()
    assert diff <= REL * peak, f"{what}: {diff} > {REL} x {peak}"


def _assert_state(tst, jst):
    for f in ("comb_buf", "comb_lp", "ap_buf"):
        np.testing.assert_allclose(getattr(tst, f).numpy(),
                                   np.asarray(getattr(jst, f)), atol=1e-6,
                                   err_msg=f)
    assert int(tst.pos) == int(jst.pos)
    assert tst.pos.dtype == torch.int32 and tst.pos.dim() == 0


def _mid_stream_state(params, batch, pos, seed):
    """A JAX state with filled rings and memories at counter ``pos``."""
    rng = np.random.default_rng(seed)
    lc, la = max(params.comb_delays), max(params.allpass_delays)
    return jrv.ReverbState(
        comb_buf=jnp.asarray((rng.standard_normal((batch, 4, lc)) * 0.1)
                             .astype(np.float32)),
        comb_lp=jnp.asarray((rng.standard_normal((batch, 4)) * 0.1)
                            .astype(np.float32)),
        ap_buf=jnp.asarray((rng.standard_normal((batch, 2, la)) * 0.1)
                           .astype(np.float32)),
        pos=jnp.int32(pos))


@pytest.mark.parametrize("start", ["silent", "before_wrap"])
@pytest.mark.parametrize("rt60,blocks", [(0.5, (4096,)),
                                         (1.0, (512, 300, 1, 700)),
                                         (3.0, (256, 256))])
def test_reverb_scan_matches_jax(rt60, blocks, start):
    """Consecutive blocks from a silent state or from a state whose counter
    sits 400 samples before the wrap (crossed inside the blocks)."""
    params = jrv.reverb_params(rt60, FS)
    lc, la = max(params.comb_delays), max(params.allpass_delays)
    wrap = math.lcm(lc, la)
    if start == "silent":
        jst = jrv.init_reverb_state(params, batch=2)
    else:
        jst = _mid_stream_state(params, 2, wrap - 400, seed=int(rt60 * 10))
    tst = reverb_state_from_numpy(jst, device="cpu")
    _assert_state(tst, jst)
    rng = np.random.default_rng(len(blocks))
    for n in blocks:
        x = (rng.standard_normal((2, n)) * 0.3).astype(np.float32)
        jy, jst = jrv.reverb_scan(jnp.asarray(x), jst, params)
        ty, tst = trv.reverb_scan(torch.from_numpy(x), tst, params)
        assert ty.shape == (2, n)
        _assert_close(ty.numpy(), jy, f"wet n={n}")
        _assert_state(tst, jst)
    if start == "before_wrap" and sum(blocks) > 400:
        assert int(tst.pos) < wrap - 400      # the wrap was crossed


def test_reverb_streaming_equals_one_shot_and_is_functional():
    """Blocks carried one to the next give the one-shot bits; a call leaves
    the state it was given untouched."""
    params = trv.reverb_params(1.0, FS)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 1024)).astype(np.float32))
    st0 = trv.init_reverb_state(params, device="cpu")
    whole, wst = trv.reverb_scan(x, st0, params)
    assert not st0.comb_buf.any() and int(st0.pos) == 0
    st, parts = st0, []
    for i in range(0, 1024, 256):
        y, st = trv.reverb_scan(x[:, i:i + 256], st, params)
        parts.append(y)
    assert torch.equal(torch.cat(parts, 1), whole)
    assert all(torch.equal(a, b) for a, b in zip(st, wst))


def test_reverb_scan_many_equals_separate_calls():
    """One call over the three canonical decays (one D2 launch on a card)
    equals three calls bit for bit; mixed sample rates are refused."""
    rng = np.random.default_rng(5)
    jobs = []
    for i, rt60 in enumerate((0.5, 1.0, 3.0)):
        p = trv.reverb_params(rt60, FS)
        st = reverb_state_from_numpy(_mid_stream_state(p, 2, 100 * i, i),
                                     device="cpu")
        x = torch.from_numpy((rng.standard_normal((2, 777)) * 0.3)
                             .astype(np.float32))
        jobs.append((x, st, p))
    many = trv.reverb_scan_many(jobs)
    for (x, st, p), (y, new) in zip(jobs, many):
        y1, new1 = trv.reverb_scan(x, st, p)
        assert torch.equal(y, y1)
        assert all(torch.equal(a, b) for a, b in zip(new, new1))
    p48 = trv.reverb_params(1.0, 48000)
    with pytest.raises(ValueError, match="delays differ"):
        trv.reverb_scan_many([jobs[0], (jobs[1][0],
                                        trv.init_reverb_state(
                                            p48, 2, device="cpu"), p48)])
    with pytest.raises(ValueError, match="comb_buf"):
        trv.reverb_scan(jobs[0][0], trv.init_reverb_state(p48, 2,
                                                          device="cpu"),
                        jobs[0][2])


def test_mix_output_matches_jax():
    """The dry + three-reverb mix over several 512-frame blocks, states
    carried in the dict keyed by (rt60, rate)."""
    rng = np.random.default_rng(1)
    jstates, tstates = None, None
    for blk in range(3):
        buses = [(rng.standard_normal((512, 2)) * 0.1).astype(np.float32)
                 for _ in range(4)]
        jmix, jstates = jrv.mix_output(*buses, FS, jstates)
        tmix, tstates = trv.mix_output(*buses, FS, tstates, device="cpu")
        assert tmix.shape == (512, 2) and tmix.device.type == "cpu"
        _assert_close(tmix.numpy(), jmix, f"mix block {blk}")
    assert set(tstates) == set(jstates) == {(0.5, FS), (1.0, FS), (3.0, FS)}
    for key in jstates:
        _assert_state(tstates[key], jstates[key])


def test_entry_points_default_to_cuda():
    """init_reverb_state and mix_output run on the card unless asked for the
    CPU: here, with no card, asking for it raises."""
    params = trv.reverb_params(1.0, FS)
    with pytest.raises((RuntimeError, AssertionError)):
        trv.init_reverb_state(params)
    bus = np.zeros((8, 2), np.float32)
    with pytest.raises((RuntimeError, AssertionError)):
        trv.mix_output(bus, bus, bus, bus, FS)


def test_reverb_numpy_parts_equal_jax():
    for rt60 in (0.3, 0.5, 1.0, 3.0):
        for fs in (22050, 44100, 48000):
            assert trv.reverb_params(rt60, fs) == jrv.reverb_params(rt60, fs)
    assert trv.comb_feedback(0.03, 0.0) == jrv.comb_feedback(0.03, 0.0)


# ---------------------------------------------------------------- convolver
def test_convolver_numpy_path_equals_jax_and_torch_path_matches():
    rng = np.random.default_rng(2)
    ir = jconv.synthetic_ir(0.4, FS, seed=3)
    np.testing.assert_array_equal(tconv.synthetic_ir(0.4, FS, seed=3), ir)
    np.testing.assert_array_equal(tconv.resample_ir(ir[:300], 1443, FS),
                                  jconv.resample_ir(ir[:300], 1443, FS))
    audio = rng.standard_normal((2000, 2)).astype(np.float32)
    want = jconv.convolve_offline(audio, ir)
    np.testing.assert_array_equal(tconv.convolve_offline(audio, ir), want)
    got = tconv.convolve_offline(torch.from_numpy(audio), ir, xp=torch)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)

    block = 256
    a, b = jconv.PartitionedConvolver(ir, block), \
        tconv.PartitionedConvolver(ir, block)
    c = tconv.PartitionedConvolver(ir, block, xp=torch, device="cpu")
    mono = audio[:, 0]
    for i in range(0, 1500, block):
        x = mono[i:i + block]
        want = a.process(x)
        np.testing.assert_array_equal(b.process(x), want)
        got = c.process(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
