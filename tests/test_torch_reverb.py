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
import re
from pathlib import Path

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


# D2's chunk schedule (planeverb_tpu_torch/csrc/dsp_scan.cu
# reverb_scan_kernel), read from the source: the longest chunk and the
# allpasses' threads (the block less warp 0), which cap a sub-chunk
_CU = (Path(trv.__file__).parent.parent / "csrc" / "dsp_scan.cu").read_text()


def _cu_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _CU).group(1))


KCHUNK = _cu_int("kReverbChunk")
AP_THREADS = _cu_int("kReverbThreads") - _cu_int("kWarp")


def _chunk_schedule(x, comb, lp, ap, pos, params):
    """D2's schedule in NumPy float32, op for op as the kernel: chunks of
    min(comb delays, KCHUNK) steps, each 1. gathering every comb's output
    (all reads before any write of the chunk) and their sum, 2. running the
    four damping chains (the one serial part) and the two allpasses in
    sub-chunks of min(ad_j, AP_THREADS) steps (all reads, then all
    writes), 3. writing the comb slots. Returns (out, comb, lp, ap, pos)."""
    comb, lp, ap = comb.copy(), lp.copy(), ap.copy()
    b, n = x.shape
    lc, la = comb.shape[-1], ap.shape[-1]
    cd, ad = params.comb_delays, params.allpass_delays
    fb = np.asarray(params.comb_feedback, np.float32)
    omd = np.float32(1.0) - np.float32(trv.DAMPING)
    d, g = np.float32(trv.DAMPING), np.float32(trv.ALLPASS_G)
    out = np.empty_like(x)
    wc, wa = pos % lc, pos % la
    chunk = min(min(cd), KCHUNK)
    for c0 in range(0, n, chunk):
        m = min(chunk, n - c0)
        t = np.arange(m)
        y = np.stack([comb[:, k, (wc + t - cd[k]) % lc] for k in range(4)],
                     1)                                    # [B, 4, m]
        s = (((y[:, 0] + y[:, 1]) + y[:, 2]) + y[:, 3]) * np.float32(0.25)
        lps = np.empty_like(y)
        for i in range(m):
            lp = y[:, :, i] * omd + lp * d
            lps[:, :, i] = lp
        for j in range(2):
            sub = min(ad[j], AP_THREADS)
            for a0 in range(0, m, sub):
                tt = np.arange(a0, min(a0 + sub, m))
                w = (wa + tt) % la
                bv = ap[:, j, (w - ad[j]) % la]      # every read first
                sv = s[:, tt]
                ap[:, j, w] = sv + bv * g
                s[:, tt] = bv - g * sv
        for k in range(4):
            comb[:, k, (wc + t) % lc] = x[:, c0 + t] + lps[:, k] * fb[k]
        out[:, c0:c0 + m] = s
        wc, wa = (wc + m) % lc, (wa + m) % la
    wrap = math.lcm(lc, la)
    return out, comb, lp, ap, (pos + n) % wrap if n else pos


@pytest.mark.parametrize("start", ["filled", "before_wrap"])
@pytest.mark.parametrize("n", [1, 512, 4096])
@pytest.mark.parametrize("rate", [44100, 48000, 11025, 1000])
def test_chunk_schedule_equals_the_plain_version(rate, n, start):
    """D2's chunk schedule gives reverb_scan_reference's bits: at 44.1 and
    48 kHz (one comb chunk for 512 steps, four for 4096), 11025 Hz (la =
    55, odd; ad_1 = 18) and 1000 Hz (ad_1 = 1: one-step allpass
    sub-chunks; chunks of 29 steps), from filled rings at pos 0 and 100
    steps before the counter's wrap."""
    params = trv.reverb_params(1.0, rate)
    lc, la = max(params.comb_delays), max(params.allpass_delays)
    wrap = math.lcm(lc, la)
    pos = 0 if start == "filled" else wrap - 100
    rng = np.random.default_rng(rate + n)
    comb = (rng.standard_normal((2, 4, lc)) * 0.1).astype(np.float32)
    lp = (rng.standard_normal((2, 4)) * 0.1).astype(np.float32)
    ap = (rng.standard_normal((2, 2, la)) * 0.1).astype(np.float32)
    x = (rng.standard_normal((2, n)) * 0.3).astype(np.float32)
    want_y, want = trv.reverb_scan_reference(
        torch.from_numpy(x),
        trv.ReverbState(*map(torch.from_numpy, (comb, lp, ap)),
                        torch.tensor(pos, dtype=torch.int32)), params)
    out, comb, lp, ap, pos = _chunk_schedule(x, comb, lp, ap, pos, params)
    np.testing.assert_array_equal(out, want_y.numpy())
    for got, ref in zip((comb, lp, ap), want[:3]):
        np.testing.assert_array_equal(got, ref.numpy())
    assert pos == int(want.pos)


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
