#!/usr/bin/env python3
"""Bring-up smoke run of planeverb_tpu_torch on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --cards     # the sharded engine across the cards
    python3 chip_smoke.py --crossover # the route's crossover (phase 10)

With ``--cards`` (a host of two or more cards) it runs only the sharded
engine on meshes of distinct cards (and, last, one process per card over
NCCL: B5 at the headline and B6 at 126 m on a 2x2 mesh of four cards, 2x1
of two, bit-equal to one card, timed beside ``measure_scaling`` on the
same cards driven by this one process), the one path that exists only across
cards: the ghost buffers filled across cards after each round and the
overlap split's frame copies on side streams. The headline (B5) and the
126 m world (B6) on a 2x2 mesh (four cards; 2x1 on two) and a 4x1 (or
2x1) split, every output held to B1 + B2 / B3 + B4 on the first card,
bit for bit, with launch counts and times; then an engine server on the
card whose ``init`` asks for a mesh of every card at the headline (B5
behind the wire), its rows bit-equal to an ``init`` on one card; then
phase 23's Contexts with one NCCL process a card (the headline on 2x2,
the 126 m world with cells publish on 2x2 and on the 4x1 banded split),
bit-equal to one process on the same cards, with each step's wall; the
NVLink fit of the projection model (``multihost.transfer`` between two
cards over its slab sizes) and the model beside ``measure_scaling``'s
rows; then the last line as below.

Builds the CUDA kernels from ``planeverb_tpu_torch/csrc`` and runs, one
line per phase:

  1. device: the card's name and power limit, torch, CUDA and nvcc versions;
  2. build: nvcc build of the kernels (seconds, ptxas registers and
     spills, the clusters of B1's cluster mode the card holds at once);
  3. B1 ``fdtd_sim`` against its plain PyTorch version on the card, at the
     headline workload (HugeRoom, 25 m at 750 Hz: 192 x 192 cells x 1187
     steps; one launch a pass, a thread-block cluster a listener), timed,
     also with the listener on a seam between two blocks' strips, and on
     grids whose strips start mid-row (SmallRoom at 275 Hz, a thin open
     field) in float32 and bf16, with listeners at and around a block's
     first cell; and its refusal of a grid one row above the cluster's
     capacity;
  4. B2 ``rt60_moments`` (csrc/moments.cu) against its plain version,
     bit for bit: on that recording, on a 29 x 29 recording of 37 steps
     (rows not 16-byte aligned, a short last chunk; and a view starting
     mid-word), on a bf16 recording, on four listeners' recordings
     (``rt60_moments_batch``) and on one table over the 2x2 and 4x1
     meshes' shards (``rt60_moments_many``, one launch); its device times
     with the host enqueue hidden behind a sleep kernel: back to back,
     right after B1 and after an L2 flush, bf16, B = 4 and the 2x2 shards
     in one table against four launches; the probe's modes (everything,
     no logarithms, no loads); and a logarithm's instructions counted in
     the SASS (cuobjdump) with the floor their instruction slots set;
  5. the engine's main path: ``Context(device="cuda")`` at the headline
     size, three emitters, five ``step()`` calls (one float32 listener:
     B3 + B4 a step, ``fdtd_fused.route_tiled``), with the kernels' launch
     counts, the card's launches in one more step and the step times;
  6. the same engine step on the CPU (the plain versions), its published
     grids held to the card's at the golden-scene tolerances;
  7. B3 ``fdtd_sim_tiled`` (the large world's simulation: k steps a round
     over tiles, the whole pass in one cooperative launch) against its
     plain version and to itself with the accumulators in global memory
     (its mode above ~1100^2 cells) at 459^2 (60 m at 750 Hz, HugeRoom,
     listener at the center) and 964^2 (126 m), timed, the plain version
     timed at 459^2 only; then rigid outer walls on an open 60 m field
     against its plain version;
  8. B4 ``rt60_moments_tiled`` against its plain version and against B2 on
     B3's recordings at 459^2 and 964^2, with times and GB/s;
  9. the large-world engine: ``Context`` at 126 m with ``publish="cells"``,
     three emitters, three ``step()`` calls, with the launch counts (B3
     once for calibration, B3 and B4 once a step, B1 and B2 never), the emitter
     rows held to the grids publish on the same fields, step times and
     peak device memory;
 10. the route's crossover for one float32 listener: B1 + B2 against
     B3 + B4 (CUDA events from idle, host enqueue and B1's fold included)
     at 65^2, 96^2, 128^2, 160^2 and 192^2 (the most B1 holds), the two
     routes' outputs bit-equal; B4 against B2 on the same recording; and
     the route ``fdtd_fused.route_tiled`` takes at each size: the
     measurement ``fdtd_fused.TILED_SINGLE_MIN_CELLS`` rests on (with
     ``--crossover`` only phases 1, 2 and 10 run);
 11. B5 ``sharded_round`` (the sharded engine's rounds, one cooperative
     launch per device and round over every shard it holds):
     ``simulate_moments_sharded`` at the headline on 2x2, 4x1 and 1x1 meshes
     of the one card (halo 16: 96^2 shards and 75 rounds on 2x2, so 75
     launches a pass), all nine outputs held to B1 + B2 and to the plain
     sharded path on the card (one B2 launch over the shards' recordings),
     the pass timed against B1 + B2 and the 2x2
     simulation against its plain version, with its host enqueue and the
     card's launches; on 2x2 also the forced slab path (every neighbour
     read through a ghost buffer, the path of neighbours on other cards),
     bit-equal to B1 + B2 and timed against the direct reads;
 12. B6 ``banded_round``: the 126 m world on a 2x2 mesh (482^2 shards, routed
     to B6, 126 launches a pass), held to B3 + B4 and to the plain sharded
     path, timed against its plain version and B3 (host enqueue too); then
     B6 forced (``band_rows=16``) against B5 on the headline's 96^2 shards
     (the same kernel now, counted as B6), bit-equal;
 13. the sharded engine's main path: ``Context(mesh=grid_mesh(["cuda:0"] *
     4, (2, 2)))`` at the headline, grids publish, five ``step()`` calls,
     its grids equal to the single-device Context's; then the 126 m world
     on the same mesh, cells publish, three steps, its emitter rows equal to
     phase 9's; launch counts (set to 0 just before each part: one round
     launch per round, one B2 launch a step), step times and peak device
     memory;
 14. B1/B2's batched mode: ``fdtd_sim_batch`` and ``rt60_moments_batch``
     at the headline with four listeners (the headline's and the three
     emitter positions), held to their plain versions and to four
     single-listener B1 + B2 passes (bit-equal), timed against both;
 15. the multi-listener main path: ``Context.set_listener_positions`` with
     the four views at the headline, grids publish (one batched B1 pass and
     one B2 launch a step; each view's grids equal a single-listener
     Context's) and cells publish (rows equal the grids'); the 126 m world
     with two views, cells publish (one B3 + B4 pass a view, peak device
     memory of one recording); the headline on the 2x2 mesh of the card
     with two views (grids equal the single-device views');
 16. B1/B2's bf16 mode: ``fdtd_sim`` and ``fdtd_sim_batch`` with bf16 wave
     state and ``rt60_moments`` / ``rt60_moments_batch`` on the bf16
     recordings against their plain versions, times against float32, and
     ``Context(precision="bf16")`` at the headline against the float32
     Context at the bf16 parameter bounds;
 17. the overlap split of the sharded rounds (``overlap=True``: a frame
     launch over every shard's two frames, the frames' exchange, an
     interior launch over every shard's interior, per round), on 1D meshes
     of the one card: B5 at the headline on 4x1 and 2x1 and B6 on the
     126 m world's 4x1, all nine outputs bit-equal to the plain rounds'
     kernels, to B1 + B2 / B3 + B4 and to the plain split, the 4x1 frames
     also through ghost buffers (the forced slab path), timed against the
     plain rounds (CUDA events and host enqueue), the 126 m pass's peak
     device memory under 1.25 recordings (the rows are written in place);
     then the main path ``Context(mesh=4x1)``, which takes the split: the
     headline with one and two views (grids equal the single-device
     Context's) and the 126 m world with cells publish (rows equal phase
     9's), launch counts (two round launches a round, one B2 launch a
     step) set to 0 before each part;
 18. the DSP's two recurrences (``csrc/dsp_scan.cu``, counterparts of the
     JAX package's ``lax.scan``s, not of Pallas kernels) bit for bit
     against their plain versions: D1 ``lowpass.process_scan`` at 1, 32,
     33 and 256 sources and blocks of 1, 511, 512 and 4096 samples, and
     rows starting mid-word, cutoffs over 20 Hz - 20 kHz with rejected
     ones among them; D2 ``reverb.reverb_scan`` with B = 2 over carried
     blocks of 1 to 4096 samples at 44.1 kHz, 11025 Hz (an odd allpass
     ring) and 1000 Hz (one-step allpass sub-chunks), across the counter's
     wrap and from rings starting mid-word, and ``mix_output``'s six rows
     in one launch against three calls; device times (the enqueue hidden),
     a call's time (``d2_call_ms``) and enqueue, the plain versions', and
     each recurrence's chain floor measured by a chain-only probe
     (``pv_dsp_chain_probe``) beside the reckoned one;
 19. the audio path at the headline, ``Context(device="cuda")`` with three
     emitters: ``sync_dsp`` into the streaming ``DSPContext``, then
     ``RealtimePlayer(native=False, reverb=True)`` over 2 s of a 440 Hz
     tone at 44.1 kHz in 512-frame blocks, with the engine idle after one
     step and stepping on its background thread, each unpaced
     (``run(realtime=False)``: ``PlayoutReport.summary()``'s mean and max
     block ms, and the blocks whose own time passed the 11.61 ms budget)
     and paced (``run(realtime=True)``: the underruns against the
     deadlines), each block's wait on the player's DSP stream beside its
     host wall; one D2 launch a block, counted; the idle unpaced run's
     first blocks held to a CPU replay; ``AudioSourceManager`` with the
     three emitters' clips and no reverbs (its per-bus reverb is the
     native one, not ported), one block a frame for the same 2 s;
     ``render_block`` at 32 and 256
     sources of 512 frames (one D1 launch a call, counted), its buses
     against the same call on the CPU (rel 1e-5 of each bus's peak);
 20. the integration front ends: the two native libraries built with g++
     (seconds), an ``EngineServer(device="cuda")`` driven over TCP at the
     headline (HugeRoom's boxes by ``add_geometry``, three emitters, five
     steps, then 50 emitters) by the Python client and by the C ABI client
     (``NativeEngineClient``, libpvengine), every ``get_output``,
     ``get_outputs`` row and the impulse response bit-equal to an
     in-process ``Context(device="cuda")``; the card's launches of a step
     over the wire, the host wall of a step over the wire against
     ``Context.step()`` in process and of a 50-emitter poll through each
     client; the 60 m world over the wire (B3 + B4), ``init`` with the
     background loop and ``wait_iteration``, ``init`` with a mesh beyond
     the card count (refused, the connection alive),
     ``examples/engine_client_demo.c`` built with gcc and run against the
     server; then the CLI on the card, in this process (launches counted)
     and as ``python -m planeverb_tpu_torch`` subprocesses (their output
     equal): ``analyze`` (the in-process Context's readouts exactly),
     ``batch`` with four listeners (one batched B1 pass, held to a
     four-view Context at the golden tolerances), ``render --mix`` with D2
     and with ``--native``; ``ir``, ``convolve``, ``play``, ``sweep``,
     ``grid`` and ``scenes`` in this process, and ``serve`` and ``view`` as
     subprocesses on the card (an ``init`` answered, the viewer's state
     served);
 21. the native audio path: ``RealtimePlayer`` with its default
     ``native=True`` (the C++ renderer and the three C++ reverbs on the
     host, the engine's step on the card) over phase 19's 2 s, idle and
     stepping, unpaced and paced, printed beside phase 19's
     ``native=False`` numbers; its idle output equal to a replay through
     the same library (max abs 0); ``AudioSourceManager`` with the native
     renderer and the three ``NativeReverb``s;
 22. the last ported modules: ``parallel.scaling.measure_scaling`` at the
     headline on meshes of ``cuda:0`` repeated (strong, B5 rounds, 1, 2
     and 4 positions; the overlap split on (2, 1) and (4, 1); a weak pair;
     the plain-torch wide solver once), every row printed with B5's
     launches a pass, each fused row's pass rerun and held bit for bit to
     one device's pass (``simulate_auto``) on [:nx, :ny], the wide pass
     and ``simulate_sharded`` (275 Hz)
     held to B1 at REL_TOL with the onset equal; two processes on the one
     card (this script started twice with a hidden worker flag,
     ``init_distributed(backend="gloo")``, two positions each of a 2x2
     ``multihost_grid_mesh``) running B5 at the headline, B6 at 60 m and
     ``simulate_sharded_wide`` at 275 Hz, every block bit-equal to this
     process's single-process run and the wide pass within REL_TOL of B1;
     a ``utils.profiling.device_trace`` of one headline ``Context.step()``
     (its five longest kernels); ``entry()`` and ``dryrun_multichip(4)``
     on the card; and ``python -m planeverb_tpu_torch scale`` as a
     subprocess, its rows parsed;
 23. a Context across processes: this script started twice more (gloo,
     two positions of ``cuda:0`` each on (2, 2) and (4, 1)
     ``multihost_grid_mesh``es), each running headline Contexts: grids
     publish with three emitters over three steps and impulse responses
     of a cell on each rank's shard rows, cells publish with 50 emitters,
     two views, the 4x1 overlap split; every rank's digests bit-equal to
     the single-process mesh and the single-device Context, B5 and B2
     launches counted in each worker, each step's host wall; a listener
     only rank 1 moves (both ranks raise the same ValueError, the next
     agreed step runs) and ``stop()`` on rank 0 alone (both loops end on
     one iteration); the projection model's fit (B5 on a 1x1 mesh at the
     headline for halos 2-16, t_round = cells*k/rate + C by least
     squares) and ``python -m planeverb_tpu_torch scale --project`` as a
     subprocess; the dry run's render with 256 sources split over a 4x1
     mesh's rows, held to one ``render_block`` at 5e-5 of each bus's peak
     (four D1 launches);
 24. assembly and DOA (``analyze_moments``: A1 + A2 of
     ``csrc/analysis.cu``) bit for bit against its plain version at the
     cells' shapes (192^2 with one and four views, 964^2), also with lazy
     directions; the layer's device time with the enqueue hidden, A1 and
     A2 alone, beside the byte bound, its CUDA-event time from an idle
     card and its host enqueue against the plain version's.

Every phase that counts a Context's calibration launch clears the
free-field cache (``core/free_grid.py::clear_cache``) before that Context.

Every main path's step is followed by one more with the card's launches of
each kernel counted (``kernels.device_launches``, zeroed just before it).
Then a JSON line with each kernel's (and mode's) launches on its main
path, its launches on the card in one step of that path, error, times and
bound, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without that line. It needs a CUDA card and the repository
beside it; it imports neither jax nor planeverb_tpu.
"""

import dataclasses
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

HEADLINE = dict(size=25.0, resolution=750, scene="HugeRoom",
                listener=(12.5, 12.5))
# the analysis's device launches in a step of every main path: A1 and A2
# (csrc/analysis.cu) once for all of the step's views
ANALYSIS_STEP = {"analysis_assemble_kernel": 1,
                 "analysis_directions_kernel": 1}
EMITTERS = [(15.0, 12.5), (10.0, 9.0), (12.5, 20.0)]
STEPS = 5
# the engine server (phase 20): the headline's emitters and 47 more for a
# game's per-frame poll of 50 (positions exact in float32, as the C client
# sends them), the 60 m world's emitters around its center, and the timed
# repetitions of a step and a poll over the wire
WIRE_EMITTERS = EMITTERS + [(2.0 + 2.5 * (i % 9), 3.0 + 4.0 * (i // 9))
                            for i in range(47)]
LARGE_EMITTERS = [(33.0, 30.0), (27.0, 26.5), (30.0, 37.0)]
WIRE_REPS = 10
# the large worlds (the JAX bench's tiled_large and tiled_xl rows): HugeRoom
# at 750 Hz, listener at the center; 459^2 x 1470 and 964^2 x 2006 cells
LARGE = 60.0
XL = 126.0
XL_EMITTERS = [(66.0, 63.0), (58.0, 59.0), (63.0, 72.0)]
XL_STEPS = 3
# the route's crossover, HugeRoom at 750 Hz: 8.4 m (65^2 cells), 12.5 m
# (96^2), 16.7 m (128^2), 20.8 m (160^2) and 25 m (the headline, 192^2, the
# most B1 holds); 1187 steps
CROSSOVER = (8.4, 12.5, 16.7, 20.8, 25.0)
CROSSOVER_REPS = 5
# the sharded engine (phases 11-13): meshes of the one card at the headline,
# the round length (the Context's default on 96^2 shards), B6's forced tile
SHARDED_MESHES = ((2, 2), (4, 1), (1, 1))
SHARD_HALO = 16
FORCED_BAND = 16
# kernel vs its plain version on the card: both round every op once (the
# kernels build with -fmad=false), so they are expected bit-equal; the bound
# checked is the C1 bound the port holds against JAX (1e-6 of the peak)
REL_TOL = 1e-6
# RT60 moments: logf inside the kernel vs torch.log; same bound as the JAX
# package's own kernel test (scale-relative 1e-5)
MOMENTS_REL_TOL = 1e-5
# several listeners (phases 14, 15): the headline's listener and the three
# emitter positions; two of them on the 2x2 mesh; two views of the 126 m
# world (its center, phase 9's listener, and one 10 m off), two steps
VIEWS = [HEADLINE["listener"], *EMITTERS]
MESH_VIEWS = 2
XL_VIEWS = [(XL / 2, XL / 2), (XL / 2 - 10.0, XL / 2 + 6.0)]
XL_MULTI_STEPS = 2
# bf16 against float32 parameters (phase 16): the bounds of the JAX
# package's tests/test_fdtd_pallas.py::test_bf16_state_mode_golden_parameters
# (SmallRoom, 10 m at 275 Hz), held on every cell there and on the
# emitters' cells at the headline
BF16_BOUNDS = {"occlusion": 0.02, "wet_gain": 0.02, "rt60": 0.06,
               "lowpass": 0.005}
BF16_MAX_DEGREES = 2.0
# the overlap split (phase 17): 1D meshes of the card at the headline (48-
# and 96-row shards at halo 16), the 126 m world on the first, and steps of
# the 126 m Context on it
OVERLAP_MESHES = ((4, 1), (2, 1))
XL_SPLIT_STEPS = 2
# the card's peaks for the bounds (NVIDIA's H100 SXM data sheet): HBM bytes
# a second, and float32 operations a second outside the tensor cores (the
# kernels compute in float32, bf16 included)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations a cell and step of the sims, and a recorded sample of the
# moments (the JAX kernels' pl.CostEstimate: 40 flops; 8 flops and a log)
SIM_OPS = 40
MOMENTS_OPS = 9
# the DSP's two recurrences (phases 18, 19): a 512-frame callback at 44.1
# kHz (the reference sandbox's stream), 2 s of audio; D1 at a game's real
# voice budgets (32, and 256: Unity's default and maximum real voices) and
# at blocks of 1 to 4096 samples (max_callback_length's limit)
AUDIO_RATE = 44100
AUDIO_FRAMES = 512
AUDIO_SECONDS = 2.0
D1_SOURCES = (32, 256)
D1_BLOCKS = (1, 511, 512, 4096)
# D1's bit-equality cases add a lone source and a ragged warp
D1_CASE_SOURCES = (1, 32, 33, 256)
# D2's bit-equality cases: (rate, start, blocks carried one to the next)
D2_CASES = ((44100, "filled", (1, 512, 4096)),
            (44100, "before the wrap", (512, 512, 512, 700)),
            (44100, "mid-word", (512, 700)),
            (11025, "filled", (1, 512, 4096)),
            (11025, "before the wrap", (700, 1000)),
            (1000, "filled", (1, 512, 4096)))
REPS_DSP = 20
# a chain probe's long run: this many callbacks' steps
CHAIN_PROBE_REPEAT = 64
# the card's playout held to a CPU replay of its first blocks (the same
# numpy DSP, D2's plain version): both round every op once
AUDIO_CHECK_BLOCKS = 8
AUDIO_REL_TOL = 1e-6
# the recurrences' serial chains: the float32 operations a step waits on
# from the last (D1: the y[t-1] product and two adds; D2: the damping
# memory's multiply and add), at an assumed dependent-instruction latency
# (phase 18 prints this reckoning beside the chain floor its probes
# measure; neither goes into the kernels line); D2's operations a sample
# and row
D1_CHAIN_OPS = 3
D2_CHAIN_OPS = 2
FP32_LATENCY = 4
D2_OPS = 30
# the sleep a timed call waits behind (torch.cuda._sleep cycles, ~2.5 ms),
# so a device time leaves out the call's host enqueue; an L2 flush (the
# card's L2 is 50 MB) for the moments timed cold
SLEEP_CYCLES = 5_000_000
FLUSH_BYTES = 256 << 20
# B2's probe: the card's schedulers an SM (each a warp instruction a
# cycle), for the floor of the instructions its SASS counts
SCHEDULERS_PER_SM = 4
# the last ported modules (phase 22): the scaling harness's positions of
# the one card and its timing reps, the per-step solvers' resolution, the
# worker processes' time limit, the hidden flag that starts a worker and
# the kernels the trace lists
SCALING_COUNTS = (1, 2, 4)
SCALING_REPS, SCALING_CHAIN = 3, 5
PER_STEP_RESOLUTION = 275
WORKER_TIMEOUT_S = 300
WORKER_FLAG = "--pv-worker"
TRACE_TOP = 5
# a Context across processes (phase 23): its steps, impulse responses on
# rank 0's and rank 1's shard rows, the background loop's steps before
# rank 0 stops it; the projection model's 1x1 halo sweep of B5 and its
# reps; the NVLink fit's shard edges (the headline's and 126 m's on 2x2)
# and exchanges a size; the dry run's split render at Unity's maximum
# real voices on a 4x1 mesh
CONTEXT_STEPS = 3
CONTEXT_IR_PROBES = ((5.0, 6.0), (20.0, 18.0))
LOOP_STEPS = 2
SWEEP_HALOS = (2, 4, 6, 8, 12, 16)
SWEEP_REPS = 3
LINK_EDGES = (96, 482)
LINK_REPS = 50
SPLIT_SOURCES = 256
# one float32 listener's pass at the headline on the card: B3 + B4, which
# fdtd_fused.route_tiled takes from TILED_SINGLE_MIN_CELLS (B1 keeps
# batches and bf16)
HEADLINE_PASS = {"fdtd_tiled_kernel": 1, "rt60_moments_tiled_kernel": 1}


def _require(cond, msg) -> None:
    """A check that holds under ``python -O`` too."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def _rel(a, b):
    """max |a - b| / max |b| over finite entries, and max |a - b|, in
    float32; a recording ([T, X, Y] or [B, T, X, Y]) is walked in chunks of
    steps, so no copy of it is made."""
    import torch

    diff = scale = 0.0
    for x, y in (zip(a.flatten(0, -3).split(64), b.flatten(0, -3).split(64))
                 if a.dim() >= 3 else [(a, b)]):
        x, y = x.float(), y.float()
        fin = torch.isfinite(y)
        if fin.any():
            diff = max(diff, (x[fin] - y[fin]).abs().max().item())
            scale = max(scale, y[fin].abs().max().item())
    return (diff / scale if scale > 0 else diff), diff


def _once(fn):
    """(CUDA-event ms, host wall ms) of one call of fn, from an idle
    device to its end."""
    import torch

    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1), (time.perf_counter() - t0) * 1e3


def _time_pair(kernel_fn, plain_fn, reps):
    """CUDA-event medians (ms) of kernel_fn and plain_fn, taken in turns
    (plain, kernel, kernel, plain, ...) after one warm-up call each."""
    import torch

    kernel_fn()
    plain_fn()
    torch.cuda.synchronize()
    ks, ps = [], []
    for r in range(reps):
        order = (plain_fn, kernel_fn) if r % 2 == 0 else (kernel_fn, plain_fn)
        for fn in order:
            (ks if fn is kernel_fn else ps).append(_once(fn)[0])
    return statistics.median(ks), statistics.median(ps)


def _compare(kres, kacc, rres, racc, what):
    """Hold a sim's outputs (FdtdResult, energies) to another's: onset
    equal, the rest within REL_TOL of the peak. Returns ({name: (rel, abs)},
    bit-equal on every output)."""
    import torch

    _require(torch.equal(kres.onset, rres.onset),
             f"{what}: onset differs")
    out = {}
    for name, a, b in (("rec", kres.pressure, rres.pressure),
                       ("fx", kres.flux_x, rres.flux_x),
                       ("fy", kres.flux_y, rres.flux_y),
                       ("e_dry", kacc[0], racc[0]),
                       ("e_wet", kacc[1], racc[1]),
                       ("e_total", kacc[2], racc[2])):
        out[name] = _rel(a, b)
        _require(out[name][0] <= REL_TOL,
                 f"{what} {name}: rel {out[name][0]} > {REL_TOL}")
    bits = all(torch.equal(a, b) for a, b in zip((*kres, *kacc),
                                                 (*rres, *racc)))
    return out, bits


def _enqueue_pair(fn_a, fn_b, reps):
    """Median host ms to enqueue fn_a and fn_b (from an idle device to the
    call's return, before the device ends), taken in turns."""
    import torch

    times = ([], [])
    for r in range(reps):
        for i in ((0, 1) if r % 2 else (1, 0)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (fn_a, fn_b)[i]()
            times[i].append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times[0]), statistics.median(times[1])


def _cuda_ms(fn, reps):
    """CUDA-event median (ms) of fn over reps calls, after one warm-up."""
    fn()
    return statistics.median(_once(fn)[0] for _ in range(reps))


def _device_ms(fn, reps, before=None):
    """CUDA-event median (ms) of fn's device work alone, after one warm-up
    call: each call is queued behind a sleep kernel, so its host enqueue is
    hidden, and ``before`` (B1, an L2 flush) runs between the sleep and
    the first event."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        if before is not None:
            before()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        fn()
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
    return statistics.median(times)


def _device_pair(fn_a, fn_b, reps):
    """:func:`_device_ms` medians of fn_a and fn_b taken in turns (a, b, b,
    a, ...)."""
    times = ([], [])
    for r in range(reps):
        for i in ((0, 1) if r % 2 == 0 else (1, 0)):
            times[i].append(_device_ms((fn_a, fn_b)[i], 1))
    return statistics.median(times[0]), statistics.median(times[1])


def _sass_loops(kernels, lib_path, names):
    """{name: [instructions of each loop body]} of the library's kernels
    whose mangled names hold each of ``names``, from cuobjdump's SASS: a
    loop is a backward branch, its body the instructions it spans (loops
    of fewer than 64 are left out)."""
    import re

    cuobjdump = os.path.join(os.path.dirname(kernels.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    loops, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = next((n for n in names if n in m.group(1)), None)
            if fn is not None:
                loops[fn] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?BRA\s+"
                      r"(?:U?P\w+,\s*)?(0x[0-9a-f]+)", ln)
        if fn is not None and m:
            src, dst = int(m.group(1), 16), int(m.group(2), 16)
            if dst < src and (src - dst) // 16 + 1 >= 64:
                loops[fn].append((src - dst) // 16 + 1)
    return loops


def _kernel_ms(fn, name):
    """(device ms, launches) of the kernels whose name holds ``name`` in one
    call of fn, from a torch.profiler trace of the card (after a warm-up
    call), and the call's wall ms; (None, 0, wall) where the trace holds no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    us, n = 0.0, 0
    for ev in prof.key_averages():
        if name in ev.key:
            us += getattr(ev, "device_time_total", 0.0)
            n += ev.count
    return (us / 1e3 if us else None), n, wall


def _stages(analyzer, q, res, mom, efree, lx, lz, directions, reps=5):
    """Medians of (CUDA-event ms, host wall ms) of parameter assembly (and
    DOA when ``directions``) on one pass's moments: the step's stage after
    the kernels."""
    def assemble():
        analyzer.analyze_moments(q, mom, res.onset, res.flux_x, res.flux_y,
                                 efree, lx, lz, compute_directions=directions)
    assemble()
    ev, wall = zip(*(_once(assemble) for _ in range(reps)))
    return statistics.median(ev), statistics.median(wall)


def _bound(moved_bytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the float32 rate."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sim_bound(q, listeners=1, state_bytes=4):
    """Bound of one simulation pass: read beta and six coefficient planes
    (state type) and the pulse, write each listener's recording (state
    type) and six float32 accumulator planes."""
    cells, T = q.nx * q.ny, q.response_length
    moved = (7 * state_bytes * cells + 4 * T
             + listeners * (state_bytes * T * cells + 6 * 4 * cells))
    return _bound(moved, SIM_OPS * listeners * T * cells)


def _moments_bound(q, listeners=1, rec_bytes=4):
    """Bound of the moments: read each recording and onset, write s0, s1."""
    cells, T = q.nx * q.ny, q.response_length
    moved = listeners * (rec_bytes * T * cells + 3 * 4 * cells)
    return _bound(moved, MOMENTS_OPS * listeners * T * cells)


def _param_errs(ref, got):
    """Per-cell deviations of got's parameters from ref's: relative for
    the four gains (cells where |ref| > 1e-6), degrees for the two
    directions (nonzero cells), as the JAX package's bf16 test measures
    them. {name: 1-D array}."""
    import numpy as np

    errs = {}
    for k in BF16_BOUNDS:
        a = np.asarray(ref[k], np.float64)
        b = np.asarray(got[k], np.float64)
        m = np.abs(a) > 1e-6
        errs[k] = np.abs(a - b)[m] / np.abs(a)[m]
    for k in ("direction", "source_directivity"):
        a = np.asarray(ref[k], np.float64)
        b = np.asarray(got[k], np.float64)
        nrm = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
        ok = nrm > 1e-9
        cos = np.clip((a * b).sum(-1)[ok] / nrm[ok], -1.0, 1.0)
        errs[k] = np.degrees(np.arccos(cos))
    return errs


def _within_bf16_bounds(errs, what) -> None:
    for k, err in errs.items():
        bound = BF16_BOUNDS.get(k, BF16_MAX_DEGREES)
        _require(err.size == 0 or err.max() < bound,
                 f"{what} {k}: {err.max()} >= {bound}")


# the packed publish row's fields, in column order (core/context.py::_pack)
ROW_FIELDS = ("occlusion", "wet_gain", "rt60", "lowpass", "direction",
              "source_directivity", "delay_samples")


# kernel names as they appear in ptxas's mangled entry names
_KERNELS = ("fdtd_cluster_kernel", "rt60_moments_kernel", "fdtd_tiled_kernel",
            "rt60_moments_tiled_kernel", "round_kernel",
            "biquad_scan_kernel", "reverb_scan_kernel",
            "dsp_chain_probe_kernel", "analysis_assemble_kernel",
            "analysis_directions_kernel")


def _template_args(tail):
    """'<float, 0>' from a mangled entry's template arguments ('IfLi0EE...'):
    types float and bf16, integers and booleans; '' where it has none."""
    import re

    if not tail.startswith("I"):
        return ""
    args, i = [], 1
    while i < len(tail) and tail[i] != "E":
        m = re.match(r"13__nv_bfloat16|f|Li(-?\d+)E|Lb([01])E", tail[i:])
        if m is None:
            return ""
        tok = m.group(0)
        args.append("bf16" if tok.startswith("13") else "float" if tok == "f"
                    else m.group(1) if m.group(1) is not None
                    else ("true" if m.group(2) == "1" else "false"))
        i += len(tok)
    return "<" + ", ".join(args) + ">"


def _ptxas_summary(log):
    """'kernel<args>: N registers, S bytes spilled' per entry of ptxas's
    -v log."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            base = next((k for k in _KERNELS if k in mangled), mangled)
            name = base + _template_args(mangled.split(base, 1)[-1])
        elif "spill stores" in ln and name:
            spill = ln.split("bytes spill stores")[0].split(",")[-1].strip()
            out.append([name, spill])
        elif "Used" in ln and "registers" in ln and name and out:
            regs = ln.split("Used", 1)[1].split("registers")[0].strip()
            out[-1] = f"{out[-1][0]}: {regs} registers, {out[-1][1]} bytes " \
                      f"spilled"
            name = None
    return [o for o in out if isinstance(o, str)]


def _device_pass(kernels, fn):
    """The card's launches of each kernel (``kernels.device_launches``, as
    the C launchers count them) in one call of fn, the counts zeroed just
    before it; the kernels launched at least once."""
    import torch

    torch.cuda.synchronize()
    kernels.device_launches(reset=True)
    fn()
    torch.cuda.synchronize()
    return {k: v for k, v in kernels.device_launches(reset=True).items()
            if v}


def _moments_phase(pv, kernels, lib_path, p, beta, refl, pulse, lix, liy,
                   kres, label):
    """Phase 4: B2 (``rt60_moments`` and its table launch) held bit for bit
    to its plain version on the headline recording, a 29 x 29 recording of
    37 steps (rows not 16-byte aligned, a short last chunk), a bf16
    recording, four listeners' recordings and one table over the 2x2 and
    4x1 meshes' shards; its device times warm (right after B1) and cold
    (after an L2 flush), the probe's modes, and the SASS count of a
    logarithm. Returns the numbers the kernels line takes."""
    import torch

    from planeverb_tpu_torch.config import gaussian_pulse
    from planeverb_tpu_torch.ops import fdtd_fused, voxelize

    dev = beta.device
    T = p.response_length
    rec, onset = kres.pressure, kres.onset
    ref = fdtd_fused.rt60_moments_reference

    def equal(q, got, recs, onsets):
        return all(torch.equal(g0, r0) and torch.equal(g1, r1)
                   for (g0, g1), (r0, r1) in zip(
                       got, (ref(q, r, o) for r, o in zip(recs, onsets))))

    # the headline, float32
    s0, s1 = fdtd_fused.rt60_moments(p, rec, onset)
    r0, r1 = ref(p, rec, onset)
    torch.cuda.synchronize()
    err = {"s0": _rel(s0, r0), "s1": _rel(s1, r1)}
    for name, (rel, _) in err.items():
        _require(rel <= MOMENTS_REL_TOL, f"B2 {name}: rel {rel}")
    bits = {"headline": torch.equal(s0, r0) and torch.equal(s1, r1)}
    _require(torch.isfinite(s0).all() and (s0 != 0).any(),
             "B2 moments not finite or all zero")
    # 29 x 29 cells (rows of 3364 bytes: not 16-byte aligned) and 37 steps
    # (chunks of 16 rows: a short last one); and a view that starts mid-word
    small = pv.compute_grid_params(pv.PlaneverbConfig(10.0, 10.0, 275))
    q = dataclasses.replace(small, response_length=37)
    sb, sr = voxelize.voxelize(q, torch.from_numpy(voxelize.boxes_to_array(
        pv.demo_scene("SmallRoom").boxes)).to(dev))
    spulse = torch.from_numpy(gaussian_pulse(q)).to(dev)
    sres, _ = fdtd_fused.fdtd_sim(q, sb, sr, spulse,
                                  *q.world_to_cell(5.0, 5.0))
    srec = sres.pressure
    _require(srec.shape[1] * srec.shape[2] * 4 % 16 != 0,
             "the small recording's rows are aligned")
    shifted = torch.empty(srec.numel() + 1, device=dev)[1:].view(srec.shape)
    shifted.copy_(srec)
    got = fdtd_fused.rt60_moments_many(q, [srec, shifted],
                                       [sres.onset, sres.onset])
    torch.cuda.synchronize()
    bits["29x29x37 unaligned"] = equal(q, got, [srec, shifted],
                                       [sres.onset, sres.onset])
    # a bf16 recording
    hres, _ = fdtd_fused.fdtd_sim(p, beta, refl, pulse, lix, liy,
                                  state_dtype=torch.bfloat16)
    got = [fdtd_fused.rt60_moments(p, hres.pressure, hres.onset)]
    torch.cuda.synchronize()
    bits["bf16"] = equal(p, got, [hres.pressure], [hres.onset])
    # four listeners (the batched mode)
    vcells = [p.world_to_cell(x, z) for x, z in VIEWS]
    bres, _ = fdtd_fused.fdtd_sim_batch(p, beta, refl, pulse, vcells)
    k0, k1 = fdtd_fused.rt60_moments_batch(p, bres.pressure, bres.onset)
    rb0, rb1 = ref(p, bres.pressure, bres.onset)
    torch.cuda.synchronize()
    bits["B = 4"] = torch.equal(k0, rb0) and torch.equal(k1, rb1)
    del rb0, rb1
    # one table over the 2x2 mesh's 96 x 96 and the 4x1 mesh's 48 x 192
    # shards' recordings, as the sharded engine's launch takes them
    cuts = ([(slice(a, a + p.nx // 2), slice(b, b + p.ny // 2))
             for a in (0, p.nx // 2) for b in (0, p.ny // 2)]
            + [(slice(a, a + p.nx // 4), slice(0, p.ny))
               for a in range(0, p.nx, p.nx // 4)])
    srecs = [rec[:, a, b].contiguous() for a, b in cuts]
    sons = [onset[a, b].contiguous() for a, b in cuts]
    fdtd_fused.reset_launch_counts()
    kernels.device_launches(reset=True)
    got = fdtd_fused.rt60_moments_many(p, srecs, sons)
    torch.cuda.synchronize()
    table_launches = kernels.device_launches(reset=True)
    _require(table_launches["rt60_moments_kernel"] == 1
             and fdtd_fused.rt60_moments_many.launches == 1,
             f"the shards' table is one launch: {table_launches}")
    bits["2x2 + 4x1 shards, one table"] = equal(p, got, srecs, sons)
    table_err = {}
    for (g0, g1), r, o in zip(got, srecs, sons):
        r0, r1 = ref(p, r, o)
        for name, a, b in (("s0", g0, r0), ("s1", g1, r1)):
            rel, diff = _rel(a, b)
            old_rel, old_diff = table_err.get(name, (0.0, 0.0))
            table_err[name] = (max(rel, old_rel), max(diff, old_diff))
    _require(all(bits.values()), f"B2 not bit-equal: {bits}")
    del got

    # device times (host enqueue hidden); warm: right after B1, whose last
    # rows B2 reads first; cold: after an L2 flush
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)

    def b2():
        fdtd_fused.rt60_moments(p, rec, onset)

    out = {"err": err, "table_err": table_err, "bits": bits}
    out["ms"] = _device_ms(b2, 10)
    out["warm_ms"] = _device_ms(b2, 6, before=lambda: fdtd_fused.fdtd_sim(
        p, beta, refl, pulse, lix, liy))
    out["cold_ms"] = _device_ms(b2, 10, before=lambda: flush.zero_())
    out["call_ms"] = _cuda_ms(b2, 10)      # host enqueue included
    out["plain_ms"] = _once(lambda: ref(p, rec, onset))[0]
    out["bf16_ms"] = _device_ms(lambda: fdtd_fused.rt60_moments(
        p, hres.pressure, hres.onset), 10)
    out["bf16_cold_ms"] = _device_ms(lambda: fdtd_fused.rt60_moments(
        p, hres.pressure, hres.onset), 10, before=lambda: flush.zero_())
    out["bf16_plain_ms"] = _once(lambda: ref(p, hres.pressure,
                                             hres.onset))[0]
    out["batch_ms"] = _device_ms(lambda: fdtd_fused.rt60_moments_batch(
        p, bres.pressure, bres.onset), 6)
    out["batch_cold_ms"] = _device_ms(lambda: fdtd_fused.rt60_moments_batch(
        p, bres.pressure, bres.onset), 6, before=lambda: flush.zero_())
    out["batch_plain_ms"] = _once(lambda: ref(p, bres.pressure,
                                              bres.onset))[0]
    mesh22 = (srecs[:4], sons[:4])
    out["table_ms"], out["singles_ms"] = _device_pair(
        lambda: fdtd_fused.rt60_moments_many(p, *mesh22),
        lambda: [fdtd_fused.rt60_moments(p, r, o) for r, o in zip(*mesh22)],
        10)
    out["table_cold_ms"] = _device_ms(
        lambda: fdtd_fused.rt60_moments_many(p, *mesh22), 10,
        before=lambda: flush.zero_())
    out["table_plain_ms"] = _once(
        lambda: fdtd_fused.rt60_moments_many_reference(p, *mesh22))[0]
    # the probe: each mode, float32 and bf16
    probe = {}
    for dt, (prec, pons) in (("f32", (rec, onset)),
                             ("bf16", (hres.pressure, hres.onset))):
        times = [_device_ms(lambda: fdtd_fused.rt60_moments_probe(
            p, [prec], [pons], mode), 6)
            for mode in fdtd_fused.MOMENTS_PROBE_MODES]
        probe[dt] = "/".join(f"{t:.4f}" for t in times)
    del bres, hres, srecs, sons, flush
    torch.cuda.empty_cache()
    # the SASS: a logarithm's instructions, the main loop's body (one chunk
    # of the aligned rows, its shortest loop) less the same loop without
    # logarithms, over the chunk's rows
    names = ("rt60_moments_kernelIfLi0E", "rt60_moments_kernelIfLi1E")
    loops = _sass_loops(kernels, lib_path, names)
    chunk = fdtd_fused.MOMENTS_CHUNK
    body, body_nolog = (min(loops[k]) for k in names)
    per_log = (body - body_nolog) / chunk
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    mhz = float(smi.stdout.split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    samples = T * p.nx * p.ny
    slots = sms * SCHEDULERS_PER_SM * 32 * mhz * 1e6     # lanes a second
    out["log_floor_ms"] = samples * per_log / slots * 1e3
    out["loop_floor_ms"] = samples * body / chunk / slots * 1e3
    bound = _moments_bound(p)[0]
    print(f"phase 4 B2 rt60_moments {p.nx}x{p.ny}x{T}: max rel diff "
          + ", ".join(f"{k} {v[0]:.3g}" for k, v in err.items())
          + f" (bound {MOMENTS_REL_TOL:g}); bit-equal to its plain version "
          f"on {bits}; the 8 shards' table: device launches "
          f"{ {k: v for k, v in table_launches.items() if v} }", flush=True)
    print(f"phase 4 B2 times (device, host enqueue hidden; {label}): "
          f"float32 {out['ms']:.4f} ms back to back, {out['warm_ms']:.4f} "
          f"right after B1, {out['cold_ms']:.4f} after an L2 flush (byte "
          f"bound {bound:.4f}, {bound / out['ms']:.0%}); with the host "
          f"enqueue {out['call_ms']:.4f}; bf16 {out['bf16_ms']:.4f} / cold "
          f"{out['bf16_cold_ms']:.4f} (byte bound "
          f"{_moments_bound(p, rec_bytes=2)[0]:.4f}); B = 4 "
          f"{out['batch_ms']:.4f} / cold {out['batch_cold_ms']:.4f} (bound "
          f"{_moments_bound(p, 4)[0]:.4f}); the 2x2 shards in one table "
          f"{out['table_ms']:.4f} / cold {out['table_cold_ms']:.4f} vs four "
          f"launches {out['singles_ms']:.4f} (in turns); plain "
          f"{out['plain_ms']:.3f} / bf16 {out['bf16_plain_ms']:.3f} / B = 4 "
          f"{out['batch_plain_ms']:.3f} / table {out['table_plain_ms']:.3f}",
          flush=True)
    print(f"phase 4 B2 probe, device ms full/no_log/no_load: {probe}; SASS: "
          f"main loop {body} instructions a chunk of {chunk} rows ({body_nolog}"
          f" without logarithms: {per_log:.1f} a logarithm, fmax and scale "
          f"included); instruction-slot floor at {mhz:.0f} MHz on {sms} SMs: "
          f"the logarithms {out['log_floor_ms']:.4f} ms, the main loop "
          f"{out['loop_floor_ms']:.4f} ms", flush=True)
    return out


def _strip_start_cells(nx, ny, rank):
    """Listener cells around the start of B1 cluster block ``rank``'s strip
    (its first cell c0 = rank * ceil(nx * ny / 16), row-major): the cell
    before it (the previous block's last), c0 itself, and the cell a row
    above c0."""
    c0 = rank * -(-nx * ny // 16)
    return [divmod(c, ny) for c in (c0 - 1, c0, c0 - ny) if c >= 0]


def _large_inputs(pv, voxelize, gaussian_pulse, size, dev, resolution=750):
    import torch

    p = pv.compute_grid_params(pv.PlaneverbConfig(size, size, resolution))
    beta, refl = voxelize.voxelize(p, torch.from_numpy(
        voxelize.boxes_to_array(pv.demo_scene("HugeRoom").boxes)).to(dev))
    pulse = torch.from_numpy(gaussian_pulse(p)).to(dev)
    lix, liy = p.world_to_cell(size / 2, size / 2)
    return p, beta, refl, pulse, lix, liy


def _b3_plan(q) -> tuple:
    """The round plan (tile_x, tile_y, k) B3 takes for q's field on card 0
    (``fdtd_tiled.plan_tiled``), and its window-rounds a pass."""
    import torch

    from planeverb_tpu_torch.ops import fdtd_tiled

    props = torch.cuda.get_device_properties(0)
    plan = fdtd_tiled.plan_tiled(q.nx, q.ny, q.response_length,
                                 props.multi_processor_count,
                                 props.shared_memory_per_block_optin)
    return plan, fdtd_tiled.window_rounds(q.nx, q.ny, q.response_length,
                                          plan, props.multi_processor_count)


def _across_cards(pv, kernels, dev, card) -> None:
    """``--cards``: the sharded engine on meshes of distinct cards, held to
    the single-card kernels bit for bit."""
    import torch

    from planeverb_tpu_torch import parallel
    from planeverb_tpu_torch.config import gaussian_pulse
    from planeverb_tpu_torch.ops import fdtd_fused, fdtd_tiled, voxelize
    from planeverb_tpu_torch.parallel import solver_fused

    n = torch.cuda.device_count()
    _require(n >= 2, f"--cards needs two or more cards, found {n}")
    cards = [f"cuda:{i}" for i in range(n)]
    square = (2, 2) if n >= 4 else (2, 1)
    row = (4, 1) if n >= 4 else (2, 1)
    label = f"{n} x {card}"
    # HugeRoom at 750 Hz, the listener at the center: the headline and the
    # 126 m world
    for size, single_fn in ((HEADLINE["size"],
                             fdtd_fused.simulate_moments_fused),
                            (XL, fdtd_tiled.simulate_moments_tiled)):
        q, qb, qr, qp, qx, qy = _large_inputs(pv, voxelize, gaussian_pulse,
                                              size, dev)
        res, mom = single_fn(q, qb, qr, qp, qx, qy)
        single = {**res._asdict(), **mom._asdict()}
        del res, mom
        for shape, overlap in ((square, False), (row, True)):
            m = shape[0] * shape[1]
            mesh = parallel.grid_mesh(cards[:m], shape)
            nx_pad, ny_pad = parallel.pad_to_mesh(q.nx, q.ny, mesh)
            pad = (0, ny_pad - q.ny, 0, nx_pad - q.nx)
            margs = (q, torch.nn.functional.pad(qb, pad),
                     torch.nn.functional.pad(qr, pad), qp, qx, qy, mesh,
                     nx_pad, ny_pad)
            fdtd_fused.reset_launch_counts()
            for d in range(m):
                torch.cuda.synchronize(d)
            kernels.device_launches(reset=True)
            res, mom = parallel.simulate_moments_sharded(
                *margs, halo=SHARD_HALO, overlap=overlap)
            for d in range(m):
                torch.cuda.synchronize(d)
            launched = {k: v for k, v in
                        kernels.device_launches(reset=True).items() if v}
            wrapper = (solver_fused.sharded_round.launches
                       + solver_fused.banded_round.launches)
            rounds = -(-q.response_length // SHARD_HALO)
            per_round = 2 if overlap else 1
            _require(wrapper == rounds * per_round * m,
                     f"{shape} overlap {overlap}: {wrapper} round launches")
            # the moments: one B2 launch per card over its shard (B5), or
            # one B4 launch a shard (B6)
            b2 = size == HEADLINE["size"]
            moments = {"rt60_moments_kernel" if b2
                       else "rt60_moments_tiled_kernel": m}
            _require({k: launched.get(k, 0) for k in moments} == moments
                     and fdtd_fused.rt60_moments_many.launches
                     == (m if b2 else 0),
                     f"{shape} overlap {overlap}: moments launches "
                     f"{launched}")
            got = {k: v[..., :q.nx, :q.ny]
                   for k, v in res.assemble(dev)._asdict().items()}
            got.update({k: v[:q.nx, :q.ny]
                        for k, v in mom.assemble(dev)._asdict().items()})
            del res, mom
            bits = all(torch.equal(got[k], single[k]) for k in single)
            errs = {k: _rel(got[k], single[k])[1] for k in single
                    if k != "onset"}
            _require(bits, f"{size:g} m on {shape} (overlap {overlap}) "
                           f"differs from one card: {errs}")
            del got

            def run():
                parallel.simulate_sharded_fused(*margs, halo=SHARD_HALO,
                                                overlap=overlap)
                for d in range(m):
                    torch.cuda.synchronize(d)

            run()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                run()
                walls.append((time.perf_counter() - t0) * 1e3)
            print(f"cards {q.nx}x{q.ny}x{q.response_length} on a "
                  f"{shape[0]}x{shape[1]} mesh of {m} cards"
                  f"{' (the split)' if overlap else ''}, halo {SHARD_HALO}: "
                  f"device launches {launched} ({rounds * per_round} a "
                  f"card), all nine outputs bit-equal to one card's "
                  f"{'B1 + B2' if size == HEADLINE['size'] else 'B3 + B4'} "
                  f"{bits}; simulation {statistics.median(walls):.3f} ms "
                  f"(host wall to the last card's end, median of 3; "
                  f"{label})", flush=True)
        del single
        torch.cuda.empty_cache()

# ------------------------------------------------------------ phase 22
def _padded_args(parallel, inputs, mesh):
    """A pass's arguments on ``mesh``: the inputs' fields padded to it."""
    import torch

    q, b, r, pu, x, y = inputs
    nx_pad, ny_pad = parallel.pad_to_mesh(q.nx, q.ny, mesh)
    pad = (0, ny_pad - q.ny, 0, nx_pad - q.nx)
    return (q, torch.nn.functional.pad(b, pad),
            torch.nn.functional.pad(r, pad), pu, x, y, mesh, nx_pad, ny_pad)


def _worker_cases(pv, dev):
    """The two-process passes, (name, inputs, run(mesh) -> Sharded): B5 at
    the headline, B6 at 60 m (its 2x2 shards are above 192^2), and the
    plain-torch wide solver at 275 Hz."""
    from planeverb_tpu_torch import parallel
    from planeverb_tpu_torch.config import gaussian_pulse
    from planeverb_tpu_torch.ops import voxelize

    cases = []
    for name, size, res, wide in (
            ("B5 headline", HEADLINE["size"], 750, False),
            (f"B6 {LARGE:g} m", LARGE, 750, False),
            (f"wide {PER_STEP_RESOLUTION} Hz", HEADLINE["size"],
             PER_STEP_RESOLUTION, True)):
        inputs = _large_inputs(pv, voxelize, gaussian_pulse, size, dev, res)

        def run(mesh, inputs=inputs, wide=wide):
            args = _padded_args(parallel, inputs, mesh)
            if wide:
                return parallel.simulate_sharded_wide(*args, halo=8)
            return parallel.simulate_sharded_fused(*args, halo=SHARD_HALO)

        cases.append((name, inputs, run))
    return cases


def _card_cases(pv, dev):
    """``--cards``' one-process-a-card passes: B5 at the headline and B6 at
    126 m (its 2x2 shards are 482^2)."""
    from planeverb_tpu_torch import parallel
    from planeverb_tpu_torch.config import gaussian_pulse
    from planeverb_tpu_torch.ops import voxelize

    cases = []
    for name, size in (("B5 headline", HEADLINE["size"]),
                       (f"B6 {XL:g} m", XL)):
        inputs = _large_inputs(pv, voxelize, gaussian_pulse, size, dev)

        def run(mesh, inputs=inputs):
            return parallel.simulate_sharded_fused(
                *_padded_args(parallel, inputs, mesh), halo=SHARD_HALO)

        cases.append((name, inputs, run))
    return cases


def _worker_launches(name, q):
    """The round launches one worker makes in a case's pass: one a round
    on its one device, B5's or B6's by the case's name; none for the
    plain-torch wide solver."""
    rounds = -(-q.response_length // SHARD_HALO)
    return {"sharded_round": rounds if name.startswith("B5") else 0,
            "banded_round": rounds if name.startswith("B6") else 0}


def _cards_mesh(parallel, n, devices, ranks):
    """A mesh of n positions (2x2 for four, n x 1 otherwise) over
    ``devices`` owned by ``ranks``, row-major."""
    shape = (2, 2) if n == 4 else (n, 1)
    rows = [list(range(i * shape[1], (i + 1) * shape[1]))
            for i in range(shape[0])]
    return parallel.Mesh([[devices[k] for k in r] for r in rows],
                         None if ranks is None else
                         [[ranks[k] for k in r] for r in rows])


def _block_digests(sharded) -> dict:
    """SHA-256 of each local block's fields (its recording and grids), by
    mesh position "i,j"."""
    names = sharded.kind._fields
    out = {}
    for i, row in enumerate(sharded.blocks[names[0]]):
        for j, block in enumerate(row):
            if block is None:
                continue
            h = hashlib.sha256()
            for n in names:
                h.update(sharded.blocks[n][i][j].contiguous().cpu().numpy()
                         .tobytes())
            out[f"{i},{j}"] = h.hexdigest()
    return out


def _vs_b1(fields, single, q):
    """(max rel over the recording and flux, onset equal) of assembled
    fields on [:nx, :ny] against a single-device FdtdResult."""
    import torch

    rel = max(_rel(getattr(fields, n)[..., :q.nx, :q.ny],
                   getattr(single, n))[0]
              for n in ("pressure", "flux_x", "flux_y"))
    return rel, bool(torch.equal(fields.onset[:q.nx, :q.ny], single.onset))


def _worker_main(argv) -> int:
    """A worker process: ``argv`` = (port, rank, processes, backend).
    Joins a process group on 127.0.0.1 and runs its cases on a
    multi-process mesh, then prints one ``WORKER {json}`` line: each
    case's block digests, launches, pass time, and for the wide pass its
    error against B1. With gloo (phase 22) two processes each take two
    positions of ``cuda:0`` on a 2x2 ``multihost_grid_mesh``; with nccl
    (``--cards``) each process owns one card of a 2x2 (four) or n x 1
    mesh. With a fifth argument ``context`` it runs phase 23's Contexts
    instead (:func:`_context_worker`)."""
    import torch

    import planeverb_tpu_torch as pv
    from planeverb_tpu_torch import parallel
    from planeverb_tpu_torch.ops import fdtd_fused
    from planeverb_tpu_torch.parallel import solver_fused

    port, rank, world, backend = argv[0], int(argv[1]), int(argv[2]), argv[3]
    parallel.init_distributed(f"127.0.0.1:{port}", num_processes=world,
                              process_id=rank, backend=backend)
    if argv[4:] == ["context"]:
        out = _context_worker(pv, rank, world, backend)
        print("WORKER " + json.dumps(out), flush=True)
        torch.distributed.destroy_process_group()
        return 0
    if backend == "gloo":
        dev = torch.device("cuda", 0)
        mesh = parallel.multihost_grid_mesh(local_devices=[dev, dev])
        _require(mesh.ranks == [[0, 0], [1, 1]] and mesh.multi_process,
                 f"worker {rank}: mesh {mesh}")
        cases = _worker_cases(pv, dev)
    else:
        dev = torch.device("cuda", rank)
        mesh = _cards_mesh(parallel, world,
                           [f"cuda:{r}" for r in range(world)],
                           list(range(world)))
        cases = _card_cases(pv, dev)
    out = {"rank": rank, "cases": {}}
    for name, inputs, run in cases:
        fdtd_fused.reset_launch_counts()
        res = run(mesh)
        torch.cuda.synchronize(dev)
        case = {"blocks": _block_digests(res),
                "launches": {f.__name__: f.launches for f in (
                    solver_fused.sharded_round, solver_fused.banded_round)}}
        if name.startswith("wide"):
            q, b, r, pu, x, y = inputs
            single, _ = fdtd_fused.fdtd_sim(q, b, r, pu, x, y)
            case["rel"], case["onset_equal"] = _vs_b1(res.assemble(dev),
                                                      single, q)
        del res
        walls = []
        for _ in range(3):
            torch.distributed.barrier()
            t0 = time.perf_counter()
            run(mesh)
            torch.cuda.synchronize(dev)
            walls.append((time.perf_counter() - t0) * 1e3)
        case["ms"] = statistics.median(walls)
        out["cases"][name] = case
        torch.cuda.empty_cache()
    print("WORKER " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def _run_workers(root, argv_of, n, timeout):
    """Start ``n`` copies of this script as workers (``argv_of(rank)``),
    wait for all, and return their ``WORKER`` results; a worker that fails
    or passes ``timeout`` fails the run, and none outlives this call."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), WORKER_FLAG,
         *argv_of(port, rank)], cwd=root, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(n)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    results = []
    for rank, (proc, text) in enumerate(zip(procs, outs)):
        _require(proc.returncode == 0,
                 f"worker {rank} exited {proc.returncode}:\n{text[-4000:]}")
        lines = [line for line in text.splitlines()
                 if line.startswith("WORKER ")]
        _require(len(lines) == 1, f"worker {rank} printed no result:\n"
                                  f"{text[-4000:]}")
        results.append(json.loads(lines[0][len("WORKER "):]))
    return results


def _scaling_phase(pv, card, label, root):
    """Phase 22: the scaling harness, the per-step solvers, two processes
    on the card, a device trace, the entry module and the CLI's scale."""
    import numpy as np
    import torch

    from planeverb_tpu_torch import parallel
    from planeverb_tpu_torch.config import gaussian_pulse
    from planeverb_tpu_torch.entry import dryrun_multichip, entry
    from planeverb_tpu_torch.ops import fdtd_fused, voxelize
    from planeverb_tpu_torch.parallel import solver_fused
    from planeverb_tpu_torch.parallel.scaling import measure_scaling
    from planeverb_tpu_torch.utils.profiling import device_trace

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    one_card = ["cuda:0"] * max(SCALING_COUNTS)
    hl = _large_inputs(pv, voxelize, gaussian_pulse, HEADLINE["size"], dev)
    q = hl[0]
    passes = 1 + SCALING_REPS * SCALING_CHAIN

    # -- the harness: strong, the overlap sweep, a weak pair (B5 rounds)
    sweeps = (("strong", dict(device_counts=list(SCALING_COUNTS))),
              ("overlap", dict(device_counts=list(SCALING_COUNTS[1:]),
                               overlap=True)),
              ("weak", dict(device_counts=[1, 2], mode="weak")))
    fused_rows = []
    for what, kw in sweeps:
        fdtd_fused.reset_launch_counts()
        rows = measure_scaling(*hl, halo=SHARD_HALO, reps=SCALING_REPS,
                               chain=SCALING_CHAIN, solver="fused",
                               devices=one_card, **kw)
        torch.cuda.synchronize()
        per_pass = [-(-q.response_length // r["halo"])
                    * (2 if r["overlap"] and r["mesh"][0] > 1 else 1)
                    for r in rows]
        b5 = solver_fused.sharded_round.launches
        _require(b5 == passes * sum(per_pass)
                 and solver_fused.banded_round.launches == 0,
                 f"{what} sweep: B5 launches {b5}, B6 "
                 f"{solver_fused.banded_round.launches}")
        for r, n in zip(rows, per_pass):
            r["b5_launches_per_pass"] = n
            print(f"phase 22 measure_scaling {what} (fused, {r['devices']} "
                  f"position(s) of cuda:0): {json.dumps(r)} ({label})",
                  flush=True)
        fused_rows += rows

    # -- each fused row's pass, rerun, bit-equal to one device's pass (the
    # weak rows' worlds are above what B1 holds)
    singles = {}
    for r in fused_rows:
        world = (hl if r["mode"] == "strong" else
                 _weak_inputs(pv, voxelize, gaussian_pulse, q, r, dev))
        key = (r["mode"], *r["grid"])
        if key not in singles:
            singles[key] = fdtd_fused.simulate_auto(*world)
        mesh = parallel.grid_mesh(one_card[:r["devices"]], tuple(r["mesh"]))
        got = parallel.simulate_sharded_fused(
            *_padded_args(parallel, world, mesh), halo=r["halo"],
            overlap=r["overlap"]).assemble(dev)
        single = singles[key]
        _require(all(torch.equal(getattr(got, n)[..., :single.onset.shape[0],
                                                 :single.onset.shape[1]],
                                 getattr(single, n))
                     for n in single._fields),
                 f"fused row {r} differs from one device's pass")
        del got
    del singles
    torch.cuda.empty_cache()
    print(f"phase 22 every fused row's pass ({len(fused_rows)}) bit-equal to "
          f"one device's pass (simulate_auto) on [:nx, :ny]", flush=True)

    # -- the plain-torch wide solver once, and the per-step solver at 275 Hz
    fdtd_fused.reset_launch_counts()
    (wrow,) = measure_scaling(*hl, device_counts=[max(SCALING_COUNTS)],
                              halo=SHARD_HALO, reps=1, chain=1,
                              solver="wide", devices=one_card)
    _require(solver_fused.sharded_round.launches == 0,
             "the wide solver launched a round kernel")
    b1, _ = fdtd_fused.fdtd_sim(*hl)
    wmesh = parallel.grid_mesh(one_card, tuple(wrow["mesh"]))
    wide = parallel.simulate_sharded_wide(
        *_padded_args(parallel, hl, wmesh), halo=wrow["halo"]).assemble(dev)
    wide_rel, wide_onset = _vs_b1(wide, b1, q)
    _require(wide_rel <= REL_TOL and wide_onset,
             f"wide vs B1: rel {wide_rel}, onset equal {wide_onset}")
    del wide, b1
    low = _large_inputs(pv, voxelize, gaussian_pulse, HEADLINE["size"], dev,
                        PER_STEP_RESOLUTION)
    b1_low, _ = fdtd_fused.fdtd_sim(*low)
    t0 = time.perf_counter()
    step = parallel.simulate_sharded(*_padded_args(parallel, low, wmesh))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    step_rel, step_onset = _vs_b1(step.assemble(dev), b1_low, low[0])
    _require(step_rel <= REL_TOL and step_onset,
             f"simulate_sharded vs B1: rel {step_rel}, onset equal "
             f"{step_onset}")
    del step
    print(f"phase 22 measure_scaling wide (plain torch, reps 1, chain 1): "
          f"{json.dumps(wrow)}; its pass vs B1 max rel {wide_rel:.3e} "
          f"(bound {REL_TOL:g}), onset equal; simulate_sharded "
          f"{low[0].nx}x{low[0].ny}x{low[0].response_length} "
          f"({PER_STEP_RESOLUTION} Hz) on {wmesh.shape['x']}x"
          f"{wmesh.shape['y']}: {step_ms:.1f} ms (host wall, first pass), "
          f"vs B1 max rel {step_rel:.3e}, onset equal ({label})", flush=True)

    # -- two processes on the one card
    t_workers = time.perf_counter()
    results = _run_workers(root, lambda port, rank: [str(port), str(rank),
                                                     "2", "gloo"],
                           2, WORKER_TIMEOUT_S)
    workers_s = time.perf_counter() - t_workers
    mesh22 = parallel.grid_mesh(one_card, (2, 2))
    for name, inputs, run in _worker_cases(pv, dev):
        mine = _block_digests(run(mesh22))
        torch.cuda.synchronize()
        for res in results:
            case = res["cases"][name]
            _require(case["blocks"] and all(
                mine[pos] == d for pos, d in case["blocks"].items()),
                f"{name}: worker {res['rank']}'s blocks differ from the "
                f"single-process run")
            _require(case["launches"] == _worker_launches(name, inputs[0]),
                     f"{name}: worker {res['rank']} launches "
                     f"{case['launches']}")
            if name.startswith("wide"):
                _require(case["rel"] <= REL_TOL and case["onset_equal"],
                         f"{name}: worker {res['rank']} vs B1 rel "
                         f"{case['rel']}")
        torch.cuda.empty_cache()
        print(f"phase 22 two processes (gloo, 2 positions of cuda:0 each, "
              f"2x2 multihost_grid_mesh) {name}: every block bit-equal to "
              f"the single-process run; launches "
              + "; ".join(f"rank {r['rank']} "
                          f"{r['cases'][name]['launches']}" for r in results)
              + "; pass " + ", ".join(f"{r['cases'][name]['ms']:.1f}"
                                     for r in results)
              + " ms (host wall, median of 3)"
              + ("" if "rel" not in results[0]["cases"][name] else
                 f"; vs B1 max rel "
                 f"{max(r['cases'][name]['rel'] for r in results):.3e}")
              + f" ({label})", flush=True)
    print(f"phase 22 the two workers took {workers_s:.1f} s", flush=True)

    # -- a device trace of one headline Context.step()
    lx, lz = HEADLINE["listener"]
    ctx = pv.Context(pv.PlaneverbConfig(HEADLINE["size"], HEADLINE["size"],
                                        HEADLINE["resolution"]),
                     scene=pv.demo_scene(HEADLINE["scene"]), device=dev)
    ctx.set_listener_position(lx, 0.0, lz)
    for x, z in EMITTERS:
        ctx.emissions.emit(x, 0.0, z)
    ctx.step()
    trace_dir = os.path.join(root, "planeverb_tpu_torch", "build", "trace22")
    with device_trace(trace_dir) as prof:
        ctx.step()
        torch.cuda.synchronize()
    _require(os.path.getsize(os.path.join(trace_dir, "trace.json")) > 0,
             "device_trace wrote no trace")
    kern = sorted(((getattr(e, "self_device_time_total", 0.0)
                    or getattr(e, "device_time_total", 0.0), e.count, e.key)
                   for e in prof.key_averages()
                   if "CUDA" in str(getattr(e, "device_type", ""))),
                  reverse=True)[:TRACE_TOP]
    del ctx
    print(f"phase 22 device_trace of one headline Context.step() -> "
          f"{os.path.relpath(trace_dir, root)}/trace.json; longest kernels: "
          + ("; ".join(f"{key[:60]} x{n} {us / 1e3:.3f} ms"
                       for us, n, key in kern)
             or "none recorded (the trace holds no device time)")
          + f" ({label})", flush=True)

    # -- the entry module on the card
    fn, args = entry(device=dev)
    out = fn(*args)
    torch.cuda.synchronize()
    cfn, cargs = entry(device="cpu")
    want = cfn(*cargs)
    for name, (rtol, atol) in _GOLDEN.items():
        np.testing.assert_allclose(getattr(out, name).cpu().numpy(),
                                   getattr(want, name).numpy(), rtol=rtol,
                                   atol=atol, err_msg=f"entry {name}")
    dryrun_multichip(max(SCALING_COUNTS), device=dev.type)
    print(f"phase 22 entry() on the card within the golden tolerances of "
          f"entry(device='cpu'); dryrun_multichip({max(SCALING_COUNTS)}) "
          f"passed its checks (the line above)", flush=True)

    # -- the CLI's scale as a subprocess
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "planeverb_tpu_torch", "scale",
         HEADLINE["scene"], "--grid-size", f"{HEADLINE['size']:g}",
         "--resolution", str(HEADLINE["resolution"]), "--listener",
         f"{lx:g},{lz:g}", "--solver", "fused", "--engine-device",
         dev.type], cwd=root,
        capture_output=True, text=True, timeout=WORKER_TIMEOUT_S)
    _require(proc.returncode == 0, f"scale exited {proc.returncode}: "
                                   f"{proc.stderr[-2000:]}")
    cli_rows = [json.loads(line) for line in proc.stdout.splitlines()]
    _require(cli_rows and all(r["solver"] == "fused" and r["wall_s"] > 0
                              for r in cli_rows), proc.stdout)
    print(f"phase 22 python -m planeverb_tpu_torch scale "
          f"{HEADLINE['scene']} --solver fused: {len(cli_rows)} row(s), "
          + "; ".join(json.dumps(r) for r in cli_rows)
          + f" ({time.perf_counter() - t0:.1f} s with the interpreter's "
          f"start; {label})", flush=True)
    print(f"phase 22 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {"rows": fused_rows, "wide": wrow}


def _weak_inputs(pv, voxelize, gaussian_pulse, q, row, dev):
    """The weak sweep's world for a row (measure_scaling's: an empty world
    mesh times the base grid, at the base response length, listener at its
    center), on ``dev``."""
    import torch

    mx, my = row["mesh"]
    p = dataclasses.replace(pv.compute_grid_params(pv.PlaneverbConfig(
        q.grid_size_x * mx, q.grid_size_y * my, q.resolution)),
        response_length=q.response_length)
    beta, refl = (torch.from_numpy(a).to(dev)
                  for a in voxelize.base_fields(p))
    pulse = torch.from_numpy(gaussian_pulse(q)).to(dev)
    return p, beta, refl, pulse, p.nx // 2, p.ny // 2



# ------------------------------------------------------------ phase 23
def _published_digest(ctx) -> str:
    """SHA-256 of a Context's published snapshot: every grid, or the
    cells rows and the device grid."""
    import numpy as np

    pub = ctx._published
    h = hashlib.sha256()
    if "cells" in pub:
        for cell in sorted(pub["cells"]):
            h.update(repr(cell).encode())
            h.update(np.ascontiguousarray(pub["cells"][cell]).tobytes())
        h.update(pub["packed_device"].cpu().numpy().tobytes())
    for key in sorted(pub.keys() - {"listener", "listeners", "pressure",
                                    "cells", "packed_device"}):
        h.update(key.encode())
        h.update(np.ascontiguousarray(pub[key]).tobytes())
    return h.hexdigest()


def _phase23_context(pv, place, size, publish="grids", emitters=EMITTERS,
                     views=None):
    """HugeRoom at ``size`` and 750 Hz on ``place`` (a mesh, or one
    device), the listener at the world's center (the headline's and phase
    9's), ``emitters`` live, ``views`` (x, z) if given."""
    from planeverb_tpu_torch.parallel import Mesh

    mesh = place if isinstance(place, Mesh) else None
    ctx = pv.Context(pv.PlaneverbConfig(size, size, HEADLINE["resolution"]),
                     scene=pv.demo_scene(HEADLINE["scene"]), publish=publish,
                     mesh=mesh, device=None if mesh is not None else place)
    ctx.set_listener_position(size / 2, 0.0, size / 2)
    if views:
        ctx.set_listener_positions([(x, 0.0, z) for x, z in views])
    for x, z in emitters:
        ctx.emissions.emit(x, 0.0, z)
    return ctx


# phase 23's Contexts: (name, the place's key, world size, publish,
# emitters, views, steps, impulse responses read); gloo on one card, and
# one NCCL process a card (``--cards``)
CONTEXT_CASES = {
    "gloo": (("grids", "2x2", HEADLINE["size"], "grids", EMITTERS, None,
              CONTEXT_STEPS, True),
             ("cells", "2x2", HEADLINE["size"], "cells", WIRE_EMITTERS, None,
              1, False),
             ("cells views", "2x2", HEADLINE["size"], "cells", WIRE_EMITTERS,
              VIEWS[:2], 1, False),
             ("split", "4x1", HEADLINE["size"], "grids", EMITTERS, None, 1,
              True)),
    "cards": (("grids", "2x2", HEADLINE["size"], "grids", EMITTERS, None,
               CONTEXT_STEPS, True),
              ("xl cells", "2x2", XL, "cells", XL_EMITTERS, None, XL_STEPS,
               False),
              ("xl split", "4x1", XL, "cells", XL_EMITTERS, None, XL_STEPS,
               False)),
}


def _context_cases(pv, kind, places) -> dict:
    """Each of ``CONTEXT_CASES[kind]`` on ``places`` ({key: mesh or
    device}): {name: digest of the last publish, host walls of its steps,
    the wrappers' launches over the steps (counts set to 0 just before
    them), the overlap split taken, impulse-response digests}."""
    import torch

    from planeverb_tpu_torch.ops import fdtd_fused, fdtd_tiled
    from planeverb_tpu_torch.parallel import solver_fused

    out = {}
    for name, key, size, publish, emitters, views, steps, irs in \
            CONTEXT_CASES[kind]:
        ctx = _phase23_context(pv, places[key], size, publish, emitters,
                               views)
        fdtd_fused.reset_launch_counts()
        walls = []
        for _ in range(steps):
            t0 = time.perf_counter()
            ctx.step()
            walls.append((time.perf_counter() - t0) * 1e3)
        case = {"digest": _published_digest(ctx), "walls": walls,
                "launches": counts_of(
                    solver_fused.sharded_round, solver_fused.banded_round,
                    fdtd_fused.rt60_moments_many,
                    fdtd_tiled.rt60_moments_tiled),
                "overlap": bool(getattr(ctx, "_overlap", False))}
        if irs:
            case["irs"] = [hashlib.sha256(ctx.get_impulse_response(x, z)
                                          .tobytes()).hexdigest()
                           for x, z in CONTEXT_IR_PROBES]
        out[name] = case
        del ctx
        torch.cuda.empty_cache()
    return out


def _agree_checks(pv, mesh, rank) -> dict:
    """On a Context of every rank: a listener only rank 1 moves (every
    rank must raise the same ValueError), an agreed step after it, then
    the background loop with ``stop()`` on rank 0 alone."""
    ctx = _phase23_context(pv, mesh, HEADLINE["size"])
    out = {}
    if rank == 1:
        ctx.set_listener_position(HEADLINE["size"] / 2 + 0.5, 0.0,
                                  HEADLINE["size"] / 2)
    try:
        ctx.step()
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    out["refused_iteration"] = ctx.iteration
    ctx.set_listener_position(HEADLINE["size"] / 2, 0.0, HEADLINE["size"] / 2)
    ctx.step()
    out["after"] = _published_digest(ctx)
    start = ctx.iteration
    ctx.start()
    if rank == 0:
        out["loop_reached"] = ctx.wait_for_iteration(start + LOOP_STEPS,
                                                     timeout=120)
        ctx.stop()
    else:
        deadline = time.monotonic() + 120
        while ctx.background_running and time.monotonic() < deadline:
            time.sleep(0.01)
        out["loop_ended_alone"] = not ctx.background_running
        ctx.stop()
    out["stopped_at"] = ctx.iteration - start
    out["loop_error"] = repr(ctx.error)
    return out


def _link_exchanges(rank, dev) -> list:
    """Ranks 0 and 1 exchange slabs of 3 x k x edge float32 both ways at
    once (``multihost.transfer``, as a round's ghosts cross), LINK_REPS
    times back to back: [{bytes, s}] of one exchange, on rank 0 and 1; the
    other ranks wait."""
    import torch
    import torch.distributed as dist

    from planeverb_tpu_torch.parallel import multihost

    rows = []
    for edge in LINK_EDGES:
        for k in SWEEP_HALOS:
            n = 3 * k * edge
            dist.barrier(device_ids=[dev.index])
            if rank > 1:
                continue
            peer = 1 - rank
            x = torch.full((n,), float(rank + 1), device=dev)
            buf = torch.zeros(n, device=dev)
            for _ in range(3):
                multihost.transfer([(x, peer, 0)], [(buf, peer, 0)])
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(LINK_REPS):
                multihost.transfer([(x, peer, 0)], [(buf, peer, 0)])
            torch.cuda.synchronize(dev)
            rows.append({"bytes": 4 * n,
                         "s": (time.perf_counter() - t0) / LINK_REPS})
            _require(bool((buf == peer + 1).all()),
                     f"rank {rank}: the exchange delivered the wrong slab")
    dist.barrier(device_ids=[dev.index])
    return rows


def _context_worker(pv, rank, world, backend) -> dict:
    """Phase 23's worker: with gloo two positions of ``cuda:0`` a process
    on (2, 2) and (4, 1) ``multihost_grid_mesh``es, the gloo cases and the
    agreement checks; with nccl one card a process on a 2x2 (or n x 1)
    and an n x 1 mesh, the cards' cases and the NVLink exchanges."""
    import torch

    from planeverb_tpu_torch import parallel

    if backend == "gloo":
        dev = torch.device("cuda", 0)
        places = {"2x2": parallel.multihost_grid_mesh(local_devices=[dev,
                                                                     dev]),
                  "4x1": parallel.multihost_grid_mesh((4, 1),
                                                      local_devices=[dev,
                                                                     dev])}
        _require(places["2x2"].ranks == [[0, 0], [1, 1]]
                 and places["4x1"].ranks == [[0], [0], [1], [1]],
                 f"worker {rank}: meshes {places}")
        out = {"rank": rank, "cases": _context_cases(pv, "gloo", places)}
        out.update(_agree_checks(pv, places["2x2"], rank))
        return out
    dev = torch.device("cuda", rank)
    cards = [f"cuda:{r}" for r in range(world)]
    places = {"2x2": _cards_mesh(parallel, world, cards, list(range(world))),
              "4x1": parallel.Mesh([[c] for c in cards],
                                   [[r] for r in range(world)])}
    return {"rank": rank, "cases": _context_cases(pv, "cards", places),
            "link": _link_exchanges(rank, dev)}


def _hold_cases(results, refs, kind, label, tag) -> None:
    """Hold every worker's cases to the references ({what: cases}) bit for
    bit, require the path's launches (B5 or B6 rounds, and their moments)
    in every worker's steps, and print each case's step walls."""
    for name, *_ in CONTEXT_CASES[kind]:
        for res in results:
            case = res["cases"][name]
            for what, ref in refs.items():
                _require(case["digest"] == ref[name]["digest"]
                         and case.get("irs") == ref[name].get("irs"),
                         f"{name}: rank {res['rank']} differs from {what}")
            n = case["launches"]
            _require(n["sharded_round"] + n["banded_round"] > 0
                     and n["rt60_moments_many"] + n["rt60_moments_tiled"] > 0,
                     f"{name}: rank {res['rank']} launched {n}")
        overlap = results[0]["cases"][name]["overlap"]
        _require(overlap == ("split" in name),
                 f"{name}: overlap split taken {overlap}")
        print(f"{tag} Context across processes, {name}"
              f"{' (the overlap split)' if overlap else ''}: every rank's "
              f"publish{' and impulse responses' if 'irs' in results[0]['cases'][name] else ''} "
              f"bit-equal to {' and '.join(refs)}; launches "
              + "; ".join(f"rank {r['rank']} {r['cases'][name]['launches']}"
                          for r in results)
              + "; step host walls "
              + "; ".join(f"rank {r['rank']} " + ", ".join(
                  f"{w:.1f}" for w in r["cases"][name]["walls"])
                  for r in results) + f" ms ({label})", flush=True)


def _halo_sweep(hl, label) -> tuple:
    """The projection model's fit on one card: B5 on a 1x1 mesh at the
    headline for each halo k of SWEEP_HALOS, CUDA-event medians of a pass
    over its rounds, fitted by least squares to t_round = cells * k /
    rate + C (cells unpadded). Returns (rate, C, max relative residual)."""
    import numpy as np
    import torch

    from planeverb_tpu_torch import parallel
    from planeverb_tpu_torch.parallel import scaling, solver_fused

    q = hl[0]
    mesh = parallel.grid_mesh(["cuda:0"], (1, 1))
    args = _padded_args(parallel, hl, mesh)
    cells = args[7] * args[8]
    xs, ts = [], []
    for k in SWEEP_HALOS:
        rounds = -(-q.response_length // k)
        solver_fused.sharded_round.launches = 0
        ms = _cuda_ms(lambda k=k: parallel.simulate_sharded_fused(
            *args, halo=k), SWEEP_REPS)
        _require(solver_fused.sharded_round.launches
                 == rounds * (1 + SWEEP_REPS),
                 f"halo {k}: {solver_fused.sharded_round.launches} B5 "
                 f"launches")
        xs.append(cells * k)
        ts.append(ms * 1e-3 / rounds)
    a = np.stack([np.asarray(xs, np.float64), np.ones(len(xs))], axis=1)
    (slope, c), *_ = np.linalg.lstsq(a, np.asarray(ts), rcond=None)
    fit = a @ np.array([slope, c])
    resid = float(np.max(np.abs(fit - ts) / ts))
    rate = 1.0 / slope
    torch.cuda.empty_cache()
    print(f"phase 23 halo sweep (B5, 1x1 mesh, {q.nx}x{q.ny}x"
          f"{q.response_length}, CUDA-event medians of {SWEEP_REPS}): "
          + ", ".join(f"k {k} {t * 1e6:.3f} us a round" for k, t in
                      zip(SWEEP_HALOS, ts))
          + f"; fit t_round = cells*k/rate + C: rate {rate:.6e} cells/s, "
          f"C {c * 1e6:.4f} us, max residual {resid:.4f} of the round; the "
          f"committed ROUND_RATE_CUPS {scaling.ROUND_RATE_CUPS:.6e}, "
          f"ROUND_OVERHEAD_S {scaling.ROUND_OVERHEAD_S * 1e6:.4f} us "
          f"({label})", flush=True)
    return rate, c, resid


def _context_phase(pv, card, label, root):
    """Phase 23: a Context on a mesh of two gloo processes on the card,
    held bit for bit to one process and to the single-device Context;
    the agreement's refusal and the agreed stop; the projection model's
    halo sweep and fit, and ``scale --project`` as a subprocess; the dry
    run's source-split render at 256 sources."""
    import numpy as np
    import torch

    from planeverb_tpu_torch import parallel
    from planeverb_tpu_torch.config import PlaneverbDSPConfig, gaussian_pulse
    from planeverb_tpu_torch.dsp import (SourceParams, init_state, lowpass,
                                        render_block)
    from planeverb_tpu_torch.entry import (DSP_SPLIT_REL_TOL, _bus_rel,
                                           _render_by_rows)
    from planeverb_tpu_torch.ops import fdtd_fused, voxelize
    from planeverb_tpu_torch.sandbox.cli import PROJECT_COUNTS

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)

    # -- two gloo processes, two positions of the card each
    t0 = time.perf_counter()
    results = _run_workers(root, lambda port, rank: [
        str(port), str(rank), "2", "gloo", "context"], 2, WORKER_TIMEOUT_S)
    workers_s = time.perf_counter() - t0
    one_card = ["cuda:0"] * 4
    refs = {"one process": _context_cases(pv, "gloo", {
        "2x2": parallel.grid_mesh(one_card, (2, 2)),
        "4x1": parallel.grid_mesh(one_card, (4, 1))}),
        "one device": _context_cases(pv, "gloo", {"2x2": dev, "4x1": dev})}
    _hold_cases(results, refs, "gloo", label, "phase 23")
    r0, r1 = results
    _require(r0["refused"] is not None and r0["refused"] == r1["refused"]
             and "'listeners'" in r0["refused"]
             and r0["refused_iteration"] == r1["refused_iteration"] == 0,
             f"the refusal: {r0['refused']!r} / {r1['refused']!r}")
    _require(r0["after"] == r1["after"]
             == refs["one process"]["grids"]["digest"],
             "the step after the refusal differs")
    _require(r0["loop_reached"] and r1["loop_ended_alone"]
             and r0["stopped_at"] == r1["stopped_at"] > LOOP_STEPS
             and r0["loop_error"] == r1["loop_error"] == "None",
             f"the agreed stop: {r0} / {r1}")
    print(f"phase 23 agree: a listener only rank 1 moved refused on both "
          f"ranks with {r0['refused']!r}, the next agreed step bit-equal; "
          f"stop() on rank 0 alone ended both loops after "
          f"{r0['stopped_at']} steps; the two workers took {workers_s:.1f} "
          f"s", flush=True)

    # -- the projection model: the halo sweep's fit and scale --project
    hl = _large_inputs(pv, voxelize, gaussian_pulse, HEADLINE["size"], dev)
    rate, c_round, _ = _halo_sweep(hl, label)
    proc = subprocess.run(
        [sys.executable, "-m", "planeverb_tpu_torch", "scale",
         HEADLINE["scene"], "--grid-size", f"{HEADLINE['size']:g}",
         "--resolution", str(HEADLINE["resolution"]), "--project"],
        cwd=root, capture_output=True, text=True, timeout=WORKER_TIMEOUT_S)
    _require(proc.returncode == 0, f"scale --project exited "
                                   f"{proc.returncode}: {proc.stderr[-2000:]}")
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    _require([r["devices"] for r in rows] == list(PROJECT_COUNTS)
             and rows[0]["efficiency"] == 1.0, proc.stdout)
    print("phase 23 python -m planeverb_tpu_torch scale HugeRoom --project "
          "(the committed constants), 1, 2 and 4 cards: "
          + "; ".join(json.dumps(r) for r in rows if r["devices"] <= 4)
          + f"; with this run's fit (rate {rate:.4e}, C "
          f"{c_round * 1e6:.3f} us): " + "; ".join(
              json.dumps(r) for r in parallel.scaling.projected_efficiency(
                  hl[0].nx, hl[0].ny, [1, 2, 4], rate, round_overhead_s=c_round))
          + " (measure_scaling over distinct cards: chip_smoke.py --cards)",
          flush=True)

    # -- the dry run's render, its sources split over a 4x1 mesh's rows
    rng = np.random.default_rng(23)
    s = SPLIT_SOURCES
    dirs = rng.standard_normal((s, 2)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    fields = dict(occlusion=rng.uniform(0.1, 1.0, s),
                  wet_gain=rng.uniform(0.1, 1.0, s),
                  rt60=rng.uniform(0.2, 3.5, s),
                  lowpass=np.geomspace(20.0, 20000.0, s), direction=dirs,
                  position=rng.uniform(0, HEADLINE["size"], (s, 2)),
                  forward=rng.standard_normal((s, 2)),
                  directivity=dirs[::-1].copy(), pattern=np.arange(s) % 2)
    target = SourceParams(**{
        k: torch.as_tensor(np.asarray(v), dtype=torch.int32
                           if k == "pattern" else torch.float32).to(dev)
        for k, v in fields.items()})
    audio = torch.from_numpy((rng.standard_normal((s, AUDIO_FRAMES, 2))
                              * 0.3).astype(np.float32)).to(dev)
    dcfg = PlaneverbDSPConfig(max_callback_length=AUDIO_FRAMES)
    state = init_state(s, device=dev)
    listener = ((12.5, 0.0, 12.5), (1.0, 0.0, 0.0))
    mesh41 = parallel.grid_mesh(one_card, (4, 1))
    one, _ = render_block(dcfg, audio, target, state, *listener)
    fdtd_fused.reset_launch_counts()
    split = _render_by_rows(dcfg, audio, target, state, *listener, mesh41)
    torch.cuda.synchronize()
    d1 = lowpass.process_scan.launches
    rel = _bus_rel(split, one)
    _require(d1 == 4 and rel <= DSP_SPLIT_REL_TOL
             and all(torch.isfinite(b).all() for b in split),
             f"the split render: D1 launches {d1}, rel {rel}")
    print(f"phase 23 the dry run's render, {s} sources of {AUDIO_FRAMES} "
          f"frames split over a 4x1 mesh's rows: buses vs one render_block "
          f"max rel {rel:.3e} of each bus's peak (bound "
          f"{DSP_SPLIT_REL_TOL:g}); D1 launches {d1} (one a row)",
          flush=True)
    print(f"phase 23 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)


def _contexts_across_cards(pv, card, root, measured) -> None:
    """``--cards``, last: one NCCL process a card running phase 23's cards
    cases (the headline on 2x2, the 126 m world with cells publish on 2x2
    and the 4x1 banded split), bit-equal to one process on the same cards;
    then the NVLink fit and the projection model beside ``measured``
    (measure_scaling's rows over the distinct cards)."""
    import numpy as np
    import torch

    from planeverb_tpu_torch import parallel
    from planeverb_tpu_torch.parallel import scaling

    n = 4 if torch.cuda.device_count() >= 4 else 2
    label = f"{n} x {card}"
    t0 = time.perf_counter()
    results = _run_workers(root, lambda port, rank: [
        str(port), str(rank), str(n), "nccl", "context"], n,
        WORKER_TIMEOUT_S)
    workers_s = time.perf_counter() - t0
    cards = [f"cuda:{i}" for i in range(n)]
    refs = {"one process on the same cards": _context_cases(pv, "cards", {
        "2x2": _cards_mesh(parallel, n, cards, None),
        "4x1": parallel.grid_mesh(cards, (n, 1))})}
    _hold_cases(results, refs, "cards", label, "cards")
    link = results[0]["link"]
    a = np.stack([np.asarray([r["bytes"] for r in link], np.float64),
                  np.ones(len(link))], axis=1)
    ts = np.asarray([r["s"] for r in link])
    (slope, lat), *_ = np.linalg.lstsq(a, ts, rcond=None)
    resid = float(np.max(np.abs(a @ np.array([slope, lat]) - ts) / ts))
    print(f"cards NVLink fit (multihost.transfer between cuda:0 and cuda:1, "
          f"both ways at once, {LINK_REPS} back to back): "
          + ", ".join(f"{r['bytes']} B {r['s'] * 1e6:.3f} us" for r in link)
          + f"; t = bytes/rate + latency: rate {1e-9 / slope:.4f} GB/s, "
          f"latency {lat * 1e6:.4f} us, max residual {resid:.4f}; the "
          f"committed NVLINK_GBPS {scaling.NVLINK_GBPS}, NVLINK_LATENCY_S "
          f"{scaling.NVLINK_LATENCY_S * 1e6:.4f} us ({label})", flush=True)
    q = pv.compute_grid_params(pv.PlaneverbConfig(
        HEADLINE["size"], HEADLINE["size"], HEADLINE["resolution"]))
    for r in measured:
        mx, my = r["mesh"]
        k = r["halo"]
        tc, tx, _ = scaling._t_round(mx, my, k, -(-q.nx // mx),
                                     -(-q.ny // my), scaling.ROUND_RATE_CUPS,
                                     scaling.CHIPS_PER_HOST, False)
        model_ms = -(-q.response_length // k) * (tc + tx) * 1e3
        print(f"cards projection model at measure_scaling's {mx}x{my} mesh "
              f"and halo {k}: {model_ms:.3f} ms a pass (t_comp "
              f"{tc * 1e6:.2f} us + t_comm {tx * 1e6:.2f} us a round) vs "
              f"measured {r['wall_s'] * 1e3:.3f} ms ({label})", flush=True)
    proj = scaling.projected_efficiency(q.nx, q.ny, [1, 2, 4])
    print("cards projected_efficiency (the committed constants), 1, 2 and 4 "
          "cards: " + "; ".join(json.dumps(r) for r in proj)
          + "; measure_scaling efficiency_vs_1 " + ", ".join(
              f"{r['devices']}: {r['efficiency_vs_1']}" for r in measured)
          + f" ({label})", flush=True)
    print(f"cards Context processes: the {n} workers took {workers_s:.1f} s",
          flush=True)


def _same(a, b) -> bool:
    """Bit-equal where both are numbers, NaN where both are NaN."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)
                and torch.equal(torch.where(na, 0.0, a),
                                torch.where(nb, 0.0, b)))


def _max_abs(pairs):
    """The largest |a - b| over finite entries of (a, b) pairs."""
    import torch

    err = 0.0
    for a, b in pairs:
        fin = torch.isfinite(a) & torch.isfinite(b)
        if fin.any():
            err = max(err, (a[fin] - b[fin]).abs().max().item())
    return err


def _sm_clock_hz():
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def _mid_word(t):
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte
    boundary (the kernels' word-copy paths)."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    v = buf[1:].view(t.shape)
    v.copy_(t)
    return v


def _chain_probe(kernels, kind, blocks, coeffs):
    """A DSP chain probe (csrc/dsp_scan.cu pv_dsp_chain_probe): the
    recurrence's loop-carried ops alone, on blocks x 32 lanes. Returns
    (ns a step from the device times of a long probe less an empty one,
    device ms of a probe of AUDIO_FRAMES steps, clock64 cycles a step of
    that probe)."""
    import torch

    vals = torch.empty(blocks * 32, device="cuda")
    cycles = torch.zeros(blocks, dtype=torch.int64, device="cuda")
    lib = kernels.library()

    def probe(n):
        err = lib.pv_dsp_chain_probe(
            kind, blocks, n, *coeffs, vals.data_ptr(), cycles.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        kernels.check(err, "pv_dsp_chain_probe")

    long = AUDIO_FRAMES * CHAIN_PROBE_REPEAT
    t_long = _device_ms(lambda: probe(long), REPS_DSP)
    t_empty = _device_ms(lambda: probe(0), REPS_DSP)
    t_n = _device_ms(lambda: probe(AUDIO_FRAMES), REPS_DSP)
    torch.cuda.synchronize()
    _require(bool(torch.isfinite(vals).all()), "chain probe values")
    return ((t_long - t_empty) / long * 1e6, t_n,
            cycles.max().item() / AUDIO_FRAMES)


def _dsp_scans_phase(kernels, label):
    """Phase 18: D1 (lowpass.process_scan) and D2 (reverb.reverb_scan_many)
    held bit for bit to their plain versions on the card in every case, and
    timed, with each recurrence's chain alone (the chain probes). Returns
    the numbers of their kernel rows."""
    import numpy as np
    import torch

    from planeverb_tpu_torch.dsp import lowpass, reverb

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(18)

    def card(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

    # -- D1: cutoffs spread over 20 Hz - 20 kHz, every 8th source rejected
    # by render_block's gate (below 20 Hz, above 20 kHz, 0, negative); 1
    # and 33 sources (a lone lane, a ragged warp), and a block whose rows
    # start mid-word (the 4-byte copies with N % 4 == 0)
    d1_err, d1_cases = 0.0, []
    for s, n, mid in ([(s, n, False) for s in D1_CASE_SOURCES
                       for n in D1_BLOCKS]
                      + [(D1_SOURCES[-1], AUDIO_FRAMES, True)]):
        cut = np.geomspace(20.0, 20000.0, s).astype(np.float32)
        cut[::8] = np.resize(np.array([5.0, 30000.0, 0.0, -100.0],
                                      np.float32), cut[::8].shape)
        x = card(rng.standard_normal((s, n)).astype(np.float32))
        if mid:
            x = _mid_word(x)
        y1 = card((rng.standard_normal(s) * 0.1).astype(np.float32))
        y2 = card((rng.standard_normal(s) * 0.1).astype(np.float32))
        c = card(cut)
        k = lowpass.process_scan(x, y1, y2, c, AUDIO_RATE)
        r = lowpass.process_scan_reference(x, y1, y2, c, AUDIO_RATE)
        torch.cuda.synchronize()
        _require(all(_same(a, b) for a, b in zip(k, r)),
                 f"D1 biquad_scan S={s} N={n}{' mid-word' * mid} differs "
                 f"from its plain version")
        d1_err = max(d1_err, _max_abs(zip(k, r)))
        d1_cases.append(f"{s}x{n}{' mid-word' * mid}")
    # timed at the main path's shape: 256 sources of a 512-frame block
    s, n = D1_SOURCES[-1], AUDIO_FRAMES
    x = card(rng.standard_normal((s, n)).astype(np.float32))
    z = torch.zeros(s, device=dev)
    c = card(np.geomspace(20.0, 20000.0, s).astype(np.float32))
    d1_ms = _device_ms(lambda: lowpass.process_scan(x, z, z, c, AUDIO_RATE),
                       REPS_DSP)
    d1_call_ms = _cuda_ms(lambda: lowpass.process_scan(x, z, z, c,
                                                       AUDIO_RATE), REPS_DSP)
    d1_plain_ms = _cuda_ms(lambda: lowpass.process_scan_reference(
        x, z, z, c, AUDIO_RATE), 3)
    # bytes: x read, out written, y1/y2/cutoff read, y1/y2 written; ops: 3
    # multiplies and 2 adds a sample; the chain: each step's y[t-1] product
    # and two adds in turn, reckoned at FP32_LATENCY cycles each, and
    # measured by the chain probe on as many warps
    d1_bound = _bound(4 * (2 * s * n + 5 * s), 5 * s * n)
    clock = _sm_clock_hz()
    d1_chain_ms = n * D1_CHAIN_OPS * FP32_LATENCY / clock * 1e3
    cx, cy1, cy2 = (float(v) for v in lowpass.coefficients(
        np.float32(1000.0), np.float32(AUDIO_RATE)))
    d1_probe = _chain_probe(kernels, 0, -(-s // 32), (cx, cy1, cy2))

    # -- D2: one reverb of B = 2 rows from a filled state, several blocks
    # carried (1 sample; 4096, whose combs read samples of the same block),
    # across the counter's wrap, at 44.1 kHz, 11025 Hz (la odd: the allpass
    # rings by words; ad_1 = 18) and 1000 Hz (ad_1 = 1: one-step allpass
    # sub-chunks), and from a state whose rings start mid-word
    def filled(params, batch, pos):
        lc, la = max(params.comb_delays), max(params.allpass_delays)
        return reverb.ReverbState(
            card((rng.standard_normal((batch, 4, lc)) * 0.1)
                 .astype(np.float32)),
            card((rng.standard_normal((batch, 4)) * 0.1).astype(np.float32)),
            card((rng.standard_normal((batch, 2, la)) * 0.1)
                 .astype(np.float32)),
            torch.tensor(pos, dtype=torch.int32, device=dev))

    d2_err, d2_cases = 0.0, []
    for rate, start, blocks in D2_CASES:
        p = reverb.reverb_params(1.0, rate)
        lc, la = max(p.comb_delays), max(p.allpass_delays)
        wrap = math.lcm(lc, la)
        pos0 = wrap - 1300 if start == "before the wrap" else 0
        ks = rs = filled(p, 2, pos0)
        if start == "mid-word":
            ks = rs = reverb.ReverbState(*map(_mid_word, ks[:3]), ks.pos)
        for n in blocks:
            x = card((rng.standard_normal((2, n)) * 0.3).astype(np.float32))
            ky, ks = reverb.reverb_scan(x, ks, p)
            ry, rs = reverb.reverb_scan_reference(x, rs, p)
            torch.cuda.synchronize()
            pairs = [(ky, ry), *zip(ks[:3], rs[:3])]
            _require(_same(ky, ry) and all(_same(a, b) for a, b in pairs)
                     and int(ks.pos) == int(rs.pos),
                     f"D2 reverb_scan {rate} Hz B=2 {start} N={n} differs "
                     f"from its plain version")
            d2_err = max(d2_err, _max_abs(pairs))
        d2_cases.append(f"{rate} Hz (lc {lc}, la {la}) {start} "
                        f"{'+'.join(map(str, blocks))}")
        if start == "before the wrap":
            _require(int(ks.pos) < pos0, "the wrap was not crossed")
    # mix_output's six rows (three decays x two channels) in one launch
    # against three calls and against the plain version
    p = reverb.reverb_params(1.0, AUDIO_RATE)
    lc, la = max(p.comb_delays), max(p.allpass_delays)
    jobs = []
    for i, rt60 in enumerate((0.5, 1.0, 3.0)):
        pi = reverb.reverb_params(rt60, AUDIO_RATE)
        x = card((rng.standard_normal((2, AUDIO_FRAMES)) * 0.3)
                 .astype(np.float32))
        jobs.append((x, filled(pi, 2, 1000 * i), pi))
    before = reverb.reverb_scan_many.launches
    many = reverb.reverb_scan_many(jobs)
    _require(reverb.reverb_scan_many.launches == before + 1,
             "mix_output's six rows must take one D2 launch")
    for job, (y, st) in zip(jobs, many):
        y3, st3 = reverb.reverb_scan(*job)
        yr, sr = reverb.reverb_scan_reference(*job)
        torch.cuda.synchronize()
        for other, ost in ((y3, st3), (yr, sr)):
            _require(_same(y, other) and all(_same(a, b) for a, b in
                                             zip(st[:3], ost[:3]))
                     and int(st.pos) == int(ost.pos),
                     f"D2 six rows in one launch differ (rt60 {job[2].rt60})")
        d2_err = max(d2_err, _max_abs([(y, yr), *zip(st[:3], sr[:3])]))
    d2_cases.append("6 rows in one launch")
    d2_ms = _device_ms(lambda: reverb.reverb_scan_many(jobs), REPS_DSP)
    d2_call_ms = _cuda_ms(lambda: reverb.reverb_scan_many(jobs), REPS_DSP)
    d2_enqueue_ms = _enqueue_pair(lambda: reverb.reverb_scan_many(jobs),
                                  lambda: None, REPS_DSP)[0]
    d2_three_ms = _cuda_ms(lambda: [reverb.reverb_scan(*j) for j in jobs],
                           REPS_DSP)
    d2_plain_ms = _cuda_ms(lambda: [reverb.reverb_scan_reference(*j)
                                    for j in jobs], 2)
    # bytes: each row's rings and memories read and written, its block read
    # and written; ops: about 30 a sample a row (4 combs x 4, the sum 4,
    # the allpasses 8); the chain: the damping memory's multiply and add
    rows = 2 * len(jobs)
    ring = 4 * lc + 4 + 2 * la
    d2_bound = _bound(4 * rows * (2 * ring + 2 * AUDIO_FRAMES),
                      D2_OPS * rows * AUDIO_FRAMES)
    d2_chain_ms = AUDIO_FRAMES * D2_CHAIN_OPS * FP32_LATENCY / clock * 1e3
    d2_probe = _chain_probe(kernels, 1, rows,
                            (reverb._ONE_MINUS_DAMP, reverb._DAMP, 0.0))
    print(f"phase 18 D1 biquad_scan: bit-equal to its plain version at "
          f"{', '.join(d1_cases)} (cutoffs 20 Hz - 20 kHz, every 8th "
          f"rejected); {s}x{AUDIO_FRAMES}: {d1_ms:.4f} ms device, "
          f"{d1_call_ms:.4f} ms a call, plain {d1_plain_ms:.3f} ms; bound "
          f"{d1_bound[0] * 1e3:.3f} us ({d1_bound[1]}); chain floor "
          f"measured {d1_probe[0] * AUDIO_FRAMES / 1e3:.3f} us "
          f"({d1_probe[0]:.3f} ns a step; a {AUDIO_FRAMES}-step probe "
          f"{d1_probe[1]:.4f} ms device, {d1_probe[2]:.2f} cycles a step), "
          f"reckoned {d1_chain_ms * 1e3:.3f} us at {FP32_LATENCY} cycles "
          f"an operation, {clock / 1e6:.0f} MHz ({label})", flush=True)
    print(f"phase 18 D2 reverb_scan: bit-equal to its plain version "
          f"({'; '.join(d2_cases)}); six rows x {AUDIO_FRAMES} at "
          f"{AUDIO_RATE} Hz: {d2_ms:.4f} ms device, d2_call_ms "
          f"{d2_call_ms:.4f} (host enqueue {d2_enqueue_ms:.4f} ms; three "
          f"calls {d2_three_ms:.4f} ms), plain {d2_plain_ms:.3f} ms; bound "
          f"{d2_bound[0] * 1e3:.3f} us ({d2_bound[1]}); chain floor "
          f"measured {d2_probe[0] * AUDIO_FRAMES / 1e3:.3f} us "
          f"({d2_probe[0]:.3f} ns a step; a {AUDIO_FRAMES}-step probe "
          f"{d2_probe[1]:.4f} ms device, {d2_probe[2]:.2f} cycles a step), "
          f"reckoned {d2_chain_ms * 1e3:.3f} us ({label})", flush=True)
    print(f"phase 18 seconds: {time.perf_counter() - t_phase:.1f}")
    return {"d1": (d1_err, d1_ms, d1_plain_ms, d1_bound),
            "d2": (d2_err, d2_ms, d2_plain_ms, d2_bound)}


def _replay_on_cpu(ctx, eid, dcfg, tone, played):
    """The first AUDIO_CHECK_BLOCKS blocks of an idle engine's playout
    replayed on the CPU: the same DSPContext chain from the card's
    parameters, then mix_output's plain version; the max abs difference,
    required within AUDIO_REL_TOL of the peak."""
    import numpy as np

    from planeverb_tpu_torch.dsp import DSPContext, reverb

    dsp = DSPContext(dcfg)
    stereo = np.stack([tone, tone], -1)
    states, chunks = {}, []
    for b in range(AUDIO_CHECK_BLOCKS):
        block = stereo[b * AUDIO_FRAMES:(b + 1) * AUDIO_FRAMES]
        out, gain = ctx.sync_dsp(dsp)[eid]
        dsp.submit_source(eid, out, block * np.float32(gain))
        dry, wa, wb, wc = dsp.get_output()
        mix, states = reverb.mix_output(dry, wa, wb, wc, AUDIO_RATE, states,
                                        device="cpu")
        chunks.append(mix.numpy())
    want = np.concatenate(chunks)
    err = float(np.abs(played[:len(want)] - want).max())
    _require(err <= AUDIO_REL_TOL * np.abs(want).max(),
             f"the card's playout vs the CPU replay: {err}")
    return err


def _audio_phase(pv, kernels, card, label):
    """Phase 19: the audio path on the card at the headline, through the
    entry points a game calls: Context.sync_dsp into the streaming
    DSPContext, RealtimePlayer(native=False) (mix_output: one D2 launch a
    block) with the engine idle and stepping in the background,
    AudioSourceManager with the three emitters' clips, and render_block (one
    D1 launch a block) against the same call on the CPU. Returns the main
    path's launch counts."""
    import numpy as np
    import torch

    from planeverb_tpu_torch.dsp import (DSPContext, SourceParams,
                                         init_state, lowpass, render_block,
                                         reverb)
    from planeverb_tpu_torch.ops import fdtd_fused
    from planeverb_tpu_torch.sandbox.audio_manager import AudioSourceManager
    from planeverb_tpu_torch.sandbox.realtime import RealtimePlayer

    t_phase = time.perf_counter()
    size, res = HEADLINE["size"], HEADLINE["resolution"]
    ctx = pv.Context(pv.PlaneverbConfig(size, size, res),
                     scene=pv.demo_scene(HEADLINE["scene"]), device="cuda")
    lx, lz = HEADLINE["listener"]
    ctx.set_listener_position(lx, 0.0, lz)
    eids = [ctx.emissions.emit(x, 0.0, z) for x, z in EMITTERS]
    ctx.step()
    dcfg = pv.PlaneverbDSPConfig(max_callback_length=AUDIO_FRAMES,
                                 sampling_rate=AUDIO_RATE)
    dsp = DSPContext(dcfg)
    dsp.set_listener_transform((lx, 0.0, lz), (1.0, 0.0, 0.0))
    synced = ctx.sync_dsp(dsp)
    _require(sorted(synced) == sorted(eids)
             and all(o.valid for o, _ in synced.values()),
             f"sync_dsp: {synced}")

    t = np.arange(int(AUDIO_SECONDS * AUDIO_RATE)) / AUDIO_RATE
    tone = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    blocks = -(-len(tone) // AUDIO_FRAMES)
    # one block unmeasured first: the streaming DSP's first call imports
    # scipy's lfilter (about 2 s)
    RealtimePlayer(ctx, eids[0], tone[:AUDIO_FRAMES], AUDIO_RATE,
                   frames=AUDIO_FRAMES, native=False).run(realtime=False)
    budget = AUDIO_FRAMES / AUDIO_RATE * 1e3
    reports = {}
    # each mode unpaced (realtime=False: the blocks back to back, each
    # block's own time held to the budget) and paced (realtime=True: the
    # blocks at their deadlines, the report's underruns)
    for mode, paced in (("engine idle", False), ("engine stepping", False),
                        ("engine idle", True), ("engine stepping", True)):
        fdtd_fused.reset_launch_counts()
        kernels.device_launches(reset=True)
        it0 = ctx.iteration
        if mode == "engine stepping":
            ctx.start()
        player = RealtimePlayer(ctx, eids[0], tone, AUDIO_RATE,
                                frames=AUDIO_FRAMES, native=False,
                                reverb=True)
        block_ms = []

        def timed(block, process=player.process_block, block_ms=block_ms):
            t0 = time.perf_counter()
            out = process(block)
            block_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        player.process_block = timed
        report = player.run(realtime=paced)
        if mode == "engine stepping":
            ctx.stop()
            _require(ctx.error is None, f"background loop: {ctx.error}")
            _require(ctx.iteration > it0, "the engine did not step")
        torch.cuda.synchronize()
        dl = kernels.device_launches(reset=True)
        _require(reverb.reverb_scan_many.launches == blocks
                 and dl["reverb_scan_kernel"] == blocks,
                 f"{mode}: D2 launches {reverb.reverb_scan_many.launches} "
                 f"(device {dl['reverb_scan_kernel']}), want one a block "
                 f"({blocks})")
        out = report.output
        _require(out.shape == (len(tone), 2) and np.isfinite(out).all()
                 and np.abs(out).max() > 0, f"{mode}: output {out.shape}")
        # the block's wait on the player's stream (the download's end) next
        # to its host wall: the block of the longest wait, and the longest
        # block
        waits = player.copy_wait_ms
        _require(player.stream is not None and len(waits) == blocks,
                 f"{mode}: {len(waits)} waits on the player's stream, want "
                 f"one a block ({blocks})")
        iw = int(np.argmax(waits))
        ib = int(np.argmax(block_ms))
        split = (f"max wait on the DSP stream {waits[iw]:.3f} ms (block "
                 f"{iw}, its wall {block_ms[iw]:.3f} ms); longest block "
                 f"{block_ms[ib]:.3f} ms (block {ib}, its wait "
                 f"{waits[ib]:.3f} ms); mean wait "
                 f"{statistics.mean(waits):.3f} ms")
        reports[mode, paced] = (report, reverb.reverb_scan_many.launches,
                                ctx.iteration - it0,
                                sum(ms > budget for ms in block_ms), split)
        if (mode, paced) == ("engine idle", False):
            audio_err = _replay_on_cpu(ctx, eids[0], dcfg, tone, out)
    d2_launches = reports["engine idle", False][1]

    # AudioSourceManager: the three emitters' clips, one block a frame, with
    # no reverbs (its per-bus reverb is the native one, not ported: A13), so
    # the dry bus alone
    mgr = AudioSourceManager(ctx, DSPContext(dcfg))
    for eid, f in zip(eids, (440.0, 660.0, 220.0)):
        clip = (0.3 * np.sin(2 * np.pi * f * t)).astype(np.float32)
        mgr.play(eid, clip, loop=False)
    mgr_ms = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        m = mgr.process_block(AUDIO_FRAMES, end_finished_emissions=False)
        mgr_ms.append((time.perf_counter() - t0) * 1e3)
        _require(np.isfinite(m).all(), "manager block")
    _require(mgr.active_sources() == [], "the clips did not finish")

    # render_block at a game's voice budgets, held to the same call on the
    # CPU (rel 1e-5 of each bus's peak)
    rng = np.random.default_rng(19)
    rb = {}
    fdtd_fused.reset_launch_counts()
    kernels.device_launches(reset=True)
    rb_calls = 0
    for s in (32, 256):
        dirs = rng.standard_normal((s, 2)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        fields = dict(
            occlusion=rng.uniform(0.1, 1.0, s), wet_gain=rng.uniform(0.1, 1, s),
            rt60=rng.uniform(0.2, 3.5, s),
            lowpass=np.geomspace(20.0, 20000.0, s), direction=dirs,
            position=rng.uniform(0, size, (s, 2)),
            forward=rng.standard_normal((s, 2)),
            directivity=dirs[::-1].copy(),
            pattern=np.arange(s) % 2)
        audio = (rng.standard_normal((s, AUDIO_FRAMES, 2)) * 0.3).astype(
            np.float32)

        def on(d, f=fields, a=audio):
            tgt = SourceParams(**{
                k: torch.as_tensor(np.asarray(v), dtype=torch.int32
                                   if k == "pattern" else torch.float32)
                .to(d) for k, v in f.items()})
            st = init_state(len(a), device=d)
            return (dcfg, torch.from_numpy(a).to(d), tgt, st, (lx, 0.0, lz),
                    (1.0, 0.0, 0.0))

        args = on("cuda")
        kb, _ = render_block(*args)
        cb, _ = render_block(*on("cpu"))
        rb_calls += 1
        errs = []
        for name, k, c in zip(("dry", "A", "B", "C"), kb, cb):
            k = k.cpu()
            peak = max(c.abs().max().item(), 1e-30)
            errs.append((k - c).abs().max().item() / peak)
            _require(torch.isfinite(k).all() and errs[-1] <= 1e-5,
                     f"render_block S={s} bus {name}: rel {errs[-1]}")
        ev = _cuda_ms(lambda: render_block(*args), REPS_DSP)
        rb_calls += 1 + REPS_DSP
        rb[s] = (ev, max(errs))
    torch.cuda.synchronize()
    d1_launches = lowpass.process_scan.launches
    dl = kernels.device_launches(reset=True)
    _require(d1_launches == rb_calls and dl["biquad_scan_kernel"] == rb_calls,
             f"render_block: D1 launches {d1_launches} (device "
             f"{dl['biquad_scan_kernel']}), want one a call ({rb_calls})")
    for (mode, paced), (report, n, steps, over, split) in reports.items():
        print(f"phase 19 RealtimePlayer(native=False, reverb=True) on "
              f"Context(device='cuda') {HEADLINE['size']:g} m at "
              f"{HEADLINE['resolution']} Hz, {mode}, "
              f"{'paced' if paced else 'unpaced'} ({steps} steps "
              f"meanwhile): {json.dumps(report.summary())}; blocks over the "
              f"{budget:.2f} ms budget {over} of {report.blocks}; {split}; "
              f"D2 launches {n}", flush=True)
    print(f"phase 19 playout vs the CPU replay of its first "
          f"{AUDIO_CHECK_BLOCKS} blocks: max abs {audio_err:.3g}; "
          f"AudioSourceManager, three clips, no reverbs, {blocks} blocks: "
          f"mean {statistics.mean(mgr_ms):.3f} ms, max {max(mgr_ms):.3f} ms "
          f"a block (budget {budget:.2f} ms)", flush=True)
    print("phase 19 render_block on the card, " + "; ".join(
        f"S={s} N={AUDIO_FRAMES}: {ev:.3f} ms (CUDA events), buses vs the "
        f"CPU rel {err:.2g}" for s, (ev, err) in rb.items())
        + f"; D1 launches {d1_launches} ({label})", flush=True)
    print(f"phase 19 seconds: {time.perf_counter() - t_phase:.1f}")
    del ctx
    return {"d1_launches": d1_launches, "d2_launches": d2_launches,
            "reports": {k: (r.summary(), steps, over) for k, (
                r, _, steps, over, _) in reports.items()}}


# the printed readout of the CLI (sandbox/cli.py::_print_params): each
# field's pattern and the unit of its last printed digit
_NUM = r"([-+]?\d+(?:\.\d+)?)"
_PRINTED = {
    "occlusion": (rf"occlusion \(dry gain\):\s+{_NUM}", 1e-5),
    "wet_gain": (rf"wet gain:\s+{_NUM}", 1e-5),
    "rt60": (rf"rt60:\s+{_NUM}", 1e-5),
    "lowpass": (rf"lowpass cutoff:\s+{_NUM}", 1e-2),
    "direction": (rf"direction:\s+\({_NUM}, {_NUM}\)", 1e-4),
    "source_directivity": (rf"source directivity:\s+\({_NUM}, {_NUM}\)",
                           1e-4),
}
# the golden tolerances (rtol, atol) of tests/test_golden_scenes.py
_GOLDEN = {"occlusion": (2e-4, 1e-5), "wet_gain": (2e-4, 1e-5),
           "lowpass": (2e-4, 1e-2), "rt60": (5e-3, 0.0),
           "source_directivity": (1e-3, 1e-4), "direction": (0.0, 1e-4)}


def _printed_params(text):
    """Every readout block the CLI printed, in order: {field: values}."""
    import re

    import numpy as np

    return [{k: np.array(re.search(rx, "occlusion (dry gain)" + chunk)
                         .groups(), float) for k, (rx, _) in _PRINTED.items()}
            for chunk in text.split("occlusion (dry gain)")[1:]]


def _printed_within_golden(got, want, what) -> None:
    """Printed readouts held at the golden tolerances plus one unit of the
    last printed digit (each side rounds on its own)."""
    import numpy as np

    _require(len(got) == len(want) > 0, f"{what}: {len(got)} readouts, "
                                        f"want {len(want)}")
    for g, w in zip(got, want):
        for k, (rtol, atol) in _GOLDEN.items():
            np.testing.assert_allclose(g[k], w[k], rtol=rtol,
                                       atol=atol + _PRINTED[k][1],
                                       err_msg=f"{what}: {k}")


def _cli(argv, codes=(0,)):
    """One ``python -m planeverb_tpu_torch`` command in this process, its
    standard output captured; its exit code must be one of ``codes``."""
    import contextlib
    import io

    from planeverb_tpu_torch.sandbox.cli import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    _require(rc in codes, f"cli {argv[0]} exited {rc}")
    return out.getvalue()


def counts_of(*fns):
    """Each wrapper's launch count, by name."""
    return {f.__name__: f.launches for f in fns}


def _integration_phase(pv, kernels, card, label):
    """Phase 20: the integration front ends on the card. An EngineServer on
    the card driven over its TCP JSON protocol by the Python client and by
    the g++-built C ABI client, every answer held bit for bit to an
    in-process Context; the 60 m world, the background loop and a mesh
    beyond the card count over the wire; examples/engine_client_demo.c
    against the server; the CLI in this process (launch counts) and as
    ``python -m planeverb_tpu_torch`` subprocesses (their output equal)."""
    import os
    import re
    import shutil
    import tempfile
    import urllib.request

    import numpy as np
    import torch

    from planeverb_tpu_torch import native
    from planeverb_tpu_torch.dsp import reverb
    from planeverb_tpu_torch.ops import fdtd_fused, fdtd_tiled
    from planeverb_tpu_torch.sandbox import cli
    from planeverb_tpu_torch.sandbox.wav import read_wav, write_wav
    from planeverb_tpu_torch.server import EngineClient, EngineServer

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    gxx = {}
    for name, build in (("libpvdsp", native.build_library),
                        ("libpvengine", native.build_engine_client_library)):
        t0 = time.perf_counter()
        build(force=True)
        gxx[name] = time.perf_counter() - t0
    size, res = HEADLINE["size"], HEADLINE["resolution"]
    cfg = pv.PlaneverbConfig(size, size, res)
    scene = pv.demo_scene(HEADLINE["scene"])
    lx, lz = HEADLINE["listener"]
    out_vals = EngineServer._output_vals

    # the in-process reference: the server's defaults (cells publish)
    ref = pv.Context(cfg, scene=scene, publish="cells", device="cuda")
    ref.set_listener_position(lx, 0.0, lz)
    for x, z in WIRE_EMITTERS:
        ref.emissions.emit(x, 0.0, z)
    ref.step()
    shape = f"{ref.params.nx}x{ref.params.ny}x{ref.params.response_length}"
    want = [out_vals(ref.get_output(e)) for e in range(len(WIRE_EMITTERS))]
    want_ir = ref.get_impulse_response(*EMITTERS[0])
    # and four views of one Context (the batched B1 + B2)
    views = pv.Context(cfg, scene=scene, device="cuda")
    views.set_listener_positions([(x, 0.0, z) for x, z in VIEWS])
    for x, z in WIRE_EMITTERS:
        views.emissions.emit(x, 0.0, z)
    views.step()

    fdtd_fused.reset_launch_counts()
    reverb.reverb_scan_many.launches = 0
    srv = EngineServer(port=0, device="cuda")
    srv.start_background()
    host, port = srv.address
    c = EngineClient(host, port)
    r = c.call("init", grid_size_x=size, grid_size_y=size,
               grid_resolution=res, background=False)
    _require(r["ok"] and r["grid"] == [ref.params.grid_x, ref.params.grid_y],
             f"init over the wire: {r}")
    for b in scene.boxes:
        _require(c.call("add_geometry", x=b.x, y=b.y, width=b.width,
                        height=b.height, absorption=b.absorption)["ok"],
                 "add_geometry")
    c.call("set_listener_position", x=lx, y=0.0, z=lz)
    ids = [c.call("emit", x=x, z=z)["id"] for x, z in EMITTERS]
    for _ in range(STEPS):
        _require(c.call("step")["ok"], "step over the wire")
    one = [c.call("get_output", id=i) for i in ids]
    for i, o in zip(ids, one):
        vals, valid = want[i]
        _require(o["valid"] == valid and [
            o["occlusion"], o["wet_gain"], o["rt60"], o["lowpass"],
            *o["direction"], *o["source_directivity"]] == vals,
            f"get_output {i} over the wire {o} vs in process {want[i]}")
    ids += [c.call("emit", x=x, z=z)["id"] for x, z in WIRE_EMITTERS[3:]]
    step_pass = _device_pass(kernels, lambda: c.call("step"))
    _require(step_pass == {**HEADLINE_PASS, **ANALYSIS_STEP},
             f"a step over the wire: device launches {step_pass}")
    rows = c.call("get_outputs")
    _require(rows["ids"] == ids and rows["count"] == len(WIRE_EMITTERS),
             f"get_outputs ids {rows['ids']}")
    got = np.reshape(rows["rows"], (-1, 9))
    for i, row in zip(ids, got):
        vals, valid = want[i]
        _require(list(row[:8]) == vals and row[8] == float(valid),
                 f"get_outputs row {i}: {row} vs {want[i]}")
    ir = c.call("get_impulse_response", x=EMITTERS[0][0], z=EMITTERS[0][1])
    _require(np.array_equal(np.asarray(ir["ir"], np.float32), want_ir)
             and np.abs(want_ir).max() > 0, "impulse response over the wire")
    n_valid = sum(v for _, v in want)
    # the session's steps: B3 + B4 each (the calibration is cached)
    headline_counts = counts_of(fdtd_fused.fdtd_sim,
                                fdtd_tiled.fdtd_sim_tiled,
                                fdtd_tiled.rt60_moments_tiled)
    _require(headline_counts == {"fdtd_sim": 0, "fdtd_sim_tiled": STEPS + 1,
                                 "rt60_moments_tiled": STEPS + 1},
             f"the wire session's launches {headline_counts}")
    # several listeners over the wire: one batched B1 pass and one B2
    # launch a step, each view's rows equal the four-view Context's
    r = c.call("set_listener_positions",
               positions=[[x, 0.0, z] for x, z in VIEWS])
    _require(r["ok"] and r["count"] == len(VIEWS), f"views: {r}")
    fdtd_fused.reset_launch_counts()
    multi_pass = _device_pass(kernels, lambda: c.call("step"))
    multi_counts = counts_of(fdtd_fused.fdtd_sim_batch,
                                fdtd_fused.rt60_moments_batch)
    _require(multi_pass == {"fdtd_cluster_kernel": 1,
                            "rt60_moments_kernel": 1, **ANALYSIS_STEP}
             and multi_counts == {"fdtd_sim_batch": 1,
                                  "rt60_moments_batch": 1},
             f"a four-view step over the wire: device launches "
             f"{multi_pass}, wrappers {multi_counts}")
    for b in range(len(VIEWS)):
        vrows = np.reshape(c.call("get_outputs", listener=b)["rows"],
                           (-1, 9))
        for i, row in zip(ids, vrows):
            vals, valid = out_vals(views.get_output(i, listener=b))
            _require(list(row[:8]) == vals and row[8] == float(valid),
                     f"view {b} row {i}: {row} vs {vals}")
    c.call("set_listener_position", x=lx, y=0.0, z=lz)

    # host walls: a step over the wire against Context.step() in this
    # process (in turns), and a 50-emitter get_outputs through each client
    wire_ms, local_ms, py_poll = [], [], []
    for _ in range(WIRE_REPS):
        wire_ms.append(_once(lambda: c.call("step"))[1])
        local_ms.append(_once(ref.step)[1])
    for _ in range(WIRE_REPS):
        t0 = time.perf_counter()
        c.call("get_outputs")
        py_poll.append((time.perf_counter() - t0) * 1e3)

    # the same session through the C ABI client against the same server
    nc = native.NativeEngineClient(host, port)
    _require(nc.init(size, size, resolution=res, background=False)
             == ref.params.fs, "C ABI init")
    for b in scene.boxes:
        nc.add_geometry(b.x, b.y, b.width, b.height, b.absorption)
    nc.set_listener_position(lx, 0.0, lz)
    cids = [nc.emit(x, 0.0, z) for x, z in EMITTERS]
    for _ in range(STEPS):
        _require(nc.step() > 0, "C ABI step")
    cids += [nc.emit(x, 0.0, z) for x, z in WIRE_EMITTERS[3:]]
    nc.step()

    def c_vals(o):
        return None if o is None else [
            o["occlusion"], o["wet_gain"], o["rt60"], o["lowpass"],
            *o["direction"], *o["source_directivity"]]

    c_got = [c_vals(nc.get_output(i)) for i in cids[:3]] \
        + [c_vals(o) for o in nc.get_outputs(cids)]
    c_want = [want[i] for i in cids[:3]] + [want[i] for i in cids]
    c_diff = 0.0
    for g, (vals, valid) in zip(c_got, c_want):
        _require((g is not None) == valid, f"C ABI validity {g} vs {valid}")
        if g is not None:
            # the server's repr of a float32 value, read back by strtod
            c_diff = max(c_diff, float(np.abs(
                np.subtract(g, np.float32(vals))).max()))
    if c_diff:
        print(f"phase 20 the C ABI client is NOT bit-equal to the "
              f"in-process Context: max abs {c_diff:.3g}; held at the "
              f"golden tolerances instead", flush=True)
        for g, (vals, valid) in zip(c_got, c_want):
            if g is not None:
                for k, (rtol, atol) in (("occlusion", (2e-4, 1e-5)),
                                        ("wet_gain", (2e-4, 1e-5)),
                                        ("rt60", (5e-3, 0.0)),
                                        ("lowpass", (2e-4, 1e-2))):
                    j = list(_PRINTED).index(k)
                    np.testing.assert_allclose(g[j], vals[j], rtol=rtol,
                                               atol=atol, err_msg=k)
    c_poll = []
    for _ in range(WIRE_REPS):
        t0 = time.perf_counter()
        nc.get_outputs(cids)
        c_poll.append((time.perf_counter() - t0) * 1e3)
    nc.close()

    # the 60 m world over the wire: one step of B3 + B4
    r = c.call("init", grid_size_x=LARGE, grid_size_y=LARGE,
               grid_resolution=res, background=False)
    _require(r["ok"], f"60 m init: {r}")
    for b in scene.boxes:
        c.call("add_geometry", x=b.x, y=b.y, width=b.width, height=b.height,
               absorption=b.absorption)
    c.call("set_listener_position", x=LARGE / 2, y=0.0, z=LARGE / 2)
    for x, z in LARGE_EMITTERS:
        c.call("emit", x=x, z=z)
    fdtd_fused.reset_launch_counts()
    large_pass = _device_pass(kernels, lambda: c.call("step"))
    _require(large_pass == {"fdtd_tiled_kernel": 1,
                            "rt60_moments_tiled_kernel": 1, **ANALYSIS_STEP},
             f"a 60 m step over the wire: device launches {large_pass}")
    large_counts = counts_of(fdtd_fused.fdtd_sim, fdtd_tiled.fdtd_sim_tiled,
                                fdtd_tiled.rt60_moments_tiled)
    _require(large_counts["fdtd_sim_tiled"] == 1
             and large_counts["rt60_moments_tiled"] == 1, large_counts)
    large_rows = np.reshape(c.call("get_outputs")["rows"], (-1, 9))
    _require(len(large_rows) == len(LARGE_EMITTERS)
             and (large_rows[:, 8] == 1).all()
             and np.isfinite(large_rows).all(), f"60 m rows {large_rows}")
    large_grid = r["grid"]

    # the background loop: init with background=true, then wait_iteration
    r = c.call("init", grid_size_x=size, grid_size_y=size,
               grid_resolution=res, background=True)
    _require(r["ok"], f"background init: {r}")
    _require(not c.call("step")["ok"], "a step beside the background loop")
    r = c.call("wait_iteration", n=2, timeout=60.0)
    _require(r["ok"] and r["iteration"] >= 2, f"wait_iteration: {r}")
    waited = r["iteration"]
    # a mesh beyond the card count: ok false, the connection alive
    beyond = torch.cuda.device_count() + 1
    r = c.call("init", mesh=beyond, grid_size_x=size, grid_size_y=size,
               grid_resolution=res, background=False)
    _require(not r["ok"] and "devices" in r["error"], f"mesh {beyond}: {r}")
    mesh_error = r["error"]
    _require(c.call("exit")["ok"], "the connection after a refused init")

    # examples/engine_client_demo.c, built with gcc against the port's
    # library, against the server
    tmp = tempfile.mkdtemp(prefix="pv_phase20_")
    lib = native.build_engine_client_library()
    exe = os.path.join(tmp, "pv_demo")
    t0 = time.perf_counter()
    subprocess.run(["gcc", os.path.join(root, "examples",
                                        "engine_client_demo.c"),
                    "-o", exe, lib, f"-Wl,-rpath,{os.path.dirname(lib)}"],
                   check=True, capture_output=True)
    gcc_s = time.perf_counter() - t0
    demo = subprocess.run([exe, host, str(port)], capture_output=True,
                          text=True, timeout=300)
    _require(demo.returncode == 0 and "batched poll: 50/50 emitters valid "
             "in one call" in demo.stdout, f"C demo: {demo.stdout} "
                                           f"{demo.stderr}")
    c.close()
    srv.shutdown()
    server_s = time.perf_counter() - t_phase

    # the CLI: each command in this process (its launches counted) and as
    # a subprocess (python -m planeverb_tpu_torch, its output equal)
    common = ["--grid-size", f"{size:g}", "--resolution", str(res),
              "--engine-device", "cuda"]
    sources = [a for x, z in EMITTERS for a in ("--source", f"{x:g},{z:g}")]
    t = np.arange(AUDIO_FRAMES * 8) / AUDIO_RATE
    wav = os.path.join(tmp, "in.wav")
    write_wav(wav, (0.4 * np.sin(2 * np.pi * 330.0 * t)).astype(np.float32),
              AUDIO_RATE)
    commands = {
        "analyze": ["analyze", HEADLINE["scene"], "--listener",
                    f"{lx:g},{lz:g}", *sources, *common],
        "batch": ["batch", HEADLINE["scene"], *[
            a for x, z in VIEWS for a in ("--listener", f"{x:g},{z:g}")],
            *sources, *common],
    }
    for flavor, extra in (("render --mix", []),
                          ("render --mix --native", ["--native"])):
        commands[flavor] = ["render", HEADLINE["scene"], "--listener",
                            f"{lx:g},{lz:g}", "--source",
                            f"{EMITTERS[0][0]:g},{EMITTERS[0][1]:g}", "--in",
                            wav, "--mix", *common, *extra]
    env = dict(os.environ, PYTHONPATH=root)
    procs = {}
    for name, argv in commands.items():
        if argv[0] == "render":
            argv = [*argv, "--out-dir", os.path.join(tmp, "sub " + name)]
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "planeverb_tpu_torch", *argv], cwd=root,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    # the two servers, each printing its address first
    servers = {name: subprocess.Popen(
        [sys.executable, "-m", "planeverb_tpu_torch", *argv], cwd=root,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, argv in (
            ("serve", ["serve", "--port", "0", "--engine-device", "cuda"]),
            ("view", ["view", HEADLINE["scene"], "--port", "0",
                      "--listener", f"{lx:g},{lz:g}", *common]))}
    try:
        texts, cli_counts = {}, {}
        wrappers = (fdtd_fused.fdtd_sim, fdtd_fused.rt60_moments,
                    fdtd_fused.fdtd_sim_batch, fdtd_fused.rt60_moments_batch,
                    fdtd_tiled.fdtd_sim_tiled, fdtd_tiled.rt60_moments_tiled,
                    reverb.reverb_scan_many)
        for name, argv in commands.items():
            fdtd_fused.reset_launch_counts()
            reverb.reverb_scan_many.launches = 0
            if argv[0] == "render":
                argv = [*argv, "--out-dir", os.path.join(tmp, "in " + name)]
            texts[name] = _cli(argv)
            torch.cuda.synchronize()
            cli_counts[name] = {k: v for k, v in counts_of(*wrappers).items()
                                if v}
        # the other subcommands on the card, in this process (play exits
        # 1 when a block missed its deadline)
        src = ["--source", f"{EMITTERS[0][0]:g},{EMITTERS[0][1]:g}"]
        at = [HEADLINE["scene"], "--listener", f"{lx:g},{lz:g}", *src]
        others = {
            "ir": ["ir", *at, "-o", os.path.join(tmp, "ir.csv"), "--plot"],
            "convolve": ["convolve", *at, "--in", wav, "-o",
                         os.path.join(tmp, "conv.wav")],
            "play": ["play", *at, "--in", wav, "--no-pace", "-o",
                     os.path.join(tmp, "played.wav")],
            "sweep": ["sweep", "--steps", "3", "-o",
                      os.path.join(tmp, "sweep.csv")],
            "grid": ["grid", *at],
        }
        other_s = {}
        for name, argv in others.items():
            t0 = time.perf_counter()
            _cli([*argv, *common], codes=(0, 1) if name == "play" else (0,))
            other_s[name] = time.perf_counter() - t0
        _require(len(_cli(["scenes"]).splitlines()) == 11, "scenes")
        for name, proc in servers.items():
            host_port = re.search(r"(\d+\.\d+\.\d+\.\d+):(\d+)",
                                  proc.stdout.readline())
            _require(host_port is not None, f"{name}: no address printed")
            shost, sport = host_port.group(1), int(host_port.group(2))
            if name == "serve":
                sc = EngineClient(shost, sport)
                r = sc.call("init", background=False)
                sc.close()
                _require(r["ok"], f"serve: init {r}")
            else:
                with urllib.request.urlopen(
                        f"http://{shost}:{sport}/api/state",
                        timeout=120) as resp:
                    state = json.loads(resp.read())
                _require(state["scene"] == HEADLINE["scene"]
                         and state["grid"]["nx"] == ref.params.nx,
                         f"view: state {state['grid']}")
            proc.terminate()
            proc.wait(timeout=60)
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            _require(proc.returncode == 0, f"python -m planeverb_tpu_torch "
                                           f"{name}: {err[-2000:]}")
            want = texts[name].replace(os.path.join(tmp, "in " + name),
                                       os.path.join(tmp, "sub " + name))
            _require(out == want, f"{name}: the subprocess printed\n{out}\n"
                                  f"in process\n{want}")
    finally:       # no subprocess outlives the phase, whatever failed
        for proc in (*procs.values(), *servers.values()):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    # what each command's run must have launched: B3 + B4 a step (the
    # calibration is cached), the batched B1 once for four listeners (their
    # moments come from ops/batch.py::analyze_listeners, as in the JAX CLI,
    # not from B2), D2 once for the mix without --native
    _require(cli_counts == {
        "analyze": {"fdtd_sim_tiled": 1, "rt60_moments_tiled": 1},
        "batch": {"fdtd_sim_batch": 1},
        "render --mix": {"fdtd_sim_tiled": 1, "rt60_moments_tiled": 1,
                         "reverb_scan_many": 1},
        "render --mix --native": {"fdtd_sim_tiled": 1,
                                  "rt60_moments_tiled": 1}},
        f"CLI launches {cli_counts}")
    # analyze prints the in-process Context's readouts, character for
    # character; batch is held to four views of one Context at the golden
    # tolerances
    want_text = _cli_readouts(cli, ref, EMITTERS)
    _require(texts["analyze"] == want_text,
             f"analyze printed\n{texts['analyze']}\nthe Context\n{want_text}")
    want_batch = [_readout_dict(views.result_at(x, z, listener=b))
                  for b in range(len(VIEWS)) for x, z in EMITTERS]
    _printed_within_golden(_printed_params(texts["batch"]), want_batch,
                           "batch vs the four-view Context")
    batch_equal = texts["batch"].count("occlusion") == len(want_batch) and \
        all(_readout_text(cli, views.result_at(x, z, listener=b))
            in texts["batch"] for b in range(len(VIEWS))
            for x, z in EMITTERS)
    mixes = {}
    for name in ("render --mix", "render --mix --native"):
        for where in ("in", "sub"):
            d = os.path.join(tmp, f"{where} {name}")
            with open(os.path.join(d, "mix.wav"), "rb") as f:
                mixes[where, name] = f.read()
        _require(mixes["in", name] == mixes["sub", name],
                 f"{name}: the subprocess's mix.wav differs")
    mix_py = read_wav(os.path.join(tmp, "in render --mix", "mix.wav"))[0]
    mix_nat = read_wav(os.path.join(tmp, "in render --mix --native",
                                    "mix.wav"))[0]
    mix_diff = float(np.abs(mix_py - mix_nat).max())
    _require(np.abs(mix_py).max() > 0 and mix_diff <= 5e-4,
             f"render --mix: D2 vs the C++ reverbs max abs {mix_diff}")
    cli_s = time.perf_counter() - t_phase - server_s
    shutil.rmtree(tmp)
    del ref, views
    torch.cuda.empty_cache()

    print(f"phase 20 native builds (g++ -O3 -march=native): "
          + ", ".join(f"{k} {v:.2f} s" for k, v in gxx.items())
          + f"; engine_client_demo.c gcc {gcc_s:.2f} s", flush=True)
    print(f"phase 20 EngineServer(device='cuda') {shape} "
          f"HugeRoom over TCP: init, {len(scene.boxes)} add_geometry, "
          f"{len(EMITTERS)} then {len(WIRE_EMITTERS)} emitters "
          f"({n_valid} valid), {STEPS + 1} steps: every get_output, "
          f"get_outputs row and the impulse response over the wire "
          f"(Python client) bit-equal to Context(device='cuda') in process; "
          f"C ABI client (libpvengine) bit-equal {c_diff == 0.0} (max abs "
          f"{c_diff:.3g}); launches {headline_counts} (wrappers), device "
          f"launches of a step over the wire {step_pass}; "
          f"set_listener_positions with {len(VIEWS)} views: device "
          f"launches of a step {multi_pass}, wrappers {multi_counts}, every "
          f"view's get_outputs rows bit-equal to a {len(VIEWS)}-view "
          f"Context; host wall "
          f"medians of {WIRE_REPS}: a step over the wire "
          f"{statistics.median(wire_ms):.3f} ms vs Context.step() in "
          f"process {statistics.median(local_ms):.3f} ms (in turns); "
          f"get_outputs of {len(WIRE_EMITTERS)} emitters, Python client "
          f"{statistics.median(py_poll):.3f} ms, C ABI client "
          f"{statistics.median(c_poll):.3f} ms ({card})", flush=True)
    print(f"phase 20 over the wire: {LARGE:g} m world {large_grid} "
          f"launches {large_counts}, device launches of a step "
          f"{large_pass}; background init reached iteration {waited} "
          f"through wait_iteration; init mesh={beyond} refused "
          f"({mesh_error!r}) with the connection alive; "
          f"engine_client_demo.c: {demo.stdout.strip().splitlines()[-1]}",
          flush=True)
    print(f"phase 20 CLI on the card (python -m planeverb_tpu_torch, the "
          f"subprocesses' output equal to the same commands in process): "
          f"launches {cli_counts}; analyze prints the in-process Context's "
          f"readouts exactly; batch (4 listeners) within the golden "
          f"tolerances of a four-view Context (text identical "
          f"{batch_equal}); render --mix D2 vs --native C++ reverbs max "
          f"abs {mix_diff:.3g}; on the card in process too: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in other_s.items())
          + f", scenes; python -m planeverb_tpu_torch serve (an init "
          f"answered) and view (its state served); server part "
          f"{server_s:.1f} s, CLI part {cli_s:.1f} s", flush=True)
    print(f"phase 20 seconds: {time.perf_counter() - t_phase:.1f}")
    return {"headline": headline_counts, "views": multi_counts,
            "large": large_counts, "cli": cli_counts}


def _readout_text(cli, out):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli._print_params(out)
    return buf.getvalue()


def _cli_readouts(cli, ctx, sources):
    """What ``analyze`` prints for these sources, from ctx's readouts."""
    return "".join(f"source ({x:g}, {z:g}):\n"
                   + _readout_text(cli, ctx.result_at(x, z))
                   for x, z in sources)


def _readout_dict(out):
    import numpy as np

    return {"occlusion": np.array([out.occlusion]),
            "wet_gain": np.array([out.wet_gain]),
            "rt60": np.array([out.rt60]), "lowpass": np.array([out.lowpass]),
            "direction": np.array([out.direction.x, out.direction.y]),
            "source_directivity": np.array([out.source_directivity.x,
                                            out.source_directivity.y])}


def _native_audio_phase(pv, kernels, card, label, python_dsp):
    """Phase 21: the native audio path on the card's Context: the default
    RealtimePlayer (the C++ renderer and reverbs on the host, the engine's
    step on the card) over the same 2 s as phase 19, idle and stepping,
    unpaced and paced, beside phase 19's native=False numbers; its output
    held to a CPU replay through the same library; AudioSourceManager with
    the three native reverbs."""
    import numpy as np
    import torch

    from planeverb_tpu_torch.dsp import reverb
    from planeverb_tpu_torch.dsp.gains import T_ER_1, T_ER_2, T_ER_3
    from planeverb_tpu_torch.native import NativeDSPContext, NativeReverb
    from planeverb_tpu_torch.sandbox.audio_manager import AudioSourceManager
    from planeverb_tpu_torch.sandbox.realtime import RealtimePlayer

    t_phase = time.perf_counter()
    size, res = HEADLINE["size"], HEADLINE["resolution"]
    ctx = pv.Context(pv.PlaneverbConfig(size, size, res),
                     scene=pv.demo_scene(HEADLINE["scene"]), device="cuda")
    lx, lz = HEADLINE["listener"]
    ctx.set_listener_position(lx, 0.0, lz)
    eids = [ctx.emissions.emit(x, 0.0, z) for x, z in EMITTERS]
    ctx.step()
    dcfg = pv.PlaneverbDSPConfig(max_callback_length=AUDIO_FRAMES,
                                 sampling_rate=AUDIO_RATE)
    t = np.arange(int(AUDIO_SECONDS * AUDIO_RATE)) / AUDIO_RATE
    tone = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    blocks = -(-len(tone) // AUDIO_FRAMES)
    budget = AUDIO_FRAMES / AUDIO_RATE * 1e3
    rt60s = (T_ER_1, T_ER_2, T_ER_3)
    reports = {}
    for mode, paced in (("engine idle", False), ("engine stepping", False),
                        ("engine idle", True), ("engine stepping", True)):
        reverb.reverb_scan_many.launches = 0
        it0 = ctx.iteration
        if mode == "engine stepping":
            ctx.start()
        player = RealtimePlayer(ctx, eids[0], tone, AUDIO_RATE,
                                frames=AUDIO_FRAMES)
        _require(isinstance(player.dsp, NativeDSPContext)
                 and player.stream is None, "the default player is native")
        block_ms = []

        def timed(block, process=player.process_block, block_ms=block_ms):
            t0 = time.perf_counter()
            out = process(block)
            block_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        player.process_block = timed
        report = player.run(realtime=paced)
        player.close()
        if mode == "engine stepping":
            ctx.stop()
            _require(ctx.error is None, f"background loop: {ctx.error}")
            _require(ctx.iteration > it0, "the engine did not step")
        _require(reverb.reverb_scan_many.launches == 0,
                 "the native player launched D2")
        out = report.output
        _require(out.shape == (len(tone), 2) and np.isfinite(out).all()
                 and np.abs(out).max() > 0, f"{mode}: output {out.shape}")
        reports[mode, paced] = (report.summary(), ctx.iteration - it0,
                                sum(ms > budget for ms in block_ms))
        if (mode, paced) == ("engine idle", False):
            # the CPU replay: the same native renderer and reverbs driven by
            # hand from the card's parameters
            dsp = NativeDSPContext(dcfg)
            revs = [NativeReverb(r, AUDIO_RATE) for r in rt60s]
            stereo = np.stack([tone, tone], -1)
            chunks = []
            for b in range(blocks):
                block = stereo[b * AUDIO_FRAMES:(b + 1) * AUDIO_FRAMES]
                o, gain = ctx.sync_dsp(dsp)[eids[0]]
                dsp.submit_source(eids[0], o, block * np.float32(gain))
                dry, wa, wb, wc = dsp.get_output()
                mix = dry[:len(block)].copy()
                for rev, bus in zip(revs, (wa, wb, wc)):
                    rev.process_add(np.ascontiguousarray(bus[:len(block)]),
                                    mix)
                chunks.append(mix)
            replay_err = float(np.abs(out - np.concatenate(chunks)).max())
            _require(replay_err == 0.0,
                     f"native playout vs its CPU replay: {replay_err}")

    mgr = AudioSourceManager(ctx, NativeDSPContext(dcfg),
                             reverbs=[NativeReverb(r, AUDIO_RATE)
                                      for r in rt60s])
    for eid, f in zip(eids, (440.0, 660.0, 220.0)):
        clip = (0.3 * np.sin(2 * np.pi * f * t)).astype(np.float32)
        mgr.play(eid, clip, loop=False)
    mgr_ms, tail = [], []
    for _ in range(blocks + 8):
        t0 = time.perf_counter()
        m = mgr.process_block(AUDIO_FRAMES, end_finished_emissions=False)
        mgr_ms.append((time.perf_counter() - t0) * 1e3)
        _require(np.isfinite(m).all(), "manager block")
        tail.append(float(np.abs(m).max()))
    _require(mgr.active_sources() == [] and tail[-1] > 0,
             "the clips did not finish, or the reverbs left no tail")
    torch.cuda.synchronize()
    for key, (summary, steps, over) in reports.items():
        py_summary, py_steps, py_over = python_dsp[key]
        mode, paced = key
        print(f"phase 21 RealtimePlayer(native=True) on "
              f"Context(device='cuda') {size:g} m at {res} Hz, {mode}, "
              f"{'paced' if paced else 'unpaced'} ({steps} steps "
              f"meanwhile): mean {summary['mean_process_ms']:.3f} ms, max "
              f"{summary['max_process_ms']:.3f} ms, blocks over the "
              f"{budget:.2f} ms budget {over} of {summary['blocks']}, "
              f"underruns {summary['underruns']} | native=False (phase "
              f"19): mean {py_summary['mean_process_ms']:.3f} ms, max "
              f"{py_summary['max_process_ms']:.3f} ms, over {py_over}, "
              f"underruns {py_summary['underruns']} ({py_steps} steps); "
              f"D2 launches 0", flush=True)
    print(f"phase 21 native playout vs its CPU replay (the same library, "
          f"{blocks} blocks): max abs {replay_err:.3g}; AudioSourceManager "
          f"with NativeDSPContext and the three NativeReverbs, three clips, "
          f"{len(mgr_ms)} blocks: mean {statistics.mean(mgr_ms):.3f} ms, "
          f"max {max(mgr_ms):.3f} ms a block, the reverbs' tail after the "
          f"clips {tail[-1]:.3g} ({card})", flush=True)
    print(f"phase 21 seconds: {time.perf_counter() - t_phase:.1f}")
    del ctx


def _processes_across_cards(pv, card, root) -> None:
    """``--cards``, last: one process per card over NCCL (``--pv-worker``),
    B5 at the headline and B6 at 126 m on a 2x2 mesh of four cards (n x 1
    of n), every block bit-equal to this process's single-controller run on
    ``cuda:0`` repeated; their pass times beside ``measure_scaling`` over
    the distinct cards driven by this one process."""
    import torch

    from planeverb_tpu_torch import parallel
    from planeverb_tpu_torch.config import gaussian_pulse
    from planeverb_tpu_torch.ops import voxelize
    from planeverb_tpu_torch.parallel.scaling import measure_scaling

    n = min(torch.cuda.device_count(), 4)
    n = 4 if n == 4 else 2
    label = f"{n} x {card}"
    t0 = time.perf_counter()
    results = _run_workers(root, lambda port, rank: [str(port), str(rank),
                                                     str(n), "nccl"],
                           n, WORKER_TIMEOUT_S)
    workers_s = time.perf_counter() - t0
    dev = torch.device("cuda", 0)
    mesh = _cards_mesh(parallel, n, ["cuda:0"] * n, None)
    for name, inputs, run in _card_cases(pv, dev):
        mine = _block_digests(run(mesh))
        torch.cuda.synchronize()
        for res in results:
            blocks = res["cases"][name]["blocks"]
            _require(len(blocks) == 1 and all(mine[pos] == d for pos, d
                                              in blocks.items()),
                     f"{name}: process {res['rank']}'s block differs from "
                     f"the single-controller run")
            _require(res["cases"][name]["launches"]
                     == _worker_launches(name, inputs[0]),
                     f"{name}: process {res['rank']} launches "
                     f"{res['cases'][name]['launches']}")
        torch.cuda.empty_cache()
        print(f"cards processes (nccl, one a card, {mesh.shape['x']}x"
              f"{mesh.shape['y']}) {name}: every block bit-equal to the "
              f"single-controller run; launches "
              + "; ".join(f"rank {r['rank']} {r['cases'][name]['launches']}"
                          for r in results)
              + "; pass " + ", ".join(f"{r['cases'][name]['ms']:.3f}"
                                     for r in results)
              + f" ms (host wall, median of 3; {label})", flush=True)
    hl = _large_inputs(pv, voxelize, gaussian_pulse, HEADLINE["size"], dev)
    rows = measure_scaling(*hl, device_counts=[c for c in SCALING_COUNTS
                                               if c <= n],
                           halo=SHARD_HALO, solver="fused",
                           devices=[f"cuda:{i}" for i in range(n)])
    for r in rows:
        print(f"cards measure_scaling (one process, distinct cards): "
              f"{json.dumps(r)} ({label})", flush=True)
    print(f"cards processes: the {n} workers took {workers_s:.1f} s",
          flush=True)
    return rows


def _server_across_cards(pv, card) -> None:
    """``--cards``: one server init with a mesh of every card at the
    headline (B5 behind the wire), its outputs bit-equal to one card's."""
    import numpy as np
    import torch

    from planeverb_tpu_torch.parallel import solver_fused
    from planeverb_tpu_torch.server import EngineClient, EngineServer

    n = torch.cuda.device_count()
    size, res = HEADLINE["size"], HEADLINE["resolution"]
    srv = EngineServer(port=0, device="cuda")
    srv.start_background()
    c = EngineClient(*srv.address)
    rows = {}
    try:
        for mesh in (n, 0):
            solver_fused.sharded_round.launches = 0
            r = c.call("init", grid_size_x=size, grid_size_y=size,
                       grid_resolution=res, background=False, mesh=mesh)
            _require(r["ok"] and ("mesh" in r) == (mesh > 0),
                     f"init mesh={mesh}: {r}")
            for b in pv.demo_scene(HEADLINE["scene"]).boxes:
                c.call("add_geometry", x=b.x, y=b.y, width=b.width,
                       height=b.height, absorption=b.absorption)
            c.call("set_listener_position", x=HEADLINE["listener"][0],
                   z=HEADLINE["listener"][1])
            for x, z in WIRE_EMITTERS:
                c.call("emit", x=x, z=z)
            t0 = time.perf_counter()
            _require(c.call("step")["ok"], "step")
            wall = (time.perf_counter() - t0) * 1e3
            rows[mesh] = (np.reshape(c.call("get_outputs")["rows"],
                                     (-1, 9)), r.get("mesh"), wall,
                          solver_fused.sharded_round.launches)
        _require(rows[n][3] > 0, "the mesh init ran no B5 round")
        _require(np.array_equal(rows[n][0], rows[0][0]),
                 "the mesh server's rows differ from one card's")
    finally:
        c.close()
        srv.shutdown()
    print(f"cards EngineServer init mesh={n} ({rows[n][1]}) at the "
          f"headline: {len(WIRE_EMITTERS)} get_outputs rows bit-equal to "
          f"mesh=0 (one card); B5 round launches {rows[n][3]}; the first "
          f"step over the wire {rows[n][2]:.3f} ms vs {rows[0][2]:.3f} ms "
          f"(host wall, voxelize included; {n} x {card})", flush=True)



# ------------------------------------------------------------ phase 24
# the analysis's shapes: the 25 m cells' one view and four (the headline's
# listener and emitters), and the 126 m cell's one view
ANALYSIS_SHAPES = ((25.0, 1), (25.0, 4), (126.0, 1))
ANALYSIS_EFREE = 0.0288
ANALYSIS_REPS = 20


def _analysis_bound(q, views):
    """Bound of assembly + DOA: read seven float32 planes, write five
    float32 grids and two of float32 pairs (the direction and the source
    directivity), a cell of every view; no operations count against
    it."""
    return _bound(views * q.grid_x * q.grid_y * (7 * 4 + 5 * 4 + 2 * 8), 0)


def _analysis_phase(pv, kernels, label):
    """Phase 24: A1 + A2 (csrc/analysis.cu) held bit for bit to
    ``analyze_moments_reference`` on the card at the cells' shapes, and
    timed: the layer's device time with the host enqueue hidden (A1 + A2,
    and each alone), its CUDA-event time from an idle card against the
    plain version's, and the host's enqueue of ``analyze_moments`` against
    the plain version's, beside the byte bound. Returns the rows."""
    import torch

    from planeverb_tpu_torch.config import gaussian_pulse
    from planeverb_tpu_torch.ops import (analyzer, doa, fdtd_fused,
                                         fdtd_tiled, voxelize)

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rows = []
    for size, nv in ANALYSIS_SHAPES:
        q = pv.compute_grid_params(pv.PlaneverbConfig(size, size, 750))
        beta, refl = voxelize.voxelize(q, torch.from_numpy(
            voxelize.boxes_to_array(pv.demo_scene("HugeRoom").boxes)).to(dev))
        pulse = torch.from_numpy(gaussian_pulse(q)).to(dev)
        views = VIEWS[:nv]
        cells = [q.world_to_cell(x, z) for x, z in views]
        if size > HEADLINE["size"]:
            res, mom = fdtd_tiled.simulate_moments_tiled(q, beta, refl, pulse,
                                                         *cells[0])
        elif nv > 1:
            res, mom = fdtd_fused.simulate_moments_fused_batch(
                q, beta, refl, pulse, cells)
        else:
            res, mom = fdtd_fused.simulate_moments_fused(q, beta, refl,
                                                         pulse, *cells[0])
        onset, fx, fy = res.onset, res.flux_x, res.flux_y
        del res, beta, refl
        torch.cuda.empty_cache()
        xs, zs = zip(*views) if nv > 1 else views[0]
        args = (q, mom, onset, fx, fy, ANALYSIS_EFREE, xs, zs)

        def kernel():
            return analyzer.analyze_moments(*args)

        def plain():
            return analyzer.analyze_moments_reference(*args)

        analyzer.assemble_views.launches = 0
        doa.encode_directions_views.launches = 0
        kernels.device_launches(reset=True)
        got = kernel()
        torch.cuda.synchronize()
        launched = {k: v for k, v in kernels.device_launches(
            reset=True).items() if v}
        wrapped = (analyzer.assemble_views.launches
                   + doa.encode_directions_views.launches)
        _require(launched == ANALYSIS_STEP
                 and analyzer.assemble_views.launches == 1
                 and doa.encode_directions_views.launches == 1,
                 f"analysis {q.grid_x}^2 x{nv}: launches {launched}")
        want = plain()
        torch.cuda.synchronize()
        err = 0.0
        for key in want._fields:
            a, b = getattr(got, key), getattr(want, key)
            nan = torch.isnan(b)
            _require(torch.equal(torch.isnan(a), nan)
                     and torch.equal(a[~nan], b[~nan]),
                     f"analysis {q.grid_x}^2 x{nv}: {key} not bit-equal")
            same = (a == b) | nan
            if not same.all():
                err = max(err, float((a[~same].double()
                                      - b[~same].double()).abs().max()))
        lazy = analyzer.analyze_moments(*args, compute_directions=False)
        lazy_want = analyzer.analyze_moments_reference(
            *args, compute_directions=False)
        torch.cuda.synchronize()
        _require(all(torch.equal(a, b) for a, b in zip(
            (*lazy[:4], *lazy[5:]), (*lazy_want[:4], *lazy_want[5:])))
            and not lazy.direction.any(),
            f"analysis {q.grid_x}^2 x{nv}: lazy directions differ")

        # A1 and A2 alone, on outputs made once
        n = q.grid_x * q.grid_y
        lead = (nv,) if nv > 1 else ()
        planes = (mom.e_dry, mom.e_wet, mom.s0, mom.s1, onset, fx, fy)
        lws = [analyzer._listener(q, x, z) for x, z in views]
        fields = torch.empty((5, *lead, q.grid_x, q.grid_y), device=dev)
        pairs = torch.empty((2, *lead, q.grid_x, q.grid_y, 2), device=dev)
        walk = torch.empty((2, nv, n), dtype=torch.int32, device=dev)

        def a1():
            analyzer.assemble_views(q, planes, nv > 1, lws, ANALYSIS_EFREE,
                                    fields, pairs, walk)

        def a2():
            doa.encode_directions_views(q, [lw[:2] for lw in lws], walk,
                                        pairs[0])

        row = {"shape": f"{q.grid_x}x{q.grid_y}", "views": nv,
               "launches": wrapped, "max_abs_err": err,
               "bound_ms": _analysis_bound(q, nv)[0]}
        row["ms"] = _device_ms(kernel, ANALYSIS_REPS)
        row["a1_ms"] = _device_ms(a1, ANALYSIS_REPS)
        row["a2_ms"] = _device_ms(a2, ANALYSIS_REPS)
        row["event_ms"], row["plain_ms"] = _time_pair(kernel, plain, reps=7)
        row["enqueue_ms"], row["plain_enqueue_ms"] = _enqueue_pair(
            kernel, plain, reps=ANALYSIS_REPS)
        row["pct_of_bound"] = 100.0 * row["bound_ms"] / row["ms"]
        rows.append(row)
        print(f"phase 24 analysis {row['shape']} x{nv}: A1 + A2 bit-equal "
              f"to the plain version (and with lazy directions); device "
              f"{row['ms']:.4f} ms (A1 {row['a1_ms']:.4f}, A2 "
              f"{row['a2_ms']:.4f}), bound {row['bound_ms']:.5f} ms "
              f"({row['pct_of_bound']:.1f} %); from an idle card "
              f"{row['event_ms']:.4f} ms vs plain {row['plain_ms']:.4f}; "
              f"host enqueue {row['enqueue_ms']:.4f} vs plain "
              f"{row['plain_enqueue_ms']:.4f} ms ({label})", flush=True)
        del mom, onset, fx, fy, got, want, lazy, lazy_want, fields, pairs
        del walk, planes, args
        torch.cuda.empty_cache()
    print(json.dumps({"analysis": rows}))
    print(f"phase 24 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return rows


def _crossover_phase(pv, dev, label) -> None:
    """Phase 10: one float32 listener's pass on each route at each of
    :data:`CROSSOVER`'s sizes, the two bit-equal, timed in turns from an
    idle card (the host enqueue and B1's coefficient fold included), B4
    against B2 on B3's recording, and the route
    ``fdtd_fused.route_tiled`` takes there."""
    import torch

    from planeverb_tpu_torch.config import gaussian_pulse
    from planeverb_tpu_torch.ops import fdtd_fused, fdtd_tiled, voxelize

    t_phase = time.perf_counter()
    for size in CROSSOVER:
        q, qb, qr, qp, qx, qy = _large_inputs(pv, voxelize, gaussian_pulse,
                                              size, dev)
        qshape = f"{q.nx}x{q.ny}x{q.response_length}"

        def tiled():
            return fdtd_tiled.simulate_moments_tiled(q, qb, qr, qp, qx, qy)

        def fused():
            return fdtd_fused.simulate_moments_fused(q, qb, qr, qp, qx, qy)

        tres, tmom = tiled()
        fres, fmom = fused()
        torch.cuda.synchronize()
        _require(all(torch.equal(a, b) for a, b in
                     zip((*tres, *tmom), (*fres, *fmom))),
                 f"B3 + B4 and B1 + B2 differ at {qshape}")
        del fres, fmom
        tiled_ms, fused_ms = _time_pair(tiled, fused, reps=CROSSOVER_REPS)
        b4_ms, b2_ms = _time_pair(
            lambda: fdtd_tiled.rt60_moments_tiled(q, tres.pressure,
                                                  tres.onset),
            lambda: fdtd_fused.rt60_moments(q, tres.pressure, tres.onset),
            reps=CROSSOVER_REPS)
        del tres, tmom
        routed = ("B3 + B4" if fdtd_fused.route_tiled(
            q.nx * q.ny, 1, torch.float32, True) else "B1 + B2")
        plan, wr = _b3_plan(q)
        print(f"phase 10 crossover {qshape} ({q.nx * q.ny} cells, one "
              f"float32 listener routed to {routed} by route_tiled: "
              f"TILED_SINGLE_MIN_CELLS = "
              f"{fdtd_fused.TILED_SINGLE_MIN_CELLS}, TILED_MIN_CELLS = "
              f"{fdtd_fused.TILED_MIN_CELLS}): B1 + B2 "
              f"{fused_ms:.3f} ms, B3 + B4 {tiled_ms:.3f} ms (B3 plan "
              f"{plan}, {wr} window-rounds), ratio "
              f"{tiled_ms / fused_ms:.3f}, bit-equal; on B3's recording B4 "
              f"{b4_ms:.3f} ms, B2 {b2_ms:.3f} ms, ratio "
              f"{b4_ms / b2_ms:.3f} ({label}, medians of {CROSSOVER_REPS} "
              f"in turns)", flush=True)
        torch.cuda.empty_cache()
    print(f"phase 10 seconds: {time.perf_counter() - t_phase:.1f}")


def main() -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "planeverb_tpu_torch")):
        print("chip_smoke: planeverb_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if WORKER_FLAG in sys.argv[1:]:
        return _worker_main(sys.argv[sys.argv.index(WORKER_FLAG) + 1:])

    import planeverb_tpu_torch as pv
    from planeverb_tpu_torch import kernels
    from planeverb_tpu_torch.config import gaussian_pulse
    from planeverb_tpu_torch.core import free_grid
    from planeverb_tpu_torch.ops import (analyzer, fdtd_fused, fdtd_tiled,
                                         voxelize)

    # -- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    nvcc = subprocess.run([kernels.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"card: {card}")
    print(f"phase 1 device: torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {nvcc[-1]}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    if "--cards" in sys.argv[1:]:
        kernels.build(force=True)
        _across_cards(pv, kernels, torch.device("cuda", 0), card)
        _server_across_cards(pv, card)
        measured = _processes_across_cards(pv, card, root)
        _contexts_across_cards(pv, card, root, measured)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # -- 2. build
    t0 = time.perf_counter()
    lib_path, log = kernels.build(force=True)
    lib = kernels.library()
    build_s = time.perf_counter() - t0
    regs = _ptxas_summary(log)

    # -- headline inputs, made on the card
    dev = torch.device("cuda")
    size, res = HEADLINE["size"], HEADLINE["resolution"]
    cfg = pv.PlaneverbConfig(size, size, res)
    p = pv.compute_grid_params(cfg)
    scene = pv.demo_scene(HEADLINE["scene"])
    beta, refl = voxelize.voxelize(p, torch.from_numpy(
        voxelize.boxes_to_array(scene.boxes)).to(dev))
    pulse = torch.from_numpy(gaussian_pulse(p)).to(dev)
    lix, liy = p.world_to_cell(*HEADLINE["listener"])
    shape = f"{p.nx}x{p.ny}x{p.response_length}"
    label = f"CUDA-event medians on {card}"
    clusters = {k: lib.pv_fdtd_cluster_occupancy(p.nx, p.ny, int(bf16))
                for k, bf16 in (("float32", False), ("bf16", True))}
    _require(min(clusters.values()) >= 1,
             f"B1's cluster mode cannot be scheduled: {clusters}")
    print(f"phase 2 build: {build_s:.2f} s -> "
          f"{os.path.relpath(lib_path, root)}; B1 cluster mode at {p.nx}x"
          f"{p.ny}: {clusters} clusters of 16 blocks active at once "
          f"(cudaOccupancyMaxActiveClusters); ptxas: {' | '.join(regs)}")
    if "--crossover" in sys.argv[1:]:
        _crossover_phase(pv, dev, label)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # -- 3. B1 vs its plain version (one launch a pass, a cluster a
    # listener), bit-equal; then a listener on a strip seam
    _require(fdtd_fused.b1_fits(p.nx, p.ny), "B1 must hold the headline")
    kres, kacc = fdtd_fused.fdtd_sim(p, beta, refl, pulse, lix, liy)
    rres, racc = fdtd_fused.fdtd_sim_reference(p, beta, refl, pulse,
                                               lix, liy)
    torch.cuda.synchronize()
    b1, b1_bits = _compare(kres, kacc, rres, racc, "B1 vs plain")
    _require(b1_bits, "B1 not bit-equal to its plain version")
    _require(torch.isfinite(kres.pressure).all(), "B1 recording not finite")
    # a strip seam: block rank r of the cluster owns the cells from
    # r * ceil(nx * ny / 16); the listener on the first row of rank 1 and on
    # the last row of rank 0
    strip_rows = -(-p.nx * p.ny // 16) // p.ny
    seam = {}
    for cx in (strip_rows, strip_rows - 1):
        c = fdtd_fused.fdtd_sim(p, beta, refl, pulse, cx, liy)
        r_ = fdtd_fused.fdtd_sim_reference(p, beta, refl, pulse, cx, liy)
        torch.cuda.synchronize()
        _, bits_c = _compare(c[0], c[1], r_[0], r_[1],
                             f"B1, listener ({cx}, {liy})")
        _require(bits_c, f"seam listener ({cx}, {liy})")
        seam[(cx, liy)] = bits_c
        del c, r_
    # blocks whose strips start mid-row (ceil(nx * ny / 16) % ny != 0, as on
    # most room sizes): SmallRoom 10 m at 275 Hz and a thin open 60 x 6 m
    # field at 750 Hz (no walls: the pulse reaches every strip), float32 and
    # bf16, listeners at block rank 8's first cell, the cell before it and
    # the cell above it; the batched pass (a cluster a listener) and the
    # plain version bit-equal
    midrow = {}
    for mname, mcfg in (("SmallRoom", pv.PlaneverbConfig(10.0, 10.0, 275)),
                        ("open", pv.PlaneverbConfig(60.0, 6.0, 750))):
        mq = pv.compute_grid_params(mcfg)
        if mname == "open":
            mb = torch.ones((mq.nx, mq.ny), dtype=torch.float32, device=dev)
            mr = torch.zeros_like(mb)
        else:
            mb, mr = voxelize.voxelize(mq, torch.from_numpy(
                voxelize.boxes_to_array(pv.demo_scene(mname).boxes)).to(dev))
        mpulse = torch.from_numpy(gaussian_pulse(mq)).to(dev)
        mcells = _strip_start_cells(mq.nx, mq.ny, 8)
        _require(-(-mq.nx * mq.ny // 16) % mq.ny != 0
                 and mcells[1][1] != 0, f"{mname}: strips start at a row")
        for dt in (torch.float32, torch.bfloat16):
            _require(fdtd_fused.b1_fits(mq.nx, mq.ny),
                     f"B1 must hold {mname}")
            c = fdtd_fused.fdtd_sim_batch(mq, mb, mr, mpulse, mcells,
                                          state_dtype=dt)
            r_ = fdtd_fused.fdtd_sim_batch_reference(mq, mb, mr, mpulse,
                                                     mcells, state_dtype=dt)
            torch.cuda.synchronize()
            what = f"B1 {mname} {mq.nx}x{mq.ny} {dt}"
            _, bits = _compare(c[0], c[1], r_[0], r_[1], what)
            _require(bits, f"{what} listeners {mcells}: not bit-equal")
            _require(torch.isfinite(c[0].pressure.float()).all()
                     and (c[0].pressure != 0).any(dim=(1, 2, 3)).all(),
                     f"{what}: recording not finite or silent")
            midrow[f"{mname} {mq.nx}x{mq.ny} {str(dt)[6:]}"] = mcells
            del c, r_
    # one row above what a cluster holds: the card refuses it, naming the
    # tiled kernels
    over = dataclasses.replace(p, grid_x=p.nx, grid_y=p.ny - 1)
    over_field = torch.ones((over.nx, over.ny), device=dev)
    try:
        fdtd_fused.fdtd_sim(over, over_field, over_field * 0, pulse, 0, 0)
        refused = ""
    except ValueError as e:
        refused = str(e)
    _require("fdtd_sim_tiled" in refused,
             f"B1 at {over.nx}x{over.ny} not refused: {refused!r}")
    # device launches of one pass, then its time
    cluster_pass = _device_pass(kernels, lambda: fdtd_fused.fdtd_sim(
        p, beta, refl, pulse, lix, liy))
    _require(cluster_pass == {"fdtd_cluster_kernel": 1},
             f"B1 pass device launches {cluster_pass}")
    b1_ms = _cuda_ms(lambda: fdtd_fused.fdtd_sim(p, beta, refl, pulse, lix,
                                                 liy), 6)
    b1_plain_ms = _once(lambda: fdtd_fused.fdtd_sim_reference(
        p, beta, refl, pulse, lix, liy))[0]
    print(f"phase 3 B1 fdtd_sim {shape} (device launches a pass "
          f"{cluster_pass}) vs plain max rel "
          + ", ".join(f"{k} {v[0]:.3g}" for k, v in b1.items())
          + f" (bound {REL_TOL:g}); onset equal; bit-equal {b1_bits}; "
          f"listener on the strip seam (strips of {strip_rows} rows) {seam} "
          f"bit-equal; strips starting mid-row, listeners at and around "
          f"block 8's first cell, batched pass bit-equal to plain: {midrow}; "
          f"{over.nx}x{over.ny} refused ({refused}); {b1_ms:.3f} ms (median "
          f"of 6); plain {b1_plain_ms:.3f} ms ({label})", flush=True)

    # -- 4. B2 vs its plain version on the kernel's recording and the other
    # shapes the engine gives it; device times, the probe's modes, and the
    # SASS count of a logarithm
    b2r = _moments_phase(pv, kernels, lib_path, p, beta, refl, pulse, lix,
                         liy, kres, label)
    b2, b2_ms, b2_plain_ms = b2r["err"], b2r["ms"], b2r["plain_ms"]

    # -- 5. the main path: Context on the card
    fdtd_fused.reset_launch_counts()
    lx, lz = HEADLINE["listener"]
    free_grid.clear_cache()   # the calibration is counted
    # one float32 listener at the headline takes B3 + B4 on the card
    # (fdtd_fused.route_tiled), the calibration's pass too
    _require(fdtd_fused.route_tiled(p.nx * p.ny, 1, torch.float32, True),
             "the headline's one listener must take the tiled route")
    ctx = pv.Context(cfg, scene=scene, device="cuda")
    _require(fdtd_tiled.fdtd_sim_tiled.launches == 1
             and fdtd_fused.fdtd_sim.launches == 0,
             "calibration must run B3 once")
    _require(fdtd_tiled.rt60_moments_tiled.launches == 0, "B4 ran at init")
    ctx.set_listener_position(lx, 0.0, lz)
    eids = [ctx.emissions.emit(x, 0.0, z) for x, z in EMITTERS]
    ev_ms, wall_ms = zip(*(_once(ctx.step) for _ in range(STEPS)))
    launches = counts_of(fdtd_fused.fdtd_sim, fdtd_fused.rt60_moments,
                         fdtd_tiled.fdtd_sim_tiled,
                         fdtd_tiled.rt60_moments_tiled)
    _require(launches == {"fdtd_sim": 0, "rt60_moments": 0,
                          "fdtd_sim_tiled": 1 + STEPS,
                          "rt60_moments_tiled": STEPS}, launches)
    # the card's launches in one more step of the main path
    hl_step = _device_pass(kernels, ctx.step)
    _require(hl_step == {**HEADLINE_PASS, **ANALYSIS_STEP},
             f"headline step device launches {hl_step}")
    outs = [ctx.get_output(e) for e in eids]
    _require(all(o.valid for o in outs), outs)
    grids = {k: v for k, v in ctx._published.items()
             if k not in ("listener", "pressure")}
    for k, v in grids.items():
        _require(v.shape[:2] == (p.grid_x, p.grid_y), k)
        if k != "delay_samples":
            _require(np.isfinite(v).all(), k)
    found = grids["delay_samples"] < np.finfo(np.float32).max
    _require(found.sum() > 0 and (grids["rt60"][found] > 0).any(),
             "no cell found, or no RT60 > 0")
    ir = ctx.get_impulse_response(lx + 2 * p.dx, lz)
    _require(ir.shape == (p.response_length,) and np.abs(ir).max() > 0,
             "impulse response near the listener is silent")
    tput = p.nx * p.ny * p.response_length / (statistics.median(ev_ms) / 1e3)
    # the step's stages: B3 and B4 (CUDA events from an idle card, the
    # enqueue included), and the assembly + DOA on this pass's moments
    sres, smom = fdtd_tiled.simulate_moments_tiled(p, beta, refl, pulse,
                                                   lix, liy)
    hl_b3_ms = _cuda_ms(lambda: fdtd_tiled.fdtd_sim_tiled(
        p, beta, refl, pulse, lix, liy), 5)
    hl_b4_ms = _cuda_ms(lambda: fdtd_tiled.rt60_moments_tiled(
        p, sres.pressure, sres.onset), 5)
    asm_ms, asm_wall = _stages(analyzer, p, sres, smom, ctx.efree,
                               float(np.float32(lx)), float(np.float32(lz)),
                               directions=not ctx._lazy_doa)
    del sres, smom
    print(f"phase 5 step stages {shape}: B3 {hl_b3_ms:.3f} ms, B4 "
          f"{hl_b4_ms:.3f} ms, assembly + DOA {asm_ms:.3f} ms (host "
          f"{asm_wall:.3f} ms), step {statistics.median(ev_ms):.3f} ms "
          f"({label})", flush=True)
    print(f"phase 5 main path Context(device='cuda') {shape}: EFree "
          f"{ctx.efree:.6g}; launches {launches} (calibration + {STEPS} "
          f"steps); device launches of a step {hl_step}; step median "
          f"{statistics.median(ev_ms):.3f} ms "
          f"(CUDA events), {statistics.median(wall_ms):.3f} ms (wall) on "
          f"{card}; {tput / 1e9:.3f} G cell-updates/s; emitters "
          + "; ".join(f"occ {o.occlusion:.4f} rt60 {o.rt60:.3f}"
                      for o in outs))

    # -- 6. the same step on the CPU (plain versions), held to the card's
    cpu = pv.Context(cfg, scene=scene, device="cpu")
    cpu.set_listener_position(lx, 0.0, lz)
    cpu.step()
    c = cpu._published
    _require(abs(cpu.efree - ctx.efree) <= 1e-5 * abs(ctx.efree),
             f"EFree card {ctx.efree} vs CPU {cpu.efree}")
    np.testing.assert_array_equal(grids["delay_samples"], c["delay_samples"])
    for k, rtol, atol in (("occlusion", 2e-4, 1e-5), ("wet_gain", 2e-4, 1e-5),
                          ("lowpass", 2e-4, 1e-2),
                          ("source_directivity", 1e-3, 1e-4)):
        np.testing.assert_allclose(grids[k], c[k], rtol=rtol, atol=atol,
                                   err_msg=k)
    valid = (c["rt60"] > 0.01) & (c["rt60"] < 100.0)
    np.testing.assert_allclose(grids["rt60"][valid], c["rt60"][valid],
                               rtol=5e-3)
    n_dir = int((np.abs(grids["direction"] - c["direction"]).max(-1)
                 > 1e-4).sum())
    _require(n_dir == 0, n_dir)
    same = {k: bool(np.array_equal(grids[k], c[k])) for k in grids}
    print(f"phase 6 card vs CPU plain path {shape}: golden tolerances hold "
          f"({int(valid.sum())} valid RT60 cells); bit-equal per grid {same}")

    del ctx, cpu, kres, rres, kacc, racc
    torch.cuda.empty_cache()

    # -- 7. B3 at its round plan vs its plain version and B1's (459^2,
    # 964^2), timed; B3 with its accumulators forced to global memory (the
    # kernel's mode above ~1100^2) against the main path's; then rigid
    # outer walls
    t_phase = time.perf_counter()
    b3 = {}
    recs = {}
    for size in (LARGE, XL):
        q, qb, qr, qp, qx, qy = _large_inputs(pv, voxelize, gaussian_pulse,
                                              size, dev)
        qshape = f"{q.nx}x{q.ny}x{q.response_length}"
        k3res, k3acc = fdtd_tiled.fdtd_sim_tiled(q, qb, qr, qp, qx, qy)
        row = {}
        # the plain version at both sizes (the main path runs B3 at 964^2);
        # it is timed at 459^2 only
        r3res, r3acc = fdtd_tiled.fdtd_sim_tiled_reference(
            q, qb, qr, qp, qx, qy)
        torch.cuda.synchronize()
        row["vs_plain"], row["plain_bits"] = _compare(
            k3res, k3acc, r3res, r3acc, f"B3 vs plain {qshape}")
        _require(row["plain_bits"], f"B3 not bit-equal at {qshape}")
        del r3res, r3acc
        # and B1's plain version (B1's kernel holds no field this large)
        r1res, r1acc = fdtd_fused.fdtd_sim_reference(q, qb, qr, qp, qx, qy)
        torch.cuda.synchronize()
        row["b1_bits"] = all(torch.equal(a, b) for a, b in zip(
            (*k3res, *k3acc), (*r1res, *r1acc)))
        _require(row["b1_bits"], f"B3 differs from B1's plain version at "
                 f"{qshape}")
        del r1res, r1acc
        if size == LARGE:
            row["plain_ms"] = _once(
                lambda: fdtd_tiled.fdtd_sim_tiled_reference(
                    q, qb, qr, qp, qx, qy))[0]
        # the accumulators in global memory must give the same bits
        plan, row["window_rounds"] = _b3_plan(q)
        row["plan"] = plan

        def b3_global():
            return fdtd_tiled.fdtd_sim_tiled_probe(
                q, qb, qr, qp, qx, qy, plan[:2], plan[2], global_acc=True)
        gres, gacc = b3_global()
        torch.cuda.synchronize()
        _require(all(torch.equal(a, b) for a, b in zip(
            (*gres, *gacc), (*k3res, *k3acc))),
            f"B3 with global accumulators differs at {qshape}")
        del gres, gacc
        row["device_pass"] = _device_pass(
            kernels, lambda: fdtd_tiled.fdtd_sim_tiled(q, qb, qr, qp, qx, qy))
        _require(row["device_pass"] == {"fdtd_tiled_kernel": 1},
                 f"B3 pass device launches {row['device_pass']}")
        row["ms"] = _cuda_ms(
            lambda: fdtd_tiled.fdtd_sim_tiled(q, qb, qr, qp, qx, qy), 3)
        row["global_ms"] = _cuda_ms(b3_global, 3)
        torch.cuda.synchronize()
        _require(torch.isfinite(k3res.pressure).all(),
                 f"B3 recording not finite at {qshape}")
        print(f"phase 7 B3 fdtd_sim_tiled {qshape} (plan_tiled: tile "
              f"{plan[:2]}, k {plan[2]}, {row['window_rounds']} "
              f"window-rounds: the whole pass in one cooperative launch, "
              f"device launches {row['device_pass']}; with the accumulators "
              f"in global memory bit-equal, {row['global_ms']:.3f} ms): vs "
              f"plain max rel "
              + ", ".join(f"{k} {v[0]:.3g}" for k, v in row["vs_plain"].items())
              + f", bit-equal {row['plain_bits']}"
              + f" (bound {REL_TOL:g}, onset equal); bit-equal to B1's "
              f"plain version {row['b1_bits']}; B3 {row['ms']:.3f} ms "
              f"(median of 3)"
              + (f", plain {row['plain_ms']:.3f} ms" if "plain_ms" in row
                 else "")
              + f" ({label})", flush=True)
        b3[qshape] = row
        recs[qshape] = (q, k3res)
    # rigid outer walls (grid_boundary_type REFLECTING: the kernel's fold
    # without the edge ABC) on an open 60 m field, where the pulse reaches
    # the edges: B3 bit-equal to its plain version
    rq = pv.compute_grid_params(pv.PlaneverbConfig(
        LARGE, LARGE, 750, grid_boundary_type=pv.BoundaryType.REFLECTING))
    rb = torch.ones((rq.nx, rq.ny), dtype=torch.float32, device=dev)
    rr = torch.zeros_like(rb)
    rp = torch.from_numpy(gaussian_pulse(rq)).to(dev)
    rx, ry = rq.world_to_cell(LARGE / 2, LARGE / 2)
    rshape = f"{rq.nx}x{rq.ny}x{rq.response_length}"
    k3 = fdtd_tiled.fdtd_sim_tiled(rq, rb, rr, rp, rx, ry)
    _, rigid_plain = _compare(*k3, *fdtd_tiled.fdtd_sim_tiled_reference(
        rq, rb, rr, rp, rx, ry), f"B3 rigid vs plain {rshape}")
    _require(rigid_plain, "B3 rigid walls not bit-equal")
    absorbing = fdtd_tiled.fdtd_sim_tiled(
        dataclasses.replace(rq, boundary_type=pv.BoundaryType.ABSORBING),
        rb, rr, rp, rx, ry)[0]
    rigid_differs = not torch.equal(absorbing.pressure, k3[0].pressure)
    _require(rigid_differs, "rigid walls change nothing: the pulse never "
             "reached the edges")
    del k3, absorbing
    print(f"phase 7 B3 rigid outer walls, open field {rshape}: bit-equal to "
          f"its plain version {rigid_plain}"
          f"; differs from the absorbing edges {rigid_differs}", flush=True)
    print(f"phase 7 seconds: {time.perf_counter() - t_phase:.1f}")

    # -- 8. B4 vs its plain version and vs B2, on B3's recordings
    t_phase = time.perf_counter()
    b4 = {}
    for qshape, (q, k3res) in recs.items():
        rec, onset = k3res.pressure, k3res.onset
        s4 = fdtd_tiled.rt60_moments_tiled(q, rec, onset)
        r4 = fdtd_tiled.rt60_moments_tiled_reference(q, rec, onset)
        s2 = fdtd_fused.rt60_moments(q, rec, onset)
        torch.cuda.synchronize()
        row = {"vs_plain": {"s0": _rel(s4[0], r4[0]),
                            "s1": _rel(s4[1], r4[1])},
               "vs_b2": {"s0": _rel(s4[0], s2[0]), "s1": _rel(s4[1], s2[1])},
               "plain_bits": all(map(torch.equal, s4, r4)),
               "b2_bits": all(map(torch.equal, s4, s2))}
        for what in ("vs_plain", "vs_b2"):
            for name, (rel, _) in row[what].items():
                _require(rel <= MOMENTS_REL_TOL,
                         f"B4 {what} {name} {qshape}: rel {rel}")
        _require(all(torch.isfinite(x).all() for x in s4),
                 f"B4 moments not finite at {qshape}")
        row["ms"], row["plain_ms"] = _time_pair(
            lambda: fdtd_tiled.rt60_moments_tiled(q, rec, onset),
            lambda: fdtd_tiled.rt60_moments_tiled_reference(q, rec, onset),
            reps=2)
        row["b2_ms"] = _cuda_ms(lambda: fdtd_fused.rt60_moments(q, rec,
                                                                onset), 3)
        gb = rec.numel() * 4 / 1e9
        print(f"phase 8 B4 rt60_moments_tiled {qshape} (chunk "
              f"{fdtd_tiled.CHUNK}): vs plain max rel "
              + ", ".join(f"{k} {v[0]:.3g}" for k, v in row["vs_plain"].items())
              + f", bit-equal {row['plain_bits']}; vs B2 max rel "
              + ", ".join(f"{k} {v[0]:.3g}" for k, v in row["vs_b2"].items())
              + f", bit-equal {row['b2_bits']} (bound {MOMENTS_REL_TOL:g}); "
              f"B4 {row['ms']:.3f} ms ({gb / row['ms'] * 1e3:.1f} GB/s over "
              f"the {gb:.2f} GB recording), B2 {row['b2_ms']:.3f} ms "
              f"({gb / row['b2_ms'] * 1e3:.1f} GB/s), plain "
              f"{row['plain_ms']:.3f} ms ({label})", flush=True)
        b4[qshape] = row
        del s4, r4, s2
    del recs, k3res, k3acc, rec, onset
    torch.cuda.empty_cache()
    print(f"phase 8 seconds: {time.perf_counter() - t_phase:.1f}")

    # -- 9. the large world's main path: Context at 126 m, cells publish
    t_phase = time.perf_counter()
    from planeverb_tpu_torch.core.context import _pack

    torch.cuda.reset_peak_memory_stats()
    xcfg = pv.PlaneverbConfig(XL, XL, 750)
    fdtd_fused.reset_launch_counts()
    free_grid.clear_cache()   # the calibration is counted
    xctx = pv.Context(xcfg, scene=pv.demo_scene("HugeRoom"),
                      publish="cells", device="cuda")
    xl_lx = xl_lz = XL / 2
    xctx.set_listener_position(xl_lx, 0.0, xl_lz)
    xeids = [xctx.emissions.emit(x, 0.0, z) for x, z in XL_EMITTERS]
    xev, xwall = zip(*(_once(xctx.step) for _ in range(XL_STEPS)))
    xl_launches = {
        "fdtd_sim": fdtd_fused.fdtd_sim.launches,
        "rt60_moments": fdtd_fused.rt60_moments.launches,
        "fdtd_sim_tiled": fdtd_tiled.fdtd_sim_tiled.launches,
        "rt60_moments_tiled": fdtd_tiled.rt60_moments_tiled.launches}
    _require(xl_launches == {"fdtd_sim": 0, "rt60_moments": 0,
                             "fdtd_sim_tiled": 1 + XL_STEPS,
                             "rt60_moments_tiled": XL_STEPS}, xl_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    xl_step = _device_pass(kernels, xctx.step)
    _require(xl_step == {"fdtd_tiled_kernel": 1,
                         "rt60_moments_tiled_kernel": 1, **ANALYSIS_STEP},
             f"126 m step device launches {xl_step}")
    xp = xctx.params
    # the step ran B3 at the rule's plan: its window-rounds counter
    from planeverb_tpu_torch.utils import profiling

    xplan, xwr = _b3_plan(xp)
    xl_wr = profiling.steps()[-1].counters.get("solver.window_rounds")
    _require(xl_wr == xwr, f"126 m step window-rounds {xl_wr}, plan {xplan} "
             f"has {xwr}")
    xouts = [xctx.get_output(e) for e in xeids]
    _require(all(o.valid for o in xouts), xouts)
    cells = xctx._published["cells"]
    _require(len(cells) == len(XL_EMITTERS), sorted(cells))
    xl_rows = dict(cells)     # phase 13 holds the sharded engine to these
    # the same pass with the grids publish's pipeline on the same fields
    xres, xout = fdtd_fused.pipeline_auto(
        xp, xctx._beta, xctx._refl, xctx._pulse,
        *xp.world_to_cell(xl_lx, xl_lz), xctx.efree,
        float(np.float32(xl_lx)), float(np.float32(xl_lz)))
    grid_rows = _pack(xout).cpu().numpy()
    xmom = fdtd_tiled.simulate_moments_tiled(xp, xctx._beta, xctx._refl,
                                             xctx._pulse, *xp.world_to_cell(
                                                 xl_lx, xl_lz))[1]
    xasm_ms, xasm_wall = _stages(
        analyzer, xp, xres, xmom, xctx.efree, float(np.float32(xl_lx)),
        float(np.float32(xl_lz)), directions=not xctx._lazy_doa)
    del xmom
    for (cx, cy), row in cells.items():
        np.testing.assert_array_equal(row, grid_rows[cx, cy],
                                      err_msg=f"cell ({cx}, {cy})")
        _require(np.isfinite(row[:8]).all(), (cx, cy, row))
    probe = xctx.result_at(xl_lx + 10.0, xl_lz - 7.0)
    pcx, pcy = xp.world_to_cell(xl_lx + 10.0, xl_lz - 7.0)
    _require(probe.valid and probe.occlusion == float(grid_rows[pcx, pcy, 0]),
             probe)
    xir = xctx.get_impulse_response(*XL_EMITTERS[0])
    _require(xir.shape == (xp.response_length,) and np.abs(xir).max() > 0,
             "large-world impulse response is silent")
    del xres, xout
    xshape = f"{xp.nx}x{xp.ny}x{xp.response_length}"
    xtput = xp.nx * xp.ny * xp.response_length / (statistics.median(xev)
                                                   / 1e3)
    print(f"phase 9 large world Context({XL:g} m, publish='cells', "
          f"device='cuda') {xshape}: EFree {xctx.efree:.6g}; launches "
          f"{xl_launches} (calibration + {XL_STEPS} steps); device launches "
          f"of a step {xl_step}; step median "
          f"{statistics.median(xev):.3f} ms (CUDA events), "
          f"{statistics.median(xwall):.3f} ms (wall), steps "
          + ", ".join(f"{v:.3f}" for v in xev)
          + f" ms on {card}; {xtput / 1e9:.3f} G cell-updates/s; B3 plan "
          f"{xplan}, solver.window_rounds {xl_wr} a step; peak "
          f"device memory {peak_gb:.2f} GB; stages: B3 "
          f"{b3[xshape]['ms']:.3f} ms, B4 {b4[xshape]['ms']:.3f} ms, "
          f"assembly{'' if xctx._lazy_doa else ' + DOA'} {xasm_ms:.3f} ms "
          f"(host {xasm_wall:.3f} ms); emitter rows equal the grids "
          f"publish; emitters "
          + "; ".join(f"occ {o.occlusion:.4f} rt60 {o.rt60:.3f}"
                      for o in xouts), flush=True)
    del xctx
    torch.cuda.empty_cache()
    print(f"phase 9 seconds: {time.perf_counter() - t_phase:.1f}")

    # -- 10. the route's crossover: B1 + B2 against B3 + B4 by grid size
    _crossover_phase(pv, dev, label)

    from planeverb_tpu_torch import parallel
    from planeverb_tpu_torch.parallel import solver_fused

    def nine(res, mom, q):
        """The nine outputs of a sharded pass, assembled on the card and
        cropped to the field."""
        out = {k: v[..., :q.nx, :q.ny]
               for k, v in res.assemble(dev)._asdict().items()}
        out.update({k: v[:q.nx, :q.ny]
                    for k, v in mom.assemble(dev)._asdict().items()})
        return out

    def hold(got, ref, what):
        """onset equal, the sim outputs within REL_TOL and the moments
        within MOMENTS_REL_TOL of the peak; returns ({name: (rel, abs)},
        bit-equal on all nine)."""
        _require(torch.equal(got["onset"], ref["onset"]),
                 f"{what}: onset differs")
        errs = {}
        for name in got:
            if name == "onset":
                continue
            errs[name] = _rel(got[name], ref[name])
            bound = MOMENTS_REL_TOL if name in ("s0", "s1") else REL_TOL
            _require(errs[name][0] <= bound,
                     f"{what} {name}: rel {errs[name][0]} > {bound}")
        return errs, all(torch.equal(got[k], ref[k]) for k in got)

    def busy(measured):
        ms, n, wall = measured
        if ms is None:
            return (f"not measured (the profiler saw no device time; pass "
                    f"{wall:.3f} ms)")
        return (f"{ms:.3f} ms in {n} launches of a {wall:.3f} ms pass "
                f"(torch.profiler; share with no round kernel running "
                f"{1 - ms / wall:.3f})")

    def sharded_impl(margs, slabs=False, overlap=False, moments=True):
        """A sharded pass through the engine's own entry, with the private
        option that reads every neighbour through a ghost buffer."""
        return solver_fused._simulate_impl(
            *margs, SHARD_HALO, None, overlap, reference=False,
            with_moments=moments, slabs=slabs)

    def region_block(bx, by, mesh_shape, banded=False):
        """A plain round's region: the shard's extended block."""
        kx = SHARD_HALO if banded or mesh_shape[0] > 1 else 0
        ky = SHARD_HALO if banded or mesh_shape[1] > 1 else 0
        return bx + 2 * kx, by + 2 * ky

    def sharded_args(q, qb, qr, qp, mesh_shape):
        mesh = parallel.grid_mesh(["cuda:0"] * (mesh_shape[0] * mesh_shape[1]),
                                  mesh_shape)
        nx_pad, ny_pad = parallel.pad_to_mesh(q.nx, q.ny, mesh)
        pad = (0, ny_pad - q.ny, 0, nx_pad - q.nx)
        return (q, torch.nn.functional.pad(qb, pad),
                torch.nn.functional.pad(qr, pad), qp), (mesh, nx_pad, ny_pad)

    # -- 11. B5: the headline on 2x2, 4x1 and 1x1 meshes of the card
    t_phase = time.perf_counter()
    fres, fmom = fdtd_fused.simulate_moments_fused(p, beta, refl, pulse,
                                                   lix, liy)
    single = {**fres._asdict(), **fmom._asdict()}
    del fres, fmom
    b5 = {}
    for mshape in SHARDED_MESHES:
        fields, (mesh, nx_pad, ny_pad) = sharded_args(p, beta, refl, pulse,
                                                      mshape)
        margs = (*fields, lix, liy, mesh, nx_pad, ny_pad)
        fdtd_fused.reset_launch_counts()
        got = nine(*parallel.simulate_moments_sharded(
            *margs, halo=SHARD_HALO), p)
        torch.cuda.synchronize()
        counts = {"sharded_round": solver_fused.sharded_round.launches,
                  "banded_round": solver_fused.banded_round.launches,
                  "rt60_moments": fdtd_fused.rt60_moments.launches,
                  "rt60_moments_many": fdtd_fused.rt60_moments_many.launches}
        rounds = -(-p.response_length // SHARD_HALO)
        # one launch per device and round, and one B2 launch per device
        # over its shards' recordings: every shard is on cuda:0
        _require(counts == {"sharded_round": rounds, "banded_round": 0,
                            "rt60_moments": 0, "rt60_moments_many": 1},
                 f"B5 {mshape} launches {counts}")
        _require(all(torch.isfinite(v).all() for k, v in got.items()
                     if k != "onset"), f"B5 {mshape}: not finite")
        vs_b1, b1_bits5 = hold(got, single, f"B5 {mshape} vs B1 + B2")
        plain = nine(*parallel.simulate_moments_sharded_reference(
            *margs, halo=SHARD_HALO), p)
        torch.cuda.synchronize()
        vs_plain, plain_bits5 = hold(got, plain, f"B5 {mshape} vs plain")
        del got, plain
        row = {"launches": counts["sharded_round"], "vs_plain": vs_plain,
               "plain_bits": plain_bits5, "b1_bits": b1_bits5}
        row["pass_ms"], row["b1b2_ms"] = _time_pair(
            lambda: parallel.simulate_moments_sharded(*margs,
                                                      halo=SHARD_HALO),
            lambda: fdtd_fused.simulate_moments_fused(p, beta, refl, pulse,
                                                      lix, liy), reps=3)
        if mshape == SHARDED_MESHES[0]:
            row["ms"], row["plain_ms"] = _time_pair(
                lambda: parallel.simulate_sharded_fused(*margs,
                                                        halo=SHARD_HALO),
                lambda: parallel.simulate_sharded_reference(
                    *margs, halo=SHARD_HALO), reps=2)
            # the forced slab path: every neighbour read through a ghost
            # buffer refreshed after each round (the path of neighbours on
            # other cards), against the direct reads
            slabs = nine(*sharded_impl(margs, slabs=True), p)
            _, row["slab_bits"] = hold(slabs, single,
                                       f"B5 {mshape} slab path vs B1 + B2")
            _require(row["slab_bits"],
                     f"B5 {mshape}: slab path not bit-equal")
            del slabs
            row["device"] = _device_pass(
                kernels, lambda: parallel.simulate_sharded_fused(
                    *margs, halo=SHARD_HALO))
            row["device_moments"] = _device_pass(
                kernels, lambda: parallel.simulate_moments_sharded(
                    *margs, halo=SHARD_HALO))
            _require(row["device_moments"] == {"round_kernel B5": rounds,
                                               "rt60_moments_kernel": 1},
                     f"B5 {mshape} pass with moments device launches "
                     f"{row['device_moments']}")
            row["busy"] = _kernel_ms(lambda: parallel.simulate_sharded_fused(
                *margs, halo=SHARD_HALO), "round_kernel")
            _require(row["device"] == {"round_kernel B5": rounds},
                     f"B5 {mshape} device launches {row['device']}")
            row["slab_ms"], row["direct_ms"] = _time_pair(
                lambda: sharded_impl(margs, slabs=True, moments=False),
                lambda: parallel.simulate_sharded_fused(*margs,
                                                        halo=SHARD_HALO),
                reps=3)
            row["enq"], row["slab_enq"] = _enqueue_pair(
                lambda: parallel.simulate_sharded_fused(*margs,
                                                        halo=SHARD_HALO),
                lambda: sharded_impl(margs, slabs=True, moments=False),
                reps=3)
        tile = parallel.solver_fused.pick_region_tile(
            [region_block(nx_pad // mshape[0], ny_pad // mshape[1], mshape)]
            * (mshape[0] * mshape[1]),
            torch.cuda.get_device_properties(0).multi_processor_count)
        print(f"phase 11 B5 sharded_round {mshape[0]}x{mshape[1]} mesh of "
              f"cuda:0 {shape} (shards {nx_pad // mshape[0]}x"
              f"{ny_pad // mshape[1]}, halo {SHARD_HALO}, tile {tile}): "
              f"launches {counts}; vs B1 + B2 bit-equal {b1_bits5}; vs "
              f"plain max rel "
              + ", ".join(f"{k} {v[0]:.3g}" for k, v in vs_plain.items())
              + f", bit-equal {plain_bits5} (onset equal); sharded pass "
              f"(rounds + exchanges + B2) {row['pass_ms']:.3f} ms vs B1 + B2 "
              f"{row['b1b2_ms']:.3f} ms"
              + (f"; simulation {row['ms']:.3f} ms vs its plain version "
                 f"{row['plain_ms']:.3f} ms, host enqueue "
                 f"{row['enq']:.3f} ms; device launches {row['device']}, "
                 f"with the moments {row['device_moments']}; "
                 f"round kernels busy {busy(row['busy'])}; "
                 f"forced slab path bit-equal {row['slab_bits']}, "
                 f"{row['slab_ms']:.3f} ms vs direct {row['direct_ms']:.3f}"
                 f" ms, host enqueue {row['slab_enq']:.3f} ms"
                 if "ms" in row else "")
              + f" ({label})", flush=True)
        b5[mshape] = row
    torch.cuda.empty_cache()
    print(f"phase 11 seconds: {time.perf_counter() - t_phase:.1f}")

    # -- 12. B6: the 126 m world on a 2x2 mesh; B6 vs B5 at 96^2 shards
    t_phase = time.perf_counter()
    q, qb, qr, qp, qx, qy = _large_inputs(pv, voxelize, gaussian_pulse, XL,
                                          dev)
    qshape = f"{q.nx}x{q.ny}x{q.response_length}"
    fields, (mesh, nx_pad, ny_pad) = sharded_args(q, qb, qr, qp, (2, 2))
    margs = (*fields, qx, qy, mesh, nx_pad, ny_pad)
    fdtd_fused.reset_launch_counts()
    got = nine(*parallel.simulate_moments_sharded(*margs, halo=SHARD_HALO),
               q)
    torch.cuda.synchronize()
    counts = {"sharded_round": solver_fused.sharded_round.launches,
              "banded_round": solver_fused.banded_round.launches,
              "rt60_moments_tiled": fdtd_tiled.rt60_moments_tiled.launches}
    rounds = -(-q.response_length // SHARD_HALO)
    _require(counts == {"sharded_round": 0, "banded_round": rounds,
                        "rt60_moments_tiled": 4}, f"B6 launches {counts}")
    _require(all(torch.isfinite(v).all() for k, v in got.items()
                 if k != "onset"), "B6: not finite")
    tres, tmom = fdtd_tiled.simulate_moments_tiled(q, qb, qr, qp, qx, qy)
    b6_vs_b3, b6_b3_bits = hold(got, {**tres._asdict(), **tmom._asdict()},
                                "B6 vs B3 + B4")
    del tres, tmom
    torch.cuda.empty_cache()
    plain = nine(*parallel.simulate_moments_sharded_reference(
        *margs, halo=SHARD_HALO), q)
    torch.cuda.synchronize()
    b6_vs_plain, b6_plain_bits = hold(got, plain, "B6 vs plain")
    del got, plain
    torch.cuda.empty_cache()
    b6 = {"launches": counts["banded_round"]}
    b6["ms"] = _cuda_ms(lambda: parallel.simulate_sharded_fused(
        *margs, halo=SHARD_HALO), 3)
    b6["plain_ms"] = _once(lambda: parallel.simulate_sharded_reference(
        *margs, halo=SHARD_HALO))[0]
    b6["b3_ms"] = _cuda_ms(lambda: fdtd_tiled.fdtd_sim_tiled(
        q, qb, qr, qp, qx, qy), 3)
    b6["busy"] = _kernel_ms(lambda: parallel.simulate_sharded_fused(
        *margs, halo=SHARD_HALO), "round_kernel")
    b6["enq"], b6["b3_enq"] = _enqueue_pair(
        lambda: parallel.simulate_sharded_fused(*margs, halo=SHARD_HALO),
        lambda: fdtd_tiled.fdtd_sim_tiled(q, qb, qr, qp, qx, qy), reps=3)
    torch.cuda.empty_cache()
    tile = parallel.solver_fused.pick_region_tile(
        [region_block(nx_pad // 2, ny_pad // 2, (2, 2), banded=True)] * 4,
        torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"phase 12 B6 banded_round {qshape} on a 2x2 mesh of cuda:0 "
          f"(shards {nx_pad // 2}x{ny_pad // 2}, halo {SHARD_HALO}, tile "
          f"{tile}): launches {counts}; vs B3 + B4 bit-equal {b6_b3_bits}; "
          f"vs plain max rel "
          + ", ".join(f"{k} {v[0]:.3g}" for k, v in b6_vs_plain.items())
          + f", bit-equal {b6_plain_bits} (onset equal); simulation "
          f"{b6['ms']:.3f} ms vs its plain version {b6['plain_ms']:.3f} ms "
          f"(one pass) and B3 {b6['b3_ms']:.3f} ms; host enqueue "
          f"{b6['enq']:.3f} ms vs B3 {b6['b3_enq']:.3f} ms; round kernels "
          f"busy {busy(b6['busy'])} ({label})",
          flush=True)
    # B6 forced against B5 on the headline's 96^2 shards
    fields, (mesh, nx_pad, ny_pad) = sharded_args(p, beta, refl, pulse,
                                                  (2, 2))
    margs = (*fields, lix, liy, mesh, nx_pad, ny_pad)
    forced = parallel.simulate_sharded_fused(*margs, halo=SHARD_HALO,
                                             band_rows=FORCED_BAND)
    rounds5 = parallel.simulate_sharded_fused(*margs, halo=SHARD_HALO)
    same = all(torch.equal(a, b) for a, b in zip(
        forced.assemble(dev), rounds5.assemble(dev)))
    _require(same, "B6 forced differs from B5 at the headline")
    del forced, rounds5
    b6_96, b5_96 = _time_pair(
        lambda: parallel.simulate_sharded_fused(*margs, halo=SHARD_HALO,
                                                band_rows=FORCED_BAND),
        lambda: parallel.simulate_sharded_fused(*margs, halo=SHARD_HALO),
        reps=5)
    print(f"phase 12 B6 forced against B5 at the headline's {nx_pad // 2}x"
          f"{ny_pad // 2} shards (2x2, halo {SHARD_HALO}; one kernel, counted "
          f"by mode): B6 (band_rows={FORCED_BAND}) {b6_96:.3f} ms, B5 "
          f"{b5_96:.3f} ms, ratio {b6_96 / b5_96:.3f}, bit-equal {same} "
          f"({label}, medians of 5 in turns)", flush=True)
    print(f"phase 12 seconds: {time.perf_counter() - t_phase:.1f}")

    # -- 13. the sharded engine's main path: Context on a 2x2 mesh
    t_phase = time.perf_counter()
    mesh4 = parallel.grid_mesh(["cuda:0"] * 4, (2, 2))
    fdtd_fused.reset_launch_counts()
    free_grid.clear_cache()   # the calibration is counted
    mctx = pv.Context(cfg, scene=scene, mesh=mesh4)
    mctx.set_listener_position(lx, 0.0, lz)
    meids = [mctx.emissions.emit(x, 0.0, z) for x, z in EMITTERS]
    mev, mwall = zip(*(_once(mctx.step) for _ in range(STEPS)))
    m_launches = {k: f.launches for k, f in (
        ("fdtd_sim", fdtd_fused.fdtd_sim),
        ("rt60_moments", fdtd_fused.rt60_moments),
        ("rt60_moments_many", fdtd_fused.rt60_moments_many),
        ("sharded_round", solver_fused.sharded_round),
        ("banded_round", solver_fused.banded_round),
        ("fdtd_sim_tiled", fdtd_tiled.fdtd_sim_tiled),
        ("rt60_moments_tiled", fdtd_tiled.rt60_moments_tiled))}
    rounds = -(-p.response_length // mctx._halo)
    _require(m_launches == {"fdtd_sim": 0, "rt60_moments": 0,
                            "rt60_moments_many": STEPS,
                            "sharded_round": rounds * STEPS,
                            "banded_round": 0, "fdtd_sim_tiled": 1,
                            "rt60_moments_tiled": 0}, m_launches)
    m_step = _device_pass(kernels, mctx.step)
    _require(m_step == {"round_kernel B5": rounds,
                        "rt60_moments_kernel": 1, **ANALYSIS_STEP},
             f"2x2 mesh step device launches {m_step}")
    one = pv.Context(cfg, scene=scene, device="cuda")
    one.set_listener_position(lx, 0.0, lz)
    for x, z in EMITTERS:
        one.emissions.emit(x, 0.0, z)
    one_ev, _ = _once(one.step)
    mg, og = mctx._published, one._published
    for k in mg.keys() - {"listener", "pressure"}:
        np.testing.assert_array_equal(mg[k], og[k], err_msg=k)
    _require(all(mctx.get_output(e).valid for e in meids), "mesh outputs")
    mir = mctx.get_impulse_response(lx + 2 * p.dx, lz)
    np.testing.assert_array_equal(
        mir, one.get_impulse_response(lx + 2 * p.dx, lz))
    del one
    print(f"phase 13 main path Context(mesh=2x2 of cuda:0, halo "
          f"{mctx._halo}) {shape}: launches {m_launches} (calibration + "
          f"{STEPS} steps; device launches of a step {m_step}); step median "
          f"{statistics.median(mev):.3f} ms "
          f"(CUDA events), {statistics.median(mwall):.3f} ms (wall), steps "
          + ", ".join(f"{v:.3f}" for v in mev)
          + f" ms; single-device step {one_ev:.3f} ms; published grids and "
          f"impulse response equal the single-device Context's ({label})",
          flush=True)
    b5_launches = m_launches["sharded_round"]
    del mctx
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fdtd_fused.reset_launch_counts()
    free_grid.clear_cache()   # the calibration is counted
    xm = pv.Context(xcfg, scene=pv.demo_scene("HugeRoom"), publish="cells",
                    mesh=mesh4)
    xm.set_listener_position(xl_lx, 0.0, xl_lz)
    xmeids = [xm.emissions.emit(x, 0.0, z) for x, z in XL_EMITTERS]
    xmev, xmwall = zip(*(_once(xm.step) for _ in range(XL_STEPS)))
    xm_launches = {k: f.launches for k, f in (
        ("fdtd_sim", fdtd_fused.fdtd_sim),
        ("rt60_moments", fdtd_fused.rt60_moments),
        ("rt60_moments_many", fdtd_fused.rt60_moments_many),
        ("sharded_round", solver_fused.sharded_round),
        ("banded_round", solver_fused.banded_round),
        ("fdtd_sim_tiled", fdtd_tiled.fdtd_sim_tiled),
        ("rt60_moments_tiled", fdtd_tiled.rt60_moments_tiled))}
    xrounds = -(-xp.response_length // xm._halo)
    _require(xm_launches == {"fdtd_sim": 0, "rt60_moments": 0,
                             "rt60_moments_many": 0, "sharded_round": 0,
                             "banded_round": xrounds * XL_STEPS,
                             "fdtd_sim_tiled": 1,
                             "rt60_moments_tiled": 4 * XL_STEPS},
             xm_launches)
    xm_peak = torch.cuda.max_memory_allocated() / 1e9
    xm_step = _device_pass(kernels, xm.step)
    _require(xm_step == {"round_kernel B6": xrounds,
                         "rt60_moments_tiled_kernel": 4, **ANALYSIS_STEP},
             f"126 m 2x2 mesh step device launches {xm_step}")
    xm_cells = xm._published["cells"]
    _require(xm_cells.keys() == xl_rows.keys(), sorted(xm_cells))
    for cell, row in xm_cells.items():
        np.testing.assert_array_equal(row, xl_rows[cell],
                                      err_msg=f"cell {cell}")
    _require(all(xm.get_output(e).valid for e in xmeids), "126 m outputs")
    print(f"phase 13 large world Context({XL:g} m, publish='cells', mesh="
          f"2x2 of cuda:0, halo {xm._halo}) {xshape}: launches "
          f"{xm_launches} (calibration + {XL_STEPS} steps; device launches "
          f"of a step {xm_step}); step median "
          f"{statistics.median(xmev):.3f} ms (CUDA events), "
          f"{statistics.median(xmwall):.3f} ms (wall), steps "
          + ", ".join(f"{v:.3f}" for v in xmev)
          + f" ms; peak device memory {xm_peak:.2f} GB; emitter rows equal "
          f"phase 9's ({label})", flush=True)
    b6_launches = xm_launches["banded_round"]
    del xm
    torch.cuda.empty_cache()
    print(f"phase 13 seconds: {time.perf_counter() - t_phase:.1f}")

    sim_fns = (fdtd_fused.fdtd_sim, fdtd_fused.fdtd_sim_batch,
               fdtd_fused.rt60_moments, fdtd_fused.rt60_moments_batch,
               fdtd_tiled.fdtd_sim_tiled, fdtd_tiled.rt60_moments_tiled)

    # -- 14. batched B1/B2: four listeners at the headline
    t_phase = time.perf_counter()
    vcells = [p.world_to_cell(x, z) for x, z in VIEWS]
    nv = len(vcells)
    _require(fdtd_fused.b1_fits(p.nx, p.ny), "B1 must hold the headline")
    _require(vcells[0] == (lix, liy), "view 0 is the headline's listener")
    fdtd_fused.reset_launch_counts()
    kres, kacc = fdtd_fused.fdtd_sim_batch(p, beta, refl, pulse, vcells)
    ks0, ks1 = fdtd_fused.rt60_moments_batch(p, kres.pressure, kres.onset)
    torch.cuda.synchronize()
    c14 = counts_of(*sim_fns)
    _require(c14 == {"fdtd_sim": 0, "fdtd_sim_batch": 1, "rt60_moments": 0,
                     "rt60_moments_batch": 1, "fdtd_sim_tiled": 0,
                     "rt60_moments_tiled": 0}, c14)
    _require(kres.pressure.shape == (nv, p.response_length, p.nx, p.ny)
             and torch.isfinite(kres.pressure).all(),
             "batched recording shape or values")
    rres, racc = fdtd_fused.fdtd_sim_batch_reference(p, beta, refl, pulse,
                                                     vcells)
    rs0, rs1 = fdtd_fused.rt60_moments_batch_reference(p, kres.pressure,
                                                       kres.onset)
    torch.cuda.synchronize()
    b1b, b1b_bits = _compare(kres, kacc, rres, racc, "batched B1 vs plain")
    b2b = {"s0": _rel(ks0, rs0), "s1": _rel(ks1, rs1)}
    for name, (rel, _) in b2b.items():
        _require(rel <= MOMENTS_REL_TOL, f"batched B2 {name}: rel {rel}")
    b2b_bits = torch.equal(ks0, rs0) and torch.equal(ks1, rs1)
    _require(b1b_bits and b2b_bits,
             "batched B1/B2 not bit-equal to their plain versions")
    del rres, racc, rs0, rs1
    batch_pass = _device_pass(kernels, lambda: fdtd_fused.fdtd_sim_batch(
        p, beta, refl, pulse, vcells))
    _require(batch_pass == {"fdtd_cluster_kernel": 1},
             f"batched B1 pass device launches {batch_pass}")
    # against four single-listener B1 + B2 passes, kernel against kernel
    for i, (cx, cy) in enumerate(vcells):
        sres, sacc = fdtd_fused.fdtd_sim(p, beta, refl, pulse, cx, cy)
        s0, s1 = fdtd_fused.rt60_moments(p, sres.pressure, sres.onset)
        _require(all(torch.equal(a, g[i]) for a, g in zip(
            (*sres, *sacc, s0, s1), (*kres, *kacc, ks0, ks1))),
            f"batched view {i} differs from its single B1 + B2 pass")
        del sres, sacc, s0, s1
    b1b_ms, b1b_plain_ms = _time_pair(
        lambda: fdtd_fused.fdtd_sim_batch(p, beta, refl, pulse, vcells),
        lambda: fdtd_fused.fdtd_sim_batch_reference(p, beta, refl, pulse,
                                                    vcells), reps=2)
    b1b_ms2, b1_singles_ms = _time_pair(
        lambda: fdtd_fused.fdtd_sim_batch(p, beta, refl, pulse, vcells),
        lambda: [fdtd_fused.fdtd_sim(p, beta, refl, pulse, cx, cy)
                 for cx, cy in vcells], reps=4)
    b2b_ms, b2b_plain_ms = _time_pair(
        lambda: fdtd_fused.rt60_moments_batch(p, kres.pressure, kres.onset),
        lambda: fdtd_fused.rt60_moments_batch_reference(
            p, kres.pressure, kres.onset), reps=2)
    b2b_ms2, b2_singles_ms = _time_pair(
        lambda: fdtd_fused.rt60_moments_batch(p, kres.pressure, kres.onset),
        lambda: [fdtd_fused.rt60_moments(p, kres.pressure[i], kres.onset[i])
                 for i in range(nv)], reps=4)
    del kres, kacc, ks0, ks1
    torch.cuda.empty_cache()
    print(f"phase 14 batched B1 fdtd_sim_batch + B2 rt60_moments_batch, "
          f"{nv} listeners {vcells} at {shape}: one pass = 1 wrapper call, "
          f"device launches {batch_pass}, and 1 B2 launch ({c14}); vs plain "
          f"max rel "
          + ", ".join(f"{k} {v[0]:.3g}" for k, v in {**b1b, **b2b}.items())
          + f", bit-equal B1 {b1b_bits}, B2 {b2b_bits}; every view bit-equal "
          f"to its single B1 + B2 pass; B1 batch {b1b_ms:.3f} / "
          f"{b1b_ms2:.3f} ms vs {nv} single passes {b1_singles_ms:.3f} ms "
          f"vs plain {b1b_plain_ms:.3f} ms; B2 batch {b2b_ms:.3f} / "
          f"{b2b_ms2:.3f} ms vs {nv} singles {b2_singles_ms:.3f} ms vs plain "
          f"{b2b_plain_ms:.3f} ms ({label})", flush=True)
    print(f"phase 14 seconds: {time.perf_counter() - t_phase:.1f}")

    # -- 15. the multi-listener main path: Context with four views
    t_phase = time.perf_counter()
    positions = [(x, 0.0, z) for x, z in VIEWS]
    fdtd_fused.reset_launch_counts()
    free_grid.clear_cache()   # the calibration is counted
    vctx = pv.Context(cfg, scene=scene, device="cuda")
    vctx.set_listener_positions(positions)
    veids = [vctx.emissions.emit(x, 0.0, z) for x, z in EMITTERS]
    vev, vwall = zip(*(_once(vctx.step) for _ in range(STEPS)))
    v_launches = counts_of(*sim_fns)
    _require(v_launches == {"fdtd_sim": 0, "fdtd_sim_batch": STEPS,
                            "rt60_moments": 0, "rt60_moments_batch": STEPS,
                            "fdtd_sim_tiled": 1, "rt60_moments_tiled": 0},
             v_launches)
    v_step = _device_pass(kernels, vctx.step)
    _require(v_step == {"fdtd_cluster_kernel": 1, "rt60_moments_kernel": 1,
                        **ANALYSIS_STEP},
             f"four-view step device launches {v_step}")
    vg = vctx._published
    _require(vg["occlusion"].shape == (nv, p.grid_x, p.grid_y),
             "multi-listener grids shape")
    _require(all(vctx.get_output(e, listener=i).valid
                 for e in veids for i in range(nv)), "multi outputs")
    _require(not vctx.result_at(*EMITTERS[0], listener=nv).valid
             and vctx.get_impulse_response(*EMITTERS[0]).size == 0,
             "view out of range or recording kept")
    for k, v in vg.items():
        if k not in ("listener", "listeners", "delay_samples"):
            _require(np.isfinite(v).all(), k)
    # each view equals a single-listener Context at that position
    solo_ms = []
    for i, pos in enumerate(positions):
        one = pv.Context(cfg, scene=scene, device="cuda")
        one.set_listener_position(*pos)
        solo_ms.append(_once(one.step)[0])
        for k in one._published.keys() - {"listener", "pressure"}:
            np.testing.assert_array_equal(vg[k][i], one._published[k],
                                          err_msg=f"view {i} {k}")
        del one
    # cells publish: every emitter's rows equal the grids publish's
    cctx = pv.Context(cfg, scene=scene, publish="cells", device="cuda")
    cctx.set_listener_positions(positions)
    for x, z in EMITTERS:
        cctx.emissions.emit(x, 0.0, z)
    cev, _ = zip(*(_once(cctx.step) for _ in range(STEPS)))
    crows = cctx._published["cells"]
    _require(len(crows) == len(EMITTERS), sorted(crows))
    for (cx, cy), rows in crows.items():
        for i in range(nv):
            np.testing.assert_array_equal(
                rows[i], np.concatenate([np.ravel(vg[k][i, cx, cy])
                                         for k in ROW_FIELDS]),
                err_msg=f"view {i} cell ({cx}, {cy})")
    del vctx, cctx
    torch.cuda.empty_cache()
    print(f"phase 15 main path Context(device='cuda') with {nv} listeners "
          f"{shape}, grids publish: launches {v_launches} (calibration + "
          f"{STEPS} steps; device launches of a step {v_step}); step "
          f"median {statistics.median(vev):.3f} ms (CUDA "
          f"events), {statistics.median(vwall):.3f} ms (wall), steps "
          + ", ".join(f"{v:.3f}" for v in vev)
          + f" ms; single-listener steps "
          + ", ".join(f"{v:.3f}" for v in solo_ms)
          + f" ms; every view's grids equal the single-listener Context's; "
          f"cells publish rows equal, step median "
          f"{statistics.median(cev):.3f} ms ({label})", flush=True)
    # the large world, cells publish, two views: one B3 + B4 pass a view,
    # one recording at a time
    torch.cuda.reset_peak_memory_stats()
    fdtd_fused.reset_launch_counts()
    free_grid.clear_cache()   # the calibration is counted
    xv = pv.Context(xcfg, scene=pv.demo_scene("HugeRoom"), publish="cells",
                    device="cuda")
    xv.set_listener_positions([(x, 0.0, z) for x, z in XL_VIEWS])
    for x, z in XL_EMITTERS:
        xv.emissions.emit(x, 0.0, z)
    xvev, xvwall = zip(*(_once(xv.step) for _ in range(XL_MULTI_STEPS)))
    xv_launches = counts_of(*sim_fns)
    nxv = len(XL_VIEWS)
    _require(xv_launches == {
        "fdtd_sim": 0, "fdtd_sim_batch": 0, "rt60_moments": 0,
        "rt60_moments_batch": 0, "fdtd_sim_tiled": 1 + nxv * XL_MULTI_STEPS,
        "rt60_moments_tiled": nxv * XL_MULTI_STEPS}, xv_launches)
    xv_peak = torch.cuda.max_memory_allocated()
    xrec_bytes = xp.nx * xp.ny * xp.response_length * 4
    _require(xv_peak < 1.5 * xrec_bytes,
             f"peak {xv_peak / 1e9:.2f} GB: more than one "
             f"{xrec_bytes / 1e9:.2f} GB recording at a time")
    xv_cells = xv._published["cells"]
    _require(xv_cells.keys() == xl_rows.keys(), sorted(xv_cells))
    for cell, rows in xv_cells.items():   # view 0 is phase 9's listener
        np.testing.assert_array_equal(rows[0], xl_rows[cell],
                                      err_msg=f"cell {cell}")
        _require(np.isfinite(rows[1][:8]).all(), (cell, rows[1]))
    del xv
    torch.cuda.empty_cache()
    print(f"phase 15 large world Context({XL:g} m, publish='cells', "
          f"device='cuda') {xshape} with {nxv} listeners: launches "
          f"{xv_launches} (calibration + {XL_MULTI_STEPS} steps, one B3 + B4 "
          f"pass a view); steps " + ", ".join(f"{v:.3f}" for v in xvev)
          + f" ms (CUDA events), "
          + ", ".join(f"{v:.3f}" for v in xvwall)
          + f" ms (wall); peak device memory {xv_peak / 1e9:.2f} GB against "
          f"one {xrec_bytes / 1e9:.2f} GB recording; view 0's rows equal "
          f"phase 9's ({label})", flush=True)
    # the headline on the 2x2 mesh of the card, two views
    fdtd_fused.reset_launch_counts()
    free_grid.clear_cache()   # the calibration is counted
    mv = pv.Context(cfg, scene=scene, mesh=mesh4)
    mv.set_listener_positions(positions[:MESH_VIEWS])
    mvev, mvwall = zip(*(_once(mv.step) for _ in range(STEPS)))
    mv_launches = counts_of(*sim_fns, fdtd_fused.rt60_moments_many,
                            solver_fused.sharded_round,
                            solver_fused.banded_round)
    mhalo = mv._halo
    mrounds = -(-p.response_length // mhalo)
    _require(mv_launches == {
        "fdtd_sim": 0, "fdtd_sim_batch": 0, "rt60_moments": 0,
        "rt60_moments_batch": 0, "fdtd_sim_tiled": 1,
        "rt60_moments_tiled": 0, "rt60_moments_many": MESH_VIEWS * STEPS,
        "sharded_round": mrounds * MESH_VIEWS * STEPS,
        "banded_round": 0}, mv_launches)
    for k in mv._published.keys() - {"listener", "listeners"}:
        np.testing.assert_array_equal(mv._published[k], vg[k][:MESH_VIEWS],
                                      err_msg=k)
    del mv
    torch.cuda.empty_cache()
    print(f"phase 15 mesh Context(mesh=2x2 of cuda:0, halo {mhalo}) "
          f"{shape} with {MESH_VIEWS} listeners: launches {mv_launches} "
          f"(calibration + {STEPS} steps); step median "
          f"{statistics.median(mvev):.3f} ms (CUDA events), "
          f"{statistics.median(mvwall):.3f} ms (wall); grids equal the "
          f"single-device views' ({label})", flush=True)
    print(f"phase 15 seconds: {time.perf_counter() - t_phase:.1f}")

    # -- 16. bf16 wave state: B1 and B2 kernels, and the Context
    t_phase = time.perf_counter()
    bf = torch.bfloat16
    hres, hacc = fdtd_fused.fdtd_sim(p, beta, refl, pulse, lix, liy,
                                     state_dtype=bf)
    rres, racc = fdtd_fused.fdtd_sim_reference(p, beta, refl, pulse, lix,
                                               liy, state_dtype=bf)
    torch.cuda.synchronize()
    _require(hres.pressure.dtype == bf and hres.onset.dtype == torch.float32
             and torch.isfinite(hres.pressure).all(), "bf16 B1 outputs")
    b1h, b1h_bits = _compare(hres, hacc, rres, racc, "bf16 B1 vs plain")
    del rres, racc
    h0, h1 = fdtd_fused.rt60_moments(p, hres.pressure, hres.onset)
    r0, r1 = fdtd_fused.rt60_moments_reference(p, hres.pressure, hres.onset)
    torch.cuda.synchronize()
    b2h = {"s0": _rel(h0, r0), "s1": _rel(h1, r1)}
    for name, (rel, _) in b2h.items():
        _require(rel <= MOMENTS_REL_TOL, f"bf16 B2 {name}: rel {rel}")
    b2h_bits = torch.equal(h0, r0) and torch.equal(h1, r1)
    # the batched bf16 pass and its moments
    kres, kacc = fdtd_fused.fdtd_sim_batch(p, beta, refl, pulse, vcells,
                                           state_dtype=bf)
    rres, racc = fdtd_fused.fdtd_sim_batch_reference(p, beta, refl, pulse,
                                                     vcells, state_dtype=bf)
    torch.cuda.synchronize()
    b1hb, b1hb_bits = _compare(kres, kacc, rres, racc,
                               "batched bf16 B1 vs plain")
    _require(all(torch.equal(a, g[0]) for a, g in zip((*hres, *hacc),
                                                      (*kres, *kacc))),
             "batched bf16 view 0 differs from the single bf16 pass")
    del rres, racc
    k0, k1 = fdtd_fused.rt60_moments_batch(p, kres.pressure, kres.onset)
    r0, r1 = fdtd_fused.rt60_moments_batch_reference(p, kres.pressure,
                                                     kres.onset)
    torch.cuda.synchronize()
    b2hb_bits = torch.equal(k0, r0) and torch.equal(k1, r1)
    _require(b1h_bits and b2h_bits and b1hb_bits and b2hb_bits,
             "bf16 B1/B2 not bit-equal to their plain versions")
    _require(max(_rel(k0, r0)[0], _rel(k1, r1)[0]) <= MOMENTS_REL_TOL,
             "batched bf16 B2 vs plain")
    _require(torch.equal(k0[0], h0) and torch.equal(k1[0], h1),
             "batched bf16 B2 view 0 differs from the single B2")
    del kres, kacc, k0, k1, r0, r1
    torch.cuda.empty_cache()
    # times: bf16 against its plain version, then against float32 in turns
    fres, _ = fdtd_fused.fdtd_sim(p, beta, refl, pulse, lix, liy)
    b1h_ms, b1h_plain_ms = _time_pair(
        lambda: fdtd_fused.fdtd_sim(p, beta, refl, pulse, lix, liy,
                                    state_dtype=bf),
        lambda: fdtd_fused.fdtd_sim_reference(p, beta, refl, pulse, lix, liy,
                                              state_dtype=bf), reps=2)
    b1h_ms2, b1f_ms = _time_pair(
        lambda: fdtd_fused.fdtd_sim(p, beta, refl, pulse, lix, liy,
                                    state_dtype=bf),
        lambda: fdtd_fused.fdtd_sim(p, beta, refl, pulse, lix, liy), reps=4)
    b2h_ms, b2h_plain_ms = _time_pair(
        lambda: fdtd_fused.rt60_moments(p, hres.pressure, hres.onset),
        lambda: fdtd_fused.rt60_moments_reference(p, hres.pressure,
                                                  hres.onset), reps=2)
    b2h_ms2, b2f_ms = _time_pair(
        lambda: fdtd_fused.rt60_moments(p, hres.pressure, hres.onset),
        lambda: fdtd_fused.rt60_moments(p, fres.pressure, fres.onset),
        reps=4)
    rec16_mb = hres.pressure.numel() * hres.pressure.element_size() / 1e6
    rec32_mb = fres.pressure.numel() * fres.pressure.element_size() / 1e6
    del hres, hacc, h0, h1, fres
    torch.cuda.empty_cache()
    print(f"phase 16 bf16 B1 fdtd_sim and B2 rt60_moments {shape}: vs plain "
          f"max rel "
          + ", ".join(f"{k} {v[0]:.3g}" for k, v in {**b1h, **b2h}.items())
          + f", bit-equal B1 {b1h_bits}, B2 {b2h_bits}; batched bf16 "
          f"({nv} listeners) bit-equal B1 {b1hb_bits}, B2 {b2hb_bits}, view 0 "
          f"equal to the single pass; B1 bf16 {b1h_ms:.3f} / {b1h_ms2:.3f} ms "
          f"vs float32 {b1f_ms:.3f} ms vs plain bf16 {b1h_plain_ms:.3f} ms; "
          f"B2 on the bf16 recording {b2h_ms:.3f} / {b2h_ms2:.3f} ms vs "
          f"float32 {b2f_ms:.3f} ms vs plain {b2h_plain_ms:.3f} ms; "
          f"recording {rec16_mb:.1f} MB (float32 {rec32_mb:.1f} MB) "
          f"({label})", flush=True)
    # the bf16 Context against the float32 Context at the JAX package's
    # bf16 bounds: on every cell at that test's setting (SmallRoom, 10 m at
    # 275 Hz, 435 steps); at the headline (1187 steps) on the emitters'
    # cells, with every cell's deviations printed
    pair = {}
    for precision in ("bf16", "f32"):
        c = pv.Context(pv.PlaneverbConfig(10.0, 10.0, 275),
                       scene=pv.demo_scene("SmallRoom"), precision=precision,
                       device="cuda")
        c.set_listener_position(5.0, 0.0, 5.0)
        c.step()
        pair[precision] = c._published
        del c
    small_errs = _param_errs(pair["f32"], pair["bf16"])
    _within_bf16_bounds(small_errs, "bf16 Context, SmallRoom 10 m at 275 Hz")
    hctx = pv.Context(cfg, scene=scene, precision="bf16", device="cuda")
    hctx.set_listener_position(lx, 0.0, lz)
    heids = [hctx.emissions.emit(x, 0.0, z) for x, z in EMITTERS]
    fdtd_fused.reset_launch_counts()      # after the float32 calibration
    hev, hwall = zip(*(_once(hctx.step) for _ in range(STEPS)))
    h_launches = counts_of(*sim_fns)
    _require(h_launches == {"fdtd_sim": STEPS, "fdtd_sim_batch": 0,
                            "rt60_moments": STEPS, "rt60_moments_batch": 0,
                            "fdtd_sim_tiled": 0, "rt60_moments_tiled": 0},
             h_launches)
    h_step = _device_pass(kernels, hctx.step)
    _require(h_step == {"fdtd_cluster_kernel": 1, "rt60_moments_kernel": 1,
                        **ANALYSIS_STEP},
             f"bf16 step device launches {h_step}")
    _require(hctx._published["pressure"].dtype == bf, "bf16 recording")
    _require(all(hctx.get_output(e).valid for e in heids), "bf16 outputs")
    hir = hctx.get_impulse_response(lx + 2 * p.dx, lz)
    _require(hir.dtype == np.float32 and np.abs(hir).max() > 0, "bf16 IR")
    fctx = pv.Context(cfg, scene=scene, device="cuda")
    fctx.set_listener_position(lx, 0.0, lz)
    fctx.step()
    hg, fg = hctx._published, fctx._published
    ecells = tuple(np.array(v) for v in zip(*(p.world_to_cell(x, z)
                                              for x, z in EMITTERS)))
    emitter_errs = _param_errs({k: fg[k][ecells] for k in ROW_FIELDS},
                               {k: hg[k][ecells] for k in ROW_FIELDS})
    _within_bf16_bounds(emitter_errs, "bf16 Context, headline emitters")
    cell_errs = _param_errs(fg, hg)
    delay_equal = float((fg["delay_samples"] == hg["delay_samples"]).mean())
    del hctx, fctx
    torch.cuda.empty_cache()

    def stats(errs, pcts=False):
        return ", ".join(
            f"{k} {e.max():.4g}"
            + (f"/{np.percentile(e, 99):.4g}/{np.median(e):.4g}" if pcts
               else "")
            + f" (bound {BF16_BOUNDS.get(k, BF16_MAX_DEGREES):g})"
            for k, e in errs.items())

    print(f"phase 16 Context(precision='bf16') vs the float32 Context on the "
          f"card (relative, directions in degrees): SmallRoom 10 m at 275 Hz, "
          f"every cell, max {stats(small_errs)}; headline {shape}, the "
          f"{len(EMITTERS)} emitters' cells, max {stats(emitter_errs)}; "
          f"every cell, max/p99/median {stats(cell_errs, True)}, delay "
          f"equal on {delay_equal:.4f} of the cells", flush=True)
    print(f"phase 16 main path Context(precision='bf16') {shape}: launches "
          f"{h_launches} ({STEPS} steps after the float32 calibration; "
          f"device launches of a step {h_step}); step "
          f"median {statistics.median(hev):.3f} ms (CUDA events), "
          f"{statistics.median(hwall):.3f} ms (wall) ({label})", flush=True)
    print(f"phase 16 seconds: {time.perf_counter() - t_phase:.1f}")

    # -- 17. the overlap split on 1D meshes of the card
    t_phase = time.perf_counter()
    rounds = -(-p.response_length // SHARD_HALO)
    split_fns = (solver_fused.sharded_round, solver_fused.banded_round,
                 fdtd_fused.rt60_moments, fdtd_fused.rt60_moments_many,
                 fdtd_tiled.rt60_moments_tiled)
    b5o = {}
    for mshape in OVERLAP_MESHES:
        fields, (mesh, nx_pad, ny_pad) = sharded_args(p, beta, refl, pulse,
                                                      mshape)
        margs = (*fields, lix, liy, mesh, nx_pad, ny_pad)
        fdtd_fused.reset_launch_counts()
        got = nine(*parallel.simulate_moments_sharded(
            *margs, halo=SHARD_HALO, overlap=True), p)
        torch.cuda.synchronize()
        counts = counts_of(*split_fns)
        _require(counts == {"sharded_round": rounds * 2,
                            "banded_round": 0, "rt60_moments": 0,
                            "rt60_moments_many": 1, "rt60_moments_tiled": 0},
                 f"B5 split {mshape} launches {counts}")
        _require(all(torch.isfinite(v).all() for k, v in got.items()
                     if k != "onset"), f"B5 split {mshape}: not finite")
        _, rounds_bits = hold(got, nine(*parallel.simulate_moments_sharded(
            *margs, halo=SHARD_HALO), p), f"B5 split {mshape} vs rounds")
        _, b1_bits = hold(got, single, f"B5 split {mshape} vs B1 + B2")
        vs_plain, plain_bits = hold(got, nine(
            *parallel.simulate_moments_sharded_reference(
                *margs, halo=SHARD_HALO, overlap=True), p),
            f"B5 split {mshape} vs plain split")
        _require(rounds_bits and b1_bits and plain_bits,
                 f"B5 split {mshape} not bit-equal")
        row = {"vs_plain": vs_plain}
        if mshape == OVERLAP_MESHES[0]:
            # the frames through ghost buffers (the exchange across cards)
            _, row["slab_bits"] = hold(
                nine(*sharded_impl(margs, slabs=True, overlap=True), p), got,
                f"B5 split {mshape} slab path vs direct")
            _require(row["slab_bits"], f"B5 split {mshape}: slab path not "
                                       f"bit-equal")
        del got
        row["pass_ms"], row["rounds_ms"] = _time_pair(
            lambda: parallel.simulate_moments_sharded(
                *margs, halo=SHARD_HALO, overlap=True),
            lambda: parallel.simulate_moments_sharded(
                *margs, halo=SHARD_HALO), reps=5)
        row["pass_enq"], row["rounds_enq"] = _enqueue_pair(
            lambda: parallel.simulate_moments_sharded(
                *margs, halo=SHARD_HALO, overlap=True),
            lambda: parallel.simulate_moments_sharded(
                *margs, halo=SHARD_HALO), reps=5)
        if mshape == OVERLAP_MESHES[0]:
            row["ms"] = _cuda_ms(lambda: parallel.simulate_sharded_fused(
                *margs, halo=SHARD_HALO, overlap=True), 3)
            row["plain_ms"] = _once(
                lambda: parallel.simulate_sharded_reference(
                    *margs, halo=SHARD_HALO, overlap=True))[0]
        bx = nx_pad // mshape[0]
        print(f"phase 17 B5 split {mshape[0]}x1 mesh of cuda:0 {shape} "
              f"(shards {bx}x{ny_pad}, halo {SHARD_HALO}: frames 2 x "
              f"{SHARD_HALO} rows, interior {bx - 2 * SHARD_HALO} rows): "
              f"launches {counts}; bit-equal to the plain rounds, B1 + B2 "
              f"and the plain split (max rel vs plain "
              + ", ".join(f"{k} {v[0]:.3g}" for k, v in vs_plain.items())
              + f"); pass {row['pass_ms']:.3f} ms vs plain rounds "
              f"{row['rounds_ms']:.3f} ms (CUDA events, medians of 5 in "
              f"turns), host enqueue {row['pass_enq']:.3f} vs "
              f"{row['rounds_enq']:.3f} ms"
              + (f"; simulation {row['ms']:.3f} ms vs plain split "
                 f"{row['plain_ms']:.3f} ms; forced slab path bit-equal "
                 f"{row['slab_bits']}" if "ms" in row else "")
              + f" ({label})", flush=True)
        b5o[mshape] = row
    torch.cuda.empty_cache()

    # B6 split: the 126 m world on 4x1 (241 x 964 shards, routed to B6)
    q, qb, qr, qp, qx, qy = _large_inputs(pv, voxelize, gaussian_pulse, XL,
                                          dev)
    fields, (mesh, nx_pad, ny_pad) = sharded_args(q, qb, qr, qp,
                                                  OVERLAP_MESHES[0])
    margs = (*fields, qx, qy, mesh, nx_pad, ny_pad)
    xbx = nx_pad // OVERLAP_MESHES[0][0]
    xrounds = -(-q.response_length // SHARD_HALO)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # held before the pass: its inputs and what earlier phases keep alive
    split_held = torch.cuda.memory_allocated()
    fdtd_fused.reset_launch_counts()
    res, mom = parallel.simulate_moments_sharded(*margs, halo=SHARD_HALO,
                                                 overlap=True)
    torch.cuda.synchronize()
    split_peak = torch.cuda.max_memory_allocated()
    counts = counts_of(*split_fns)
    _require(counts == {"sharded_round": 0,
                        "banded_round": xrounds * 2, "rt60_moments": 0,
                        "rt60_moments_many": 0, "rt60_moments_tiled": 4},
             f"B6 split launches {counts}")
    rec_bytes = q.nx * q.ny * q.response_length * 4
    _require(split_peak < 1.25 * rec_bytes,
             f"B6 split peak {split_peak / 1e9:.2f} GB >= 1.25 x the "
             f"{rec_bytes / 1e9:.2f} GB recording")
    got = nine(res, mom, q)
    del res, mom
    _require(all(torch.isfinite(v).all() for k, v in got.items()
                 if k != "onset"), "B6 split: not finite")
    _, rounds_bits = hold(got, nine(*parallel.simulate_moments_sharded(
        *margs, halo=SHARD_HALO), q), "B6 split vs rounds")
    torch.cuda.empty_cache()
    tres, tmom = fdtd_tiled.simulate_moments_tiled(q, qb, qr, qp, qx, qy)
    _, b3_bits = hold(got, {**tres._asdict(), **tmom._asdict()},
                      "B6 split vs B3 + B4")
    del tres, tmom
    torch.cuda.empty_cache()
    b6o_vs_plain, plain_bits = hold(got, nine(
        *parallel.simulate_moments_sharded_reference(
            *margs, halo=SHARD_HALO, overlap=True), q),
        "B6 split vs plain split")
    _require(rounds_bits and b3_bits and plain_bits,
             "B6 split not bit-equal")
    del got
    torch.cuda.empty_cache()
    b6o = {}
    b6o["ms"], b6o["rounds_ms"] = _time_pair(
        lambda: parallel.simulate_sharded_fused(*margs, halo=SHARD_HALO,
                                                overlap=True),
        lambda: parallel.simulate_sharded_fused(*margs, halo=SHARD_HALO),
        reps=3)
    b6o["enq"], b6o["rounds_enq"] = _enqueue_pair(
        lambda: parallel.simulate_sharded_fused(*margs, halo=SHARD_HALO,
                                                overlap=True),
        lambda: parallel.simulate_sharded_fused(*margs, halo=SHARD_HALO),
        reps=3)
    b6o["plain_ms"] = _once(lambda: parallel.simulate_sharded_reference(
        *margs, halo=SHARD_HALO, overlap=True))[0]
    torch.cuda.empty_cache()
    print(f"phase 17 B6 split {xshape} on a 4x1 mesh of cuda:0 (shards "
          f"{xbx}x{ny_pad}, halo {SHARD_HALO}: interior "
          f"{xbx - 2 * SHARD_HALO} rows): launches {counts}; peak device "
          f"memory of the pass {split_peak / 1e9:.2f} GB ("
          f"{split_held / 1e9:.2f} GB held before it) against one "
          f"{rec_bytes / 1e9:.2f} GB recording; bit-equal to the plain "
          f"banded rounds, B3 + B4 and the plain split (max rel vs plain "
          + ", ".join(f"{k} {v[0]:.3g}" for k, v in b6o_vs_plain.items())
          + f"); simulation {b6o['ms']:.3f} ms vs plain banded rounds "
          f"{b6o['rounds_ms']:.3f} ms (CUDA events, medians of 3 in turns), "
          f"host enqueue {b6o['enq']:.3f} vs {b6o['rounds_enq']:.3f} ms; "
          f"plain split {b6o['plain_ms']:.3f} ms (one pass) ({label})",
          flush=True)

    # the main path on a 4x1 mesh: Context at the headline, which takes the
    # split (48-row shards, halo 16), one view and then two
    mesh41 = parallel.grid_mesh(["cuda:0"] * 4, OVERLAP_MESHES[0])
    ctx_fns = (fdtd_fused.fdtd_sim, fdtd_fused.fdtd_sim_batch,
               fdtd_tiled.fdtd_sim_tiled, *split_fns)
    fdtd_fused.reset_launch_counts()
    free_grid.clear_cache()   # the calibration is counted
    sctx = pv.Context(cfg, scene=scene, mesh=mesh41)
    _require(sctx._overlap and sctx._halo == SHARD_HALO,
             f"Context on 4x1: overlap {sctx._overlap}, halo {sctx._halo}")
    sctx.set_listener_position(lx, 0.0, lz)
    seids = [sctx.emissions.emit(x, 0.0, z) for x, z in EMITTERS]
    sev, swall = zip(*(_once(sctx.step) for _ in range(STEPS)))
    s_launches = counts_of(*ctx_fns)
    _require(s_launches == {"fdtd_sim": 0, "fdtd_sim_batch": 0,
                            "fdtd_sim_tiled": 1,
                            "sharded_round": rounds * 2 * STEPS,
                            "banded_round": 0, "rt60_moments": 0,
                            "rt60_moments_many": STEPS,
                            "rt60_moments_tiled": 0}, s_launches)
    s_step = _device_pass(kernels, sctx.step)
    _require(s_step == {"round_kernel B5": rounds * 2,
                        "rt60_moments_kernel": 1, **ANALYSIS_STEP},
             f"4x1 split step device launches {s_step}")
    one = pv.Context(cfg, scene=scene, device="cuda")
    one.set_listener_position(lx, 0.0, lz)
    one.step()
    sg, og = sctx._published, one._published
    for k in sg.keys() - {"listener", "pressure"}:
        np.testing.assert_array_equal(sg[k], og[k], err_msg=k)
    np.testing.assert_array_equal(
        sctx.get_impulse_response(lx + 2 * p.dx, lz),
        one.get_impulse_response(lx + 2 * p.dx, lz))
    _require(all(sctx.get_output(e).valid for e in seids), "4x1 outputs")
    b5o_launches = s_launches["sharded_round"]
    del sctx, one
    fdtd_fused.reset_launch_counts()
    free_grid.clear_cache()   # the calibration is counted
    sv = pv.Context(cfg, scene=scene, mesh=mesh41)
    sv.set_listener_positions(positions[:MESH_VIEWS])
    svev, _ = zip(*(_once(sv.step) for _ in range(2)))
    sv_launches = counts_of(*ctx_fns)
    _require(sv_launches == {
        "fdtd_sim": 0, "fdtd_sim_batch": 0, "fdtd_sim_tiled": 1,
        "sharded_round": rounds * 2 * MESH_VIEWS * 2, "banded_round": 0,
        "rt60_moments": 0, "rt60_moments_many": MESH_VIEWS * 2,
        "rt60_moments_tiled": 0},
        sv_launches)
    for k in sv._published.keys() - {"listener", "listeners"}:
        np.testing.assert_array_equal(sv._published[k], vg[k][:MESH_VIEWS],
                                      err_msg=k)
    del sv
    print(f"phase 17 main path Context(mesh=4x1 of cuda:0, halo "
          f"{SHARD_HALO}: the split) {shape}: launches {s_launches} "
          f"(calibration + {STEPS} steps: 2 round launches a round; "
          f"device launches of a step {s_step}); step median "
          f"{statistics.median(sev):.3f} ms (CUDA "
          f"events), {statistics.median(swall):.3f} ms (wall), steps "
          + ", ".join(f"{v:.3f}" for v in sev)
          + f" ms; grids and impulse response equal the single-device "
          f"Context's; {MESH_VIEWS} views: launches {sv_launches} (2 steps), "
          f"steps " + ", ".join(f"{v:.3f}" for v in svev)
          + f" ms, grids equal the single-device views' ({label})",
          flush=True)
    # ... and the 126 m world on the same mesh, cells publish (the B6 split)
    fdtd_fused.reset_launch_counts()
    free_grid.clear_cache()   # the calibration is counted
    xs = pv.Context(xcfg, scene=pv.demo_scene("HugeRoom"), publish="cells",
                    mesh=mesh41)
    _require(xs._overlap, "126 m Context on 4x1 must take the split")
    xs.set_listener_position(xl_lx, 0.0, xl_lz)
    for x, z in XL_EMITTERS:
        xs.emissions.emit(x, 0.0, z)
    xsev, xswall = zip(*(_once(xs.step) for _ in range(XL_SPLIT_STEPS)))
    xs_launches = counts_of(*ctx_fns)
    _require(xs_launches == {
        "fdtd_sim": 0, "fdtd_sim_batch": 0, "fdtd_sim_tiled": 1,
        "sharded_round": 0,
        "banded_round": xrounds * 2 * XL_SPLIT_STEPS,
        "rt60_moments": 0, "rt60_moments_many": 0,
        "rt60_moments_tiled": 4 * XL_SPLIT_STEPS},
        xs_launches)
    xs_step = _device_pass(kernels, xs.step)
    _require(xs_step == {"round_kernel B6": xrounds * 2,
                         "rt60_moments_tiled_kernel": 4, **ANALYSIS_STEP},
             f"126 m 4x1 split step device launches {xs_step}")
    xs_cells = xs._published["cells"]
    _require(xs_cells.keys() == xl_rows.keys(), sorted(xs_cells))
    for cell, row in xs_cells.items():
        np.testing.assert_array_equal(row, xl_rows[cell],
                                      err_msg=f"cell {cell}")
    b6o_launches = xs_launches["banded_round"]
    del xs
    torch.cuda.empty_cache()
    print(f"phase 17 main path Context({XL:g} m, publish='cells', mesh=4x1 "
          f"of cuda:0: the B6 split) {xshape}: launches {xs_launches} "
          f"(calibration + {XL_SPLIT_STEPS} steps; device launches of a step "
          f"{xs_step}); steps "
          + ", ".join(f"{v:.3f}" for v in xsev) + " ms (CUDA events), "
          + ", ".join(f"{v:.3f}" for v in xswall)
          + f" ms (wall); emitter rows equal phase 9's ({label})",
          flush=True)
    print(f"phase 17 seconds: {time.perf_counter() - t_phase:.1f}")

    # -- 18, 19. the DSP's recurrences and the audio path
    dsp18 = _dsp_scans_phase(kernels, label)
    audio19 = _audio_phase(pv, kernels, card, label)
    # -- 20, 21. the integration front ends and the native audio path
    _integration_phase(pv, kernels, card, label)
    _native_audio_phase(pv, kernels, card, label, audio19["reports"])
    # -- 22. the last ported modules
    _scaling_phase(pv, card, label, root)
    # -- 23. a Context across processes, the projection model, the split DSP
    _context_phase(pv, card, label, root)
    # -- 24. assembly and DOA
    analysis24 = _analysis_phase(pv, kernels, label)

    b3_err = max(v[1] for r in b3.values() for v in r["vs_plain"].values())
    b4_xl = b4[xshape]
    b3_large = next(r for r in b3.values() if "plain_ms" in r)
    large = pv.compute_grid_params(pv.PlaneverbConfig(LARGE, LARGE, 750))

    def row(name, source, replaces, launches, err, ms, plain_ms, bound,
            per_pass):
        return {"name": name, "route": "cuda",
                "source": f"planeverb_tpu_torch/csrc/{source}",
                "replaces": f"planeverb_tpu/{replaces}",
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": None,
                "device_launches_per_pass": per_pass}

    def err_of(*dicts):
        return max(v[1] for d in dicts for v in d.values())

    # device_launches_per_pass: the kernel's launches on the card in one
    # step of its main path (one pass; for B1 one headline pass, for B2
    # alone the bf16 step), as the C launchers counted them in
    # this run. No single PyTorch call computes any of these functions, so
    # every library_ms is null
    print(json.dumps({"kernels": [
        row("fdtd_sim", "fdtd_fused.cu", "ops/fdtd_pallas.py:104",
            launches["fdtd_sim"], err_of(b1), b1_ms, b1_plain_ms,
            _sim_bound(p), cluster_pass["fdtd_cluster_kernel"]),
        row("rt60_moments", "moments.cu", "ops/fdtd_pallas.py:246",
            launches["rt60_moments"], err_of(b2), b2_ms, b2_plain_ms,
            _moments_bound(p), h_step["rt60_moments_kernel"]),
        row("rt60_moments_many", "moments.cu",
            "parallel/solver_pallas.py:1256", m_launches["rt60_moments_many"],
            err_of(b2r["table_err"]), b2r["table_ms"], b2r["table_plain_ms"],
            _moments_bound(p), m_step["rt60_moments_kernel"]),
        row("fdtd_sim_tiled", "fdtd_tiled.cu", "ops/fdtd_tiled.py:54",
            xl_launches["fdtd_sim_tiled"], b3_err, b3_large["ms"],
            b3_large["plain_ms"], _sim_bound(large),
            xl_step["fdtd_tiled_kernel"]),
        row("rt60_moments_tiled", "fdtd_tiled.cu", "ops/fdtd_tiled.py:382",
            xl_launches["rt60_moments_tiled"], err_of(b4_xl["vs_plain"]),
            b4_xl["ms"], b4_xl["plain_ms"], _moments_bound(xp),
            xl_step["rt60_moments_tiled_kernel"]),
        row("sharded_round", "solver_rounds.cu",
            "parallel/solver_pallas.py:76", b5_launches,
            err_of(*(r["vs_plain"] for r in b5.values())),
            b5[SHARDED_MESHES[0]]["ms"], b5[SHARDED_MESHES[0]]["plain_ms"],
            _sim_bound(p), m_step["round_kernel B5"]),
        row("banded_round", "solver_rounds.cu",
            "parallel/solver_pallas.py:221", b6_launches, err_of(b6_vs_plain),
            b6["ms"], b6["plain_ms"], _sim_bound(xp),
            xm_step["round_kernel B6"]),
        row("fdtd_sim_batch", "fdtd_fused.cu", "ops/fdtd_pallas.py:104",
            v_launches["fdtd_sim_batch"], err_of(b1b), b1b_ms, b1b_plain_ms,
            _sim_bound(p, nv), v_step["fdtd_cluster_kernel"]),
        row("rt60_moments_batch", "moments.cu", "ops/fdtd_pallas.py:246",
            v_launches["rt60_moments_batch"], err_of(b2b), b2r["batch_ms"],
            b2r["batch_plain_ms"], _moments_bound(p, nv),
            v_step["rt60_moments_kernel"]),
        row("fdtd_sim bf16", "fdtd_fused.cu", "ops/fdtd_pallas.py:104",
            h_launches["fdtd_sim"], err_of(b1h), b1h_ms, b1h_plain_ms,
            _sim_bound(p, state_bytes=2), h_step["fdtd_cluster_kernel"]),
        row("rt60_moments bf16", "moments.cu", "ops/fdtd_pallas.py:246",
            h_launches["rt60_moments"], err_of(b2h), b2r["bf16_ms"],
            b2r["bf16_plain_ms"],
            _moments_bound(p, rec_bytes=2), h_step["rt60_moments_kernel"]),
        row("B5 overlap", "solver_rounds.cu",
            "parallel/solver_pallas.py:550", b5o_launches,
            err_of(*(r["vs_plain"] for r in b5o.values())),
            b5o[OVERLAP_MESHES[0]]["ms"], b5o[OVERLAP_MESHES[0]]["plain_ms"],
            _sim_bound(p), s_step["round_kernel B5"]),
        row("B6 overlap", "solver_rounds.cu",
            "parallel/solver_pallas.py:798", b6o_launches,
            err_of(b6o_vs_plain), b6o["ms"], b6o["plain_ms"],
            _sim_bound(xp), xs_step["round_kernel B6"]),
        # XLA scans, not Pallas kernels: D1 a render_block call, D2 an
        # audio callback (device_launches_per_pass: one a call)
        row("biquad_scan", "dsp_scan.cu", "dsp/lowpass.py:73",
            audio19["d1_launches"], *dsp18["d1"], 1),
        row("reverb_scan", "dsp_scan.cu", "dsp/reverb.py:88",
            audio19["d2_launches"], *dsp18["d2"], 1),
        # XLA's fusion of the assembly and DOA, not a Pallas kernel: A1 + A2
        # at the headline, one view, as phase 24 measured its first call
        # (ms and plain_ms both CUDA-event times from an idle card)
        row("analyze_moments A1 + A2", "analysis.cu",
            "ops/analyzer.py:148", analysis24[0]["launches"],
            analysis24[0]["max_abs_err"], analysis24[0]["event_ms"],
            analysis24[0]["plain_ms"], _analysis_bound(p, 1),
            hl_step["analysis_assemble_kernel"]
            + hl_step["analysis_directions_kernel"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
