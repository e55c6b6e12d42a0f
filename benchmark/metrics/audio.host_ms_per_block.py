"""audio.host_ms_per_block: the host's time in one audio callback, from the
block's start to its end on the harness's clock (``drive.AudioPump``: the
listener transform, the engine-to-DSP sync of every live emission, one
submission a voice, the buses and the three reverbs), over the blocks that
started and ended inside the traced window, in ms.

The harness times the blocks itself (``info["audio_block_ms"]``), not in
the trace: a profiler that records every thread turns
``torch.autograd._profiler_enabled()`` false on the refresh loop's, and
the program then forwards none of its spans into the trace.

Layer: audio. It moves ``audio_block_ms_p50``: a block ends this long after
it starts, and a block that starts late because the one before ran long, or
because the refresh loop held the interpreter, ends later still.
"""

UNIT = "ms"
MOVES = "audio_block_ms_p50"
SPANS: dict = {}


def read(trace, info):
    blocks = info.get("audio_block_ms")
    if not blocks or trace.refreshes == 0:
        return None
    return sum(blocks) / len(blocks)
