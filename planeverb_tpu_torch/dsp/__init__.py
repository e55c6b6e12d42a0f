"""DSP module — acoustic parameter renderer (PlaneverbDSP analog).

Two renderers share one gain/filter math core (dsp/gains.py, dsp/lowpass.py):

  - :class:`DSPContext` (dsp/context.py): streaming per-callback renderer,
    NumPy, mirrors the reference audio-thread pipeline semantics.
  - :func:`render_block` (dsp/ops.py): batched renderer — all sources in one
    call on a torch device, the biquad as one D1 launch on a card.

:func:`~planeverb_tpu_torch.dsp.reverb.mix_output` (dsp/reverb.py) mixes the
dry bus with the three canonical reverbs, one D2 launch on a card.
"""

from planeverb_tpu_torch.dsp.context import (DirectivityPattern, DSPContext,
                                             EmissionParams)
from planeverb_tpu_torch.dsp.ops import (DSPState, SourceParams, init_state,
                                         render_block)

__all__ = [
    "DSPContext", "DirectivityPattern", "EmissionParams",
    "DSPState", "SourceParams", "init_state", "render_block",
]
