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


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(4)
