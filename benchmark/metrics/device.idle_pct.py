"""device.idle_pct: the share of the traced window in which no kernel, copy
or fill ran on the card (the default stream and every other), in %.

Layer: the device (the H100). It moves ``refreshes_per_s``: the card's idle
time is where the host holds the refresh back.
"""

UNIT = "%"
MOVES = "refreshes_per_s"
# the harness's own spans bound the window; no program function is wrapped
SPANS: dict = {}


def read(trace, info):
    if not trace.device or trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us() / trace.window_us)
