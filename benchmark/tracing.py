"""The traced run: spans around the program's layers, the profiler's trace of
the card, and the trace reduced to what the per-layer metrics read.

Spans are ``torch.profiler.record_function`` ranges named ``pvb.<layer>``.
The harness opens ``pvb.refresh``, ``pvb.inputs`` (listener and geometry),
``pvb.step`` and ``pvb.query`` itself; each per-layer metric's file names the
program functions it needs wrapped (``SPANS``: span name -> list of
``module:function``), and :func:`wrap` replaces each module attribute with a
function that runs the original inside its span. The program itself is not
edited.

:func:`reduce` reads the profiler's Chrome trace into a :class:`Trace`: the
harness's spans on the host, and every kernel, copy and fill on the device,
each attributed to the innermost span that was open on the host when it was
launched (through the launch's correlation id), and the traced window: from
the first traced refresh's start to the last one's end.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import importlib
import json

PREFIX = "pvb."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# what the breakdown lists of each kind, and the longest name it keeps
TOP = 10
NAME_CHARS = 160


def wrap(spans: dict) -> list:
    """Wrap each ``module:function`` of ``spans`` ({span: [targets]}) in a
    ``record_function(PREFIX + span)``. Returns [(module, attr, original)]
    for :func:`unwrap`."""
    from torch.profiler import record_function

    done = []
    for span, targets in sorted(spans.items()):
        for target in targets:
            mod_name, attr = target.split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)

            def spanned(*a, _fn=fn, _name=PREFIX + span, **k):
                with record_function(_name):
                    return _fn(*a, **k)

            functools.update_wrapper(spanned, fn)
            setattr(mod, attr, spanned)
            done.append((mod, attr, fn))
    return done


def unwrap(done: list) -> None:
    for mod, attr, fn in reversed(done):
        setattr(mod, attr, fn)


@dataclasses.dataclass
class Trace:
    """A traced window: ``spans`` [(name, start_us, end_us)] of the harness
    (names without the prefix), ``device`` [(cat, name, start_us, end_us,
    span)] with the span open at launch (None: outside every span),
    ``start``/``end`` of the window, and the ``refreshes`` in it."""
    spans: list
    device: list
    start: float
    end: float
    refreshes: int

    @property
    def window_us(self) -> float:
        return self.end - self.start

    def host_us(self, name: str) -> float:
        """Host time inside spans ``name``, nested ones counted once."""
        total, reach = 0.0, float("-inf")
        for n, s, e in sorted(x for x in self.spans if x[0] == name):
            if e <= reach:
                continue
            total += e - max(s, reach)
            reach = e
        return total

    def kernels(self, span: str | None = None) -> list:
        """Kernels launched inside ``span`` (any span: None)."""
        return [d for d in self.device if d[0] == "kernel"
                and (span is None or d[4] == span)]

    def busy(self) -> list:
        """The device's busy intervals inside the window, merged."""
        out = []
        for _, _, s, e, _ in sorted(self.device, key=lambda d: d[2]):
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy())

    def idle_by_span(self) -> dict:
        """Idle device time inside the window, split by the innermost span
        the host was in (``"between refreshes"``: outside every span)."""
        segs = _segments(self.spans)
        starts = [s for s, _, _ in segs]
        idle, cursor = {}, self.start
        for s, e in self.busy() + [[self.end, self.end]]:
            if s > cursor:
                _split(cursor, s, segs, starts, idle)
            cursor = max(cursor, e)
        return idle

    def device_ops(self) -> dict:
        """Device seconds by operation name inside the window."""
        out = {}
        for _, name, s, e, _ in self.device:
            s, e = max(s, self.start), min(e, self.end)
            if e > s:
                out[name] = out.get(name, 0.0) + (e - s) * 1e-6
        return out


def _segments(spans) -> list:
    """Nested host spans -> non-overlapping (start, end, innermost span)."""
    segs, stack, cursor = [], [], 0.0

    def close(upto):
        if stack and upto > cursor:
            segs.append((cursor, upto, stack[-1][0]))

    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][2] <= s:
            close(stack[-1][2])
            cursor = stack.pop()[2]
        close(s)
        stack.append((name, s, e))
        cursor = s
    while stack:
        close(stack[-1][2])
        cursor = stack.pop()[2]
    return segs


def _split(a: float, b: float, segs, starts, out: dict) -> None:
    """Add the interval [a, b] to ``out`` by host segment."""
    k = max(bisect.bisect_right(starts, a) - 1, 0)
    t = a
    while t < b:
        while k < len(segs) and segs[k][1] <= t:
            k += 1
        if k < len(segs) and segs[k][0] <= t:
            e, name = min(b, segs[k][1]), segs[k][2]
        else:
            e = min(b, segs[k][0]) if k < len(segs) else b
            name = "between refreshes"
        out[name] = out.get(name, 0.0) + (e - t)
        t = e


def _span_at(segs, starts, t: float):
    k = bisect.bisect_right(starts, t) - 1
    if k >= 0 and segs[k][0] <= t < segs[k][1]:
        return segs[k][2]
    return None


def reduce(events: list) -> Trace:
    """A Chrome trace's ``traceEvents`` -> :class:`Trace`."""
    spans, launches, dev = [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        corr = (ev.get("args") or {}).get("correlation")
        if cat == "user_annotation" and name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], ts, ts + dur))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = ts
        elif cat in DEVICE_CATS:
            dev.append((cat, name, ts, ts + dur, corr))
    refreshes = sorted((s, e) for n, s, e in spans if n == "refresh")
    if not refreshes:
        return Trace(spans, [], 0.0, 0.0, 0)
    segs = _segments(spans)
    starts = [s for s, _, _ in segs]
    device = []
    for cat, name, s, e, corr in dev:
        t = launches.get(corr)
        device.append((cat, name, s, e,
                       None if t is None else _span_at(segs, starts, t)))
    return Trace(spans, device, refreshes[0][0], refreshes[-1][1],
                 len(refreshes))


def load(path: str) -> Trace:
    with open(path) as f:
        data = json.load(f)
    return reduce(data["traceEvents"] if isinstance(data, dict) else data)


def breakdown(trace: Trace) -> dict:
    """The line's ``breakdown``: the device operations that took the most
    time, and the idle time by what the host was doing, each [name,
    seconds], at most :data:`TOP` of each."""
    ops = sorted(trace.device_ops().items(), key=lambda x: -x[1])[:TOP]
    ops = [(n if len(n) <= NAME_CHARS else n[:NAME_CHARS - 3] + "...", s)
           for n, s in ops]
    idle = sorted(((f"host in {k}", v * 1e-6)
                   for k, v in trace.idle_by_span().items()),
                  key=lambda x: -x[1])[:TOP]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}
