"""Reduce a jax.profiler trace to device metrics.

`jax.profiler.trace(logdir)` writes an XSpace protobuf
(`<logdir>/plugins/profile/<time>/*.xplane.pb`). Its device planes are
named `/device:<PLATFORM>:<n>`; on a GPU each line named `Stream #<n>(...)`
holds the kernels and copies one CUDA stream ran, with start and duration
in nanoseconds. Other lines of a device plane (module- or launch-level
spans) can cover whole executions, so only stream lines are counted. This
module sums the device time per operation name and the busy share of the
traced window, so every caller computes the same numbers the same way.
"""

from __future__ import annotations

import glob
import os

#: prefix of the device-plane lines that hold one stream's operations
STREAM_LINE = "Stream"


def latest_xplane(logdir: str) -> str:
    paths = sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {logdir}")
    return paths[-1]


def summarize(planes, top: int = 10) -> dict:
    """Per-operation device time and the busy share of the window.

    planes: iterable of objects with `.name` and `.lines`; each line has
    `.name` and `.events`, each event `.name`, `.start_ns`, `.duration_ns`
    (the jax.profiler.ProfileData shapes). Only `/device:` planes and their
    stream lines count. Returns {"device_planes" (each with all its line
    names, counted or not), "window_ms", "busy_ms", "busy_share",
    "top": [(name, total_ms, count), ...]}; busy is the union of operation
    intervals, the window runs from the first operation's start to the
    last one's end. Without device operations (a CPU run) every number is
    zero."""
    agg: dict[str, list] = {}
    intervals = []
    names = []
    for plane in planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = list(plane.lines)
        names.append(f"{plane.name} lines="
                     f"{sorted({ln.name for ln in lines})}")
        for line in lines:
            if not line.name.startswith(STREAM_LINE):
                continue
            for ev in line.events:
                rec = agg.setdefault(ev.name, [0, 0])
                rec[0] += ev.duration_ns
                rec[1] += 1
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy = 0
    end = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (max(e for _, e in intervals) - min(s for s, _ in intervals)
              if intervals else 0)
    ranked = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
    return {"device_planes": names,
            "window_ms": window / 1e6,
            "busy_ms": busy / 1e6,
            "busy_share": busy / window if window else 0.0,
            "top": [(name, ns / 1e6, n) for name, (ns, n) in ranked]}


def device_summary(logdir: str, top: int = 10) -> dict:
    """summarize() over the newest trace under logdir."""
    import jax

    pd = jax.profiler.ProfileData.from_file(latest_xplane(logdir))
    return summarize(pd.planes, top)
