"""The profiler-trace reduction behind the device busy share and the top
device operations chip_smoke.py and tools/trace_step.py print.

The planes are built by hand in the jax.profiler.ProfileData shapes, so
each rule of the reduction is pinned on numbers worked out by hand.
"""

from types import SimpleNamespace as NS

import pytest

from maniac_tpu.utils.devtrace import summarize


def _ev(name, start, dur):
    return NS(name=name, start_ns=start, duration_ns=dur)


def _line(name, *events):
    return NS(name=name, events=list(events))


def _plane(name, *lines):
    return NS(name=name, lines=list(lines))


def test_only_stream_lines_count():
    """A module-level line spanning the whole execution would make the
    device look busy by construction; it is listed but not counted."""
    plane = _plane("/device:GPU:0",
                   _line("XLA Modules", _ev("jit_block", 0, 1000)),
                   _line("Stream #13(Compute)", _ev("gemm", 100, 100),
                         _ev("fusion", 500, 100)))
    s = summarize([plane])
    assert s["window_ms"] == pytest.approx(500 / 1e6)
    assert s["busy_ms"] == pytest.approx(200 / 1e6)
    assert s["busy_share"] == pytest.approx(0.4)
    assert [name for name, _, _ in s["top"]] == ["gemm", "fusion"]
    assert "XLA Modules" in s["device_planes"][0]


def test_busy_is_the_union_across_streams():
    """Overlapping operations, on one stream or on two, are busy once."""
    plane = _plane("/device:GPU:0",
                   _line("Stream #13(Compute)", _ev("a", 0, 100),
                         _ev("b", 50, 100)),
                   _line("Stream #14(MemcpyD2D)", _ev("c", 120, 80),
                         _ev("d", 300, 100)))
    s = summarize([plane])
    assert s["window_ms"] == pytest.approx(400 / 1e6)
    assert s["busy_ms"] == pytest.approx(300 / 1e6)
    assert s["busy_share"] == pytest.approx(0.75)


def test_top_ranks_by_total_time_and_counts():
    line = _line("Stream #7", _ev("small", 0, 10), _ev("small", 20, 10),
                 _ev("small", 40, 10), _ev("big", 60, 50),
                 _ev("tiny", 120, 1))
    s = summarize([_plane("/device:GPU:0", line)], top=2)
    assert s["top"] == [("big", pytest.approx(50 / 1e6), 1),
                        ("small", pytest.approx(30 / 1e6), 3)]


def test_host_planes_and_empty_devices_give_zero():
    host = _plane("/host:CPU", _line("Stream #1", _ev("x", 0, 100)))
    idle = _plane("/device:GPU:0", _line("Stream #13(Compute)"))
    s = summarize([host, idle])
    assert s["window_ms"] == 0 and s["busy_ms"] == 0
    assert s["busy_share"] == 0.0 and s["top"] == []
    assert len(s["device_planes"]) == 1
    assert s["device_planes"][0].startswith("/device:GPU:0")
