"""Unit tests for the endurance soak's pure verdict (tools/endurance.py
judge_windows): sustained throughput decay and a rising host-RSS floor.

- a DRAIN tail (feed ended, runner still settling at ~0 fed/s) and windows
  with a stalled device read must not count as throughput degradation;
- the leak verdict compares window RSS MINIMA across the halves of the run,
  because point samples swing with XLA scratch buffers.

Mirrors the reference's whole-flight operating envelope
(src/pointcloud_segmentation_node.cpp:267-348): the node must hold
throughput and memory for the duration of a flight.
"""

import importlib.util
import os
import sys

RATE = 30.0
WINDOW_S = 30.0


def _load():
    tools = os.path.join(os.path.dirname(__file__), "..", "tools")
    spec = importlib.util.spec_from_file_location(
        "endurance", os.path.join(tools, "endurance.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["endurance"] = mod
    spec.loader.exec_module(mod)
    return mod


END = _load()


def w(rate_ps=30.0, fed=900, rss=550.0):
    return {"processed_per_sec": rate_ps, "fed_in_window": fed,
            "rss_mb": rss}


def judge(windows):
    return END.judge_windows(windows, RATE, WINDOW_S)


def test_flat_sawtooth_plateau_not_a_leak():
    # point samples swing with scratch buffers; the minima floor is flat
    windows = [w(rss=545 + (i % 3) * 40) for i in range(14)]
    windows.append(w(rate_ps=4.0, fed=30, rss=550))   # partial tail
    v = judge(windows)
    assert not v["leaked"], v
    assert not v["degraded"], v
    assert v["rss_mb_min_first_half"] == 545, v


def test_true_floor_rise_still_flags():
    # a genuine leak: the minima floor keeps climbing
    windows = [w(rss=300 + i * 50) for i in range(20)]
    v = judge(windows)
    assert v["leaked"], v


def test_drain_tail_windows_do_not_degrade():
    # healthy 30/s stream, then the feed ends and the runner settles
    # for 4 windows at ~0 fed/s
    windows = [w() for _ in range(12)]
    windows += [w(rate_ps=0.1, fed=5) for _ in range(4)]
    v = judge(windows)
    assert not v["degraded"], v
    assert v["median_processed_per_sec"] == 30.0, v


def test_sustained_decay_flags():
    windows = [w() for _ in range(10)] + \
        [w(rate_ps=18.0) for _ in range(6)] + [w()]
    v = judge(windows)
    assert v["degraded"], v


def test_transient_outage_counts_but_does_not_degrade():
    windows = [w() for _ in range(8)] + [w(rate_ps=2.0)] + \
        [w() for _ in range(8)]
    v = judge(windows)
    assert not v["degraded"], v
    assert v["outage_windows"] == 1, v


def test_short_run_never_flags():
    v = judge([w(rss=300), w(rss=900), w(rss=1200)])
    assert not v["leaked"] and not v["degraded"], v


def test_wedge_tail_does_not_degrade():
    """Windows whose slowest flusher read crossed the engine's wedge
    threshold read as outages, not sustained decay: the trailing median
    skips them."""
    windows = [w() for _ in range(10)]
    for _ in range(6):
        c = w(rate_ps=3.0)
        c["max_flush_read_ms"] = 250000.0
        windows.append(c)
    windows.append(w())   # partial tail dropped by the judge
    v = judge(windows)
    assert not v["degraded"], v
    assert v["outage_windows"] == 6, v


def test_all_tail_wedged_insufficient_signal():
    # fewer than 3 clean windows total -> no degradation verdict at all
    windows = []
    for i in range(8):
        c = w(rate_ps=3.0)
        c["max_flush_read_ms"] = 99000.0
        windows.append(c)
    windows.append(w(rate_ps=3.0))
    v = judge(windows)
    assert not v["degraded"], v
