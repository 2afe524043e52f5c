"""monogs_torch's spans, host-read counts and counters (utils/profiling.py)
on the CPU, and the benchmark's readers of them on hand-built summaries;
one `gpu` case holds a span on the card to its stream time without a wait.

No JAX here: the card case runs in this file as it is."""

import sys
import threading
import time

import pytest
import torch

from monogs_torch.ops import binning
from monogs_torch.utils import profiling as P
from slambench.metrics import (
    kf_bin_ms,
    map_slab_fill,
    probe_ms,
    track_bin_ms,
    track_host_ms,
    track_reads,
    track_slab_fill,
)


@pytest.fixture(autouse=True)
def _fresh():
    P.reset()
    yield
    P.reset()


def test_spans_nest_with_paths_self_time_and_frame_ids():
    with P.span("frame", frame=12) as f:
        with P.span("track.dispatch") as d:
            with P.span("bin") as b:
                time.sleep(0.02)
            time.sleep(0.01)
        with P.span("kf.extend", frame=10) as k:
            with P.span("bin") as kb:
                time.sleep(0.005)
    assert (f.path, d.path, b.path) == ("frame", "frame/track.dispatch",
                                        "frame/track.dispatch/bin")
    assert (k.path, kb.path) == ("frame/kf.extend", "frame/kf.extend/bin")
    assert (f.frame, d.frame, b.frame, k.frame, kb.frame) == (12, 12, 12, 10, 10)
    s = P.summary()
    assert s["bin"]["n"] == 2
    assert set(s["bin"]["paths"]) == {"frame/track.dispatch/bin", "frame/kf.extend/bin"}
    assert s["bin"]["paths"]["frame/track.dispatch/bin"]["total_s"] >= 0.02
    disp = s["track.dispatch"]
    assert disp["total_s"] >= 0.03
    assert disp["self_s"] == pytest.approx(disp["total_s"] - b.total_s)
    assert 0.01 <= disp["self_s"] < disp["total_s"] - 0.015
    fr = s["frame"]
    assert fr["self_s"] == pytest.approx(fr["total_s"] - d.total_s - k.total_s)
    for v in s.values():     # on the CPU a span's time is its host time
        assert v["host_s"] == pytest.approx(v["total_s"])


def test_spans_of_two_threads_keep_their_own_paths_and_frames():
    barrier = threading.Barrier(2, timeout=10)
    seen = {}

    def worker(name, frame):
        with P.span(name, frame=frame) as top:
            barrier.wait()
            for _ in range(20):
                with P.span("bin") as b:
                    time.sleep(0.001)
                seen.setdefault(name, set()).add((b.path, b.frame))
            barrier.wait()
        seen[name].add((top.path, top.frame))

    threads = [threading.Thread(target=worker, args=("frame", 5)),
               threading.Thread(target=worker, args=("kf.optimize", 3))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    assert seen == {"frame": {("frame/bin", 5), ("frame", 5)},
                    "kf.optimize": {("kf.optimize/bin", 3), ("kf.optimize", 3)}}
    s = P.summary()
    assert {p: v["n"] for p, v in s["bin"]["paths"].items()} == {"frame/bin": 20,
                                                                 "kf.optimize/bin": 20}
    assert s["frame"]["n"] == s["kf.optimize"]["n"] == 1


def test_many_threads_lose_no_span_or_read():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(i):
            for _ in range(300):
                with P.span("frame", frame=i):
                    with P.span("bin"):
                        pass
                    with P.host_read():
                        pass
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    s = P.summary()
    assert s["frame"]["n"] == s["bin"]["n"] == s["host_read"]["n"] == 16 * 300
    assert s["frame"]["reads"] == 16 * 300
    assert list(s["host_read"]["paths"]) == ["frame/host_read"]


def test_host_read_counts_reads_and_blocked_time_against_the_innermost_span():
    with P.span("track.dispatch"):
        with P.host_read():
            time.sleep(0.02)
        with P.span("bin"):
            with P.host_read():
                pass
    with P.host_read():
        pass
    s = P.summary()
    r = s["host_read"]
    assert r["n"] == 3
    assert r["paths"]["track.dispatch/host_read"]["n"] == 1
    assert r["paths"]["track.dispatch/host_read"]["total_s"] >= 0.02
    assert r["paths"]["track.dispatch/bin/host_read"]["n"] == 1
    assert r["paths"]["host_read"]["n"] == 1
    assert s["track.dispatch"]["reads"] == 1 and s["track.dispatch"]["read_s"] >= 0.02
    assert s["bin"]["reads"] == 1


def test_no_profiler_no_fine_span_and_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with P.span("track.dispatch"):
        for _ in range(3):
            with P.fine_span("track.iter"):
                with P.host_read():
                    pass
    s = P.summary()
    assert "track.iter" not in s
    assert s["host_read"]["paths"] == {"track.dispatch/host_read": s["host_read"]["paths"]
                                       ["track.dispatch/host_read"]}
    assert s["track.dispatch"]["reads"] == 3


def test_spans_are_nested_annotations_under_the_profiler(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("frame", frame=9):
            with P.span("track.dispatch"):
                for _ in range(2):
                    with P.fine_span("track.iter"):
                        torch.ones(64).cumsum(0)
                        with P.host_read():
                            pass
    by_name = {}
    for e in prof.events():
        by_name.setdefault(e.name, []).append(e)
    assert len(by_name["frame"]) == 1 and len(by_name["track.dispatch"]) == 1
    assert len(by_name["track.iter"]) == 2 and len(by_name["host_read"]) == 2
    for e in by_name["track.iter"]:
        assert e.cpu_parent.name == "track.dispatch"
        assert e.cpu_parent.cpu_parent.name == "frame"
    for e in by_name["host_read"]:
        assert e.cpu_parent.name == "track.iter"
    assert any(e.name == "aten::cumsum" and e.cpu_parent.name == "track.iter"
               for e in prof.events())
    s = P.summary()
    assert s["track.iter"]["n"] == 2
    assert set(s["track.iter"]["paths"]) == {"frame/track.dispatch/track.iter"}
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    assert '"track.dispatch"' in trace.read_text()


def test_summary_keeps_the_section_fields_and_reset_clears_it():
    for device in (None, "cpu", torch.device("cpu")):
        with P.span("kf.extend", device=device):
            torch.ones(4).sum()
    s = P.summary()
    assert list(s) == ["kf.extend"]
    a = s["kf.extend"]
    assert a["n"] == 3 and a["total_s"] >= 0.0
    assert a["mean_ms"] == pytest.approx(1e3 * a["total_s"] / 3)
    assert {"n", "total_s", "mean_ms", "host_s", "self_s", "reads", "read_s",
            "paths"} <= set(a)
    P.reset()
    assert P.summary() == {}


def _sections():
    """A window of 4 tracked frames (100 iterations), 2 keyframe events."""
    def row(n, total, host=None, reads=0):
        return {"n": n, "total_s": total, "host_s": total if host is None else host,
                "self_s": total, "reads": reads, "read_s": 0.0}

    def entry(paths):
        tot = {k: sum(p[k] for p in paths.values()) for k in ("n", "total_s", "host_s",
                                                               "self_s", "reads", "read_s")}
        return dict(tot, mean_ms=1e3 * tot["total_s"] / tot["n"], paths=paths)

    return {
        "track.dispatch": entry({"frame/track.dispatch": row(4, 2.0, host=1.5, reads=100)}),
        "bin": entry({"frame/track.dispatch/bin": row(52, 0.8),
                      "frame/track.dispatch/track.iter/bin": row(2, 0.2),
                      "frame/kf.extend/bin": row(2, 0.1),
                      "frame/kf.optimize/map.span/bin": row(40, 3.0),
                      "kf.prune/map.visibility/bin": row(16, 0.9),
                      "refine/bin": row(5, 7.0)}),
        "host_read": entry({"frame/track.dispatch/host_read": row(96, 0.3),
                            "frame/track.dispatch/track.iter/host_read": row(4, 0.2),
                            "frame/track.readback/host_read": row(4, 0.01),
                            "frame/host_read": row(3, 0.01),
                            "frame/kf.optimize/host_read": row(2, 0.01),
                            "kf.apply_result/host_read": row(2, 0.01),
                            "refine/host_read": row(9, 0.01)}),
    }


@pytest.mark.parametrize("reader,expected", [
    (track_bin_ms, 1e3 * 1.0 / 4),             # the bins inside track.dispatch, a frame
    (kf_bin_ms, 1e3 * 4.0 / 2),                # the bins inside a kf.* span, an event
    (track_host_ms, 1e3 * (1.5 - 0.5) / 100),  # dispatch host time less its reads, an iter
    (track_reads, (96 + 4 + 4 + 3) / 4),       # the frames' reads outside kf.*, a frame
])
def test_readers_on_a_hand_built_summary(reader, expected):
    ctx = {"sections": _sections(), "window": {"keyframes": [5, 10]},
           "track_iters": [30, 20, 25, 25]}
    assert reader.read(ctx) == pytest.approx(expected)
    # A program whose summary has no paths, host times or reads: nothing.
    old = {k: {f: v[f] for f in ("n", "total_s", "mean_ms")} for k, v in ctx["sections"].items()}
    assert reader.read(dict(ctx, sections=old)) is None
    assert reader.read(dict(ctx, sections={})) is None


def test_counts_sum_by_path_on_the_host_and_on_the_device():
    live = torch.tensor(5)
    with P.span("frame"):
        with P.span("bin"):
            P.count("slab_live", live)
            P.count("slab_rows", 512)
        with P.span("kf.extend"):
            with P.span("bin") as closed:
                P.count("slab_live", torch.tensor(7, dtype=torch.int32))
                P.count("slab_rows", 1024)
            P.count("slab_live", torch.tensor(1), at=closed)   # at a closed span's path
        P.count("capacity_raise")
    s = P.summary()
    assert set(s) == {"frame", "bin", "kf.extend", "counters"}
    c = s["counters"]
    assert c["slab_live"]["paths"] == {"frame/bin/slab_live": {"n": 1, "value": 5},
                                       "frame/kf.extend/bin/slab_live": {"n": 2, "value": 8}}
    assert (c["slab_live"]["n"], c["slab_live"]["value"]) == (3, 13)
    assert c["slab_rows"]["value"] == 1536
    assert c["capacity_raise"] == {"n": 1, "value": 1,
                                   "paths": {"frame/capacity_raise": {"n": 1, "value": 1}}}
    assert int(live) == 5                       # the sum is kept apart from the caller's
    assert P.summary()["counters"]["slab_live"]["value"] == 13
    P.reset()
    assert P.summary() == {}


def test_tile_bin_counts_its_live_entries_and_slab_rows_in_its_span():
    """At the `bin` span's path, but after the span closed: the span times
    the binning alone."""
    g = torch.Generator().manual_seed(0)
    n = 64
    u, v = 64 * torch.rand(n, generator=g), 48 * torch.rand(n, generator=g)
    radius = 2 + 6 * torch.rand(n, generator=g)
    depth = 1 + torch.rand(n, generator=g)
    opened = []
    orig_count = P.count

    def spy(name, value=1, at=None):
        opened.append([sp.name for sp in P._stack()])
        return orig_count(name, value, at)

    with P.span("frame"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(binning, "count", spy)
            bins = binning.tile_bin(None, radius, depth, torch.ones(n, dtype=torch.bool), 64,
                                    48, tile_size=16, tile_capacity=128, max_dup=12,
                                    entry_capacity=12 * binning.SLAB, uv=(u, v))
    assert opened == [["frame"], ["frame"]]     # the bin span had closed
    s = P.summary()["counters"]
    assert s["slab_live"]["paths"] == {
        "frame/bin/slab_live": {"n": 1, "value": int(bins.counts.sum())}}
    assert s["slab_rows"]["paths"] == {"frame/bin/slab_rows": {"n": 1, "value": 12 * binning.SLAB}}
    assert 0 < int(bins.counts.sum()) and int(bins.overflow) == 0


def _counted_sections():
    """A window of 4 tracked frames and 2 keyframe events: its probe spans
    and its binnings' slab counts."""
    def counter(paths):
        return {"n": sum(p["n"] for p in paths.values()),
                "value": sum(p["value"] for p in paths.values()), "paths": paths}

    probe = {"frame/kf.optimize/probe": {"n": 4, "total_s": 0.2, "host_s": 0.2, "self_s": 0.2,
                                         "reads": 4, "read_s": 0.0},
             "frame/probe": {"n": 1, "total_s": 0.05, "host_s": 0.05, "self_s": 0.05,
                             "reads": 1, "read_s": 0.0}}
    live = counter({"frame/track.dispatch/bin/slab_live": {"n": 8, "value": 300},
                    "frame/kf.extend/bin/slab_live": {"n": 2, "value": 100},
                    "frame/kf.optimize/map.span/bin/slab_live": {"n": 4, "value": 500},
                    "refine/bin/slab_live": {"n": 1, "value": 900}})
    rows = counter({"frame/track.dispatch/bin/slab_rows": {"n": 8, "value": 3000},
                    "frame/kf.extend/bin/slab_rows": {"n": 2, "value": 1000},
                    "frame/kf.optimize/map.span/bin/slab_rows": {"n": 4, "value": 2000},
                    "refine/bin/slab_rows": {"n": 1, "value": 1000}})
    return {
        "track.dispatch": {"n": 4, "total_s": 2.0, "mean_ms": 500.0, "paths": {}},
        "probe": {"n": 5, "total_s": 0.25, "mean_ms": 50.0, "paths": probe},
        "counters": {"slab_live": live, "slab_rows": rows},
    }


@pytest.mark.parametrize("reader,expected", [
    (probe_ms, 1e3 * 0.25 / 2),                 # every probe span, a keyframe event
    (map_slab_fill, 100.0 * 600 / 3000),        # the slabs binned inside a kf.* span
    (track_slab_fill, 100.0 * 300 / 3000),      # the slabs binned inside track.dispatch
])
def test_probe_and_slab_fill_readers_on_a_hand_built_summary(reader, expected):
    ctx = {"sections": _counted_sections(), "window": {"keyframes": [5, 10]},
           "track_iters": [30, 20, 25, 25]}
    assert reader.read(ctx) == pytest.approx(expected)
    # A program without probe spans and slab counts: nothing.
    assert reader.read(dict(ctx, sections=_sections())) is None
    assert reader.read(dict(ctx, sections={})) is None


@pytest.mark.gpu
def test_span_on_the_card_returns_at_once_and_holds_the_stream_time():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the span's events time the card's stream")
    dev = torch.device("cuda")

    def sleep_ms(cycles):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    sleep_ms(20_000_000)                           # the clock up to its load
    cycles = int(20_000_000 * 60.0 / sleep_ms(20_000_000))   # about 60 ms
    torch.cuda.synchronize()
    P.reset()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    with P.span("frame", device=dev) as s:
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
    host = time.perf_counter() - t0
    assert host < 1e-3, f"the span returned after {1e3 * host:.3f} ms"
    summ = P.summary()
    inner = 1e-3 * a.elapsed_time(b)
    assert inner >= 0.045
    assert inner <= summ["frame"]["total_s"] < inner + 0.005
    assert s.total_s == summ["frame"]["total_s"]
    assert summ["frame"]["host_s"] < 1e-3
