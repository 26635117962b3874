"""The port's spans (``ops.span`` under ``ops.span_log``): the engine's
request and the train step record their phases, nested and in order, one
call identifier a request or step; nothing is recorded with no log open;
spans and launch records are switched apart; the spans map onto a
``torch.profiler`` window's clock, on a card by anchors at both ends of
the window that follow a host clock drifting against the card's; the
loop's ``ProfileHook`` keeps them; and ``tools/trace.by_span``'s
arithmetic (host ms by span, device idle ms by the innermost span open) on
synthetic windows.  The tiny XS geometry of ``tests/test_torch_serving.py``
on the CPU, float32.

The ``cuda`` cases check the clock on the card: a span around a kernel
and a synchronize holds the kernel's device interval, and in traced
windows of X3D-M requests of 8 videos x 10 views every request's copy of
its clips starts inside its ``engine.upload`` and its last operation ends
inside its ``engine.fetch``.
"""

import json
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler_util import Interval

from x3d_tpu_torch import ops, variant_config
from x3d_tpu_torch.models import create_model
from x3d_tpu_torch.serving import InferenceEngine
from x3d_tpu_torch.tools import trace as trace_mod
from x3d_tpu_torch.train import create_train_state, make_train_step
from x3d_tpu_torch.train.hooks import ProfileHook

ENGINE = ["engine.request", "engine.convert", "engine.upload",
          "engine.forward", "engine.fetch"]
STEP = ["train.step", "train.forward", "train.backward", "train.optimizer"]


def _tiny():
    cfg = variant_config("XS")
    cfg.NETWORK.C1_CHANNELS = 4
    cfg.NETWORK.DEPTH_FACTOR = 0.34
    cfg.NETWORK.NUM_CLASSES = 7
    cfg.NETWORK.DROPOUT_RATE = 0.0
    cfg.DATA.TEMP_DURATION = 4
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.TEST.NUM_TEMPORAL_VIEWS = 2
    cfg.TEST.NUM_SPATIAL_CROPS = 1
    cfg.TRAIN.DATASET_SIZE = 8
    cfg.TRAIN.BATCH_SIZE = 2
    return cfg


@pytest.fixture(scope="module")
def engine():
    torch.set_num_threads(1)
    eng = InferenceEngine.random_init(_tiny(), max_videos=2,
                                      dtype=torch.float32, device="cpu")
    clips = np.random.default_rng(0).integers(0, 256, eng.clip_shape,
                                              dtype=np.uint8)
    return eng, clips


@pytest.fixture(scope="module")
def step():
    torch.set_num_threads(1)
    cfg = _tiny()
    model = create_model(cfg, dtype=torch.float32, device="cpu", seed=0)
    state = create_train_state(cfg, model)
    fn = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)
    g = torch.Generator().manual_seed(0)
    batch = {"video": torch.randn((2, 4, 32, 32, 3), generator=g),
             "label": torch.tensor([1, 5])}
    holder = {"state": state}

    def run():
        holder["state"], metrics = fn(holder["state"], batch,
                                      torch.Generator().manual_seed(0))
        return metrics

    return run


def _nested(records, names):
    """Each record's name in order, its parent the first, one call."""
    assert [r["name"] for r in records] == names
    root = records[0]
    assert root["parent"] is None and root["call"] == root["id"]
    for r in records[1:]:
        assert r["parent"] == root["id"] and r["call"] == root["id"]
    for r in records:
        assert root["start_ns"] <= r["start_ns"] <= r["end_ns"] \
            <= root["end_ns"]
    for a, b in zip(records[1:], records[2:]):
        assert a["end_ns"] <= b["start_ns"]


def test_request_makes_the_five_engine_spans_in_order(engine):
    eng, clips = engine
    with ops.span_log() as marks:
        eng.predict(clips)
    _nested(marks, ENGINE)


def test_request_span_carries_its_number_videos_and_clips(engine):
    eng, clips = engine
    with ops.span_log() as marks:
        eng.predict(clips)
        eng.predict(clips[:eng.views])
    roots = [r for r in marks if r["name"] == "engine.request"]
    assert [r["request"] for r in roots] == [roots[0]["request"],
                                             roots[0]["request"] + 1]
    assert [(r["videos"], r["clips"]) for r in roots] == \
        [(2, 2 * eng.views), (1, eng.views)]
    assert len({r["call"] for r in marks}) == 2


def test_refused_request_closes_its_spans(engine):
    eng, clips = engine
    with ops.span_log() as marks:
        with pytest.raises(ValueError, match="not divisible"):
            eng.predict(clips[:1])
        eng.predict(clips)
    assert [r["name"] for r in marks[:2]] == ENGINE[:2]
    assert all(r["end_ns"] is not None for r in marks)
    _nested(marks[2:], ENGINE)
    assert ops._open.stack == []


def test_train_step_makes_its_spans_without_a_reduce(step):
    with ops.span_log() as marks:
        step()
    _nested(marks, STEP)
    assert marks[0]["clips"] == 2 and marks[0]["step"] >= 0


def test_nothing_is_recorded_with_no_log_open(engine, step, monkeypatch):
    eng, clips = engine
    made = []
    monkeypatch.setattr(ops, "_Span",
                        lambda *a: made.append(a) or pytest.fail("a span"))
    assert ops.spans is None and ops.records is None
    eng.predict(clips)
    step()
    assert made == [] and ops._open.stack == []


def test_spans_and_launch_records_are_switched_apart(engine, step,
                                                     monkeypatch):
    eng, clips = engine
    with ops.launch_log() as records:
        assert ops.spans is None
        step()
        eng.predict(clips)
    assert records and all(r["body"] == "plain" for r in records)
    logged = []
    monkeypatch.setattr(ops, "log_launch", lambda *a: logged.append(a))
    with ops.span_log() as marks:
        assert ops.records is None
        step()
        eng.predict(clips)
    assert logged == [] and [r["name"] for r in marks] == STEP + ENGINE


def test_an_inner_log_hands_its_spans_to_the_outer():
    with ops.span_log() as outer:
        with ops.span("a"):
            with ops.span_log() as inner:
                with ops.span("b"):
                    pass
            assert [r["name"] for r in inner] == ["b"]
    assert [r["name"] for r in outer] == ["a", "b"]
    assert outer[1]["parent"] == outer[0]["id"]
    assert outer[1]["call"] == outer[0]["call"]


def test_a_span_in_another_thread_has_no_parent_here():
    got = []
    with ops.span_log() as marks:
        with ops.span("main"):
            t = threading.Thread(target=lambda: got.append(
                ops.span("other").__enter__()))
            t.start()
            t.join()
    other = next(r for r in marks if r["name"] == "other")
    assert other["parent"] is None and other["call"] == other["id"]
    assert got == [other]


def test_record_function_inside_a_span_maps_inside_it():
    """On a CPU profiler window, the host's spans land on the events'
    timeline: a ``record_function`` inside a span within 1 ms of it."""
    cpu = torch.profiler.ProfilerActivity.CPU
    with ops.span_log() as marks, \
            torch.profiler.profile(activities=[cpu]) as prof:
        for i in range(3):
            with ops.span(f"outer{i}"):
                time.sleep(0.003)
                with torch.autograd.profiler.record_function(f"inner{i}"):
                    torch.ones(256).sum()
                time.sleep(0.003)
    spans = trace_mod.span_times(prof, marks)
    assert [s["name"] for s in spans] == ["outer0", "outer1", "outer2"]
    for i, s in enumerate(spans):
        e = next(e for e in prof.events() if e.name == f"inner{i}")
        assert s["start_us"] - 1e3 <= e.time_range.start
        assert e.time_range.end <= s["end_us"] + 1e3
        # the sleeps on both sides keep it clear of the span's ends
        assert e.time_range.start - s["start_us"] > 2e3
        assert s["end_us"] - e.time_range.end > 2e3


def _span(name, start, end, depth=0, ident=0, parent=None):
    return {"name": name, "start_us": start, "end_us": end, "depth": depth,
            "id": ident, "parent": parent, "call": 0}


def _request(t, ident):
    """A request at ``t`` µs: convert 0-10, upload 10-40, forward 40-50,
    fetch 50-100, the request 0-102."""
    return [_span("engine.request", t, t + 102, 0, ident),
            _span("engine.convert", t, t + 10, 1, ident + 1, ident),
            _span("engine.upload", t + 10, t + 40, 1, ident + 2, ident),
            _span("engine.forward", t + 40, t + 50, 1, ident + 3, ident),
            _span("engine.fetch", t + 50, t + 100, 1, ident + 4, ident)]


def test_by_span_host_ms_and_idle_by_innermost_span():
    """Two requests, 200 µs apart; the device busy from 15 to 95 µs of
    each but for a gap from 60 to 70 in the fetch: idle in each request
    10 µs in convert (before the first copy), 5 in upload, 15 in fetch
    (the gap, then after the last kernel), 2 in the request's own time
    after the fetch; 98 between the requests (outside any span), which no
    engine row holds."""
    spans = _request(0, 0) + _request(200, 10)
    kernels = [(t + a, t + b) for t in (0, 200)
               for a, b in ((15, 60), (70, 95))]
    got = trace_mod.by_span(kernels, spans, 2, "request")
    host = got["span_host_ms_per_request"]
    assert host == pytest.approx({"engine.request": 0.102,
                                  "engine.convert": 0.010,
                                  "engine.upload": 0.030,
                                  "engine.forward": 0.010,
                                  "engine.fetch": 0.050})
    idle = got["span_idle_ms_per_request"]
    assert idle == pytest.approx({"engine.convert": 0.010,
                                  "engine.upload": 0.005,
                                  "engine.fetch": 0.005 + 0.010,
                                  "engine.request": 0.002,
                                  trace_mod.OUTSIDE: 0.098 / 2})
    inside = sum(v for k, v in idle.items() if k.startswith("engine."))
    assert inside == pytest.approx(0.032)


def test_by_span_counts_overlapping_kernels_once():
    spans = [_span("train.step", 0, 100), _span("train.forward", 0, 50, 1)]
    kernels = [(10, 40), (20, 60), (60, 70)]     # busy 10-70
    got = trace_mod.by_span(kernels, spans, 1, "step")
    assert got["span_idle_ms_per_step"] == pytest.approx(
        {"train.forward": 0.010, "train.step": 0.030})


def test_innermost_takes_the_deepest_then_the_latest():
    a = _span("a", 0, 10)
    b = _span("b", 2, 8, 1)
    c = _span("c", 4, 6, 1)
    assert trace_mod.innermost([a, b, c], 1)["name"] == "a"
    assert trace_mod.innermost([a, b, c], 3)["name"] == "b"
    assert trace_mod.innermost([a, b, c], 5)["name"] == "c"
    assert trace_mod.innermost([a, b, c], 10) is None


def test_span_times_maps_closed_spans_and_their_depth():
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(trace_start_ns=lambda: 10**6)))
    records = [{"name": "r", "id": 5, "parent": None, "call": 5,
                "start_ns": 10**6 + 2000, "end_ns": 10**6 + 9000},
               {"name": "c", "id": 6, "parent": 5, "call": 5,
                "start_ns": 10**6 + 3000, "end_ns": 10**6 + 4000},
               {"name": "open", "id": 7, "parent": 5, "call": 5,
                "start_ns": 10**6 + 5000, "end_ns": None}]
    got = trace_mod.span_times(prof, records)
    assert [(s["name"], s["start_us"], s["end_us"], s["depth"])
            for s in got] == [("r", 2.0, 9.0, 0), ("c", 3.0, 4.0, 1)]


def test_trace_writes_the_spans_into_its_chrome_trace(monkeypatch,
                                                      tmp_path):
    """A stand-in profiler whose Chrome trace puts its kernels 1000 µs
    after its events' timeline: the spans go in at the same offset, on a
    host thread of their own, and into ``spans.json``; the summary gains
    the host and idle ms by span."""
    import json

    class Profiler:
        def __enter__(self):
            self.t0 = time.time_ns()
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [types.SimpleNamespace(
                name="k", device_type=DeviceType.CUDA,
                time_range=Interval(100, 150))]

        @property
        def profiler(self):
            return types.SimpleNamespace(kineto_results=types.SimpleNamespace(
                trace_start_ns=lambda: self.t0))

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": [{"ph": "X", "cat": "kernel",
                                            "name": "k", "ts": 1100,
                                            "dur": 50}]}, f)

    monkeypatch.setattr(trace_mod, "device_profiler", Profiler)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(trace_mod, "card", lambda: "card")
    monkeypatch.setattr(trace_mod, "SETTLE_S", (0.0,))

    def run():
        with ops.span("engine.request"):
            with ops.span("engine.fetch"):
                pass

    path = tmp_path / "trace.json"
    got = trace_mod.trace(run, 1, "request", trace_path=str(path), warmup=0)
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert [s["name"] for s in spans] == ["engine.request", "engine.fetch"]
    events = json.loads(path.read_text())["traceEvents"]
    mine = [e for e in events if e.get("cat") == "span"]
    assert [e["name"] for e in mine] == ["engine.request", "engine.fetch"]
    for e, s in zip(mine, spans):
        assert e["ts"] == pytest.approx(s["start_us"] + 1000)
        assert e["dur"] == pytest.approx(s["end_us"] - s["start_us"])
        assert e["tid"] == "spans" and e["args"]["id"] == s["id"]
    assert set(got["span_host_ms_per_request"]) == {"engine.request",
                                                    "engine.fetch"}
    assert "span_idle_ms_per_request" in got


T0 = 10**12      # the stand-in profiler's trace_start_ns


def _clocked(device, drift_ppm, offset_us, groups, gap_us=4.0):
    """A stand-in profiler whose card timeline runs ``drift_ppm`` fast
    against the host's clock from ``offset_us`` at the trace's start, with
    ``device`` (name, host start µs, host end µs) operations and, for each
    group of host µs, an anchor each: its kernel starts ``gap_us`` after
    the host's first time and ends ``gap_us`` before the second.  Returns
    the profiler and the anchors as ``anchor`` gives them."""
    def card(h):
        return h + offset_us + h * drift_ppm * 1e-6

    events, anchors = [], []
    for name, a, b in device:
        events.append((name, card(a), card(b)))
    for group in groups:
        pairs = []
        for h in group:
            before, after = h, h + 2 * gap_us + 0.5
            events.append((trace_mod.ANCHOR + "(long)", card(before + gap_us),
                           card(after - gap_us)))
            pairs.append((T0 + int(before * 1e3), T0 + int(after * 1e3)))
        anchors.append(pairs)
    prof = types.SimpleNamespace(
        events=lambda: [types.SimpleNamespace(
            name=n, device_type=DeviceType.CUDA, time_range=Interval(a, b))
            for n, a, b in events],
        profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(
            trace_start_ns=lambda: T0)))
    return prof, anchors


def test_clock_follows_a_drifting_host_clock_between_its_anchors():
    """The card's timestamps 450 ppm fast and 30 µs ahead: anchors at 1 ms
    and 401 ms give back the drift and put a host instant 200 ms in within
    a µs of its place, where one offset at the trace's start misses by
    120 µs."""
    prof, anchors = _clocked([], 450, 30, [(1000, 1030, 1060),
                                           (401000, 401030, 401060)])
    to_us, read = trace_mod.clock(prof, anchors)
    assert read["clock_drift_ppm"] == pytest.approx(450, abs=0.1)
    assert read["clock_error_us"] == pytest.approx(4, abs=0.05)
    h = 200_000
    truth = h + 30 + h * 450e-6
    assert to_us(T0 + h * 1000) == pytest.approx(truth, abs=1.0)
    assert abs(trace_mod.clock(prof)[0](T0 + h * 1000) - truth) > 100


def test_span_times_by_anchors_hold_their_copy():
    """A copy issued 5 µs into a span 300 ms into a window whose card
    timestamps run 450 ppm slow lies in the span when mapped by the
    anchors, and before it by one offset."""
    h = 300_000
    prof, anchors = _clocked([("Memcpy HtoD (Pageable -> Device)", h + 5,
                               h + 40)], -450, 0, [(1000,), (400_000,)])
    records = [{"name": "engine.upload", "id": 0, "parent": None, "call": 0,
                "start_ns": T0 + h * 1000, "end_ns": T0 + (h + 50) * 1000}]
    copy = trace_mod.device_events(prof)[0]
    by_anchor = trace_mod.span_times(prof, records, anchors)[0]
    assert by_anchor["start_us"] < copy.time_range.start \
        < copy.time_range.end < by_anchor["end_us"]
    one = trace_mod.span_times(prof, records)[0]
    assert copy.time_range.start < one["start_us"]


def test_clock_raises_lost_trace_without_its_anchors():
    prof, anchors = _clocked([("k", 0, 10)], 0, 0, [(1000,), (2000,)])
    anchors[1].append((T0 + 3_000_000, T0 + 3_000_010))
    with pytest.raises(trace_mod.LostTrace, match="2 anchor kernels"):
        trace_mod.clock(prof, anchors)


def test_anchors_are_no_operations_of_the_window():
    """The summary, the device events and the span summary leave the
    anchors' kernels out: two operations of 10 µs, 10 µs apart."""
    prof, anchors = _clocked([("k", 100, 110), ("k", 120, 130)], 0, 0,
                             [(0,), (1000,)])
    assert [e.name for e in trace_mod.device_events(prof)] == ["k", "k"]
    got = trace_mod.summarize(prof, 1, "call")
    assert got["kernels_per_call"] == 2.0
    assert got["idle_share"] == pytest.approx(1 / 3, abs=1e-3)
    records = [{"name": "s", "id": 0, "parent": None, "call": 0,
                "start_ns": T0 + 90_000, "end_ns": T0 + 140_000}]
    spans, keys = trace_mod.span_summary(prof, records, anchors, 1, "call")
    assert keys["span_idle_ms_per_call"] == pytest.approx(
        {"s": 0.030}, abs=1e-4)
    assert keys["clock_drift_ppm"] == pytest.approx(0, abs=1)


def test_profile_hook_writes_the_steps_spans(step, monkeypatch, tmp_path):
    """The loop's profile hook, one step in its window (a stand-in for the
    device profiler): the step's spans go into its summary (host and idle
    ms a step by span), its Chrome trace and ``_spans.json``."""
    class Profiler:
        def start(self):
            self.t0 = time.time_ns()

        def stop(self):
            pass

        def events(self):
            return [types.SimpleNamespace(name="k",
                                          device_type=DeviceType.CUDA,
                                          time_range=Interval(0, 10))]

        @property
        def profiler(self):
            return types.SimpleNamespace(kineto_results=types.SimpleNamespace(
                trace_start_ns=lambda: self.t0))

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": [{"ph": "X", "cat": "kernel",
                                            "name": "k", "ts": 500,
                                            "dur": 10}]}, f)

    monkeypatch.setattr(trace_mod, "device_profiler", Profiler)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    hook = ProfileHook(str(tmp_path), 3)
    hook.on_step(2, {})
    assert ops.spans is not None
    step()
    hook.on_step(3, {})
    assert ops.spans is None
    summary = json.loads((tmp_path / "profile_step3_summary.json")
                         .read_text())
    assert sorted(summary["span_host_ms_per_step"]) == sorted(STEP)
    assert summary["span_host_ms_per_step"]["train.step"] > 0
    assert "span_idle_ms_per_step" in summary
    spans = json.loads((tmp_path / "profile_step3_spans.json").read_text())
    assert [s["name"] for s in spans] == STEP
    events = json.loads((tmp_path / "profile_step3.json").read_text())
    assert [e["name"] for e in events["traceEvents"]
            if e.get("cat") == "span"] == STEP


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _device_ops(prof):
    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


@pytest.mark.cuda
def test_span_holds_its_kernel_on_the_device_clock(cuda):
    """Three spans, each around a product of two 8192-square matrices and
    a synchronize, in a window mapped by its anchors: every device
    operation (the product's kernel, and cuBLAS's memset of its
    workspace) lies inside a span, and each span holds one."""
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    a @ a
    torch.cuda.synchronize()
    with ops.span_log() as marks, trace_mod.device_profiler() as prof:
        time.sleep(0.05)
        anchors = [trace_mod.anchor()]
        for _ in range(3):
            with ops.span("product"):
                a @ a
                torch.cuda.synchronize()
            time.sleep(0.01)
        anchors.append(trace_mod.anchor())
        time.sleep(0.05)
    spans = trace_mod.span_times(prof, marks, anchors)
    kernels = trace_mod.device_events(prof)
    assert len(spans) == 3 and kernels
    for k in kernels:
        assert any(s["start_us"] <= k.time_range.start
                   and k.time_range.end <= s["end_us"] for s in spans), \
            (k.name, k.time_range.start, k.time_range.end, spans)
    for s in spans:
        assert any(s["start_us"] <= k.time_range.start < s["end_us"]
                   for k in kernels), s


@pytest.mark.cuda
def test_serving_windows_put_copies_in_upload_and_the_end_in_fetch(cuda):
    """X3D-M, requests of 8 videos x 10 views of uint8 clips from host
    memory, in 3 traced windows of 4 requests each, the spans mapped by the
    window's anchors: every request's copy of its clips (its first
    host-to-device copy) starts inside its ``engine.upload`` and any other
    inside its ``engine.forward`` (the normalise's mean and std, which
    ``utils.normalize`` puts on the device at each call), the last of the
    operations that start inside the request ends inside its
    ``engine.fetch``, every request holds as many operations, and the
    request's own time outside its four children is under 0.3 ms.  No
    window is taken again: one whose operations fall outside their
    request fails the test, which prints each window's clock."""
    eng = InferenceEngine.random_init(variant_config("M"), max_videos=8,
                                      seed=0)
    clips = np.random.default_rng(0).integers(0, 256, eng.clip_shape,
                                              dtype=np.uint8)
    for _ in range(2):
        eng.predict(clips)
    torch.cuda.synchronize()
    problems, clocks = [], []
    for window in range(3):
        with ops.span_log() as marks, trace_mod.device_profiler() as prof:
            time.sleep(trace_mod.SETTLE_S[0])
            anchors = [trace_mod.anchor()]
            for _ in range(4):
                eng.predict(clips)
            anchors.append(trace_mod.anchor())
            time.sleep(trace_mod.SETTLE_S[0])
        clocks.append(trace_mod.clock(prof, anchors)[1])
        spans = trace_mod.span_times(prof, marks, anchors)
        device = trace_mod.device_events(prof)
        requests = [s for s in spans if s["name"] == "engine.request"]
        assert len(requests) == 4
        mine = {r["id"]: [e for e in device if r["start_us"]
                          <= e.time_range.start < r["end_us"]]
                for r in requests}
        if len({len(m) for m in mine.values()}) != 1 \
                or sum(map(len, mine.values())) != len(device):
            problems.append((window, "operations a request",
                             [len(m) for m in mine.values()], len(device)))
        for req in requests:
            where = (window, req["request"])
            kids = {s["name"]: s for s in spans if s["parent"] == req["id"]}
            assert sorted(kids) == sorted(ENGINE[1:])
            up, fwd = kids["engine.upload"], kids["engine.forward"]
            fetch = kids["engine.fetch"]
            copies = [e for e in mine[req["id"]] if "HtoD" in e.name]
            if not copies:
                problems.append((where, "no copy"))
                continue
            start = copies[0].time_range.start
            if not up["start_us"] <= start < up["end_us"]:
                problems.append((where, "clips' copy", start - up["start_us"],
                                 up["end_us"] - up["start_us"]))
            for e in copies[1:]:
                if not fwd["start_us"] <= e.time_range.start < fwd["end_us"]:
                    problems.append((where, "another copy",
                                     e.time_range.start - fwd["start_us"]))
            last = max(e.time_range.end for e in mine[req["id"]])
            if not fetch["start_us"] <= last <= fetch["end_us"]:
                problems.append((where, "last operation",
                                 last - fetch["start_us"],
                                 fetch["end_us"] - fetch["start_us"]))
            own = (req["end_us"] - req["start_us"]) - sum(
                k["end_us"] - k["start_us"] for k in kids.values())
            if own >= 300:
                problems.append((where, "own µs", own))
    print("clocks", clocks)
    assert problems == [], (problems, clocks)
