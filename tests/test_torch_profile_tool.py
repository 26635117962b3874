"""``tools/profile`` (the JAX package's ``tools/profile.py``) and the traced
window it writes, on synthetic traces and stand-in profilers: the analysis
by family and group and by conv shape (rows that sum to their group), the
analysis of a directory without a card, and ``tools/trace.trace`` writing
the window's launch log beside its Chrome trace and retaking a window
whose kernels the log does not match."""

import json
import re
import types

import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler_util import Interval

from x3d_tpu_torch import ops, variant_config
from x3d_tpu_torch.tools import profile
from x3d_tpu_torch.tools import trace as trace_mod

K1_RING = "void (anonymous namespace)::dw_conv3d_fwd_ring_kernel<" \
    "__nv_bfloat16, 2, 3, 2>(...)"
K3_RING = "void (anonymous namespace)::dw_bn_act_conv_bwd_ring_kernel<" \
    "__nv_bfloat16, 2, 3>(...)"
K3_SUM = "(anonymous namespace)::dw_bn_act_conv_bwd_sum_kernel(float const*)"
K6_MMA = "void (anonymous namespace)::pw_act_conv_stats_mma_kernel<16, 8>()"
SUMS = "sum_partials_kernel(float const*, float*, int, int)"
ELEMENTWISE = "void at::native::vectorized_elementwise_kernel<4>(...)"


def _record(kernel, body, shape, direction):
    return {"kernel": kernel, "body": body, "shape": shape,
            "direction": direction, "dtype": "bfloat16", "bytes": 10**6,
            "flops": 10**6}


def _write_window(d, kernels, records):
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": dur,
               "pid": 0, "tid": 7} for n, ts, dur in kernels]
    (d / "trace.json").write_text(json.dumps({"traceEvents": events}))
    (d / "launches.json").write_text(json.dumps(records))
    return str(d)


@pytest.fixture
def window(tmp_path):
    """Two K3 launches at two shapes (ring body and its two sums), two K6
    launches (main and second pass), a K1 launch, elementwise work."""
    kernels = [(K1_RING, 0, 100), (ELEMENTWISE, 100, 50),
               (K6_MMA, 200, 300), (SUMS, 500, 20),
               (K6_MMA, 600, 200), (SUMS, 800, 10),
               (K3_RING, 1000, 700), (K3_SUM, 1700, 30), (K3_SUM, 1730, 20),
               (K3_RING, 2000, 400), (K3_SUM, 2400, 10), (K3_SUM, 2410, 5)]
    records = [_record("K1", "ring", {"taps": [3, 3, 3], "C": 108}, "fwd"),
               _record("K6", "pipe", {"M": 9, "K": 216, "N": 96}, "fwd"),
               _record("K6", "pipe", {"M": 9, "K": 432, "N": 192}, "fwd"),
               _record("K3", "ring", {"taps": [3, 3, 3], "C": 216}, "bwd"),
               _record("K3", "ring", {"taps": [3, 3, 3], "C": 432}, "bwd")]
    return _write_window(tmp_path, kernels, records)


def _sections(text):
    head, conv = text.split("=== the port's kernels by conv shape")
    groups = {}
    for ln in head.splitlines()[1:]:
        ms, fam, group = re.match(r"\s*([\d.]+)\s+(.+?)\s{2,}(.+)$",
                                  ln).groups()
        groups[group] = (fam, float(ms))
    shapes = [re.match(r"\s*([\d.]+)\s+(fwd|bwd)\s+(.+?)\s+\[(.+)\]$",
                       ln).groups() for ln in conv.splitlines()[1:]]
    return groups, shapes


def test_analyze_trace_shape_rows_sum_to_their_group(window):
    text = profile.analyze_trace(window)
    groups, shapes = _sections(text)
    # ms to two places, as the JAX tool prints them
    assert groups == {
        "K3 dw_bn_act_conv_bwd": ("port kernels", pytest.approx(1.165,
                                                                abs=0.006)),
        "K6 pw_act_conv_stats": ("port kernels", 0.5),
        "K1 depthwise_conv3d": ("port kernels", 0.1),
        "elementwise": ("elementwise", 0.05),
        "K2/K3/K5/K6 second passes": ("port kernels", 0.03)}
    assert [(d, s, g) for _, d, s, g in shapes] == [
        ("bwd", "dw k=333 C=216", "K3 dw_bn_act_conv_bwd"),
        ("bwd", "dw k=333 C=432", "K3 dw_bn_act_conv_bwd"),
        ("fwd", "pw io=216->96", "K6 pw_act_conv_stats"),
        ("fwd", "pw io=432->192", "K6 pw_act_conv_stats"),
        ("fwd", "dw k=333 C=108", "K1 depthwise_conv3d"),
        ("fwd", "pw io=216->96", "K2/K3/K5/K6 second passes"),
        ("fwd", "pw io=432->192", "K2/K3/K5/K6 second passes")]
    for group, (_, ms) in groups.items():
        rows = [float(m) for m, _, _, g in shapes if g == group]
        if group.startswith("K"):
            assert sum(rows) == pytest.approx(ms, abs=0.011), group


def test_analyze_only_needs_no_card(window, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile.main(["--analyze_only", window]) == 0
    assert capsys.readouterr().out == profile.analyze_trace(window) + "\n"


def test_analyze_without_a_trace(tmp_path):
    assert profile.analyze_trace(str(tmp_path)) == "no trace found"


def test_capture_needs_a_config_and_a_card(monkeypatch, tmp_path):
    with pytest.raises(SystemExit) as e:
        profile.main(["--trace_dir", str(tmp_path)])
    assert e.value.code == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile.capture(variant_config("M"), "train", 1, 1, str(tmp_path))


class _Profiler:
    """A stand-in for ``device_profiler``: each window's kernels, one list
    a window entered."""

    def __init__(self, windows, taken):
        self.windows, self.taken = windows, taken

    def __call__(self):
        return self

    def __enter__(self):
        names = self.windows[len(self.taken)]
        events = [types.SimpleNamespace(
            name=n, device_type=DeviceType.CUDA,
            time_range=Interval(10 * i, 10 * i + 5))
            for i, n in enumerate(names)]
        def export_chrome_trace(path):
            with open(path, "w") as f:
                json.dump({"traceEvents": [
                    {"ph": "X", "cat": "kernel", "name": e.name,
                     "ts": e.time_range.start, "dur": 5} for e in events]},
                    f)

        prof = types.SimpleNamespace(events=lambda: events,
                                     export_chrome_trace=export_chrome_trace)
        self.taken.append(prof)
        return prof

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("windows, lost", [
    # the first window lost K6's main kernel: traced again
    ([[K1_RING, ELEMENTWISE], [K1_RING, K6_MMA, SUMS]], 1),
    ([[K1_RING, K6_MMA, SUMS]], 0),
])
def test_trace_writes_the_launch_log_beside_its_window(
        monkeypatch, tmp_path, windows, lost):
    taken = []
    monkeypatch.setattr(trace_mod, "device_profiler",
                        _Profiler(windows, taken))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(trace_mod, "card", lambda: "NVIDIA H100, 700 W")
    monkeypatch.setattr(trace_mod.trace, "lost", 0)
    monkeypatch.setattr(trace_mod, "SETTLE_S", (0.0,))

    def run():
        # the launches a wrapper would log on the card
        if ops.records is not None:
            ops.records.append(_record("K1", "ring", {"taps": [3, 3, 3],
                                                      "C": 8}, "fwd"))
            ops.records.append(_record("K6", "pipe", {"M": 1, "K": 8,
                                                      "N": 8}, "fwd"))

    path = tmp_path / "trace.json"
    trace_mod.trace(run, 1, "step", group=trace_mod.port_group,
                    trace_path=str(path), warmup=1)
    assert len(taken) == len(windows) and trace_mod.trace.lost == lost
    assert [r["kernel"] for r in json.loads(
        (tmp_path / "launches.json").read_text())] == ["K1", "K6"]
    assert (tmp_path / "card.txt").read_text() == "NVIDIA H100, 700 W\n"
    assert profile.analyze_trace(str(tmp_path)).startswith("=== device")


def test_trace_raises_naming_the_groups_of_a_log_it_cannot_match(
        monkeypatch, tmp_path):
    monkeypatch.setattr(trace_mod, "device_profiler",
                        _Profiler([[ELEMENTWISE]] * 3, []))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(trace_mod.trace, "lost", 0)
    monkeypatch.setattr(trace_mod, "SETTLE_S", (0.0,))

    def run():
        if ops.records is not None:
            ops.records.append(_record("K6", "pipe", {"M": 1, "K": 8,
                                                      "N": 8}, "fwd"))

    with pytest.raises(trace_mod.LostTrace,
                       match=r"'K6 pw_act_conv_stats': \(0, 1\), \"window's "
                             r"first main kernel, log's first\": \(None, "
                             r"'K6 pw_act_conv_stats'\)"):
        trace_mod.trace(run, 1, "step", trace_path=str(tmp_path / "t.json"))
    assert not (tmp_path / "launches.json").exists()
