"""The kernels' launch log and ``tools/roofline`` against the JAX package.

* ``aggregate`` and ``report`` equal the JAX tool's on the JAX tool's own
  synthetic events (its three tests as cases), at the same peaks;
* ``load_device_events`` on a synthetic Chrome trace and launch log gives
  a launch's bytes and operations to its main kernel only and raises,
  naming the group, where main kernels and records differ in number; a
  kernel above 105% of a peak is marked and ``main`` exits 1;
* the wrappers' cost functions, summed over an X3D-M training step's
  shapes at 32 clips (enumerated from ``build_arch``), give PERF.md's
  bound column within 1%, and the same enumeration equals the log of a
  tiny training step on the CPU record for record;
* a tiny CPU training step under ``ops.launch_log()`` logs K1-K8 once a
  wrapper call, as often as the launch plan of remat off / block / convs
  says, and a log nested in another hands its records on.
"""

import collections
import json
import math
import re

import pytest
import torch

import chip_smoke
from x3d_tpu.tools import roofline as jax_roofline
from x3d_tpu_torch import ops, variant_config
from x3d_tpu_torch.data import synthetic_batches
from x3d_tpu_torch.models import build_arch, create_model
from x3d_tpu_torch.ops import depthwise, dw_fused, pointwise, pw_stats
from x3d_tpu_torch.tools import roofline
from x3d_tpu_torch.train import create_train_state, make_train_step

F32_KERNELS = ("K1", "K2", "K3", "K4 dx", "K4 dk", "K8")


def _event(name, dur_us, bytes_, flops, cat="convolution fusion"):
    return {"ph": "X", "name": name, "dur": dur_us,
            "args": {"hlo_category": cat, "bytes_accessed": str(bytes_),
                     "model_flops": str(flops), "source": "", "tf_op": ""}}


@pytest.mark.parametrize("events, kw", [
    # test_aggregate_sums_calls
    ([_event("f.1", 1000, 10**9, 10**9), _event("f.1", 1000, 10**9, 10**9),
      _event("f.2", 500, 2 * 10**9, 0, cat="loop fusion")],
     {"hbm_gbps": 819.0, "peak_tflops": 394.0}),
    # test_report_bandwidth_math: 1 GB in 2 ms at a 1000 GB/s peak
    ([_event("op", 2000, 10**9, 0)],
     {"top": 5, "hbm_gbps": 1000.0, "peak_tflops": 100.0}),
    # test_report_handles_zero_bytes
    ([_event("cc", 100, 0, 0, cat="custom-call")],
     {"hbm_gbps": 819.0, "peak_tflops": 394.0}),
], ids=["aggregate_sums_calls", "report_bandwidth_math",
        "report_handles_zero_bytes"])
def test_aggregate_and_report_match_jax(events, kw):
    agg = roofline.aggregate(events)
    assert agg == jax_roofline.aggregate(events)
    want = jax_roofline.report(jax_roofline.aggregate(events), **kw)
    got = roofline.report(agg, **kw)
    number = re.compile(r"\d+\.?\d*")
    assert number.findall(got) == number.findall(want)
    # the port marks a row above 105% of a peak (here f.1's and f.2's)
    rows = [ln for ln in want.splitlines() if "[" in ln or "(" in ln[:20]]
    got_rows = [ln.removesuffix(" !") for ln in got.splitlines()]
    assert rows and all(ln in got_rows for ln in rows)


def _kernel(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7}


def _record(kernel, body, shape, direction, nbytes, flops):
    return {"kernel": kernel, "body": body, "shape": shape,
            "direction": direction, "dtype": "bfloat16", "bytes": nbytes,
            "flops": flops}


K2_RING = "void (anonymous namespace)::dw_bn_act_conv_fwd_ring_kernel<" \
    "__nv_bfloat16, 2, 3>(...)"
K2_SUM = "(anonymous namespace)::dw_bn_act_conv_fwd_sum_kernel(float const*)"
K5_MMA = "void (anonymous namespace)::pw_conv_stats_mma_kernel<16, 24>(...)"
SUMS = "sum_partials_kernel(float const*, float*, int, int)"
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n"
K7_WG = "void (anonymous namespace)::pw_conv_wg_kernel<96, 2>(...)"


def _window(tmp_path, kernels, records, card="NVIDIA H100 80GB HBM3, 700 W"):
    host = {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
            "dur": 9, "pid": 1, "tid": 1}
    (tmp_path / "trace.json").write_text(json.dumps(
        {"traceEvents": [host] + kernels}))
    (tmp_path / "launches.json").write_text(json.dumps(records))
    (tmp_path / "card.txt").write_text(card + "\n")
    return str(tmp_path)


def _k2_k5_window(tmp_path, extra_kernels=(), extra_records=()):
    # trace events out of time order: the loader sorts them
    kernels = [_kernel(K5_MMA, 50, 10), _kernel(SUMS, 61, 2),
               _kernel(K2_RING, 10, 30), _kernel(K2_SUM, 41, 1),
               _kernel(GEMM, 70, 5),
               _kernel("Memcpy DtoD (Device -> Device)", 80, 3,
                       cat="gpu_memcpy"), *extra_kernels]
    records = [_record("K2", "ring", {"taps": [3, 3, 3], "C": 192}, "fwd",
                       67_000_000, 1_000_000_000),
               _record("K5", "pipe", {"M": 100, "K": 192, "N": 432}, "fwd",
                       3_350_000, 200_000_000), *extra_records]
    return _window(tmp_path, kernels, records)


def test_load_device_events_gives_costs_to_main_kernels(tmp_path):
    events = roofline.load_device_events(_k2_k5_window(tmp_path))
    assert [e["ts"] for e in events] == sorted(e["ts"] for e in events)
    got = {e["name"]: (e["args"]["hlo_category"],
                       e["args"]["bytes_accessed"],
                       e["args"]["model_flops"]) for e in events}
    assert got == {
        K2_RING: ("K2 dw_bn_act_conv", 67_000_000, 1_000_000_000),
        K2_SUM: ("K2 dw_bn_act_conv", 0, 0),
        K5_MMA: ("K5 pw_conv_stats", 3_350_000, 200_000_000),
        SUMS: ("K2/K3/K5/K6 second passes", 0, 0),
        GEMM: ("gemm", 0, 0),
        "Memcpy DtoD (Device -> Device)": ("copy", 0, 0)}
    by_name = {e["name"]: e["args"] for e in events}
    # a second pass belongs to the launch before it
    assert by_name[K2_SUM]["shape"] == by_name[K2_RING]["shape"] \
        == "dw k=333 C=192"
    assert by_name[SUMS]["shape"] == "pw io=192->432"
    assert by_name[K2_SUM]["main"] is False and by_name[K5_MMA]["main"]
    assert "shape" not in by_name[GEMM]
    groups = roofline.groups(events)
    assert groups["K2 dw_bn_act_conv"]["launches"] == 1
    assert groups["K2 dw_bn_act_conv"]["ms"] == pytest.approx(0.031)
    # 67 MB at 3350 GB/s: 0.02 ms; 1 GFLOP at 67 TFLOP/s: 0.0149 ms
    assert groups["K2 dw_bn_act_conv"]["bound_ms"] == pytest.approx(0.02)
    assert groups["K2 dw_bn_act_conv"]["bound_by"] == "bytes"
    # 3.35 MB: 0.001 ms of the main kernel's 0.01 (its second pass lies
    # in a group of its own)
    assert groups["K5 pw_conv_stats"]["share"] == pytest.approx(0.1)


@pytest.mark.parametrize("extra_kernels, extra_records, group", [
    ((), [_record("K7", "wg", {"M": 1, "K": 8, "N": 8}, "bwd", 1, 1)],
     "K7 pw_conv: 0 against 1"),
    ([_kernel(K5_MMA, 90, 10)], (), "K5 pw_conv_stats: 2 against 1"),
    ([_kernel(K7_WG, 90, 10)], (), "K7 pw_conv: 1 against 0"),
])
def test_load_device_events_raises_on_a_count_mismatch(
        tmp_path, extra_kernels, extra_records, group):
    d = _k2_k5_window(tmp_path, extra_kernels, extra_records)
    with pytest.raises(roofline.MismatchedLog, match=group):
        roofline.load_device_events(d)


def test_plain_records_and_second_passes_are_not_matched(tmp_path):
    """Records of plain versions (no kernel) are left out; a second pass
    alone is not a launch."""
    d = _k2_k5_window(tmp_path, [_kernel(SUMS, 90, 1)], [
        _record("K1", "plain", {"taps": [3, 3, 3], "C": 8}, "fwd", 1, 1)])
    assert len(roofline.load_device_events(d)) == 7


def test_report_marks_a_row_above_the_peak_and_main_exits_1(tmp_path,
                                                              capsys):
    d = _window(tmp_path, [_kernel(K7_WG, 0, 10)], [
        _record("K7", "wg", {"M": 10, "K": 8, "N": 8}, "fwd", 4e7, 1)])
    assert roofline.main(["--trace_dir", d]) == 1
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "card: NVIDIA H100 80GB HBM3, 700 W"
    row = next(ln for ln in out.splitlines() if "[K7 pw_conv] void" in ln)
    # 40 MB in 10 us: 4000 GB/s, 119% of 3350
    assert row.endswith(" !") and "  119 " in row
    assert roofline.main(["--trace_dir", d, "--hbm_gbps", "4200"]) == 0
    assert " !" not in capsys.readouterr().out


def _step_launches(cfg, clips, elem):
    """(kernel, direction, shape, (bytes, flops)) of every wrapper call in
    one training step without remat of ``cfg``'s model at ``clips``
    clips of ``elem``-byte activations, from its architecture plan."""
    arch = build_arch(cfg)
    T, B = cfg.DATA.TEMP_DURATION, clips
    H = -(-cfg.DATA.TRAIN_CROP_SIZE // 2)
    out = []

    def dw(kernel, direction, x, kdims, cost):
        out.append((kernel, direction, {"taps": list(kdims), "C": x[-1]},
                    cost))

    def gemm(kernel, M, K, N, cost):
        out.append((kernel, "fwd", {"M": M, "K": K, "N": N}, cost))

    def k7(M, K, N):
        gemm("K7", M, K, N, pointwise.cost(M, K, N, elem))
        out.append(("K7", "bwd", {"M": M, "K": N, "N": K},
                    pointwise.cost(M, N, K, elem)))

    kt, taps = arch.temp_filter, (arch.temp_kernel, 3, 3)
    x = (B, T, H, H, arch.conv1_dim)
    dw("K1", "fwd", x, (kt, 1, 1), depthwise.fwd_cost(x, x, (kt, 1, 1),
                                                      elem))
    if T >= kt:
        dw("K8", "bwd", x, (kt, 1, 1), depthwise.pbwd_cost(x, (kt, 1, 1),
                                                           elem))
    else:
        for k in ("K4 dx", "K4 dk"):
            dw(k, "bwd", x, (kt, 1, 1), depthwise.bwd_cost(x, x, (kt, 1, 1),
                                                           elem))
    for blocks in arch.stages:
        for sp in blocks:
            cin, mid, cout = sp.in_channels, sp.inner_channels, \
                sp.out_channels
            if sp.stride == 2:
                Ho = -(-H // 2)
                k7(B * T * H * H, cin, mid)
                xi, y = (B, T, H, H, mid), (B, T, Ho, Ho, mid)
                dw("K1", "fwd", xi, taps, depthwise.fwd_cost(xi, y, taps,
                                                             elem))
                for k in ("K4 dx", "K4 dk"):
                    dw(k, "bwd", xi, taps, depthwise.bwd_cost(xi, y, taps,
                                                              elem))
                k7(B * T * Ho * Ho, mid, cout)
                k7(B * T * Ho * Ho, cin, cout)
                H = Ho
            else:
                M, xi = B * T * H * H, (B, T, H, H, mid)
                gemm("K5", M, cin, mid,
                     pw_stats.conv_stats_cost(M, cin, mid, B, elem))
                dw("K2", "fwd", xi, taps, dw_fused.fwd_cost(xi, taps, elem))
                dw("K3", "bwd", xi, taps, dw_fused.bwd_cost(xi, taps, elem))
                gemm("K6", M, mid, cout,
                     pw_stats.act_conv_stats_cost(M, mid, cout, B, elem))
    k7(B * T * H * H, arch.stages[-1][-1].out_channels, arch.conv5_dim)
    return out


def test_cost_functions_give_the_step_bound_of_perf_md():
    """X3D-M, bfloat16, 32 clips: each kernel's least time a step (the
    larger of its bytes at 3.35 TB/s and its operations at 67 TFLOP/s on
    the CUDA cores or 989 TFLOP/s on the tensor cores, a launch at a time)
    within 1% of PERF.md section 6's bound column, over the launches the
    plan counts."""
    total, launches = collections.Counter(), collections.Counter()
    for kernel, _, _, (nbytes, flops) in _step_launches(
            variant_config("M"), 32, 2):
        rate = roofline.PEAK_TFLOPS_F32 if kernel in F32_KERNELS \
            else roofline.PEAK_TFLOPS
        total[kernel] += max(nbytes / (roofline.HBM_GBPS * 1e9),
                             flops / (rate * 1e12)) * 1e3
        launches[kernel] += 1
    want = chip_smoke.want_step_of(build_arch(variant_config("M")), True,
                                   "off")
    assert {k: launches[k] for k in chip_smoke.STEP_BOUND_MS} == \
        {k: want[k] for k in chip_smoke.STEP_BOUND_MS}
    for kernel, bound_ms in chip_smoke.STEP_BOUND_MS.items():
        assert total[kernel] == pytest.approx(bound_ms, rel=0.01), kernel


def _tiny_cfg(T=6):
    cfg = variant_config("S")
    cfg.merge_from_list(["NETWORK.C1_CHANNELS", 4,
                         "NETWORK.DEPTH_FACTOR", 0.34,
                         "DATA.TEMP_DURATION", T, "DATA.TRAIN_CROP_SIZE", 32])
    return cfg


def _tiny_step(cfg, remat):
    torch.set_num_threads(1)
    model = create_model(cfg, dtype=torch.float32, device="cpu",
                         remat=remat)
    state = create_train_state(cfg, model)
    step = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)
    batch = next(synthetic_batches(cfg, 2, dtype=torch.float32,
                                   device="cpu"))
    with ops.launch_log() as log:
        step(state, batch, torch.Generator().manual_seed(0))
    return model, log


def _key(kernel, direction, shape, nbytes, flops):
    return (kernel, direction,
            tuple((k, tuple(v) if isinstance(v, list) else v)
                  for k, v in sorted(shape.items())), nbytes, flops)


@pytest.mark.parametrize("T", [6, 4])
def test_the_step_enumeration_equals_a_tiny_steps_log(T):
    """The enumeration behind the bound test, at a tiny config: the log of
    a float32 CPU step holds the same calls (T = 4 < 5 taps: the stem's
    backward by K4)."""
    cfg = _tiny_cfg(T)
    _, log = _tiny_step(cfg, "off")
    assert {r["body"] for r in log} == {"plain"}
    assert {r["dtype"] for r in log} == {"float32"}
    got = collections.Counter(_key(r["kernel"], r["direction"], r["shape"],
                                   r["bytes"], r["flops"]) for r in log)
    want = collections.Counter(_key(k, d, s, *c)
                               for k, d, s, c in _step_launches(cfg, 2, 4))
    assert got == want


# the wrappers and the modules whose callers reach them by name
_WRAPPERS = {"K1": (depthwise, "depthwise_conv3d"),
             "K2": (dw_fused, "dw_bn_act_conv"),
             "K3": (dw_fused, "dw_bn_act_conv_bwd"),
             "K4 dx": (depthwise, "depthwise_conv3d_dx"),
             "K4 dk": (depthwise, "depthwise_conv3d_dk"),
             "K5": (pw_stats, "pw_conv_stats"),
             "K6": (pw_stats, "pw_act_conv_stats"),
             "K7": (pointwise, "pw_conv"),
             "K8": (depthwise, "depthwise_conv3d_pbwd")}


@pytest.mark.parametrize("remat", ["off", "block", "convs"])
def test_a_tiny_step_logs_every_wrapper_call(monkeypatch, remat):
    """Each of K1-K8 is logged once a call of its wrapper (counted by a
    spy around it), in the numbers the launch plan gives a step: "block"
    runs the blocks' forward kernels again, "convs" keeps their outputs
    (the x3d:: ops reach the wrappers once, in the forward pass)."""
    calls = collections.Counter()
    for kernel, (module, name) in _WRAPPERS.items():
        wrapped = getattr(module, name)

        def spy(*args, _k=kernel, _f=wrapped, **kw):
            calls[_k] += 1
            return _f(*args, **kw)

        monkeypatch.setattr(module, name, spy)
    cfg = _tiny_cfg()
    model, log = _tiny_step(cfg, remat)
    assert model.remat == remat
    logged = collections.Counter(r["kernel"] for r in log)
    want = chip_smoke.want_step_of(build_arch(cfg), True, remat)
    assert dict(logged) == dict(calls) == {k: want[k] for k in _WRAPPERS}
    directions = {(r["kernel"], r["direction"]) for r in log}
    assert directions == {("K1", "fwd"), ("K2", "fwd"), ("K3", "bwd"),
                          ("K4 dx", "bwd"), ("K4 dk", "bwd"), ("K5", "fwd"),
                          ("K6", "fwd"), ("K7", "fwd"), ("K7", "bwd"),
                          ("K8", "bwd")}


def test_no_log_open_and_nested_logs():
    x = torch.randn(1, 3, 4, 4, 2)
    k = torch.randn(3, 3, 3, 1, 2)
    assert ops.records is None
    depthwise.depthwise_conv3d(x, k)                 # no log: no record
    with ops.launch_log() as outer:
        depthwise.depthwise_conv3d(x, k)
        with ops.launch_log() as inner:
            pointwise.pw_conv(x, torch.randn(5, 2))
        assert [r["kernel"] for r in inner] == ["K7"]
    assert ops.records is None
    assert [r["kernel"] for r in outer] == ["K1", "K7"]
    assert outer[0]["shape"] == {"taps": [3, 3, 3], "C": 2}
    assert (outer[0]["bytes"], outer[0]["flops"]) == depthwise.fwd_cost(
        x.shape, x.shape, (3, 3, 3), 4)
    assert math.prod(outer[1]["shape"].values()) == 48 * 2 * 5
