"""The profile tools' kernel grouping: each of the port's CUDA kernels, by
the name of its ``__global__`` function as the profiler reports it, and
the library's kernel families land in their group; the trace's summary and
its retakes of windows the profiler lost, on stand-in profilers; and, on
the card, K7's per-case rows timed with CUDA events where the profiler
loses them."""

import json
import types

import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler_util import Interval

from x3d_tpu_torch.tools import profile_pointwise, profile_training
from x3d_tpu_torch.tools import trace as trace_mod
from x3d_tpu_torch.tools.trace import LostTrace, family, summarize


@pytest.mark.parametrize("name, want", [
    ("void dw_conv3d_fwd_kernel<float>(float const*, float const*)",
     "port kernels"),
    ("void dw_bn_act_conv_fwd_kernel<__nv_bfloat16>(...)", "port kernels"),
    ("sum_partials_kernel(float const*, float*, int, int)", "port kernels"),
    ("void (anonymous namespace)::dw_bn_act_conv_fwd_ring_kernel<"
     "__nv_bfloat16, 2, 3>(...)", "port kernels"),
    ("(anonymous namespace)::dw_bn_act_conv_fwd_sum_kernel(float const*, "
     "float*, float const*, float*, int, int)", "port kernels"),
    ("void pw_conv_kernel<float>(...)", "port kernels"),
    ("(anonymous namespace)::pw_conv_mma_kernel(__nv_bfloat16 const*, ...)",
     "port kernels"),
    ("void dw_conv3d_pbwd_kernel<float>(...)", "port kernels"),
    ("void (anonymous namespace)::dw_conv3d_dx_phase_kernel<__nv_bfloat16, "
     "2, 3>(...)", "port kernels"),
    ("sum_pbwd_partials_kernel(float const*, float*, int, int, int)",
     "port kernels"),
    ("void (anonymous namespace)::dw_conv3d_pbwd_temporal_kernel<float, "
     "4, 3>(...)", "port kernels"),
    ("(anonymous namespace)::dw_conv3d_pbwd_sum_kernel(float const*, "
     "float*, int, int)", "port kernels"),
    ("void (anonymous namespace)::dw_conv3d_dk_ring_kernel<__nv_bfloat16, "
     "2, 3, 2>(...)", "port kernels"),
    ("(anonymous namespace)::dw_conv3d_dk_sum_kernel(float const*, float*, "
     "int, int)", "port kernels"),
    ("void pw_stats_kernel<float, false>(...)", "port kernels"),
    ("void (anonymous namespace)::pw_conv_stats_mma_kernel<16, 24>(...)",
     "port kernels"),
    ("void (anonymous namespace)::pw_act_conv_stats_mma_kernel<4, 8>(...)",
     "port kernels"),
    ("void (anonymous namespace)::pw_conv_mma_kernel<8, 16>(...)",
     "port kernels"),
    ("void (anonymous namespace)::pw_conv_wg_kernel<216, 1>(CUtensorMap_st, "
     "...)", "port kernels"),
    ("void fma_chain_bf16_kernel<8>(...)", "port kernels"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "gemm"),
    ("void cudnn::ops::convolve_kernel<...>", "cudnn conv"),
    ("void at::native::reduce_kernel<512, 1>(...)", "reduction"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4>(...)",
     "elementwise"),
    ("some_unknown_kernel", "other"),
    ("void (anonymous namespace)::clip_prep_kernel<__nv_bfloat16>(...)",
     "input"),
    ("void nvjpeg::DecodeBatchedKernel<...>(...)", "input"),
])
def test_family(name, want):
    assert family(name) == want


@pytest.mark.parametrize("name, want", [
    ("void dw_conv3d_fwd_kernel<__nv_bfloat16>(...)", "K1 depthwise_conv3d"),
    ("void (anonymous namespace)::dw_conv3d_fwd_temporal_kernel<"
     "__nv_bfloat16, 8, 5>(...)", "K1 depthwise_conv3d"),
    ("void (anonymous namespace)::dw_conv3d_fwd_ring_kernel<__nv_bfloat16, "
     "2, 3, 2>(...)", "K1 depthwise_conv3d"),
    ("void dw_bn_act_conv_fwd_kernel<__nv_bfloat16>(...)",
     "K2 dw_bn_act_conv"),
    ("void (anonymous namespace)::dw_bn_act_conv_fwd_ring_kernel<"
     "__nv_bfloat16, 2, 3>(...)", "K2 dw_bn_act_conv"),
    ("(anonymous namespace)::dw_bn_act_conv_fwd_sum_kernel(float const*, "
     "float*, float const*, float*, int, int)", "K2 dw_bn_act_conv"),
    ("void dw_bn_act_conv_bwd_kernel<__nv_bfloat16>(...)",
     "K3 dw_bn_act_conv_bwd"),
    ("void (anonymous namespace)::dw_bn_act_conv_bwd_ring_kernel<"
     "__nv_bfloat16, 2, 3>(...)", "K3 dw_bn_act_conv_bwd"),
    ("(anonymous namespace)::dw_bn_act_conv_bwd_sum_kernel(float const*, "
     "float*, float const*, float*, int, int)", "K3 dw_bn_act_conv_bwd"),
    ("void dw_conv3d_dx_kernel<__nv_bfloat16>(...)",
     "K4 depthwise_conv3d_dx"),
    ("void (anonymous namespace)::dw_conv3d_dx_phase_kernel<__nv_bfloat16, "
     "2, 3>(...)", "K4 depthwise_conv3d_dx"),
    ("void dw_conv3d_dk_kernel<__nv_bfloat16>(...)",
     "K4 depthwise_conv3d_dk"),
    ("sum_dk_partials_kernel(float const*, float*, int, int)",
     "K4 depthwise_conv3d_dk"),
    ("void (anonymous namespace)::dw_conv3d_dk_ring_kernel<__nv_bfloat16, "
     "2, 3, 2>(...)", "K4 depthwise_conv3d_dk"),
    ("(anonymous namespace)::dw_conv3d_dk_sum_kernel(float const*, float*, "
     "int, int)", "K4 depthwise_conv3d_dk"),
    ("void pw_stats_kernel<__nv_bfloat16, true>(...)", "K5/K6 pw_stats"),
    ("void (anonymous namespace)::pw_conv_stats_mma_kernel<16, 24>(...)",
     "K5 pw_conv_stats"),
    ("void (anonymous namespace)::pw_act_conv_stats_mma_kernel<4, 8>(...)",
     "K6 pw_act_conv_stats"),
    ("void (anonymous namespace)::pw_conv_mma_kernel<8, 16>(...)",
     "K7 pw_conv"),
    ("void pw_conv_kernel<float>(...)", "K7 pw_conv"),
    ("void (anonymous namespace)::pw_conv_wg_kernel<96, 2>(CUtensorMap_st, "
     "...)", "K7 pw_conv"),
    ("(anonymous namespace)::pw_conv_mma_kernel(__nv_bfloat16 const*, ...)",
     "K7 pw_conv"),
    ("void dw_conv3d_pbwd_kernel<__nv_bfloat16>(...)",
     "K8 depthwise_conv3d_pbwd"),
    ("sum_pbwd_partials_kernel(float const*, float*, int, int, int)",
     "K8 depthwise_conv3d_pbwd"),
    ("void (anonymous namespace)::dw_conv3d_pbwd_temporal_kernel<"
     "__nv_bfloat16, 8, 5>(...)", "K8 depthwise_conv3d_pbwd"),
    ("(anonymous namespace)::dw_conv3d_pbwd_sum_kernel(float const*, "
     "float*, int, int)", "K8 depthwise_conv3d_pbwd"),
    ("sum_partials_kernel(float const*, float*, int, int)",
     "K2/K3/K5/K6 second passes"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "gemm"),
    ("void (anonymous namespace)::clip_prep_kernel<unsigned char>(...)",
     "input"),
    ("void nvjpeg::DecodeBatchedKernel<...>(...)", "input"),
])
def test_training_group(name, want):
    assert profile_training._group(name) == want


@pytest.mark.parametrize("remat", ["off", "block", "stage", "convs"])
def test_profile_training_takes_the_remat_mode(monkeypatch, capsys, remat):
    """``--remat`` reaches ``create_model``; an unknown mode is a usage
    error."""
    seen = {}

    def fake_profile(cfg, clips, steps, seed, trace_path=None, remat=None):
        seen["remat"] = remat
        return {}

    monkeypatch.setattr(profile_training, "profile", fake_profile)
    monkeypatch.setattr(profile_training, "card", lambda: "card")
    profile_training.main(["--variant", "L", "--remat", remat])
    assert seen["remat"] == remat
    assert json.loads(capsys.readouterr().out)["remat"] == remat
    with pytest.raises(SystemExit):
        profile_training.main(["--remat", "layer"])


def _prof(*kernels):
    """A stand-in for a finished profiler: (name, start us, end us) device
    kernels and one host event, which the summary leaves out."""
    events = [types.SimpleNamespace(name=name, device_type=DeviceType.CUDA,
                                    time_range=Interval(start, end))
              for name, start, end in kernels]
    events.append(types.SimpleNamespace(name="aten::mm",
                                        device_type=DeviceType.CPU,
                                        time_range=Interval(0, 100)))
    return types.SimpleNamespace(events=lambda: events)


def test_summarize_counts_kernels_by_group():
    prof = _prof(("pw_conv_wg_kernel<96, 1>", 0, 4),
                 ("sm90_xmma_gemm_bf16", 5, 11),
                 ("pw_conv_wg_kernel<96, 1>", 12, 16),
                 ("sm90_xmma_gemm_bf16", 16, 20))
    got = summarize(prof, 2, "call", group=profile_pointwise._group)
    assert got["group_kernels_per_call"] == {"wg": 1.0, "library": 1.0}
    assert got["group_ms_per_call"] == pytest.approx(
        {"wg": 4e-3, "library": 5e-3})
    assert got["kernels_per_call"] == 2.0
    assert got["window_ms_per_call"] == pytest.approx(10e-3)
    assert got["idle_share"] == pytest.approx(0.1)
    family_keys = summarize(prof, 1, "step")
    assert family_keys["family_kernels_per_step"] == {"port kernels": 2,
                                                      "gemm": 2}


def test_summarize_idle_share_counts_overlapping_kernels_once():
    """Two kernels that overlap on two streams (0-6 and 2-8) and one after
    a gap (10-12): busy 10 of 12 µs, though the kernels' durations sum to
    14."""
    prof = _prof(("void at::native::reduce_kernel<512, 1>", 0, 6),
                 ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 2, 8),
                 ("void at::native::reduce_kernel<512, 1>", 10, 12))
    got = summarize(prof, 1, "step")
    assert got["idle_share"] == pytest.approx(2 / 12)
    assert got["device_busy_ms_per_step"] == pytest.approx(14e-3)
    assert got["window_ms_per_step"] == pytest.approx(12e-3)


def test_summarize_raises_lost_trace_without_device_activity():
    with pytest.raises(LostTrace, match="no device activity"):
        summarize(_prof(), 1, "call")


@pytest.mark.parametrize("windows, want", [
    # empty, then short of a kernel, then whole: the third window counts
    ([(), (("pw_conv_wg_kernel", 0, 4),),
      (("pw_conv_wg_kernel", 0, 4), ("pw_conv_wg_kernel", 5, 9))], 4e-3),
    ([(), (), ()], None),
    ([(("pw_conv_wg_kernel", 0, 4),)] * 3, None),
])
def test_trace_retakes_lost_windows(monkeypatch, windows, want):
    queue = [_prof(*w) for w in windows]
    taken = []

    class Profiler:
        def __enter__(self):
            taken.append(queue[len(taken)])
            return taken[-1]

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(trace_mod, "device_profiler", Profiler)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(trace_mod.trace, "lost", 0)
    calls = []

    def run():
        calls.append(1)

    def complete(got):
        return got["group_kernels_per_call"].get("wg", 0) >= 1

    if want is None:
        with pytest.raises(LostTrace, match="3 windows of 2 calls"):
            trace_mod.trace(run, 2, "call", group=profile_pointwise._group,
                            complete=complete)
    else:
        got = trace_mod.trace(run, 2, "call", group=profile_pointwise._group,
                              complete=complete)
        assert got["group_ms_per_call"] == pytest.approx({"wg": want})
    assert len(taken) == 3
    assert trace_mod.trace.lost == (3 if want is None else 2)
    assert len(calls) == 2 + 3 * 2        # the warm-up, then each window


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("shape, N, strides", [
    ((10, 16, 7, 7, 192), 432, (1, 1, 1)),
    ((32, 16, 14, 14, 96), 192, (1, 2, 2)),
])
def test_case_row_times_with_events_where_the_profiler_loses(
        cuda, monkeypatch, shape, N, strides):
    got = profile_pointwise.case_row(shape, N, strides)
    assert got["timer"] == "profiler"

    def lost(*args, **kwargs):
        raise LostTrace("stand-in")

    monkeypatch.setattr(profile_pointwise, "trace", lost)
    held = profile_pointwise.case_row(shape, N, strides)
    assert held["timer"] == "events"
    assert held["body"] == got["body"]
    keys = {k for k in got if k.endswith("_us") and k != "bound_us"}
    assert keys == {k for k in held if k.endswith("_us") and k != "bound_us"}
    for key in keys:
        # the events also count the device's gaps between kernels
        assert 0.5 * got[key] < held[key] < 3 * got[key] + 5, key


def test_bench_loader_prints_one_json_line(capsys):
    """The loader benchmark on the CPU at a tiny size: one JSON line with
    the loader's clips/s, a thread's, the reservoir's fill, a thread's
    milliseconds a record by stage, the host's cores and the cores a step
    rate needs."""
    from x3d_tpu_torch.tools import bench_loader

    assert bench_loader.main([
        "--device=cpu", "--variant=XS", "--videos=3", "--frames=6",
        "--height=32", "--width=144", "--videos_per_shard=2", "--batch=2",
        "--batches=2", "--threads=2", "--step_rate=10", "--opts",
        "DATA.TRAIN_CROP_SIZE", "32"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["device"] == "cpu" and out["card"] is None
    assert out["clips_per_sec"] > 0 and out["clips_per_sec_per_thread"] > 0
    assert out["cores_needed_for_step_rate"] == pytest.approx(
        10 / out["clips_per_sec_per_thread"])
    assert out["host_cores"] >= 1 and out["threads"] == 2
    assert out["fill_s"] > 0 and out["reservoir_records"] == 32
    split = out["thread_ms_per_record"]
    assert split["records"] == 3 and split["inflate"] > 0
    assert split["record"] == pytest.approx(
        split["inflate"] + split["crc"] + split["plan"])


def test_bench_multigrid_prints_one_json_line(capsys):
    """The multigrid benchmark on the CPU at a tiny config: one JSON line
    with the JAX package's ``tools/bench_multigrid.py`` keys, one row a
    phase at its (batch, T, S), and the epoch times those rows give."""
    from x3d_tpu_torch.tools import bench_multigrid

    torch.set_num_threads(1)
    assert bench_multigrid.main([
        "--device=cpu", "--variant=XS", "--steps=1",
        "--base_steps_per_epoch=8", "--mixed_precision=false", "--opts",
        "NETWORK.C1_CHANNELS", "4", "NETWORK.DEPTH_FACTOR", "0.34",
        "DATA.TEMP_DURATION", "4", "DATA.TRAIN_CROP_SIZE", "32",
        "DATA.TRAIN_JITTER_SCALES", "[36,44]", "TRAIN.BATCH_SIZE", "1",
        "MULTIGRID.SPATIAL_DIVISOR", "4"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert list(out) == ["variant", "base_steps_per_epoch", "phases",
                         "base_epoch_s", "multigrid_mean_epoch_s",
                         "epoch_time_speedup"]
    assert out["variant"] == "XS" and out["base_steps_per_epoch"] == 8
    assert [(p["phase"], p["batch"], p["input"], p["steps_per_epoch"])
            for p in out["phases"]] == [
        (0, 8, "1x24^2", 1), (1, 4, "2x24^2", 2), (2, 2, "2x32^2", 4),
        (3, 1, "4x32^2", 8)]
    for p in out["phases"]:
        assert list(p) == ["phase", "batch", "input", "steps_per_epoch",
                           "step_ms", "clips_per_s", "epoch_s"]
        assert p["step_ms"] > 0
        assert p["clips_per_s"] == pytest.approx(p["batch"] / p["step_ms"]
                                                 * 1e3)
        assert p["epoch_s"] == pytest.approx(p["steps_per_epoch"]
                                             * p["step_ms"] / 1e3)
    mean = sum(p["epoch_s"] for p in out["phases"]) / 4
    assert out["base_epoch_s"] == out["phases"][-1]["epoch_s"]
    assert out["multigrid_mean_epoch_s"] == pytest.approx(mean)
    assert out["epoch_time_speedup"] == pytest.approx(
        out["base_epoch_s"] / mean)
