"""Per-kernel roofline of a traced window on the card.

The counterpart of the JAX package's ``tools/roofline.py``: for every
device kernel of a window traced by ``tools/trace.trace`` (a directory
holding the Chrome trace ``trace.json`` and the kernels' launch log
``launches.json``, as ``tools/profile`` writes them) it reports the
achieved share of the card's memory rate (the launch's least bytes over
its duration) and of its operation rate, answering which kernels still
have headroom and how much.

XLA gives each HLO op its bytes and operations; PyTorch's trace gives a
kernel its name and duration only.  The bytes and operations come from the
wrappers' launch log (``ops.launch_log``: each call's ``cost`` function),
matched to the trace group by group in launch order: a port kernel's main
launch takes its record's bytes and operations; its second pass (the sum
of partials) takes none, as the record's cost counts the whole op; the
library's kernels take none (no count, as the JAX tool's custom calls).  A
window whose main kernels and records differ in number in any group raises
:class:`MismatchedLog` naming the groups.

    python -m x3d_tpu_torch.tools.roofline --trace_dir=DIR [--top=25]

Peaks default to one H100 SXM's published figures: 3350 GB/s, 989 bf16
TFLOP/s on the tensor cores (the GEMMs), 67 float32 TFLOP/s on the CUDA
cores (``--peak_tflops_f32``: the depthwise kernels K1-K4 and K8).  A row
above 105% of either peak is marked, and then ``main`` exits 1.  Needs no
card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os

from x3d_tpu_torch.tools.trace import (ANCHOR, CARD, LAUNCHES, main_group,
                                       port_group, record_group, unmatched)

HBM_GBPS = 3350.0            # H100 SXM device memory (published)
PEAK_TFLOPS = 989.0          # H100 SXM dense bfloat16 tensor cores
PEAK_TFLOPS_F32 = 67.0       # H100 SXM float32 outside the tensor cores
OVER = 1.05                  # a share above this marks a row
# the groups whose operations run on the CUDA cores in float32
F32_GROUPS = ("K1 depthwise_conv3d", "K2 dw_bn_act_conv",
              "K3 dw_bn_act_conv_bwd", "K4 depthwise_conv3d_dx",
              "K4 depthwise_conv3d_dk", "K8 depthwise_conv3d_pbwd")
# the Chrome trace's categories of device activity
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


class MismatchedLog(ValueError):
    """A trace's main kernels and the launch log differ in number."""


def label(record: dict) -> str:
    """A launch's conv shape, as the JAX tool's ``classify_conv`` names
    it: ``dw k=333 C=192`` or ``pw io=192->432``."""
    s = record["shape"]
    if "taps" in s:
        return f"dw k={''.join(map(str, s['taps']))} C={s['C']}"
    return f"pw io={s['K']}->{s['N']}"


def load_device_events(trace_dir: str):
    """The window's device events in the JAX tool's format, in time order:
    ``{"ph": "X", "name", "ts", "dur", "args": {"hlo_category",
    "bytes_accessed", "model_flops"}}``, the category being the kernel's
    group (``tools/trace.port_group``).  A port kernel's events also carry
    ``main`` (whether it is its launch's main kernel), ``shape`` and
    ``direction`` of the launch it belongs to (a second pass: the last
    main launch before it).  The clock's anchors (``tools/trace``) are left
    out."""
    path = os.path.join(trace_dir, "trace.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no trace under {trace_dir}")
    with open(path) as f:
        trace = json.load(f)
    with open(os.path.join(trace_dir, LAUNCHES)) as f:
        records = [r for r in json.load(f) if r["body"] != "plain"]
    kernels = sorted((e for e in trace["traceEvents"]
                      if e.get("ph") == "X" and e.get("cat") in _DEVICE
                      and ANCHOR not in e["name"]),
                     key=lambda e: e["ts"])
    off = unmatched([e["name"] for e in kernels], records)
    if off:
        raise MismatchedLog(
            "main kernels against launch-log records differ in group(s) "
            + ", ".join(f"{g}: {k} against {n}" for g, (k, n) in off.items()))
    queues = collections.defaultdict(collections.deque)
    for r in records:
        queues[record_group(r)].append(r)
    out, last = [], None
    for e in kernels:
        group = port_group(e["name"])
        args = {"hlo_category": group, "bytes_accessed": 0,
                "model_flops": 0}
        main = main_group(e["name"])
        if main is not None:
            last = queues[main].popleft()
            args.update(bytes_accessed=last["bytes"],
                        model_flops=last["flops"])
        if group.startswith("K") and last is not None:
            args.update(main=main is not None, shape=label(last),
                        direction=last["direction"])
        out.append({"ph": "X", "name": e["name"], "ts": e["ts"],
                    "dur": e["dur"], "args": args})
    return out


def aggregate(dev_events):
    """Per-op-name totals: calls, duration_us, bytes, flops, category."""
    agg = {}
    for e in dev_events:
        a = e["args"]
        name = e["name"]
        rec = agg.setdefault(name, {
            "calls": 0, "dur_us": 0.0, "bytes": 0, "flops": 0,
            "category": a.get("hlo_category", "?"),
            "source": a.get("source", ""),
            "tf_op": a.get("tf_op", "")})
        rec["calls"] += 1
        rec["dur_us"] += e["dur"]
        rec["bytes"] += int(a.get("bytes_accessed", 0) or 0)
        rec["flops"] += int(a.get("model_flops", 0) or 0)
    return agg


def _rate(category: str, peak_tflops: float, peak_tflops_f32: float):
    return peak_tflops_f32 if category in F32_GROUPS else peak_tflops


def _shares(r, hbm_gbps, peak):
    """(% of the memory rate, % of the operation rate) a row achieves."""
    dur_s = r["dur_us"] / 1e6
    if not dur_s:
        return 0.0, 0.0
    return (r["bytes"] / dur_s / 1e9 / hbm_gbps * 100,
            r["flops"] / dur_s / 1e12 / peak * 100)


def over_peak(agg, hbm_gbps: float = HBM_GBPS,
              peak_tflops: float = PEAK_TFLOPS,
              peak_tflops_f32: float = PEAK_TFLOPS_F32) -> list:
    """The names of the rows, and the categories, above 105% of either
    peak: a cost that counts more than the kernel can have moved or
    done."""
    cats = collections.defaultdict(lambda: {"dur_us": 0.0, "bytes": 0,
                                            "flops": 0})
    for r in agg.values():
        for k in ("dur_us", "bytes", "flops"):
            cats[r["category"]][k] += r[k]
    rows = [(n, r, r["category"]) for n, r in agg.items()] + \
        [(f"[{c}]", r, c) for c, r in cats.items()]
    return [n for n, r, c in rows
            if max(_shares(r, hbm_gbps,
                           _rate(c, peak_tflops, peak_tflops_f32)))
            > OVER * 100]


def groups(dev_events, hbm_gbps: float = HBM_GBPS,
           peak_tflops: float = PEAK_TFLOPS,
           peak_tflops_f32: float = PEAK_TFLOPS_F32) -> dict:
    """{category: launches (main kernels), ms (every kernel of the
    category), bytes, flops, bound_ms (each main launch's bytes over the
    memory rate or its operations over the rate, whichever is larger,
    summed), bound_by, share (bound over ms)} of the port's K groups."""
    out = {}
    for e in dev_events:
        a, cat = e["args"], e["args"]["hlo_category"]
        if not cat.startswith("K"):
            continue
        g = out.setdefault(cat, {"launches": 0, "ms": 0.0, "bytes": 0,
                                 "flops": 0, "bound_ms": 0.0,
                                 "bytes_ms": 0.0, "operations_ms": 0.0})
        g["ms"] += e["dur"] / 1e3
        if a.get("main"):
            t_mem = a["bytes_accessed"] / (hbm_gbps * 1e9) * 1e3
            t_ops = a["model_flops"] / (
                _rate(cat, peak_tflops, peak_tflops_f32) * 1e12) * 1e3
            g["launches"] += 1
            g["bytes"] += a["bytes_accessed"]
            g["flops"] += a["model_flops"]
            g["bound_ms"] += max(t_mem, t_ops)
            g["bytes_ms"] += t_mem
            g["operations_ms"] += t_ops
    for g in out.values():
        g["bound_by"] = "bytes" if g.pop("bytes_ms") >= \
            g.pop("operations_ms") else "operations"
        g["share"] = g["bound_ms"] / g["ms"] if g["ms"] else 0.0
    return out


def report(agg, top: int = 25, hbm_gbps: float = HBM_GBPS,
           peak_tflops: float = PEAK_TFLOPS,
           peak_tflops_f32: float = PEAK_TFLOPS_F32,
           card: str | None = None, dev_events=None) -> str:
    """The JAX tool's report: the window's totals, the ``top`` rows by
    device time (ms, % of the memory rate, % of the operation rate -- the
    float32 rate for the depthwise groups --, GB, calls), device time by
    category; a row above 105% of either peak ends in ``!``.  ``card``
    heads it; ``dev_events`` adds the K groups' launches, bound and
    share (:func:`groups`)."""
    rows = sorted(agg.items(), key=lambda kv: -kv[1]["dur_us"])
    total_us = sum(r["dur_us"] for _, r in rows)
    total_bytes = sum(r["bytes"] for _, r in rows)
    total_flops = sum(r["flops"] for _, r in rows)
    marked = set(over_peak(agg, hbm_gbps, peak_tflops, peak_tflops_f32))

    lines = [f"card: {card}"] if card else []
    lines += [
        f"total device time {total_us / 1e3:.1f} ms | "
        f"traffic {total_bytes / 1e9:.1f} GB "
        f"(roofline {total_bytes / hbm_gbps / 1e6:.1f} ms @ {hbm_gbps:.0f} "
        f"GB/s => {total_bytes / hbm_gbps / 1e3 / total_us * 100:.0f}% of "
        f"memory peak) | {total_flops / 1e12:.2f} TFLOP "
        f"({total_flops / total_us / 1e6:.1f} TFLOP/s, "
        f"{total_flops / total_us / 1e6 / peak_tflops * 100:.1f}% of "
        "tensor-core peak)",
        f"{'ms':>9} {'%bw':>5} {'%mxu':>5} {'GB':>7} {'calls':>5}  op",
    ]
    for name, r in rows[:top]:
        bw, fl = _shares(r, hbm_gbps, _rate(r["category"], peak_tflops,
                                            peak_tflops_f32))
        lines.append(
            f"{r['dur_us'] / 1e3:9.2f} {bw:5.0f} {fl:5.1f} "
            f"{r['bytes'] / 1e9:7.2f} {r['calls']:5d}  "
            f"[{r['category']}] {name[:70]}" + (" !" if name in marked
                                                  else ""))
    by_cat = collections.Counter()
    cat_bytes = collections.Counter()
    for _, r in agg.items():
        by_cat[r["category"]] += r["dur_us"]
        cat_bytes[r["category"]] += r["bytes"]
    lines.append("--- by category: ms (achieved %bw) ---")
    for c, d in by_cat.most_common():
        bw = cat_bytes[c] / (d / 1e6) / 1e9 / hbm_gbps * 100 if d else 0.0
        lines.append(f"{d / 1e3:9.2f} ({bw:3.0f}%)  {c}"
                     + (" !" if f"[{c}]" in marked else ""))
    if dev_events is not None:
        lines.append("--- the port's kernels: launches, ms, bound ms (by), "
                     "share of the bound ---")
        for c, g in sorted(groups(dev_events, hbm_gbps, peak_tflops,
                                  peak_tflops_f32).items()):
            lines.append(f"{g['launches']:6d} {g['ms']:9.3f} "
                         f"{g['bound_ms']:9.4f} ({g['bound_by']}) "
                         f"{g['share']:6.3f}  {c}"
                         + (" !" if g["share"] > OVER else ""))
    return "\n".join(lines)


def read_card(trace_dir: str) -> str:
    """The card's name and power limit that ``tools/trace`` wrote beside
    the trace, or "not recorded"."""
    try:
        with open(os.path.join(trace_dir, CARD)) as f:
            return f.read().strip()
    except FileNotFoundError:
        return "not recorded"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="x3d_tpu_torch.tools.roofline",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--trace_dir", required=True,
                    help="A tools/trace window: trace.json, launches.json.")
    ap.add_argument("--top", type=int, default=25, help="Rows to print.")
    ap.add_argument("--hbm_gbps", type=float, default=HBM_GBPS,
                    help="Memory peak bandwidth (GB/s).")
    ap.add_argument("--peak_tflops", type=float, default=PEAK_TFLOPS,
                    help="bf16 tensor-core peak (TFLOP/s).")
    ap.add_argument("--peak_tflops_f32", type=float, default=PEAK_TFLOPS_F32,
                    help="float32 CUDA-core peak (TFLOP/s), the depthwise "
                         "kernels'.")
    args = ap.parse_args(argv)
    events = load_device_events(args.trace_dir)
    agg = aggregate(events)
    peaks = (args.hbm_gbps, args.peak_tflops, args.peak_tflops_f32)
    print(report(agg, args.top, *peaks, card=read_card(args.trace_dir),
                 dev_events=events))
    over = over_peak(agg, *peaks) + [
        f"[{c}]" for c, g in groups(events, *peaks).items()
        if g["share"] > OVER]
    return 1 if over else 0


if __name__ == "__main__":
    raise SystemExit(main())
