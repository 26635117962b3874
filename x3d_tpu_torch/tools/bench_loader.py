"""Input-pipeline throughput: the port's InputReader on TFRecord shards.

The counterpart of the JAX package's ``tools/bench_loader.py``.  Writes
synthetic shards (coded, textured frames at a chosen size, JPEG quality 90,
on the chosen device), then times the loader's training batches in
steady state, with ``--threads`` host threads and with one, and splits one
thread's work on a record into its stages:

    python -m x3d_tpu_torch.tools.bench_loader --variant=M --videos=32 \
        --frames=300 --height=256 --width=340 --step_rate=150

Prints one JSON line: loader clips/s, clips/s a thread, the seconds the
first batch took (it fills the training reservoir, 16 batches of records:
set-up, outside the timed batches), a thread's milliseconds a record by
stage (inflate, CRC-32C and framing, the SequenceExample walk, the whole
plan), the host's cores, and for ``--step_rate`` (a training step's
clips/s) the cores the loader would need to keep up, step_rate / (clips/s
a thread).  On the card the line carries its name and power limit; on the
CPU (``--device cpu``) the numbers are the plain versions' and say nothing
about the card.

``loader_rate(..., use_tfrecord=False)`` and :func:`video_thread_split`
time a text list of raw videos the same way (``chip_smoke.py`` phase 14).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="x3d_tpu_torch.tools.bench_loader",
                                description=__doc__.splitlines()[0])
    p.add_argument("--variant", default="M", help="X3D variant (XS-XL).")
    p.add_argument("--videos", type=int, default=32)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--videos_per_shard", type=int, default=8)
    p.add_argument("--batch", type=int, default=0,
                   help="Clips a batch (default: the config's).")
    p.add_argument("--batches", type=int, default=8,
                   help="Batches timed a run, after one warm-up batch.")
    p.add_argument("--threads", type=int, default=0,
                   help="Loader threads (0: the host's cores, at most 8).")
    p.add_argument("--step_rate", type=float, default=0.0,
                   help="A training step's clips/s to size the loader by.")
    p.add_argument("--shards", default=None,
                   help="Read these shards instead of writing synthetic "
                        "ones.")
    p.add_argument("--device", default=None, help="cuda (default) or cpu.")
    p.add_argument("--opts", nargs="+", default=[],
                   help="Config overrides: KEY VALUE pairs.")
    return p


def write_synthetic_shards(out_dir: str, videos: int, frames: int,
                           height: int, width: int, per_shard: int,
                           device) -> str:
    """Coded textured videos (``data.synthetic.coded_video``, label = index
    mod 400) in GZIP shards; returns their file pattern."""
    from x3d_tpu_torch.data import tfrecords
    from x3d_tpu_torch.data.synthetic import coded_video

    for s in range(0, videos, per_shard):
        path = os.path.join(out_dir, f"bench-{s // per_shard:05d}.tfrecord")
        tfrecords.write_shard(path, (
            tfrecords.frames_to_sequence_example(
                coded_video(frames, height, width, i % 400, seed=i,
                            device=device), i % 400, device=device)
            for i in range(s, min(videos, s + per_shard))), device=device)
    return os.path.join(out_dir, "bench-*")


def loader_rate(cfg, pattern: str, batch: int, batches: int, threads,
                device, use_tfrecord: bool = True) -> dict:
    """Training clips/s of the loader over ``batches`` batches, after the
    first batch, whose seconds (``fill_s``: it fills the reservoir of
    ``reservoir`` records; a text list has none) are set-up and timed
    apart."""
    import torch

    from x3d_tpu_torch.data import InputReader

    reader = InputReader(cfg, is_training=True, num_threads=threads,
                         device=device, use_tfrecord=use_tfrecord)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: 0)
    t0 = time.perf_counter()
    it = reader(pattern, batch)
    next(it)
    sync()
    t1 = time.perf_counter()
    for _ in range(batches):
        next(it)
    sync()
    dt = time.perf_counter() - t1
    it.close()
    return {"clips_per_s": batch * batches / dt, "fill_s": t1 - t0,
            "reservoir": reader.reservoir_depth(batch) if use_tfrecord
            else 0}


def thread_split(cfg, pattern: str, device, records: int = 16) -> dict:
    """One thread's work on the first ``records`` training records of the
    shards, in milliseconds a record: ``inflate`` (reading and inflating
    the shard, shared out over its records), ``crc`` (CRC-32C and framing),
    ``walk`` (the SequenceExample walk to the last sampled frame) and
    ``plan`` (the reader's whole plan of a record: the walk again, the
    sampling, the frames' bytes, their headers and the crop); ``record``
    sums inflate, crc and plan.  Run on the calling thread alone."""
    import glob

    from x3d_tpu_torch.data import InputReader, tfrecords, transforms

    reader = InputReader(cfg, is_training=True, device=device)
    ms = {"inflate": 0.0, "crc": 0.0, "walk": 0.0, "plan": 0.0}
    n = inflated = 0
    for path in sorted(glob.glob(pattern)):
        t0 = time.perf_counter()
        buf = tfrecords.inflate(path)
        t1 = time.perf_counter()
        recs = tfrecords.split_records(buf, path, reader.crc)
        t2 = time.perf_counter()
        ms["inflate"] += (t1 - t0) * 1e3
        ms["crc"] += (t2 - t1) * 1e3
        inflated += len(buf)
        for rec in recs:
            t0 = time.perf_counter()
            view = tfrecords.SequenceExampleView(rec)
            idx = reader.sampler.indices(
                view.size(), transforms.record_rng(reader.seed, 0, n))
            view.frame(int(idx.max()))
            t1 = time.perf_counter()
            reader._plan(rec, path, 0, n)
            t2 = time.perf_counter()
            ms["walk"] += (t1 - t0) * 1e3
            ms["plan"] += (t2 - t1) * 1e3
            n += 1
        if n >= records:
            break
    out = {k: v / n for k, v in ms.items()}
    out["record"] = out["inflate"] + out["crc"] + out["plan"]
    out["records"] = n
    out["inflated_mb_per_record"] = inflated / n / 2**20
    return out


def video_thread_split(cfg, label_file: str, device,
                       records: int = 16) -> dict:
    """One thread's work on the first ``records`` videos of a text list,
    in milliseconds a record: ``read`` (the file's bytes), ``walk`` (the
    RIFF walk of an MJPEG AVI to its frames) and ``plan`` (the reader's
    whole plan of a record: the read and walk again, the sampling, the
    sampled JPEGs' headers and the crop, or for other videos the host
    decode), and the MB read a record.  Run on the calling thread alone."""
    from x3d_tpu_torch.data import InputReader, avi

    reader = InputReader(cfg, is_training=True, device=device,
                         use_tfrecord=False)
    lines = reader.lines(label_file)[:records]
    ms = {"read": 0.0, "walk": 0.0, "plan": 0.0}
    nbytes = 0
    for n, (line, where) in enumerate(lines):
        t0 = time.perf_counter()
        data = avi.read_header(line[0])
        t1 = time.perf_counter()
        if data is not None:
            avi.parse(line[0], data)
            nbytes += len(data)
        t2 = time.perf_counter()
        reader._plan_video(line, where, 0, n)
        t3 = time.perf_counter()
        ms["read"] += (t1 - t0) * 1e3
        ms["walk"] += (t2 - t1) * 1e3
        ms["plan"] += (t3 - t2) * 1e3
    out = {k: v / len(lines) for k, v in ms.items()}
    out["records"] = len(lines)
    out["mb_per_record"] = nbytes / len(lines) / 2**20
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from x3d_tpu_torch import variant_config
    from x3d_tpu_torch.tools.trace import card
    from x3d_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    cfg = variant_config(args.variant)
    if args.opts:
        cfg.merge_from_list(args.opts)
    batch = args.batch or cfg.TRAIN.BATCH_SIZE
    with tempfile.TemporaryDirectory(prefix="bench_loader_") as d:
        pattern = args.shards or write_synthetic_shards(
            d, args.videos, args.frames, args.height, args.width,
            args.videos_per_shard, device)
        threads = args.threads or min(8, os.cpu_count() or 1)
        rate = loader_rate(cfg, pattern, batch, args.batches, threads,
                           device)
        solo = loader_rate(cfg, pattern, batch, args.batches, 1, device)
        split = thread_split(cfg, pattern, device)
    out = {"variant": args.variant, "device": device.type,
           "card": card() if device.type == "cuda" else None,
           "frames": [args.frames, args.height, args.width],
           "batch": batch, "threads": threads,
           "clips_per_sec": rate["clips_per_s"],
           "clips_per_sec_per_thread": solo["clips_per_s"],
           "fill_s": rate["fill_s"], "reservoir_records": rate["reservoir"],
           "thread_ms_per_record": split, "host_cores": os.cpu_count()}
    if args.step_rate:
        out["step_rate_clips_per_sec"] = args.step_rate
        out["cores_needed_for_step_rate"] = (args.step_rate
                                             / solo["clips_per_s"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
