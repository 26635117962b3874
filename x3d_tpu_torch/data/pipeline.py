"""InputReader: TFRecord shards of JPEG frames, or text lists of raw
videos, -> device batches.

The port's one loader, in place of the JAX package's two (the tf.data
``InputReader``, ``x3d_tpu/data/pipeline.py:45-322``, and the C++
``NativeClipLoader``, ``x3d_tpu/data/native_loader.py:102-247``).  The
call surface is the JAX reader's: ``InputReader(cfg, is_training, ...)
(file_pattern, batch_size)`` yields ``{"video": (B * views * crops, T, S,
S, 3), "label": (B,) int64}`` on the device, views and crops folded into
the batch crop-major as JAX folds them.  Training repeats for ever;
evaluation reads every shard once, in order, and drops the last partial
batch as JAX does (``pipeline.py:29-31``).

How a batch is made:

1. Shards: the file list is reshuffled every epoch (training) and up to
   eight shards are open at once, each record drawn from one of them
   picked at random (the C++ loader's ``RecordReader``,
   ``clip_loader.cc:63-140``); evaluation opens one shard at a time in
   sorted order.  A host thread inflates a whole shard (GZIP or plain) and
   checks every record's CRCs.
2. Records: a host thread walks the SequenceExample to the sampled frames
   (``data/tfrecords.py``), draws the record's indices and crop from its
   own generator (``data/transforms.py``; seed, epoch, record index) and
   reads the frame size from the JPEG header.  Training draws from a
   reservoir of planned records, as the C++ loader's binding does.
3. Decode: the batch's distinct sampled frames go to nvJPEG in one
   batched call (``ops/jpeg.py``), their bitstreams staged in pinned host
   memory, into one arena on the device.  On the card a thread of its own
   does this and step 4 for the next batch, on a stream of its own, while
   the caller works on the current one.
4. The clip kernel (``ops/clip_prep.py``) samples every clip frame from
   its decoded frame by its bilinear map, truncates to uint8 and
   normalises into the batch (bfloat16 by default).

Text lists of raw videos (``use_tfrecord=False``, JAX
``pipeline.py:203-220,268-276``): the pattern is a file of ``<path>
<label>`` lines, the path its first space-separated token and the label
its second.  A host takes every ``host_count``-th line from ``host_id``,
in the file's order; training shuffles that list every epoch and repeats
it (JAX's shuffle buffer of ``max(DATASET_SIZE, 1024)`` lines holds the
whole list), evaluation reads it once in order.  A Motion-JPEG AVI
(``data/avi.py``) is planned as a record is: its sampled frames' JPEGs
go to step 3 as they are.  Any other video is decoded on the host
(``data/video.py``: decord, OpenCV or imageio) at its sampled frames,
which reach the device in one upload per batch, into an arena laid out
as step 3's.  Training there takes the exact geometry
(``transforms.train_exact_map``: jitter resize, crop, flip), as JAX does
without TFRecords.  An undecodable video becomes zeros of JAX's fallback
shape with a warning, as in the reference, counted in ``substituted``.

The order of records and every random draw depend on the seed only, not
on the number of threads.  On a CUDA device nvJPEG and the clip kernel run
or raise; on the CPU (``device="cpu"``) Pillow and the plain version do
the same work.  A bad CRC, record or JPEG raises and names the shard and
the record.

The JAX tf.data reader interleaves several shards at evaluation too
(``interleave`` with its default cycle length); this reader, as the C++
loader, reads them one after another, so with more than one shard the two
give the same batches in another order.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import logging
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np
import torch

from x3d_tpu_torch.data import tfrecords, transforms, video
from x3d_tpu_torch.ops import clip_prep, jpeg
from x3d_tpu_torch.utils import resolve_device

log = logging.getLogger(__name__)
INTERLEAVE = 8            # shards open at once in training
# the training reservoir holds 16 batches of records, at most as many as
# this many bytes of decoded clips would fill (the C++ loader's binding:
# it buffers decoded clips, this reader the records' sampled bitstreams)
RESERVOIR_BYTES = 1 << 30


def _frame_size(blobs) -> tuple:
    """(height, width) that every JPEG of a video has, from its headers."""
    h, w = jpeg.image_size(blobs[0])
    for b in blobs[1:]:
        if jpeg.image_size(b) != (h, w):
            raise ValueError("frames of one video differ in size")
    return h, w


@dataclass
class RecordPlan:
    """One record, planned: its label, the JPEG bitstreams of its distinct
    sampled frames (or, for a video decoded on the host, the frames), each
    clip frame's slot among them, its maps (one a crop) and where it came
    from."""
    label: int
    indices: np.ndarray        # (V*T,) sampled frame indices
    slots: np.ndarray          # (V*T,) position of each in ``blobs``
    blobs: List[bytes]
    height: int
    width: int
    maps: np.ndarray           # (crops,) MAP_DTYPE, ``src`` unset
    where: str
    frames: Optional[np.ndarray] = None   # (K, H, W, 3) uint8, host decode
    key: Optional[tuple] = None   # a text list's (line, where, epoch, index)


@dataclass
class BatchPlan:
    """What made the last batch (kept where ``InputReader.keep_last``):
    the decoded frames' arena, their offsets, the map table and the
    records."""
    arena: torch.Tensor
    offsets: np.ndarray
    table: np.ndarray
    records: List[RecordPlan]


class InputReader:
    """Iterate device batches from TFRecord shards of JPEG frames or a
    text list of raw videos.

    Args:
      cfg: the experiment config.
      is_training: training (one random clip a video, flips; the fast
        crop on shards, the exact geometry on a text list) or multi-view
        eval (``TEST.NUM_TEMPORAL_VIEWS`` x ``TEST.NUM_SPATIAL_CROPS``
        clips a video).
      use_tfrecord: TFRecord shards (a file pattern) or a text file of
        ``<video path> <label>`` lines (the exact training geometry).
      seed: seeds shard order, interleave, reservoir, a text list's
        shuffles and every record's draws.
      num_threads: host threads that inflate and plan (default: the
        host's cores, at most 8).
      device: CUDA unless the caller asks for the CPU.
      replicate_flip_bug: flip every training clip, as the reference did.
      dtype: bfloat16 (default) or float32 normalised clips, or uint8
        (the truncated samples before normalisation).
      host_id, host_count: this host's share of the files where several
        hosts (data ranks) read one pattern: the matching files, shuffled
        alike on every host in training (sorted in evaluation), then every
        ``host_count``-th from ``host_id``, as ``files.shard(host_count,
        host_id)`` (``x3d_tpu/data/pipeline.py:250-251``); of a text list,
        every ``host_count``-th line from ``host_id`` (``:268-270``).
    """

    keep_last = False

    def __init__(self, cfg, is_training: bool, seed: int = 0,
                 num_threads: Optional[int] = None, device=None,
                 replicate_flip_bug: bool = False,
                 dtype: torch.dtype = torch.bfloat16, host_id: int = 0,
                 host_count: int = 1, use_tfrecord: bool = True):
        if not 0 <= host_id < host_count:
            raise ValueError(f"host {host_id} of {host_count}")
        self.host_id, self.host_count = int(host_id), int(host_count)
        self.cfg = cfg
        self.is_training = bool(is_training)
        self.use_tfrecord = bool(use_tfrecord)
        self.seed = int(seed)
        self.threads = int(num_threads or min(8, os.cpu_count() or 1))
        self.device = resolve_device(device)
        self.dtype = dtype
        self.crops = 1 if is_training else cfg.TEST.NUM_SPATIAL_CROPS
        if self.crops not in (1, 3):
            raise ValueError(
                f"TEST.NUM_SPATIAL_CROPS must be 1 or 3, got {self.crops}")
        self.sampler = transforms.TemporalSampler(
            is_training, cfg.DATA.FRAME_RATE, cfg.DATA.TEMP_DURATION,
            cfg.TEST.NUM_TEMPORAL_VIEWS)
        self.crop = (cfg.DATA.TRAIN_CROP_SIZE if is_training
                     else cfg.DATA.TEST_CROP_SIZE)
        self.flip_mode = 2 if replicate_flip_bug else int(is_training)
        self.crc = tfrecords.crc_function(self.device.type)
        self.last: Optional[BatchPlan] = None
        self.substituted = 0          # undecodable videos given as zeros
        self._count_lock = threading.Lock()

    @property
    def clips_per_video(self) -> int:
        return self.sampler.views * self.crops

    def reservoir_depth(self, batch_size: int) -> int:
        """Records in the training reservoir: 16 batches, at most as many
        as RESERVOIR_BYTES of decoded clips would fill."""
        per_sample = (self.clips_per_video * self.cfg.DATA.TEMP_DURATION
                      * self.crop * self.crop * 3)
        return min(16 * batch_size, max(64, RESERVOIR_BYTES // per_sample))

    # ------------------------------------------------------------ records
    def _plan(self, rec, where: str, epoch: int, index: int) -> RecordPlan:
        try:
            view = tfrecords.SequenceExampleView(rec)
            rng = transforms.record_rng(self.seed, epoch, index) \
                if self.is_training else None
            idx = self.sampler.indices(view.size(), rng)
            distinct, slots = np.unique(idx, return_inverse=True)
            blobs = [bytes(view.frame(int(i))) for i in distinct]
            h, w = _frame_size(blobs)
            maps = self._maps(h, w, rng)
        except ValueError as e:
            raise ValueError(f"{where}: {e}") from e
        return RecordPlan(int(view.label), idx, slots.reshape(-1), blobs, h,
                          w, maps, where)

    def _maps(self, h: int, w: int, rng) -> np.ndarray:
        cfg = self.cfg
        if not self.is_training:
            return transforms.eval_maps(h, w, self.crop, self.crops)
        jitter = (cfg.DATA.TRAIN_JITTER_SCALES[0],
                  cfg.DATA.TRAIN_JITTER_SCALES[1])
        # JAX's fast crop needs TFRecords; raw videos take the exact one
        fn = transforms.train_map if self.use_tfrecord \
            else transforms.train_exact_map
        return fn(h, w, self.crop, *jitter, rng, self.flip_mode)

    def _plan_video(self, line, where: str, epoch: int, index: int,
                    zeros: bool = False) -> RecordPlan:
        """Plan a text list's video: an MJPEG AVI's sampled JPEGs, else its
        sampled frames decoded on the host; zeros of JAX's fallback shape
        (counted in ``substituted``) where it does not decode or where
        ``zeros``."""
        path, label = line
        rng = transforms.record_rng(self.seed, epoch, index) \
            if self.is_training else None
        blobs, frames = [], None
        mjpeg = None if zeros else video.open_mjpeg(path)
        if mjpeg is not None:
            try:
                idx = video.sample_mjpeg(mjpeg, self.sampler, rng)
                if idx is None:
                    raise ValueError("no frame holds data")
                distinct, slots = np.unique(idx, return_inverse=True)
                blobs = [mjpeg.jpeg(int(i)) for i in distinct]
                h, w = _frame_size(blobs)
            except ValueError as e:
                log.warning("%s: %s; substituting zeros.", where, e)
                zeros = True
        elif not zeros:
            got = video.host_frames_sampled(path, self.sampler, rng)
            idx, zeros = got.indices, got.substituted
            distinct, first, slots = np.unique(
                idx, return_index=True, return_inverse=True)
            frames = got.frames[first]
        if zeros:
            with self._count_lock:
                self.substituted += 1
            idx = np.asarray(self.sampler.indices(100, rng))
            slots = np.zeros(idx.size, np.int64)
            blobs, frames = [], np.zeros((1,) + video._FALLBACK_SHAPE[1:],
                                         np.uint8)
        if frames is not None:
            h, w = frames.shape[1:3]
        try:
            maps = self._maps(h, w, rng)
        except ValueError as e:
            raise ValueError(f"{where}: {e}") from e
        return RecordPlan(int(label), idx, slots.reshape(-1), blobs, h, w,
                          maps, where, frames, (line, where, epoch, index))

    def _records(self, paths: List[str], pool: ThreadPoolExecutor):
        """(record, where, epoch, index) in the reader's order."""
        # shard order and interleave picks draw from generators of their
        # own: how far ahead shards are read must not move the picks
        order_rng = np.random.default_rng([self.seed, 0x9E3779B9])
        rng = np.random.default_rng([self.seed, 0x7F4A7C15])
        want = INTERLEAVE if self.is_training else 1
        order: collections.deque = collections.deque()
        epoch = -1

        def refill():
            nonlocal epoch
            if order or (epoch >= 0 and not self.is_training):
                return
            epoch += 1
            names = list(paths)
            if self.is_training:
                order_rng.shuffle(names)
            order.extend((p, epoch) for p in names)

        pending: collections.deque = collections.deque()

        def prefetch():
            while len(pending) < want + self.threads:
                refill()
                if not order:
                    return
                p, e = order.popleft()
                pending.append((p, e, pool.submit(tfrecords.read_shard, p,
                                                  self.crc)))

        streams = []         # [path, epoch, records, next position]
        index = 0
        while True:
            prefetch()
            while len(streams) < want and pending:
                p, e, fut = pending.popleft()
                streams.append([p, e, fut.result(), 0])
                prefetch()
            if not streams:
                return
            i = int(rng.integers(len(streams))) if len(streams) > 1 else 0
            s = streams[i]
            if s[3] >= len(s[2]):
                del streams[i]
                continue
            rec = s[2][s[3]]
            yield rec, f"{s[0]}: record {s[3]}", s[1], index
            s[3] += 1
            index += 1

    def _video_records(self, lines):
        """(line, where, epoch, index) of a text list in the reader's
        order: reshuffled every epoch and repeated in training, once in
        order in evaluation."""
        rng = np.random.default_rng([self.seed, 0x2545F491])
        epoch = index = 0
        while True:
            order = rng.permutation(len(lines)) if self.is_training \
                else range(len(lines))
            for k in order:
                yield (*lines[k], epoch, index)
                index += 1
            if not self.is_training:
                return
            epoch += 1

    def _plans(self, source, pool, batch_size) -> Iterator[RecordPlan]:
        """Planned records in order, prepared ``ahead`` at a time on the
        pool, through the training reservoir (shards only: a text list is
        shuffled whole)."""
        window: collections.deque = collections.deque()
        ahead = 2 * self.threads + batch_size
        if self.use_tfrecord:
            records, plan = self._records(source, pool), self._plan
        else:
            records, plan = self._video_records(source), self._plan_video

        def ordered():
            while True:
                while len(window) < ahead:
                    nxt = next(records, None)
                    if nxt is None:
                        break
                    window.append(pool.submit(plan, *nxt))
                if not window:
                    return
                yield window.popleft().result()

        stream = ordered()
        if not self.is_training or not self.use_tfrecord:
            yield from stream
            return
        depth = self.reservoir_depth(batch_size)
        rng = np.random.default_rng(self.seed + 0x5BD1E995)
        reservoir: list = []
        while True:
            while len(reservoir) < depth:
                p = next(stream, None)
                if p is None:
                    break
                reservoir.append(p)
            if not reservoir:
                return
            yield reservoir.pop(int(rng.integers(len(reservoir))))

    # ------------------------------------------------------------ batches
    def batch(self, plans: List[RecordPlan]) -> dict:
        """Decode and prepare one batch from planned records."""
        out, plan = self._batch(plans)
        if self.keep_last:
            self.last = plan
        return out

    def _decode(self, plans: List[RecordPlan]):
        """The batch's distinct sampled frames in one arena on the device:
        the JPEGs decoded (nvJPEG, or Pillow on the CPU), then the frames
        decoded on the host, uploaded at once; returns the arena and each
        plan's offsets of its distinct frames."""
        blobs, sizes, base = [], [], []
        for p in plans:
            base.append(len(blobs))
            blobs.extend(p.blobs)
            sizes.extend([(p.height, p.width)] * len(p.blobs))
        try:
            arena, offsets = jpeg.decode_batch(blobs, sizes, self.device) \
                if blobs else (None, np.zeros(0, np.int64))
        except jpeg.DecodeError as e:
            k = int(np.searchsorted(base, e.index, side="right")) - 1 \
                if e.index >= 0 else -1
            if k >= 0 and plans[k].key is not None:
                # a raw video's frame does not decode: zeros, as the
                # reference gives for an undecodable video
                log.warning("%s: %s; substituting zeros.", plans[k].where, e)
                plans[k] = self._plan_video(*plans[k].key, zeros=True)
                return self._decode(plans)
            if k >= 0:
                raise ValueError(f"{plans[k].where}: frame "
                                 f"{e.index - base[k]} of the sampled: {e}"
                                 ) from e
            raise ValueError(f"{', '.join(p.where for p in plans)}: {e}"
                             ) from e
        starts = [offsets[b:b + len(p.blobs)] for b, p in zip(base, plans)]
        hosted = [k for k, p in enumerate(plans) if p.frames is not None]
        if hosted:
            frames = [f for k in hosted for f in plans[k].frames]
            local, total = jpeg.arena_layout([f.shape[:2] for f in frames])
            pinned = self.device.type == "cuda"
            host = torch.empty(total, dtype=torch.uint8, pin_memory=pinned)
            view = host.numpy()
            for f, o in zip(frames, local):
                view[o:o + f.size] = f.reshape(-1)
            host = host.to(self.device, non_blocking=pinned)
            shift = 0 if arena is None else arena.numel()
            arena = host if arena is None else torch.cat([arena, host])
            n = 0
            for k in hosted:
                m = len(plans[k].frames)
                starts[k] = local[n:n + m] + shift
                n += m
        return arena, starts

    def _batch(self, plans: List[RecordPlan]):
        plans = list(plans)
        arena, starts = self._decode(plans)
        offsets = np.concatenate(starts)
        VT = len(plans[0].indices)
        table = np.zeros(len(plans) * self.crops * VT, clip_prep.MAP_DTYPE)
        step = self.crops * VT
        for b, p in enumerate(plans):
            rows = np.repeat(p.maps, VT)
            rows["src"] = np.tile(starts[b][p.slots], self.crops)
            rows["pitch"] = p.width * 3
            table[b * step:(b + 1) * step] = rows
        T = self.cfg.DATA.TEMP_DURATION
        shape = (len(table) // T, T, self.crop, self.crop, 3)
        video = clip_prep.clip_prep(arena, table, shape, self.dtype,
                                    self.cfg.DATA.MEAN, self.cfg.DATA.STD)
        label = torch.tensor([p.label for p in plans], dtype=torch.int64)
        plan = BatchPlan(arena, offsets, table, list(plans)) \
            if self.keep_last else None
        return {"video": video,
                "label": label.to(self.device, non_blocking=True)}, plan

    def lines(self, list_file: str) -> List[tuple]:
        """This host's ``((path, label), where)`` of a text list: the
        path is a line's first space-separated token and the label its
        second, as JAX parses them (``pipeline.py:203-220``)."""
        with open(list_file) as f:
            text = f.read()
        rows = text.split("\n")
        if rows and rows[-1] == "":
            rows.pop()
        out = []
        for k, row in enumerate(rows):
            parts = row.strip().split(" ")
            where = f"{list_file}:{k + 1}"
            try:
                out.append(((parts[0], int(parts[1])),
                            f"{where}: {parts[0]}"))
            except (IndexError, ValueError):
                raise ValueError(f"{where}: not '<path> <label>': {row!r}"
                                 ) from None
        out = out[self.host_id::self.host_count]
        if not out:
            raise ValueError(f"{list_file}: no lines for host "
                             f"{self.host_id} of {self.host_count}")
        return out

    def files(self, file_pattern: str) -> List[str]:
        """This host's shards of the files matching ``file_pattern``."""
        paths = sorted(glob.glob(file_pattern))
        if self.host_count > 1:
            if self.is_training:
                np.random.default_rng([self.seed, 0x51ED27]).shuffle(paths)
            paths = paths[self.host_id::self.host_count]
        if not paths:
            raise FileNotFoundError(
                f"no files match {file_pattern!r} for host {self.host_id} "
                f"of {self.host_count}")
        return paths

    def plan_batches(self, file_pattern: str,
                     batch_size: int) -> Iterator[List[RecordPlan]]:
        """The planned records of each batch, before anything is decoded;
        :meth:`batch` makes a batch of them."""
        source = self.files(file_pattern) if self.use_tfrecord \
            else self.lines(file_pattern)
        pool = ThreadPoolExecutor(self.threads,
                                  thread_name_prefix="x3d-input")
        try:
            plans = self._plans(source, pool, batch_size)
            while True:
                chunk = []
                for p in plans:
                    chunk.append(p)
                    if len(chunk) == batch_size:
                        break
                if len(chunk) < batch_size:
                    return            # drop the remainder, as JAX does
                yield chunk
        finally:
            if not sys.is_finalizing():
                pool.shutdown(wait=False, cancel_futures=True)

    def __call__(self, file_pattern: str,
                 batch_size: int) -> Iterator[dict]:
        chunks = self.plan_batches(file_pattern, batch_size)
        with contextlib.closing(chunks):
            if self.device.type != "cuda":
                for chunk in chunks:
                    yield self.batch(chunk)
                return
            # on the card the next batch is decoded and prepared by a thread
            # of its own on a stream of its own while the caller works on
            # this one (nvJPEG's host work and the launches release the GIL)
            side = torch.cuda.Stream(self.device)
            prep = ThreadPoolExecutor(1, thread_name_prefix="x3d-batch")

            def make(chunk):
                with torch.cuda.stream(side):
                    out, plan = self._batch(chunk)
                    done = torch.cuda.Event()
                    done.record(side)
                return out, plan, done

            try:
                first = next(chunks, None)
                pending = first and prep.submit(make, first)
                while pending:
                    out, plan, done = pending.result()
                    if self.keep_last:
                        self.last = plan
                    nxt = next(chunks, None)
                    pending = nxt and prep.submit(make, nxt)
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(done)
                    for t in out.values():
                        t.record_stream(stream)
                    yield out
            finally:
                prep.shutdown(wait=True)
