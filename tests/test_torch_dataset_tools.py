"""The port's offline dataset tools against the JAX package's
(``x3d_tpu/data/tfrecords.py``, ``x3d_tpu/tools/make_synthetic_videos.py``),
on the CPU, on tiny videos.

* ``create_tfrecords``: from the same mp4v videos both packages write
  shards with the same names and record counts, and the records, read field
  by field, have the same labels, ``num_frames`` and JPEG bytes byte for
  byte (Pillow writes TensorFlow's 300-dpi JFIF density), including the
  first-10-s trim at the container's frame rate (10 and 12.5 fps, not the
  default 25); one worker or two spawned processes give the same shards.
  An MJPEG AVI's record holds JAX's writer's JPEGs of the frames as
  libjpeg decodes them (JAX's ``VideoCapture`` decodes MJPEG otherwise).
* The label files (class tree with and without a per-class cap, a flat
  test directory through an annotations JSON) and ``build_label_map``,
  ``resolve_test_labels`` and ``kinetics400_split`` equal JAX's outputs;
  the Kinetics-400 files are byte-for-byte copies.
* ``make_synthetic_videos`` writes JAX's corpus: the same stats and the
  same files byte for byte.
* The inspector writes one GIF a sample, of the clip's frames.
* The four tools run as processes of their own with ``--device cpu``:
  corpus, labels, shards, GIFs.
"""

import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from x3d_tpu_torch import variant_config
from x3d_tpu_torch.data import avi, tfrecords
from x3d_tpu_torch.tools import make_synthetic_videos as port_msv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _write(path, n, h, w, fps, fourcc="mp4v", seed=0):
    import cv2

    rng = np.random.default_rng(seed)
    y = np.arange(h)[:, None, None]
    x = np.arange(w)[None, :, None]
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    assert out.isOpened()
    for i in range(n):
        img = (y * 3 + x * 2 + i * 7 + rng.integers(0, 20, (h, w, 3))) % 256
        out.write(img.astype(np.uint8))
    out.release()
    return path


def _records(path):
    """(label, num_frames, [JPEG bytes]) of each record of a shard."""
    out = []
    for rec in tfrecords.read_shard(path):
        v = tfrecords.SequenceExampleView(rec)
        out.append((v.label, v.num_frames,
                    [bytes(v.frame(i)) for i in range(v.stored_frames())]))
    return out


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("videos")
    return [
        (_write(str(d / "long.mp4"), 120, 24, 32, 10.0, seed=1), 5),
        (_write(str(d / "short.mp4"), 9, 32, 24, 30.0, seed=2), 1),
        (_write(str(d / "pal.mp4"), 130, 24, 32, 12.5, seed=3), 0),
    ]


def test_shards_equal_the_jax_writer(tmp_path, videos):
    from x3d_tpu.data import tfrecords as jax_tfrecords

    jax_dir, port_dir, two_dir = (str(tmp_path / n) for n in
                                  ("jax", "port", "two"))
    want = jax_tfrecords.create_tfrecords(videos, jax_dir, prefix="t",
                                          videos_per_record=2, num_workers=1)
    got = tfrecords.create_tfrecords(videos, port_dir, prefix="t",
                                     videos_per_record=2, num_workers=1,
                                     device="cpu")
    two = tfrecords.create_tfrecords(videos, two_dir, prefix="t",
                                     videos_per_record=2, num_workers=2,
                                     device="cpu")
    names = [os.path.basename(p) for p in want]
    assert names == ["t-00000.tfrecord", "t-00001.tfrecord"]
    assert [os.path.basename(p) for p in got] == names
    assert [os.path.basename(p) for p in two] == names
    for a, b, c in zip(want, got, two):
        ra, rb = _records(a), _records(b)
        assert [(l, n, len(f)) for l, n, f in ra] \
            == [(l, n, len(f)) for l, n, f in rb]
        assert ra == rb
        assert filecmp.cmp(b, c, shallow=False)
    frames = [n for rec in map(_records, want) for _, n, _ in rec]
    assert frames == [100, 9, 125]      # 10 s at 10 and 12.5 fps


def test_an_mjpeg_record_holds_libjpeg_frames(tmp_path):
    import cv2

    from x3d_tpu.data import tfrecords as jax_tfrecords

    path = _write(str(tmp_path / "v.avi"), 60, 24, 32, 5.0, "MJPG")
    a = avi.open_mjpeg(path)
    assert (a.count, a.fps) == (60, 5.0)
    tfrecords.create_tfrecords([(path, 3)], str(tmp_path), prefix="m",
                               num_workers=1, device="cpu")
    (label, n, jpegs), = _records(str(tmp_path / "m-00000.tfrecord"))
    frames = np.stack([cv2.imdecode(np.frombuffer(bytes(a.frame(i)),
                                                  np.uint8),
                                    cv2.IMREAD_COLOR)[..., ::-1]
                       for i in range(50)])
    want = tfrecords.SequenceExampleView(
        jax_tfrecords.frames_to_sequence_example(frames, 3))
    assert (label, n) == (3, 50)
    assert jpegs == [bytes(want.frame(i)) for i in range(50)]


def _tree(root):
    for cls, names in (("b_cls", ["x.mp4", "y.avi", "z.txt"]),
                       ("a_cls", ["q.MKV", "p.webm", "r.mp4"]),
                       ("c_cls", [])):
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for n in names:
            open(os.path.join(root, cls, n), "w").close()
    open(os.path.join(root, "stray.mp4"), "w").close()


@pytest.mark.parametrize("sample_size", [None, 1])
def test_label_files_equal_jax(tmp_path, sample_size):
    from x3d_tpu.data import tfrecords as jax_tfrecords

    _tree(str(tmp_path / "tree"))
    root = str(tmp_path / "tree")
    assert tfrecords.build_label_map(root) \
        == jax_tfrecords.build_label_map(root)
    n_port = tfrecords.create_label_file(root, str(tmp_path / "p" / "l.txt"),
                                         sample_size=sample_size)
    n_jax = jax_tfrecords.create_label_file(root, str(tmp_path / "j.txt"),
                                            sample_size=sample_size)
    assert n_port == n_jax == (2 if sample_size else 5)
    assert filecmp.cmp(tmp_path / "p" / "l.txt", tmp_path / "j.txt",
                       shallow=False)
    remap = {"c_cls": 0, "b_cls": 1, "a_cls": 7}
    tfrecords.create_label_file(root, str(tmp_path / "pr.txt"), remap)
    jax_tfrecords.create_label_file(root, str(tmp_path / "jr.txt"), remap)
    assert filecmp.cmp(tmp_path / "pr.txt", tmp_path / "jr.txt",
                       shallow=False)


def test_test_label_file_equals_jax(tmp_path):
    from x3d_tpu.data import tfrecords as jax_tfrecords

    flat = tmp_path / "test"
    flat.mkdir()
    for vid in ("aaa111.mp4", "bbb222.avi", "ccc333.mkv", "zzz999.mp4",
                "notes.txt"):
        (flat / vid).write_bytes(b"x")
    ann = {"aaa111": {"annotations": {"label": "air drumming"}},
           "bbb222": {"annotations": {"label": "abseiling"}},
           "ccc333": {"annotations": {"label": "no such class"}},
           "ddd444": {"annotations": {}}}
    (tmp_path / "test.json").write_text(json.dumps(ann))
    js = str(tmp_path / "test.json")
    assert tfrecords.resolve_test_labels(js) \
        == jax_tfrecords.resolve_test_labels(js)
    n = tfrecords.create_test_label_file(str(flat), str(tmp_path / "p.txt"),
                                         js)
    assert n == jax_tfrecords.create_test_label_file(
        str(flat), str(tmp_path / "j.txt"), js) == 2
    assert filecmp.cmp(tmp_path / "p.txt", tmp_path / "j.txt", shallow=False)


def test_kinetics400_metadata_is_the_jax_packages(tmp_path):
    from x3d_tpu.data import tfrecords as jax_tfrecords

    for name in ("label_map.json", "validate.csv", "test.csv"):
        assert filecmp.cmp(os.path.join(tfrecords.K400_DIR, name),
                           os.path.join(jax_tfrecords.K400_DIR, name),
                           shallow=False), name
    assert tfrecords.K400_DIR.startswith(os.path.join(ROOT, "x3d_tpu_torch"))
    assert tfrecords.kinetics400_label_map() \
        == jax_tfrecords.kinetics400_label_map()
    for split in ("validate", "test"):
        assert tfrecords.kinetics400_split(split) \
            == jax_tfrecords.kinetics400_split(split)
    with pytest.raises(ValueError, match="validate"):
        tfrecords.kinetics400_split("train")


def test_synthetic_corpus_equals_jax(tmp_path):
    from x3d_tpu.tools import make_synthetic_videos as jax_msv

    kw = dict(num_classes=2, train_per_class=1, val_per_class=1, seed=3,
              duration_range=(0.5, 1.0), force_over_10s=False)
    got = port_msv.generate(str(tmp_path / "port"), **kw)
    want = jax_msv.generate(str(tmp_path / "jax"), **kw)
    assert got == want and got["videos"] == 4
    files = []
    for dirpath, _, names in os.walk(tmp_path / "jax"):
        files += [os.path.relpath(os.path.join(dirpath, n), tmp_path / "jax")
                  for n in names]
    assert len(files) == 4
    for f in files:
        assert filecmp.cmp(tmp_path / "port" / f, tmp_path / "jax" / f,
                           shallow=False), f


def test_synthetic_corpus_needs_opencv(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        port_msv.generate(str(tmp_path), num_classes=1, train_per_class=1,
                          val_per_class=0)


def _tiny_cfg():
    cfg = variant_config("XS")
    cfg.DATA.TEMP_DURATION = 4
    cfg.DATA.TRAIN_JITTER_SCALES = [24, 28]
    cfg.DATA.TRAIN_CROP_SIZE = 24
    cfg.DATA.TEST_CROP_SIZE = 24
    cfg.TEST.NUM_TEMPORAL_VIEWS = 2
    cfg.TEST.NUM_SPATIAL_CROPS = 1
    return cfg


@pytest.mark.parametrize("training", [True, False])
def test_inspector_writes_gifs(tmp_path, videos, training):
    from PIL import Image

    tfrecords.create_tfrecords(videos, str(tmp_path), prefix="s",
                               num_workers=1, device="cpu")
    paths = tfrecords.inspect_tfrecords(
        _tiny_cfg(), str(tmp_path / "s-*"), str(tmp_path / "gifs"),
        num_samples=2, is_training=training, device="cpu")
    assert len(paths) == 2
    for i, p in enumerate(paths):
        assert os.path.basename(p).startswith(f"sample{i}_label")
        img = Image.open(p)
        assert img.size == (24, 24) and img.n_frames == 4
    if not training:        # evaluation reads the shard in order
        assert [os.path.basename(p) for p in paths] == [
            "sample0_label5.gif", "sample1_label1.gif"]


def _tool(name, *args):
    proc = subprocess.run(
        [sys.executable, "-m", f"x3d_tpu_torch.tools.{name}", *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc


def test_the_tools_as_processes(tmp_path):
    corpus, shards, gifs = (str(tmp_path / n) for n in
                            ("corpus", "shards", "gifs"))
    _tool("make_synthetic_videos", f"--output_root={corpus}",
          "--num_classes=2", "--train_per_class=2", "--val_per_class=0")
    labels = str(tmp_path / "train.txt")
    _tool("create_label", f"--video_root={corpus}/train",
          f"--output={labels}")
    lines = open(labels).read().splitlines()
    assert [ln.rsplit(" ", 1)[1] for ln in lines] == ["0", "0", "1", "1"]
    _tool("create_tfrecords", f"--label_file={labels}",
          f"--output_dir={shards}", "--videos_per_record=3",
          "--num_workers=1", "--device", "cpu")
    assert sorted(os.listdir(shards)) == ["train-00000.tfrecord",
                                          "train-00001.tfrecord"]
    got = [r for s in sorted(os.listdir(shards))
           for r in _records(os.path.join(shards, s))]
    assert [l for l, _, _ in got] == [0, 0, 1, 1]
    _tool("inspect_tfrecords",
          "--cfg=x3d_tpu_torch/configs/kinetics/X3D_XS.yaml",
          f"--file_pattern={shards}/train-*", f"--output_dir={gifs}",
          "--num_samples=3", "--notraining", "--device", "cpu", "--opts",
          "DATA.TEMP_DURATION", "4", "DATA.TEST_CROP_SIZE", "64",
          "TEST.NUM_TEMPORAL_VIEWS", "1")
    assert sorted(os.listdir(gifs)) == ["sample0_label0.gif",
                                        "sample1_label0.gif",
                                        "sample2_label1.gif"]
