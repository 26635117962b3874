"""The port's command-line tools on the CPU: train (fresh, then resumed),
eval, predict, ``InferenceEngine.from_checkpoint``, the flags of modules
that are not ported yet, and the multiply-add probe's plain chain.

The tools run in this process through their ``main(argv)`` with ``--device
cpu`` on a tiny model (``NETWORK.C1_CHANNELS 4``, ``NETWORK.DEPTH_FACTOR
0.34``, T=4, 32² crops, 10 classes, 2 clips a batch, 2 views).  What is
compared is exact: the engine built from a checkpoint gives the trained
model's probabilities bit for bit.  The probe's float32 chain is held
against its closed form within 1e-5 (512 roundings of 6e-8 each).

``setup_runtime`` sets cuDNN's flags itself: deterministic algorithms, no
autotuning, and for a float32 run no TF32.  Two tests (marker ``cuda``)
show it on the card, where the flags matter:
``python -m pytest --noconftest -m cuda tests/test_torch_cli.py``.  The
float32 one holds the card's forward to the CPU's plain float32 forward at
``chip_smoke.py``'s float32 tolerances: logits 1e-4, probabilities 1e-5.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from x3d_tpu_torch.tools import bench_serving, common, fma_probe
from x3d_tpu_torch.tools import eval as eval_cli
from x3d_tpu_torch.tools import export as export_cli
from x3d_tpu_torch.tools import predict as predict_cli
from x3d_tpu_torch.tools import train as train_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "x3d_tpu_torch", "configs", "kinetics",
                      "X3D_S.yaml")
OPTS = ["--opts", "NETWORK.C1_CHANNELS", "4", "NETWORK.DEPTH_FACTOR", "0.34",
        "NETWORK.NUM_CLASSES", "10", "DATA.TEMP_DURATION", "4",
        "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
        "TRAIN.BATCH_SIZE", "2", "TEST.BATCH_SIZE", "2",
        "TEST.NUM_TEMPORAL_VIEWS", "2", "TEST.NUM_SPATIAL_CROPS", "1",
        "--device", "cpu"]


CUDNN_FLAGS = (("cudnn", "deterministic"), ("cudnn", "benchmark"),
               ("cudnn", "allow_tf32"), ("cuda.matmul", "allow_tf32"))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cudnn_flags():
    """Set the backend flags of CUDNN_FLAGS, in order; restores them after
    the test."""
    def backend(name):
        obj = torch.backends
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj

    old = [getattr(backend(m), f) for m, f in CUDNN_FLAGS]

    def set_flags(*values):
        for (m, f), v in zip(CUDNN_FLAGS, values):
            setattr(backend(m), f, v)

    yield set_flags
    set_flags(*old)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


class _Keep:
    """A hook that keeps the live state and every fetched loss."""

    def __init__(self):
        self.state, self.losses, self.lrs = None, {}, []

    def on_epoch_start(self, epoch, lr):
        self.lrs.append(lr)

    def on_step(self, step, metrics):
        self.losses[step] = metrics["loss"]

    def on_step_end(self, step, state):
        self.state = state

    def on_epoch_end(self, epoch, state, train_metrics, val_metrics):
        self.val = getattr(self, "val", []) + [val_metrics]

    def on_train_end(self): ...


def _train(model_dir, *extra):
    keep = _Keep()
    rc = train_cli.main(
        [f"--config={CONFIG}", "--synthetic", f"--model_dir={model_dir}",
         "--steps_per_epoch=3", "--mixed_precision=false", *extra, *OPTS],
        extra_hooks=[keep])
    assert rc == 0
    return keep


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two epochs of three steps, checkpoints every second step."""
    torch.set_num_threads(1)
    model_dir = str(tmp_path_factory.mktemp("run"))
    keep = _train(model_dir, "--epochs=2", "--save_checkpoints_step=2")
    return model_dir, keep


def test_train_writes_step_keyed_checkpoints(trained):
    model_dir, keep = trained
    names = sorted(os.listdir(os.path.join(model_dir, "checkpoints")))
    assert names == ["ckpt-2.pt", "ckpt-3.pt", "ckpt-4.pt", "ckpt-6.pt"]
    assert keep.state.step == 6
    assert sorted(keep.losses) == [2, 3, 4, 6]
    assert all(np.isfinite(v) for v in keep.losses.values())
    assert len(keep.lrs) == 2 and keep.lrs[0] != keep.lrs[1]


def test_train_resumes_mid_epoch_like_an_uninterrupted_run(tmp_path, trained,
                                                           caplog):
    """A run killed after the step-4 save resumes at (epoch 1, step 1) and
    ends where the uninterrupted run did, bit for bit; the log names the
    restored step."""
    model_dir, keep = trained
    ckpts = tmp_path / "checkpoints"
    ckpts.mkdir()
    for name in ("ckpt-2.pt", "ckpt-4.pt"):
        (ckpts / name).write_bytes(
            open(os.path.join(model_dir, "checkpoints", name), "rb").read())
    with caplog.at_level(logging.INFO):
        again = _train(str(tmp_path), "--epochs=2",
                       "--save_checkpoints_step=2")
    assert "resumed at global step 4 (epoch 1, step-in-epoch 1)" \
        in caplog.text
    assert sorted(again.losses) == [6]
    assert again.losses[6] == keep.losses[6]
    for k, v in keep.state.model.state_dict().items():
        assert torch.equal(again.state.model.state_dict()[k], v), k


def test_train_resumes_for_a_third_epoch(trained, caplog):
    model_dir, keep = trained
    with caplog.at_level(logging.INFO):
        more = _train(model_dir, "--epochs=3", "--save_checkpoints_step=2")
    assert "resumed at global step 6 (epoch 2, step-in-epoch 0)" \
        in caplog.text
    assert more.state.step == 9 and sorted(more.losses) == [8, 9]
    assert len(more.lrs) == 1
    # a finished run resumed again does nothing
    with caplog.at_level(logging.INFO):
        done = _train(model_dir, "--epochs=3")
    assert done.state is None and not done.losses


def test_eval_prints_one_json_line(trained, capsys):
    model_dir, _ = trained
    rc = eval_cli.main([f"--cfg={CONFIG}", f"--model_folder={model_dir}",
                        "--synthetic", "--max_batches=2", *OPTS])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert sorted(out) == ["acc", "count", "loss", "top_5_acc"]
    assert out["count"] == 4.0 and np.isfinite(out["loss"])
    assert 0.0 <= out["acc"] <= out["top_5_acc"] <= 1.0


def test_eval_without_a_checkpoint_is_a_usage_error(tmp_path, capsys):
    argv = [f"--cfg={CONFIG}", f"--model_folder={tmp_path}", "--synthetic",
            "--max_batches=1", *OPTS]
    with pytest.raises(SystemExit) as e:
        eval_cli.main(argv)
    assert e.value.code == 2
    assert "No checkpoint found" in capsys.readouterr().err
    assert eval_cli.main(argv + ["--allow_random_init"]) == 0
    assert json.loads(capsys.readouterr().out.strip())["count"] == 2.0


def test_predict_and_from_checkpoint(trained, capsys):
    from x3d_tpu_torch.serving import InferenceEngine

    model_dir, _ = trained
    rc = predict_cli.main([f"--cfg={CONFIG}", f"--model_folder={model_dir}",
                           "--synthetic", "--max_batches=1",
                           "--batch_videos=2", "--k=3", *OPTS])
    assert rc == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(rows) == 2
    for row in rows:
        assert len(row["top"]) == len(row["probs"]) == 3
        assert row["probs"] == sorted(row["probs"], reverse=True)

    cfg = common.load_config(CONFIG, OPTS[1:-2])
    engine = InferenceEngine.from_checkpoint(cfg, model_dir, max_videos=2,
                                             device="cpu")
    clips = np.random.default_rng(0).integers(
        0, 256, engine.clip_shape, dtype=np.uint8)
    probs = engine.predict(clips)
    assert probs.shape == (2, 10)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    with pytest.raises(FileNotFoundError):
        InferenceEngine.from_checkpoint(cfg, os.path.join(model_dir, "no"),
                                        device="cpu")


def test_from_checkpoint_serves_the_trained_weights(tmp_path):
    """Probabilities from the engine built on a run's checkpoint equal
    those of the model the run trained, bit for bit."""
    from x3d_tpu_torch.serving import InferenceEngine

    keep = _train(str(tmp_path), "--epochs=1")
    cfg = common.load_config(CONFIG, OPTS[1:-2])
    engine = InferenceEngine.from_checkpoint(cfg, str(tmp_path),
                                             max_videos=1, device="cpu")
    clips = np.random.default_rng(1).integers(
        0, 256, engine.clip_shape, dtype=np.uint8)
    want = InferenceEngine(cfg, keep.state.model, max_videos=1,
                           device="cpu").predict(clips)
    assert np.array_equal(engine.predict(clips), want)


def _x3d_ops(export_dir):
    """The x3d:: ops in an export's serve_videos graph, by name."""
    from x3d_tpu_torch import export

    graph = export.load(export_dir, device="cpu").module.graph
    return sorted({str(n.target) for n in graph.nodes
                   if str(n.target).startswith("x3d.")})


def test_export_serves_the_checkpoint(trained, tmp_path, capsys):
    """tools.export on the train tool's checkpoint: serve_videos gives the
    probabilities of the engine built on the same folder, bit for bit."""
    from x3d_tpu_torch import export
    from x3d_tpu_torch.serving import InferenceEngine

    model_dir, _ = trained
    out = str(tmp_path / "export")
    assert export_cli.main([f"--cfg={CONFIG}", f"--model_folder={model_dir}",
                            f"--export_dir={out}", *OPTS]) == 0
    assert capsys.readouterr().out.strip() == out
    cfg = common.load_config(CONFIG, OPTS[1:-2])
    engine = InferenceEngine.from_checkpoint(cfg, model_dir, max_videos=2,
                                             device="cpu")
    clips = np.random.default_rng(3).integers(
        0, 256, engine.clip_shape, dtype=np.uint8)
    program = export.load(out, device="cpu")
    assert program.meta["dtype"] == "float32"
    assert np.array_equal(program(torch.from_numpy(clips)).numpy(),
                          engine.predict(clips))
    assert _x3d_ops(out) == ["x3d.depthwise_conv3d.default",
                             "x3d.dw_bn_act_conv.default",
                             "x3d.pw_conv.default"]


@pytest.mark.parametrize("portable", [False, True],
                         ids=["default", "portable"])
def test_export_without_a_checkpoint(tmp_path, capsys, portable):
    """Exit 2 without a checkpoint unless --allow_random_init; --portable
    writes a graph of ATen ops only; the JAX tool's --tflite is refused."""
    out = str(tmp_path / "export")
    argv = [f"--cfg={CONFIG}", f"--model_folder={tmp_path}",
            f"--export_dir={out}", *OPTS] + (["--portable"] if portable
                                             else [])
    with pytest.raises(SystemExit) as e:
        export_cli.main(argv)
    assert e.value.code == 2
    assert "No checkpoint found" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        export_cli.main(argv + ["--allow_random_init", f"--tflite={out}.tfl"])
    assert e.value.code == 2
    assert export_cli.main(argv + ["--allow_random_init"]) == 0
    assert capsys.readouterr().out.strip() == out
    assert bool(_x3d_ops(out)) != portable


# The multi-GPU flags (A10) run one process a GPU under torchrun, and
# without torchrun's environment they raise saying so.
_TORCHRUN = (RuntimeError, "started by torchrun")


@pytest.mark.parametrize("flags,error", [
    (["--synthetic", "--multihost"], _TORCHRUN),
    (["--synthetic", "--num_gpus=2"], _TORCHRUN),
], ids=["flags3-A10", "flags4-A10"])
def test_train_refuses_unported_flags(tmp_path, monkeypatch, flags, error):
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(error[0], match=error[1]):
        train_cli.main([f"--config={CONFIG}", f"--model_dir={tmp_path}",
                        "--device=cpu", *flags])
    assert not os.path.exists(tmp_path / "checkpoints")


@pytest.mark.parametrize("cli,flags,error", [
    (eval_cli, ["--synthetic", "--gpus=2"], _TORCHRUN),
], ids=["x3d_tpu_torch.tools.eval-flags1-A10"])
def test_eval_and_predict_refuse_unported_flags(tmp_path, monkeypatch, cli,
                                                flags, error):
    """``--gpus=2`` without torchrun's environment raises saying how to
    start it."""
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(error[0], match=error[1]):
        cli.main([f"--cfg={CONFIG}", f"--model_folder={tmp_path}",
                  "--device=cpu", *flags, "--allow_random_init"])


@pytest.mark.parametrize("cli", [train_cli, eval_cli],
                         ids=["train", "eval"])
def test_native_loader_needs_tfrecords(tmp_path, capsys, cli):
    """The JAX tools' usage error: their C++ loader reads shards only."""
    with pytest.raises(SystemExit) as e:
        if cli is train_cli:
            cli.main([f"--config={CONFIG}", f"--model_dir={tmp_path}",
                      "--native_loader", "--train_file_pattern=/d/t.txt",
                      *OPTS])
        else:
            cli.main([f"--cfg={CONFIG}", f"--model_folder={tmp_path}",
                      "--native_loader", "--test_file_pattern=/d/t.txt",
                      "--allow_random_init", *OPTS])
    assert e.value.code == 2
    assert "--native_loader requires --" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "checkpoints")


def _frames(n, base):
    y = np.arange(36)[:, None, None]
    x = np.arange(48)[None, :, None]
    return np.stack([np.broadcast_to((base * 40 + i * 5 + y + x) % 250,
                                     (36, 48, 3)).astype(np.uint8)
                     for i in range(n)])


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    """Six tiny videos (36x48, labels 0-5) in three train shards and one
    val shard, written on the CPU by the port's writer."""
    from x3d_tpu_torch.data import write_video_array_shards

    d = tmp_path_factory.mktemp("shards")
    videos = [(_frames(12 + i, i), i) for i in range(6)]
    write_video_array_shards(videos, str(d), prefix="train",
                             videos_per_record=2, device="cpu")
    write_video_array_shards(videos[:4], str(d), prefix="val",
                             videos_per_record=4, device="cpu")
    return d


@pytest.mark.parametrize("loader", [[], ["--native_loader",
                                         "--native_threads=2"]])
def test_train_on_shards_with_validation(tmp_path, shard_dir, loader):
    keep = _Keep()
    rc = train_cli.main(
        [f"--config={CONFIG}", f"--model_dir={tmp_path}", "--use_tfrecord",
         f"--train_file_pattern={shard_dir / 'train-*'}",
         f"--val_file_pattern={shard_dir / 'val-*'}", "--steps_per_epoch=2",
         "--epochs=2", "--mixed_precision=false", *loader, *OPTS],
        extra_hooks=[keep])
    assert rc == 0
    assert sorted(keep.losses) == [2, 4]        # fetched at epoch ends
    assert all(np.isfinite(v) for v in keep.losses.values())
    assert [v["count"] for v in keep.val] == [4.0, 4.0]    # 2 batches of 2
    assert all(np.isfinite(v["loss"]) for v in keep.val)


@pytest.mark.parametrize("loader", [[], ["--native_loader",
                                         "--native_threads=2"]])
def test_eval_on_shards(trained, shard_dir, capsys, loader):
    model_dir, _ = trained
    rc = eval_cli.main([f"--cfg={CONFIG}", f"--model_folder={model_dir}",
                        "--tfrecord",
                        f"--test_file_pattern={shard_dir / 'train-*'}",
                        *loader, *OPTS])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["count"] == 6.0 and np.isfinite(out["loss"])


def test_predict_on_shards(trained, shard_dir, capsys):
    model_dir, _ = trained
    rc = predict_cli.main([f"--cfg={CONFIG}", f"--model_folder={model_dir}",
                           f"--file_pattern={shard_dir / 'val-*'}",
                           "--batch_videos=2", "--k=3", *OPTS])
    assert rc == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["label"] for r in rows] == [0, 1, 2, 3]
    assert all(len(r["top"]) == 3 for r in rows)


@pytest.fixture(scope="module")
def video_list(tmp_path_factory):
    """The six videos as files, mp4v and MJPEG AVIs in turn (OpenCV), their
    text list, and one shard of them by the port's ``create_tfrecords``."""
    import cv2

    from x3d_tpu_torch.data import tfrecords

    d = tmp_path_factory.mktemp("videos")
    pairs = []
    for i in range(6):
        ext, fourcc = ("avi", "MJPG") if i % 2 else ("mp4", "mp4v")
        path = str(d / f"v{i}.{ext}")
        out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 30.0,
                              (48, 36))
        for f in _frames(12 + i, i):
            out.write(f)
        out.release()
        pairs.append((path, i))
    (d / "list.txt").write_text("".join(f"{p} {l}\n" for p, l in pairs))
    tfrecords.create_tfrecords(pairs, str(d), prefix="shard",
                               videos_per_record=6, num_workers=1,
                               device="cpu")
    return d


def _eval_batches(monkeypatch):
    """Record the labels and sampled indices of every eval batch that
    ``InputReader`` makes, with the kind of input it read."""
    from x3d_tpu_torch.data import InputReader

    seen = []
    real = InputReader.batch

    def batch(self, plans):
        if not self.is_training:
            seen.append((self.use_tfrecord, [p.label for p in plans],
                         [p.indices.tolist() for p in plans]))
        return real(self, plans)

    monkeypatch.setattr(InputReader, "batch", batch)
    return seen


def _by_kind(seen, kind):
    return [b[1:] for b in seen if b[0] == kind]


def test_train_on_a_text_list_with_validation(tmp_path, video_list,
                                              monkeypatch):
    """``--nouse_tfrecord`` (the default): the patterns are text lists of
    videos; validation reads the list's videos in the order and at the
    frames that validation on their shard reads them."""
    seen = _eval_batches(monkeypatch)
    runs = {}
    for kind, flags in (("text", [f"--train_file_pattern="
                                  f"{video_list / 'list.txt'}",
                                  f"--val_file_pattern="
                                  f"{video_list / 'list.txt'}",
                                  "--nouse_tfrecord"]),
                        ("shards", [f"--train_file_pattern="
                                    f"{video_list / 'shard-*'}",
                                    f"--val_file_pattern="
                                    f"{video_list / 'shard-*'}",
                                    "--use_tfrecord"])):
        keep = _Keep()
        rc = train_cli.main(
            [f"--config={CONFIG}", f"--model_dir={tmp_path / kind}", *flags,
             "--steps_per_epoch=2", "--epochs=2", "--mixed_precision=false",
             *OPTS], extra_hooks=[keep])
        assert rc == 0
        assert all(np.isfinite(v) for v in keep.losses.values())
        assert [v["count"] for v in keep.val] == [6.0, 6.0]
        runs[kind] = keep
    assert os.listdir(tmp_path / "text" / "checkpoints")
    text, shards = _by_kind(seen, False), _by_kind(seen, True)
    assert len(text) == len(shards) == 6 and text == shards
    assert [l for labels, _ in text[:3] for l in labels] == list(range(6))


def test_eval_on_a_text_list_equals_the_shards(trained, video_list, capsys,
                                               monkeypatch):
    model_dir, _ = trained
    seen = _eval_batches(monkeypatch)
    out = {}
    for kind, flags in (("text", ["--notfrecord", "--test_file_pattern="
                                  f"{video_list / 'list.txt'}"]),
                        ("shards", ["--tfrecord", "--test_file_pattern="
                                    f"{video_list / 'shard-*'}"])):
        rc = eval_cli.main([f"--cfg={CONFIG}", f"--model_folder={model_dir}",
                            *flags, *OPTS])
        assert rc == 0
        out[kind] = json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1])
    assert out["text"]["count"] == out["shards"]["count"] == 6.0
    assert np.isfinite(out["text"]["loss"])
    text, shards = _by_kind(seen, False), _by_kind(seen, True)
    assert text == shards and len(text) == 3
    assert [l for labels, _ in text for l in labels] == list(range(6))


def test_train_needs_data_or_synthetic(tmp_path, capsys):
    with pytest.raises(SystemExit):
        train_cli.main([f"--config={CONFIG}", f"--model_dir={tmp_path}"])
    assert "--train_file_pattern is required" in capsys.readouterr().err


def test_tools_need_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal shows only without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main([f"--config={CONFIG}", f"--model_dir={tmp_path}",
                        "--synthetic", *OPTS[:-2]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_serving.main(["--variants=S", "--videos=1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fma_probe.main([])


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_setup_runtime_sets_cudnn_flags(cudnn_flags, mixed_precision):
    """From PyTorch's defaults with autotuning on: deterministic cuDNN, no
    autotuning, and TF32 off for a float32 run (left as it was in bf16)."""
    cudnn_flags(False, True, True, True)
    cfg = common.load_config(CONFIG, OPTS[1:-2])
    _, model, dtype = common.setup_runtime(cfg, 1, mixed_precision, False,
                                           device="cpu")
    assert dtype == (torch.bfloat16 if mixed_precision else torch.float32)
    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.benchmark
    assert torch.backends.cudnn.allow_tf32 == mixed_precision
    assert torch.backends.cuda.matmul.allow_tf32 == mixed_precision


def _train_on_card(model_dir, *extra):
    keep = _Keep()
    rc = train_cli.main(
        [f"--config={CONFIG}", "--synthetic", f"--model_dir={model_dir}",
         "--steps_per_epoch=3", "--save_checkpoints_step=1", *extra,
         *OPTS[:-2]], extra_hooks=[keep])
    assert rc == 0
    return keep


@pytest.mark.cuda
def test_train_on_card_resumes_bit_for_bit(cuda, cudnn_flags, tmp_path):
    """bfloat16 on the card, from PyTorch's cuDNN defaults (which allow
    nondeterministic algorithms): two epochs and a resumed third equal
    three uninterrupted epochs, losses and weights bit for bit; the tool
    makes its runs deterministic itself."""
    cudnn_flags(False, False, True, True)
    first = _train_on_card(tmp_path / "run", "--epochs=2")
    resumed = _train_on_card(tmp_path / "run", "--epochs=3")
    straight = _train_on_card(tmp_path / "straight", "--epochs=3")
    assert sorted(first.losses) == [1, 2, 3, 4, 5, 6]
    assert sorted(resumed.losses) == [7, 8, 9]
    assert straight.losses == first.losses | resumed.losses
    assert all(np.isfinite(v) for v in straight.losses.values())
    want = straight.state.model.state_dict()
    for k, v in resumed.state.model.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.cuda
def test_float32_run_on_card_keeps_tf32_off(cuda, cudnn_flags):
    """With TF32 allowed again (PyTorch's cuDNN default), a float32 model
    built through ``setup_runtime`` computes in float32: its forward on the
    card equals the same weights' plain forward on the CPU."""
    from x3d_tpu_torch.models import create_model

    cudnn_flags(False, False, True, True)
    cfg = common.load_config(CONFIG, OPTS[1:-2])
    _, model, dtype = common.setup_runtime(cfg, 1, False, False, seed=3)
    assert dtype == torch.float32
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    plain = create_model(cfg, dtype=torch.float32, device="cpu", init=False)
    plain.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    clips = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 4, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        got = [t.cpu() for t in (model.eval()(clips.to(cuda)),
                                 model(clips.to(cuda), return_logits=True))]
        want = (plain.eval()(clips), plain(clips, return_logits=True))
    assert (got[1] - want[1]).abs().max().item() <= 1e-4
    assert (got[0] - want[0]).abs().max().item() <= 1e-5


def test_bool_flags_take_the_reference_forms():
    parse = train_cli.build_parser().parse_args
    base = ["--config=c.yaml", "--model_dir=d"]
    assert parse(base).mixed_precision is True
    assert parse(base + ["--nomixed_precision"]).mixed_precision is False
    assert parse(base + ["--mixed_precision=false"]).mixed_precision is False
    assert parse(base + ["--synthetic"]).synthetic is True
    assert parse(base + ["--synthetic=true", "--debug"]).debug is True
    cfg = common.load_config(CONFIG, ["TRAIN.BATCH_SIZE=4",
                                      "TEST.BATCH_SIZE 2"])
    assert (cfg.TRAIN.BATCH_SIZE, cfg.TEST.BATCH_SIZE) == (4, 2)
    with pytest.raises(ValueError, match="yaml"):
        common.load_config("config.json")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fma_chain_plain_value(dtype):
    """512 multiply-adds from 0.5.  float32 follows the closed form
    a^n v + b (1 - a^n) / (1 - a); in bfloat16 a rounds to 1 and b is
    below half an ulp of 0.5, so the chain stays at 0.5."""
    x = torch.full((6,), 0.5, dtype=dtype)
    y = fma_probe.fma_chain(x, unroll=8, inner=64)       # CPU: plain version
    assert y.dtype == dtype and y.shape == x.shape
    assert torch.equal(y, fma_probe.fma_chain_reference(x, unroll=8,
                                                        inner=64))
    if dtype == torch.float32:
        a, b, n = fma_probe.A, fma_probe.B, 512
        want = a ** n * 0.5 + b * (1 - a ** n) / (1 - a)
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-5)
    else:
        assert torch.equal(y, x)
    with pytest.raises(ValueError, match="unroll"):
        fma_probe.fma_chain(x, unroll=3)
    with pytest.raises(ValueError, match="CUDA"):
        fma_probe.fma_chain(x.to("meta"))
    with pytest.raises(ValueError, match="even"):
        fma_probe.fma_chain(torch.zeros(3, dtype=torch.bfloat16))


def test_tensor_health_report(tmp_path, caplog):
    """One record per module output, by module path; all finite on a fresh
    model (the fraction is exactly 1.0), and a NaN weight shows up in its
    module and everything downstream, is logged and written."""
    from x3d_tpu_torch.models import create_model
    from x3d_tpu_torch.train import create_train_state
    from x3d_tpu_torch.train.debug import dump_tensor_health, tensor_health

    cfg = common.load_config(CONFIG, OPTS[1:-2])
    model = create_model(cfg, dtype=torch.float32, device="cpu").train()
    video = torch.randn(2, 4, 32, 32, 3,
                        generator=torch.Generator().manual_seed(0))
    report = tensor_health(model, video)
    assert model.training                       # the mode is restored
    assert {"__call__", "conv_1/conv_t", "stage2_block0/bottleneck/bn_a",
            "fc_2"} <= set(report)
    assert all(v["finite_frac"] == 1.0 for v in report.values())
    assert sorted(report["fc_2"]) == ["absmax", "finite_frac", "max", "mean",
                                      "min"]
    assert report["__call__"]["absmax"] == report["fc_2"]["absmax"]

    with torch.no_grad():
        model.conv_5.weight[0, 0] = float("nan")
    out = tmp_path / "health.json"
    with caplog.at_level(logging.ERROR):
        bad = dump_tensor_health(model, create_train_state(cfg, model),
                                 video, str(out))
    assert bad["conv_5"]["finite_frac"] < 1.0
    assert bad["stage5_block0"]["finite_frac"] == 1.0
    assert "NON-FINITE values in conv_5" in caplog.text
    assert json.loads(out.read_text())["conv_5"]["finite_frac"] < 1.0
    with pytest.raises(ValueError, match="another model"):
        dump_tensor_health(create_model(cfg, dtype=torch.float32,
                                        device="cpu"),
                           create_train_state(cfg, model), video)
