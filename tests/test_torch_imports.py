"""The port stands alone: no module of ``x3d_tpu_torch`` nor
``chip_smoke.py`` imports jax, flax, orbax, absl or the JAX package, and the
port imports, serves and trains a tiny model with those imports blocked;
every module imports and the train / eval / predict / export tools run
with tensorboard and tensorflow blocked as well (the TensorBoard hook then
does nothing).  Every C function
a wrapper binds with ``ctypes`` is defined ``extern "C"`` in the CUDA
source it loads (a missing one shows only when the library loads on a
card)."""

import ast
import importlib
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "x3d_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "absl", "x3d_tpu")


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PACKAGE):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


_BLOCK = r"""
import sys
BLOCKED = ("jax", "jaxlib", "flax", "x3d_tpu")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
"""

_BLOCKED_RUN = _BLOCK + r"""
import numpy as np
import torch
torch.set_num_threads(1)
from x3d_tpu_torch import variant_config
from x3d_tpu_torch.serving import InferenceEngine

cfg = variant_config("XS")
cfg.NETWORK.C1_CHANNELS = 4
cfg.NETWORK.DEPTH_FACTOR = 0.34
cfg.DATA.TEMP_DURATION = 5
cfg.DATA.TEST_CROP_SIZE = 32
cfg.TEST.NUM_TEMPORAL_VIEWS = 2
cfg.TEST.NUM_SPATIAL_CROPS = 1
engine = InferenceEngine.random_init(cfg, max_videos=1, device="cpu")
clips = np.random.default_rng(0).integers(0, 256, engine.clip_shape,
                                          dtype=np.uint8)
probs = engine.predict(clips)
assert probs.shape == (1, 400) and abs(probs.sum() - 1) < 1e-4
assert not any(n.split(".")[0] in BLOCKED for n in sys.modules)
print("OK")
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


_BLOCKED_TRAIN = _BLOCK + r"""
import torch
torch.set_num_threads(1)
from x3d_tpu_torch import variant_config
from x3d_tpu_torch.data import synthetic_batches
from x3d_tpu_torch.models import create_model
from x3d_tpu_torch.train import (create_train_state, make_eval_step,
                                 make_train_step)

cfg = variant_config("XS")
cfg.NETWORK.C1_CHANNELS = 4
cfg.NETWORK.DEPTH_FACTOR = 0.34
cfg.DATA.TEMP_DURATION = 4
cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
cfg.TEST.NUM_TEMPORAL_VIEWS = 1
model = create_model(cfg, dtype=torch.float32, device="cpu")
state = create_train_state(cfg, model)
step = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)
batch = next(synthetic_batches(cfg, 2, dtype=torch.float32, device="cpu"))
state, metrics = step(state, batch, torch.Generator().manual_seed(0))
assert state.step == 1 and torch.isfinite(metrics["loss"])
sums = make_eval_step(model)(state, batch)
assert float(sums["count"]) == 2
assert not any(n.split(".")[0] in BLOCKED for n in sys.modules)
print("OK")
"""


def test_imports_and_serves_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, ROOT],
                          capture_output=True, text=True, cwd=ROOT,
                          env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_chip_smoke_refuses_without_a_card():
    """Without CUDA the smoke run exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal shows only without one")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          capture_output=True, text=True, cwd=ROOT,
                          env=_env(), timeout=300)
    if "no CUDA device" not in proc.stderr:
        pytest.fail(f"expected the no-card refusal, got {proc.stderr!r}")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_trains_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_TRAIN, ROOT],
                          capture_output=True, text=True, cwd=ROOT,
                          env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


_BLOCKED_TOOLS = _BLOCK.replace(
    'BLOCKED = ("jax", "jaxlib", "flax", "x3d_tpu")',
    'BLOCKED = ("jax", "jaxlib", "flax", "x3d_tpu", "orbax", "absl", '
    '"tensorboard", "cv2", "decord", "imageio")') + r"""
# tensorflow absent, as on the card machine: importing it fails and
# importlib.util.find_spec, which torch's compiler asks, answers None
sys.modules["tensorflow"] = None
import importlib
import os
import pkgutil
import tempfile
import torch
torch.set_num_threads(1)
import x3d_tpu_torch

names = [m.name for m in pkgutil.walk_packages(x3d_tpu_torch.__path__,
                                               "x3d_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for wanted in ("ops.timing", "ops.pointwise", "train.checkpoint",
               "train.hooks", "train.loop", "train.debug", "tools.common",
               "tools.train", "tools.eval", "tools.predict",
               "tools.bench_serving", "tools.fma_probe", "train.multigrid",
               "tools.bench_multigrid", "parallel.mesh", "tools.dryrun",
               "tools.export", "export", "ops.library", "data.avi",
               "data.video", "tools.create_label", "tools.create_tfrecords",
               "tools.inspect_tfrecords", "tools.make_synthetic_videos",
               "tools.memory", "tools.roofline", "tools.ab", "tools.profile"):
    assert "x3d_tpu_torch." + wanted in names, wanted

from x3d_tpu_torch.tools import eval as eval_cli, export, predict, train
config = os.path.join(sys.argv[1], "x3d_tpu_torch", "configs", "kinetics",
                      "X3D_S.yaml")
opts = ["--device", "cpu", "--opts", "NETWORK.C1_CHANNELS", "4",
        "NETWORK.DEPTH_FACTOR", "0.34", "DATA.TEMP_DURATION", "4",
        "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
        "TRAIN.BATCH_SIZE", "2", "TEST.BATCH_SIZE", "1",
        "TEST.NUM_TEMPORAL_VIEWS", "2", "TEST.NUM_SPATIAL_CROPS", "1"]
with tempfile.TemporaryDirectory() as d:
    assert train.main(["--config=" + config, "--synthetic", "--model_dir=" + d,
                       "--steps_per_epoch=2", "--epochs=1", "--debug",
                       "--mixed_precision=false", *opts]) == 0
    assert os.path.exists(os.path.join(d, "checkpoints", "ckpt-2.pt"))
    assert os.path.exists(os.path.join(d, "debug_health.json"))
    # the TensorBoard hook was built and stayed inactive: no event file
    assert not [n for n in os.listdir(d) if "tfevents" in n]
    assert eval_cli.main(["--cfg=" + config, "--model_folder=" + d,
                          "--synthetic", "--max_batches=1", *opts]) == 0
    assert predict.main(["--cfg=" + config, "--model_folder=" + d,
                         "--synthetic", "--max_batches=1",
                         "--batch_videos=1", *opts]) == 0
    out = os.path.join(d, "export")
    assert export.main(["--cfg=" + config, "--model_folder=" + d,
                        "--export_dir=" + out, *opts]) == 0
    assert sorted(os.listdir(out)) == ["export.json", "serve_clips.pt2",
                                       "serve_videos.pt2"]
    # raw videos with no video library, as on the card machine: MJPEG AVIs
    # (chip_smoke's writer) through the text-list path of train and eval
    import importlib.util
    import numpy as np
    from x3d_tpu_torch.ops import jpeg
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(sys.argv[1], "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rows = []
    for k in range(2):
        frames = np.random.default_rng(k).integers(0, 255, (9, 36, 48, 3),
                                                   dtype=np.uint8)
        path = os.path.join(d, f"v{k}.avi")
        cs.write_mjpeg_avi(path, jpeg.encode(frames, device="cpu"), 48, 36)
        rows.append(f"{path} {k}")
    listing = os.path.join(d, "list.txt")
    with open(listing, "w") as f:
        f.write("\n".join(rows) + "\n")
    assert train.main(["--config=" + config, "--model_dir=" + d,
                       "--train_file_pattern=" + listing,
                       "--steps_per_epoch=1", "--epochs=3",
                       "--mixed_precision=false", *opts]) == 0
    assert eval_cli.main(["--cfg=" + config, "--model_folder=" + d,
                          "--test_file_pattern=" + listing, *opts]) == 0
assert sys.modules["tensorflow"] is None and not any(
    n.startswith("tensorflow.") for n in sys.modules)
assert not any(n.split(".")[0] in BLOCKED for n in sys.modules)
print("OK")
"""


def test_tools_run_with_optional_packages_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_TOOLS, ROOT],
                          capture_output=True, text=True, cwd=ROOT,
                          env=_env(), timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


@pytest.mark.parametrize("module", [
    "x3d_tpu_torch.ops.depthwise", "x3d_tpu_torch.ops.dw_fused",
    "x3d_tpu_torch.ops.pointwise", "x3d_tpu_torch.ops.pw_stats",
    "x3d_tpu_torch.tools.fma_probe", "x3d_tpu_torch.ops.jpeg",
    "x3d_tpu_torch.ops.clip_prep"])
def test_every_bound_c_function_is_defined(module):
    mod = importlib.import_module(module)
    with open(mod.__file__) as f:
        loads = set(re.findall(r'_build\.load\(\s*"(\w+\.cu)",\s*(_\w+)\)',
                               f.read()))
    assert loads
    for source, table in loads:
        with open(os.path.join(PACKAGE, "kernels", "csrc", source)) as f:
            defined = set(re.findall(r'extern "C" int (\w+)\(', f.read()))
        missing = set(getattr(mod, table)) - defined
        assert not missing, f"{source} does not define {sorted(missing)}"


_TF_FREE = ("x3d_tpu_torch/tools/tf_bundle.py",
            "x3d_tpu_torch/tools/import_tf_checkpoint.py",
            "x3d_tpu_torch/tools/summary.py")


@pytest.mark.parametrize("path", _TF_FREE)
def test_checkpoint_tools_import_no_tensorflow(path):
    """The TF checkpoint reader, the import tool and the summary tool read
    TensorFlow's format without TensorFlow (the card machine has none)."""
    roots = set(_imported_roots(os.path.join(ROOT, path)))
    bad = sorted(roots & set(FORBIDDEN + ("tensorflow",)))
    assert not bad, f"{path} imports {bad}"


def test_checkpoint_tools_leave_tensorflow_unloaded():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, x3d_tpu_torch.tools.import_tf_checkpoint, "
         "x3d_tpu_torch.tools.summary; "
         "print(sorted(m for m in sys.modules "
         "if m.split('.')[0] in ('tensorflow', 'jax')))"],
        capture_output=True, text=True, cwd=ROOT, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "[]"


_VIDEO_FILES = ("x3d_tpu_torch/data/avi.py", "x3d_tpu_torch/data/video.py",
                "x3d_tpu_torch/data/tfrecords.py",
                "x3d_tpu_torch/data/pipeline.py",
                "x3d_tpu_torch/tools/create_label.py",
                "x3d_tpu_torch/tools/create_tfrecords.py",
                "x3d_tpu_torch/tools/inspect_tfrecords.py",
                "x3d_tpu_torch/tools/make_synthetic_videos.py")


@pytest.mark.parametrize("path", _VIDEO_FILES)
def test_video_modules_import_no_tensorflow(path):
    """The raw-video reader and the dataset tools import neither
    TensorFlow nor the JAX package (the card machine has neither)."""
    roots = set(_imported_roots(os.path.join(ROOT, path)))
    bad = sorted(roots & set(FORBIDDEN + ("tensorflow",)))
    assert not bad, f"{path} imports {bad}"


def _module_level_imports(path):
    """Roots of the imports that run when ``path`` is imported (outside
    every function body)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                yield from (a.name.split(".")[0] for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module.split(".")[0]
            yield from walk(child)

    return set(walk(tree))


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_video_libraries_are_imported_inside_functions(path):
    """OpenCV, decord and imageio are optional (the card machine has none):
    no module imports them when it is imported."""
    bad = sorted(_module_level_imports(path) & {"cv2", "decord", "imageio"})
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
