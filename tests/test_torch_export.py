"""The port's export (``x3d_tpu_torch.export``) against the JAX package's
forward and the port's engine (tiny X3D on the CPU: XS geometry,
``C1_CHANNELS 4``, ``DEPTH_FACTOR 0.34``, T 4, 32², 7 classes, 2 views;
weights converted from the JAX package's ``init_variables``).

* ``serve_clips`` equals the JAX model's per-clip softmax and
  ``serve_videos`` its view-averaged eval forward within atol 1e-6
  (float32, sums in another order), the JAX export's two signatures.
* Both equal the port's engine bit for bit at the same batch, in float32
  and bfloat16: they run the same ATen ops and the same plain versions.
* One file serves 2 and 6 clips, or 1 and 3 videos; a fixed-batch export
  refuses another batch, and every export refuses float input.
* The default graph holds one ``x3d::`` op a call of the kernel's path in
  the eager forward; the portable graph none, and it loads in a process
  that cannot import ``x3d_tpu_torch``, where the default graph fails.
* ``torch.library.opcheck`` on each op (schema, fake version).
* The default graph passes every BatchNorm to the op of the kernel that
  writes its input as its epilogue, by the model's plan, and its answers
  equal the unfused eager model's bit for bit.
"""

import collections
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x3d_tpu import variant_config as jax_variant_config
from x3d_tpu.models import create_model as jax_create_model
from x3d_tpu.models import init_variables
from x3d_tpu.utils import normalize as jax_normalize
from x3d_tpu_torch import convert, export, variant_config
from x3d_tpu_torch.models import build_arch, create_model
from x3d_tpu_torch.ops import depthwise, dw_fused, library, pointwise
from x3d_tpu_torch.serving import InferenceEngine, serve_forward

T, S, CLASSES, VIEWS = 4, 32, 7, 2
OPS = {"x3d.depthwise_conv3d.default": "depthwise",
       "x3d.dw_bn_act_conv.default": "segment",
       "x3d.pw_conv.default": "pointwise"}


def _tiny(cfg):
    cfg.NETWORK.C1_CHANNELS = 4
    cfg.NETWORK.DEPTH_FACTOR = 0.34
    cfg.NETWORK.NUM_CLASSES = CLASSES
    cfg.DATA.TEMP_DURATION = T
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = S
    cfg.TEST.NUM_TEMPORAL_VIEWS = VIEWS
    cfg.TEST.NUM_SPATIAL_CROPS = 1
    return cfg


def _clips(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, T, S, S, 3),
                                                dtype=np.uint8)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg = _tiny(jax_variant_config("XS"))
    model = jax_create_model(cfg, dtype=jnp.float32, remat=False,
                             time_fold=False)
    variables = init_variables(model, jax.random.PRNGKey(0),
                               jnp.zeros((1, T, S, S, 3)))
    mean, std = tuple(cfg.DATA.MEAN), tuple(cfg.DATA.STD)

    def forward(x, per_clip):
        x = jax_normalize(x.astype(jnp.float32), mean, std)
        if per_clip:
            return jax.nn.softmax(model.apply(variables, x, train=False,
                                              return_logits=True), axis=-1)
        return model.apply(variables, x, train=False)

    jax_fn = jax.jit(forward, static_argnums=1)
    return _tiny(variant_config("XS")), convert.flax_to_state_dict(
        variables), jax_fn


@pytest.fixture(scope="module")
def exports(setup, tmp_path_factory):
    """export dir by (dtype, portable): the default graph in float32 and
    bfloat16, the portable one in float32."""
    torch.set_num_threads(1)
    cfg, state, _ = setup
    out = {}
    for dtype, portable in ((torch.float32, False), (torch.bfloat16, False),
                            (torch.float32, True)):
        d = str(tmp_path_factory.mktemp(f"{dtype}_{portable}"))
        assert export.export_program(cfg, state, d, dtype=dtype,
                                     portable=portable, device="cpu") == d
        out[dtype, portable] = d
    return out


def _engine_probs(cfg, state, dtype, clips, signature):
    """The engine at the request's batch: per-video probabilities, or its
    forward's per-clip softmax."""
    engine = InferenceEngine(cfg, state, max_videos=len(clips) // VIEWS,
                             dtype=dtype, device="cpu")
    if signature == "serve_videos":
        return torch.from_numpy(engine.predict(clips))
    with torch.inference_mode():
        logits = serve_forward(engine.model, torch.from_numpy(clips),
                               cfg.DATA.MEAN, cfg.DATA.STD,
                               return_logits=True)
    return torch.softmax(logits.to(torch.float32), dim=-1)


@pytest.mark.parametrize("signature", export.SIGNATURES)
def test_matches_jax(setup, exports, signature):
    _, _, jax_fn = setup
    clips = _clips(3 * VIEWS)
    got = export.load(exports[torch.float32, False], signature, device="cpu")
    p = got(torch.from_numpy(clips))
    want = np.asarray(jax_fn(jnp.asarray(clips), signature == "serve_clips"))
    assert p.dtype == torch.float32 and p.shape == want.shape
    np.testing.assert_allclose(p.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("signature", export.SIGNATURES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_equals_the_engine_bit_for_bit(setup, exports, dtype, signature):
    cfg, state, _ = setup
    clips = _clips(2 * VIEWS, seed=1)
    got = export.load(exports[dtype, False], signature, device="cpu")
    assert torch.equal(got(torch.from_numpy(clips)),
                       _engine_probs(cfg, state, dtype, clips, signature))


# the arguments of each op before the epilogue's mul, add and relu
_BASE_ARGS = {"x3d.depthwise_conv3d.default": 4,
              "x3d.dw_bn_act_conv.default": 4, "x3d.pw_conv.default": 3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_graph_holds_the_epilogues(setup, exports, dtype):
    """Every BatchNorm of the default programs rides the x3d:: op of the
    kernel that writes its input: K7 bn_c of every block and bn_r of the
    four projections, bn_a and bn_5 with the ReLU; K2 bn_b of every
    stride-1 block; K1 bn_b of the four stage entries, the stem's with the
    ReLU; conv ``a`` of the stride-1 blocks (K2's input) alone takes none.
    The program's answers equal the eager model's on the unfused path
    (autograd on: every BatchNorm by the model's affine), bit for bit."""
    cfg, state, _ = setup
    arch = build_arch(cfg)
    blocks = sum(len(stage) for stage in arch.stages)
    entries = len(arch.stages)
    want = {("pw_conv", "bn"): blocks + entries,
            ("pw_conv", "bn_relu"): entries + 1,
            ("pw_conv", "none"): blocks - entries,
            ("dw_bn_act_conv", "bn"): blocks - entries,
            ("depthwise_conv3d", "bn"): entries,
            ("depthwise_conv3d", "bn_relu"): 1}
    clips = torch.from_numpy(_clips(2 * VIEWS, seed=3))
    model = create_model(cfg, dtype=dtype, device="cpu", init=False)
    model.load_state_dict(state)
    for signature in export.SIGNATURES:
        program = export.load(exports[dtype, False], signature, device="cpu")
        got = collections.Counter()
        for n in program.module.graph.nodes:
            base = _BASE_ARGS.get(str(n.target))
            if n.op == "call_function" and base is not None:
                args = list(n.args) + [None, None, False][len(n.args) - base:]
                kind = "none" if args[base] is None else \
                    "bn_relu" if args[base + 2] else "bn"
                got[str(n.target).split(".")[1], kind] += 1
        assert dict(got) == want, signature
        per_clip = signature == "serve_clips"
        unfused = serve_forward(model, clips, cfg.DATA.MEAN, cfg.DATA.STD,
                                return_logits=per_clip).detach()
        if per_clip:
            unfused = torch.softmax(unfused.to(torch.float32), dim=-1)
        assert torch.equal(program(clips), unfused), signature


@pytest.mark.parametrize("signature,clips", [
    ("serve_clips", 2), ("serve_clips", 6), ("serve_videos", VIEWS),
    ("serve_videos", 3 * VIEWS)])
def test_one_file_serves_any_batch(setup, exports, signature, clips):
    cfg, state, _ = setup
    x = _clips(clips, seed=clips)
    got = export.load(exports[torch.float32, False], signature, device="cpu")
    p = got(torch.from_numpy(x))
    n = clips if signature == "serve_clips" else clips // VIEWS
    assert p.shape == (n, CLASSES)
    model = create_model(cfg, dtype=torch.float32, device="cpu", init=False)
    model.load_state_dict(state)
    with torch.inference_mode():
        want = serve_forward(model, torch.from_numpy(x), cfg.DATA.MEAN,
                             cfg.DATA.STD,
                             return_logits=signature == "serve_clips")
    if signature == "serve_clips":
        want = torch.softmax(want, dim=-1)
    assert torch.equal(p, want)


def test_fixed_batch_and_uint8_only(setup, exports, tmp_path):
    cfg, state, _ = setup
    d = export.export_program(cfg, state, str(tmp_path), batch_clips=VIEWS,
                              device="cpu")
    fixed = export.load(d, device="cpu")
    assert fixed.meta["batch_clips"] == VIEWS
    assert fixed(torch.from_numpy(_clips(VIEWS))).shape == (1, CLASSES)
    with pytest.raises(Exception, match="shape|size|dim|Guard"):
        fixed(torch.from_numpy(_clips(2 * VIEWS)))
    dynamic = export.load(exports[torch.float32, False], device="cpu")
    with pytest.raises(Exception, match="dtype"):
        dynamic(torch.from_numpy(_clips(VIEWS)).float())
    with pytest.raises(ValueError, match="multiple"):
        export.export_program(cfg, state, str(tmp_path), batch_clips=3,
                              device="cpu")


@pytest.mark.parametrize("portable", [False, True],
                         ids=["default", "portable"])
def test_graph_holds_one_op_a_kernel_call(setup, exports, monkeypatch,
                                          portable):
    """The default graph calls each x3d:: op as often as the eager forward
    calls that kernel's launch function (on the CPU its plain version);
    the portable graph holds none."""
    cfg, state, _ = setup
    eager = collections.Counter()

    def counted(module, name, key):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            eager[key] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)

    counted(depthwise, "depthwise_conv3d", "depthwise")
    counted(dw_fused, "dw_bn_act_conv", "segment")
    counted(pointwise, "pw_conv", "pointwise")
    model = create_model(cfg, dtype=torch.float32, device="cpu", init=False)
    model.load_state_dict(state)
    with torch.inference_mode():
        serve_forward(model, torch.from_numpy(_clips(VIEWS)), cfg.DATA.MEAN,
                      cfg.DATA.STD)
    assert eager["depthwise"] and eager["segment"] and eager["pointwise"]
    for signature in export.SIGNATURES:
        graph = export.load(exports[torch.float32, portable], signature,
                            device="cpu").module.graph
        ops = collections.Counter(
            OPS[str(n.target)] for n in graph.nodes
            if n.op == "call_function" and str(n.target).startswith("x3d."))
        targets = {str(n.target) for n in graph.nodes
                   if n.op == "call_function"}
        if portable:
            assert not ops
            assert all(t.startswith(("aten.", "<built-in"))
                       for t in targets), targets
        else:
            assert ops == eager, signature


_BLOCKED_LOAD = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "x3d_tpu_torch":
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
import numpy as np
import torch
torch.set_num_threads(1)
try:
    import x3d_tpu_torch
    raise SystemExit("x3d_tpu_torch imported")
except ImportError:
    pass
portable, default, clips = sys.argv[1:]
program = torch.export.load(portable + "/serve_videos.pt2")
with torch.inference_mode():
    p = program.module()(torch.from_numpy(np.load(clips)))
np.save(clips + ".out.npy", p.numpy())
try:
    torch.export.load(default + "/serve_videos.pt2")
except Exception as e:
    print("DEFAULT FAILED", type(e).__name__)
    raise SystemExit(0)
raise SystemExit("the default program loaded without the x3d:: ops")
"""


def test_portable_loads_without_the_package(setup, exports, tmp_path):
    cfg, state, _ = setup
    clips = _clips(2 * VIEWS, seed=5)
    path = str(tmp_path / "clips.npy")
    np.save(path, clips)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_LOAD, exports[torch.float32, True],
         exports[torch.float32, False], path],
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "DEFAULT FAILED" in proc.stdout
    assert "torch.ops.x3d." in proc.stderr
    got = np.load(path + ".out.npy")
    want = _engine_probs(cfg, state, torch.float32, clips, "serve_videos")
    np.testing.assert_array_equal(got, want.numpy())


def test_each_signature_loads_alone(exports, tmp_path):
    src = exports[torch.float32, False]
    for signature in export.SIGNATURES:
        d = tmp_path / signature
        d.mkdir()
        for name in (signature + ".pt2", export.META):
            shutil.copy(os.path.join(src, name), d / name)
        p = export.load(str(d), signature, device="cpu")(
            torch.from_numpy(_clips(VIEWS)))
        assert p.shape == ((VIEWS if signature == "serve_clips" else 1),
                           CLASSES)


def test_export_json(exports):
    with open(os.path.join(exports[torch.bfloat16, False],
                           export.META)) as f:
        meta = json.load(f)
    assert meta == {"variant": None, "views": VIEWS, "classes": CLASSES,
                    "clip": [T, S, S, 3], "dtype": "bfloat16",
                    "portable": False, "batch_clips": None, "device": "cpu"}
    assert export._variant(variant_config("M"), create_model(
        variant_config("M"), device="meta")) == "M"


def test_load_moves_the_program(exports):
    """A program traced on the CPU moves to the device asked for: its
    state, the normalisation constants and the device checks (here the
    meta device, since the CPU has no other)."""
    got = export.load(exports[torch.float32, True], device="meta")
    p = got(torch.zeros((2 * VIEWS, T, S, S, 3), dtype=torch.uint8,
                        device="meta"))
    assert p.device.type == "meta" and p.shape == (2, CLASSES)


def test_export_refuses_what_it_cannot_trace(setup, tmp_path):
    cfg, state, _ = setup
    model = create_model(cfg, dtype=torch.float32, device="cpu", init=False)
    with pytest.raises(ValueError, match="state_dict"):
        export.export_program(cfg, model, str(tmp_path),
                              dtype=torch.bfloat16, device="cpu")
    model.head_split = {"fc_1.weight": 0}
    with pytest.raises(ValueError, match="full_model_state"):
        export.export_program(cfg, model, str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="signature"):
        export.load(str(tmp_path), "serve", device="cpu")


def test_eager_paths_bypass_the_ops(setup, monkeypatch):
    """Eager serving and training never dispatch through the x3d:: ops."""
    from x3d_tpu_torch.data import synthetic_batches
    from x3d_tpu_torch.train import create_train_state, make_train_step

    def refuse(*args, **kwargs):
        raise AssertionError("an eager call went through an x3d:: op")

    for name in ("depthwise_conv3d", "dw_bn_act_conv", "pw_conv"):
        monkeypatch.setattr(library, name, refuse)
    cfg, state, _ = setup
    probs = _engine_probs(cfg, state, torch.float32, _clips(VIEWS),
                          "serve_videos")
    assert probs.shape == (1, CLASSES)
    model = create_model(cfg, dtype=torch.float32, device="cpu").train()
    train_state = create_train_state(cfg, model)
    batch = next(synthetic_batches(cfg, 2, dtype=torch.float32,
                                   device="cpu"))
    make_train_step(model, 0.0)(train_state, batch,
                                torch.Generator().manual_seed(0))


_OPCHECK = ("test_schema", "test_faketensor")


def _op_args(op, dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 5, 7, 9, 8), generator=g).to(dtype)
    k = torch.randn((3, 3, 3, 1, 8), generator=g).to(dtype)
    if op == "depthwise_conv3d":
        return x, k, [1, 2, 2], [1, 1, 0, 1, 1, 1]
    if op == "dw_bn_act_conv":
        return x, torch.rand((8, 2), generator=g), \
            torch.rand((8, 2), generator=g) - 0.5, k
    return x, torch.randn((16, 8), generator=g).to(dtype), [1, 2, 2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["depthwise_conv3d", "dw_bn_act_conv",
                                "pw_conv"])
def test_opcheck(op, dtype):
    torch.library.opcheck(getattr(library, op), _op_args(op, dtype),
                          test_utils=_OPCHECK)
