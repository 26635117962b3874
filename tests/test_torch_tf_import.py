"""The port's TF checkpoint import (``tools/tf_bundle``,
``tools/import_tf_checkpoint``) against TensorFlow and the JAX package's
import tool, on the CPU.

* The bundle reader against ``tf.train``: a checkpoint written by
  ``tf.train.Checkpoint.write`` from the weights of a tiny X3D (XS geometry
  narrowed) hung at the reference's published variable paths, with the
  momentum slots of TF's own optimizer, int64, int32, float64, float16 and
  bfloat16 tensors and the string object graph, spanning several index
  blocks: names and shapes equal ``tf.train.list_variables``, every tensor
  ``get_tensor``'s bit for bit.
* Refusals, each naming its cause: a flipped byte in the ``.data`` or the
  ``.index`` file, a compressed block, big-endian data, a partitioned
  tensor, a dtype outside the list, a string tensor.
* The port's copy of ``map_variable`` equals the JAX package's on every
  written name and on ``tests/test_tf_import.py``'s examples.
* Import parity: both packages import one checkpoint (JAX through
  TensorFlow, the port through its reader): the trees equal leaf for leaf,
  bit for bit; eval logits rtol 1e-4 / atol 1e-5 and probabilities atol
  1e-6 (``tests/test_torch_model.py``'s tolerances).
* ``chip_smoke.py``'s numpy writer: TensorFlow reads back what it wrote,
  exactly, and its names map through the JAX ``map_variable`` onto the
  tree's leaves.
* The CLI on the CPU: ``--verify_only`` counts equal JAX's
  ``verify_mapping``; ``--output --device cpu`` writes a model folder that
  ``InferenceEngine.from_checkpoint`` serves with the imported weights.
* A missing target, a size mismatch and a checkpoint without model
  variables raise.

Float32, one thread; Python's CRC-32C reads the tiny bundles in well under
a second.
"""

import hashlib
import importlib.util
import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from x3d_tpu import variant_config as jax_variant_config  # noqa: E402
from x3d_tpu.models import create_model as jax_create_model  # noqa: E402
from x3d_tpu.tools import import_tf_checkpoint as jax_import  # noqa: E402
from x3d_tpu_torch import convert, variant_config  # noqa: E402
from x3d_tpu_torch.data.tfrecords import _varint  # noqa: E402
from x3d_tpu_torch.models import create_model  # noqa: E402
from x3d_tpu_torch.serving import InferenceEngine  # noqa: E402
from x3d_tpu_torch.tools import import_tf_checkpoint as port_import  # noqa
from x3d_tpu_torch.tools import tf_bundle  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, S, VIEWS, CLASSES = 4, 32, 2, 10
SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"
_BN = {"scale": "gamma", "bias": "beta", "mean": "moving_mean",
       "var": "moving_variance"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def tiny(cfg):
    cfg.NETWORK.C1_CHANNELS = 4
    cfg.NETWORK.DEPTH_FACTOR = 0.34
    cfg.NETWORK.NUM_CLASSES = CLASSES
    cfg.DATA.TEMP_DURATION = T
    cfg.DATA.TEST_CROP_SIZE = S
    cfg.TEST.NUM_TEMPORAL_VIEWS = VIEWS
    cfg.TEST.NUM_SPATIAL_CROPS = 1
    return cfg


def reference_tree(seed=0):
    """Weights for the checkpoint: the port's tiny model drawn from
    ``seed``, converted to the Flax tree, with random BN variables."""
    model = create_model(tiny(variant_config("XS")), dtype=torch.float32,
                         device="cpu", seed=seed)
    tree = convert.state_dict_to_flax(model.state_dict())
    rng = np.random.default_rng(seed)

    def walk(p, s):
        for k, v in p.items():
            if k == "norm":
                c = v["scale"].shape
                v["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                v["bias"] = rng.normal(0, 0.3, c).astype(np.float32)
                s[k]["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            elif isinstance(v, dict):
                walk(v, s.get(k, {}))
    walk(tree["params"], tree["batch_stats"])
    return tree


def _attach(root, parts, variable):
    """Nested ``tf.train.Checkpoint`` children along ``parts``, the
    variable at the leaf (``tests/test_tf_import.py:_attach``)."""
    node = root
    for p in parts[:-1]:
        child = getattr(node, p, None)
        if child is None:
            child = tf.train.Checkpoint()
            setattr(node, p, child)
        node = child
    setattr(node, parts[-1], variable)


def write_tf_checkpoint(prefix, tree):
    """The tree at the reference's published paths, walked as
    ``tests/test_tf_import.py`` walks the reference model, with TF's
    momentum slots for every weight and tensors of the other dtypes the
    reader loads.  Returns the variables written by name."""
    p, s = tree["params"], tree["batch_stats"]
    root = tf.train.Checkpoint()
    weights = []

    def var(parts, value, trainable=True):
        v = tf.Variable(value)
        _attach(root, parts, v)
        if trainable:
            weights.append(v)

    def bn(prefix_, pp, ss):
        for leaf, src in (("scale", pp), ("bias", pp), ("mean", ss),
                          ("var", ss)):
            var(prefix_ + [_BN[leaf]], src["norm"][leaf],
                trainable=src is pp)

    var(["conv1", "conv_s", "kernel"], p["conv_1"]["conv_s"]["kernel"])
    var(["conv1", "conv_t", "kernel"], p["conv_1"]["conv_t"]["kernel"])
    bn(["conv1", "bn"], p["conv_1"]["bn"], s["conv_1"]["bn"])
    blocks = sorted((k for k in p if k.startswith("stage")),
                    key=lambda k: tuple(map(int, k[5:].split("_block"))))
    for key in blocks:
        si, bi = map(int, key[5:].split("_block"))
        base = ["stages", str(si - 2), "stage", f"layer_with_weights-{bi}"]
        bp, bs = p[key]["bottleneck"], s[key]["bottleneck"]
        for conv in ("a", "b", "c"):
            var(base + ["bottleneck", conv, "kernel"], bp[conv]["kernel"])
        for name in ("bn_a", "bn_b", "bn_c"):
            bn(base + ["bottleneck", name], bp[name], bs[name])
        for fc in ("se_fc1", "se_fc2") if "se" in bp else ():
            for leaf in ("kernel", "bias"):
                var(base + ["bottleneck", fc, leaf], bp["se"][fc][leaf])
        if "residual" in p[key]:
            var(base + ["residual", "kernel"], p[key]["residual"]["kernel"])
            bn(base + ["bn_r"], p[key]["bn_r"], s[key]["bn_r"])
    var(["conv5", "layer_with_weights-0", "kernel"], p["conv_5"]["kernel"])
    bn(["conv5", "layer_with_weights-1"], p["bn_5"], s["bn_5"])
    # the reference's fc1 is a 1x1x1 conv
    var(["fc1", "kernel"], p["fc_1"]["kernel"].reshape(
        (1, 1, 1) + p["fc_1"]["kernel"].shape))
    var(["fc2", "kernel"], p["fc_2"]["kernel"])
    var(["fc2", "bias"], p["fc_2"]["bias"])
    # TF's own momentum slots (.OPTIMIZER_SLOT/optimizer/momentum)
    opt = tf.compat.v1.train.MomentumOptimizer(0.1, 0.9)
    before = [v.numpy() for v in weights]
    opt.apply_gradients([(tf.ones_like(v) * 1e-3, v) for v in weights])
    for v, value in zip(weights, before):      # the step moved the weights
        v.assign(value)
    root.optimizer = opt
    rng = np.random.default_rng(1)
    var(["extra", "step"], np.int64(7), False)
    var(["extra", "i32"], rng.integers(-9, 9, (3, 2)).astype(np.int32),
        False)
    var(["extra", "f64"], rng.normal(size=(5,)), False)
    var(["extra", "f16"], rng.normal(size=(2, 3)).astype(np.float16), False)
    var(["extra", "bf16"], tf.constant(rng.normal(size=(4,)),
                                       dtype=tf.bfloat16), False)
    # TF's tables cut a data block at 256 KiB: 1500 keys of about 400
    # bytes (hex names share few leading bytes) make the index span three
    for i in range(1500):
        name = (hashlib.sha1(b"%d" % i).hexdigest() * 10)[:380]
        var(["pad", name], np.float32(i), False)
    root.write(prefix)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    tree = reference_tree()
    prefix = str(tmp_path_factory.mktemp("tf") / "model")
    write_tf_checkpoint(prefix, tree)
    return prefix, tree


def _np(value):
    value = np.asarray(value)
    return value.astype(np.float32) if value.dtype.name == "bfloat16" \
        else value


def test_reader_matches_tensorflow(ckpt):
    prefix, _ = ckpt
    want = tf.train.list_variables(prefix)
    reader = tf_bundle.load_checkpoint(prefix, device="cpu")
    assert reader.list_variables() == [(n, list(s)) for n, s in want]
    assert reader.num_blocks >= 3
    names = [n for n, _ in want]
    assert any(".OPTIMIZER_SLOT/optimizer/momentum" in n for n in names)
    dtypes = set()
    tf_reader = tf.train.load_checkpoint(prefix)
    for name in names:
        if name == "_CHECKPOINTABLE_OBJECT_GRAPH":
            continue
        w, got = _np(tf_reader.get_tensor(name)), reader.get_tensor(name)
        assert got.dtype == w.dtype and got.shape == w.shape, name
        assert got.tobytes() == w.tobytes(), name
        dtypes.add(reader.entry(name).dtype)
    assert dtypes == {tf_bundle.DT_FLOAT, tf_bundle.DT_DOUBLE,
                      tf_bundle.DT_INT32, tf_bundle.DT_INT64,
                      tf_bundle.DT_HALF, tf_bundle.DT_BFLOAT16}
    with pytest.raises(tf_bundle.BundleError, match="string tensor"):
        reader.get_tensor("_CHECKPOINTABLE_OBJECT_GRAPH")
    reader.close()


def _copy(prefix, dest):
    for ext in (".index", ".data-00000-of-00001"):
        with open(prefix + ext, "rb") as f, open(dest + ext, "wb") as g:
            g.write(f.read())
    return dest


def _flip(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x40]))


def test_corrupt_bytes_raise(ckpt, tmp_path):
    prefix, _ = ckpt
    name = "fc2/kernel" + SUFFIX
    entry = tf_bundle.load_checkpoint(prefix).entry(name)
    bad = _copy(prefix, str(tmp_path / "data"))
    _flip(bad + ".data-00000-of-00001", entry.offset + entry.size // 2)
    reader = tf_bundle.load_checkpoint(bad)
    with pytest.raises(tf_bundle.BundleError, match="CRC mismatch"):
        reader.get_tensor(name)
    reader.get_tensor("fc2/bias" + SUFFIX)          # the rest still reads
    reader.close()
    bad = _copy(prefix, str(tmp_path / "index"))
    _flip(bad + ".index", 40)                        # inside the first block
    with pytest.raises(tf_bundle.BundleError, match="CRC mismatch"):
        tf_bundle.load_checkpoint(bad)
    bad = _copy(prefix, str(tmp_path / "compressed"))
    # the metaindex block's compression byte (the footer's first handle)
    with open(bad + ".index", "rb") as f:
        (offset, size), _ = tf_bundle._handle(f.read()[-48:], 0, 40)
    _flip(bad + ".index", offset + size)
    with pytest.raises(tf_bundle.BundleError, match="compressed"):
        tf_bundle.load_checkpoint(bad)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bundle(prefix, header_fields, entry):
    """A one-tensor bundle through chip_smoke's table writer, with the
    header and entry protos given (to hold what the reader refuses)."""
    cs = _chip_smoke()
    data = np.arange(4, dtype=np.float32).tobytes()
    with open(prefix + ".data-00000-of-00001", "wb") as f:
        f.write(data)
    proto = entry + cs._pb(5, 0, len(data)) + cs._pb(
        6, 5, cs._masked_crc32c(data))
    index = bytearray()

    def put(block):
        handle = _varint(len(index)) + _varint(len(block))
        index.extend(block + b"\x00" + cs._masked_crc32c(
            block + b"\x00").to_bytes(4, "little"))
        return handle

    data_block = cs._table_block([(b"", header_fields), (b"t", proto)], 16)
    handle = put(data_block)
    meta = put(cs._table_block([], 1))
    top = put(cs._table_block([(b"t", handle)], 1))
    with open(prefix + ".index", "wb") as f:
        f.write(bytes(index) + (meta + top).ljust(40, b"\x00")
                + cs.BUNDLE_MAGIC.to_bytes(8, "little"))
    return cs


@pytest.mark.parametrize("case,match", [
    ("ok", None), ("big_endian", "big-endian"), ("slices", "partitioned"),
    ("complex64", "dtype 8")])
def test_unhandled_bundles_raise(tmp_path, case, match):
    prefix = str(tmp_path / case)
    cs = _chip_smoke()
    shape = cs._pb(2, 2, cs._pb(2, 2, cs._pb(1, 0, 4)))
    header = cs._pb(1, 0, 1) + (cs._pb(2, 0, 1) if case == "big_endian"
                                else b"")
    dtype = 8 if case == "complex64" else 1
    entry = cs._pb(1, 0, dtype) + shape + (
        cs._pb(7, 2, b"") if case == "slices" else b"")
    _bundle(prefix, header, entry)
    if case == "ok":
        got = tf_bundle.load_checkpoint(prefix).get_tensor("t")
        np.testing.assert_array_equal(got, np.arange(4, dtype=np.float32))
        # TensorFlow reads the hand-made bundle as well
        assert tf.train.list_variables(prefix) == [("t", [4])]
        return
    with pytest.raises(tf_bundle.BundleError, match=match):
        tf_bundle.load_checkpoint(prefix).get_tensor("t")


def test_map_variable_is_the_jax_packages(ckpt):
    prefix, _ = ckpt
    names = [n for n, _ in tf.train.list_variables(prefix)] + [
        "conv1/conv_s/kernel" + SUFFIX,
        "conv1/bn/moving_mean" + SUFFIX,
        "stages/0/stage/layer_with_weights-1/bottleneck/se_fc1/bias" + SUFFIX,
        "stages/3/stage/layer_with_weights-0/bn_r/gamma" + SUFFIX,
        "conv5/layer_with_weights-0/kernel" + SUFFIX,
        "fc2/bias" + SUFFIX,
        "conv1/conv_s/kernel/.OPTIMIZER_SLOT/optimizer/momentum" + SUFFIX,
        "save_counter" + SUFFIX, "optimizer/iter" + SUFFIX]
    mapped = 0
    for name in names:
        assert port_import.map_variable(name) == \
            jax_import.map_variable(name), name
        mapped += port_import.map_variable(name) is not None
    assert mapped > 100
    # tests/test_tf_import.py:32-55
    assert port_import.map_variable(
        "stages/0/stage/layer_with_weights-1/bottleneck/se_fc1/bias"
        + SUFFIX) == ("params", "stage2_block1", "bottleneck", "se",
                      "se_fc1", "bias")
    assert port_import.map_variable(
        "stages/3/stage/layer_with_weights-0/bn_r/gamma" + SUFFIX) == (
        "params", "stage5_block0", "bn_r", "norm", "scale")


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_import_matches_jax(ckpt):
    prefix, tree = ckpt
    jcfg, cfg = tiny(jax_variant_config("XS")), tiny(variant_config("XS"))
    jmodel = jax_create_model(jcfg, dtype=jnp.float32)
    # JAX's tool fills a tree of the model's shape; a second draw of the
    # port's weights stands in for its initialisation
    start = reference_tree(seed=1)
    want = jax_import.load_reference_checkpoint(prefix, start)
    model = create_model(cfg, dtype=torch.float32, device="cpu", seed=2)
    got = port_import.load_reference_checkpoint(prefix, model)
    w, g = _leaves(want), _leaves(got)
    assert sorted(w) == sorted(g) == sorted(_leaves(tree))
    for k, v in _leaves(tree).items():
        assert g[k].dtype == np.float32 and np.array_equal(g[k], v), k
        assert np.array_equal(np.asarray(w[k], np.float32), g[k]), k
    back = _leaves(convert.state_dict_to_flax(model.state_dict()))
    for k, v in g.items():
        assert np.array_equal(back[k], v), k

    x = np.random.default_rng(3).normal(
        size=(2 * VIEWS, T, S, S, 3)).astype(np.float32)
    logits = np.asarray(jax.jit(lambda v, x_: jmodel.apply(
        v, x_, train=False, return_logits=True))(
            jax.tree_util.tree_map(jnp.asarray, want), jnp.asarray(x)))
    probs = np.asarray(jax.nn.softmax(logits, axis=-1).reshape(
        -1, VIEWS, CLASSES).mean(axis=1))
    with torch.no_grad():
        got_logits = model(torch.from_numpy(x), return_logits=True).numpy()
        got_probs = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_logits, logits, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_probs, probs, rtol=0, atol=1e-6)


def test_chip_smoke_writer_reads_back_in_tensorflow(tmp_path):
    cs = _chip_smoke()
    tree = reference_tree()
    prefix = str(tmp_path / "model")
    written = cs.write_reference_checkpoint(prefix, tree)
    listed = tf.train.list_variables(prefix)
    assert [n for n, _ in listed] == sorted(
        list(written) + ["_CHECKPOINTABLE_OBJECT_GRAPH"], key=str.encode)
    reader = tf.train.load_checkpoint(prefix)
    for name, value in written.items():
        got = reader.get_tensor(name)
        assert got.dtype == value.dtype and got.tobytes() == value.tobytes(), \
            name
    assert reader.get_tensor("_CHECKPOINTABLE_OBJECT_GRAPH") == b"\n\x00"
    assert any(".OPTIMIZER_SLOT/optimizer/momentum" in n for n in written)
    assert written["save_counter" + SUFFIX].dtype == np.int64
    # the model variables map through the JAX package's map_variable onto
    # the tree's leaves, every leaf once
    leaves = _leaves(tree)
    hit = set()
    for name, value in written.items():
        target = jax_import.map_variable(name)
        if target is None:
            continue
        key = jax.tree_util.keystr(tuple(
            jax.tree_util.DictKey(k) for k in target))
        assert key not in hit, name
        hit.add(key)
        assert np.array_equal(value.reshape(leaves[key].shape),
                              leaves[key]), name
    assert hit == set(leaves)
    # and the port's reader takes its many blocks
    assert tf_bundle.load_checkpoint(prefix).num_blocks > 3


def _tiny_yaml(path):
    import yaml

    with open(os.path.join(ROOT, "x3d_tpu_torch", "configs", "kinetics",
                           "X3D_XS.yaml")) as f:
        text = yaml.safe_load(f)
    text.setdefault("NETWORK", {}).update(
        C1_CHANNELS=4, DEPTH_FACTOR=0.34, NUM_CLASSES=CLASSES)
    text.setdefault("DATA", {}).update(TEMP_DURATION=T, TEST_CROP_SIZE=S)
    text.setdefault("TEST", {}).update(NUM_TEMPORAL_VIEWS=VIEWS,
                                       NUM_SPATIAL_CROPS=1)
    with open(path, "w") as f:
        yaml.safe_dump(text, f)
    return str(path)


def test_cli_on_the_cpu(ckpt, tmp_path, capsys):
    prefix, tree = ckpt
    config = _tiny_yaml(tmp_path / "tiny.yaml")
    rc = port_import.main([f"--ckpt={prefix}", f"--config={config}",
                           "--verify_only", "--device", "cpu"])
    stats = json.loads(capsys.readouterr().out.splitlines()[-1])
    jmodel = jax_create_model(tiny(jax_variant_config("XS")),
                              dtype=jnp.float32)
    want = jax_import.verify_mapping(prefix, jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, T, S, S, 3)), train=False,
                            return_logits=True)))
    capsys.readouterr()
    assert rc == 0 and stats == want and want["errors"] == 0, (stats, want)
    folder = str(tmp_path / "folder")
    rc = port_import.main([f"--ckpt={prefix}", f"--config={config}",
                           f"--output={folder}", "--device=cpu"])
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 0 and out["mapped"] == want["mapped"], out
    assert os.path.exists(os.path.join(folder, "checkpoints", "ckpt-0.pt"))
    engine = InferenceEngine.from_checkpoint(
        tiny(variant_config("XS")), folder, max_videos=1, device="cpu")
    got = _leaves(convert.state_dict_to_flax(engine.model.state_dict()))
    for k, v in _leaves(tree).items():
        assert np.array_equal(got[k], v), k
    probs = engine.predict(np.zeros(engine.clip_shape, np.uint8))
    assert probs.shape == (1, CLASSES) and np.isfinite(probs).all()
    # without a card the tool refuses rather than fall back to the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_import.main([f"--ckpt={prefix}", f"--config={config}",
                              "--verify_only"])


@pytest.mark.parametrize("case", ["missing", "size", "empty"])
def test_import_refusals(tmp_path, case):
    cs = _chip_smoke()
    tree = reference_tree()
    if case == "missing":        # a block the model does not have
        tree["params"]["stage5_block9"] = {
            "residual": {"kernel": np.zeros((1, 1, 1, 4, 4), np.float32)}}
    elif case == "size":
        k = tree["params"]["fc_2"]["kernel"]
        tree["params"]["fc_2"]["kernel"] = np.zeros(
            (k.shape[0], k.shape[1] + 1), np.float32)
    else:
        tree = {"params": {}, "batch_stats": {}}
    prefix = str(tmp_path / "model")
    cs.write_reference_checkpoint(prefix, tree)
    model = create_model(tiny(variant_config("XS")), dtype=torch.float32,
                         device="cpu")
    error, match = {"missing": (KeyError, "stage5_block9"),
                    "size": (ValueError, "fc2/kernel"),
                    "empty": (ValueError, "No model variables")}[case]
    with pytest.raises(error, match=match):
        port_import.load_reference_checkpoint(prefix, model)
    if case != "empty":
        assert port_import.verify_mapping(prefix, model)["errors"] == 1


def test_block_trailer_layout(ckpt):
    """The footer and the first block as the reader takes them: the table
    magic, and a 5-byte trailer whose CRC covers the block and its type
    byte."""
    prefix, _ = ckpt
    with open(prefix + ".index", "rb") as f:
        index = f.read()
    assert index[-8:] == bytes.fromhex("57fb808b247547db")
    meta, pos = tf_bundle._handle(index[-48:], 0, 40)
    offset, size = meta
    crc, = struct.unpack_from("<I", index, offset + size + 1)
    assert index[offset + size] == 0
    assert crc == tf_bundle.masked_crc(tf_bundle.crc_function(None)(
        index[offset:offset + size + 1]))
