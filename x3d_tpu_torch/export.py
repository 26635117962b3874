"""Export: the serving forward as ``torch.export`` programs (``.pt2``).

The deployment artifact of a trained model, the counterpart of the JAX
package's SavedModel export.  :func:`export_program` traces the eval
forward over raw uint8 clips and writes two programs and a description:

  ``serve_clips.pt2``   (clips, T, S, S, 3) uint8 -> (clips, classes)
                        float32 per-clip probabilities
  ``serve_videos.pt2``  (videos*views, T, S, S, 3) uint8 -> (videos,
                        classes) probabilities averaged over the views
                        (the published eval protocol)
  ``export.json``       variant, views, classes, clip shape, dtype,
                        portable, batch (null: dynamic) and the device the
                        programs were traced on

Normalisation runs inside the programs, as in the engine (both run
``serving.serve_forward``).  The batch is dynamic -- any number of clips,
any number of videos -- or fixed by ``batch_clips``.  Each file holds the
float32 parameters and BN statistics as its state (not graph constants),
so either loads without the other.

By default the programs hold the hand-written kernels K1, K2 and K7 as the
``torch.library`` ops ``x3d::depthwise_conv3d``, ``x3d::dw_bn_act_conv``
and ``x3d::pw_conv`` (``ops/library.py``): on the card they launch the
kernels, on the CPU their plain versions, and a process must import
``x3d_tpu_torch`` to load them.  ``portable=True`` traces the plain
versions instead (``ops.plain_versions()``), so the graph holds ATen ops
only and loads in any PyTorch process on any device, without this
package -- the counterpart of the JAX export's pinned plain composition.

Not ported: the JAX package's ``export_tflite``, which needs TensorFlow
(the card machine has none; no ONNX exporter is installed either).

    export_program(cfg, model, "/tmp/x3d_m/export")
    serve = load("/tmp/x3d_m/export")              # serve_videos, on CUDA
    probs = serve(clips_uint8)                     # (videos, classes)
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Optional, Union

import torch
import torch.fx.experimental._config as fx_config
import torch.nn as nn
from torch.export import Dim
from torch.export.passes import move_to_device_pass

from x3d_tpu_torch import VARIANTS, ops, variant_config
from x3d_tpu_torch.models import build_arch, create_model
from x3d_tpu_torch.serving import serve_forward
from x3d_tpu_torch.utils import resolve_device, use_full_float32

SIGNATURES = ("serve_clips", "serve_videos")
META = "export.json"


class _Serve(nn.Module):
    """uint8 clips -> float32 probabilities, per clip or per video."""

    def __init__(self, cfg, model: nn.Module, per_clip: bool):
        super().__init__()
        self.model, self.per_clip = model, per_clip
        self.mean, self.std = tuple(cfg.DATA.MEAN), tuple(cfg.DATA.STD)

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        if self.per_clip:
            logits = serve_forward(self.model, clips, self.mean, self.std,
                                   return_logits=True)
            return torch.softmax(logits.to(torch.float32), dim=-1)
        return serve_forward(self.model, clips, self.mean, self.std)


def _variant(cfg, model: nn.Module) -> Optional[str]:
    """The published variant whose network and clip this is, else None."""
    for name in VARIANTS:
        ref = variant_config(name)
        if build_arch(ref) == model.arch and (
                ref.DATA.TEMP_DURATION, ref.DATA.TEST_CROP_SIZE) == (
                cfg.DATA.TEMP_DURATION, cfg.DATA.TEST_CROP_SIZE):
            return name
    return None


def export_program(cfg, model_or_state_dict: Union[nn.Module, dict],
                   export_dir: str, *, dtype: torch.dtype = torch.float32,
                   batch_clips: Optional[int] = None, portable: bool = False,
                   device=None) -> str:
    """Write ``serve_clips.pt2``, ``serve_videos.pt2`` and ``export.json``
    under ``export_dir`` (created) and return it.

    Args:
      cfg: experiment config (TEST.* the views, DATA.* the clip and the
        normalisation).
      model_or_state_dict: an X3D model computing in ``dtype`` (traced in
        eval mode, its mode restored after) or a state_dict for one.  A
        model on a mesh or with a split head is refused: export the full
        state (``parallel.full_model_state``).
      dtype: the compute dtype inside the programs.
      batch_clips: a fixed clip batch (a multiple of the views); None
        exports a dynamic batch.
      portable: trace the plain versions (ATen ops only) instead of the
        ``x3d::`` ops.
      device: where to trace, and where the programs' state lives: CUDA
        unless the caller asks for the CPU; :func:`load` moves a program
        to another device.
    """
    device = resolve_device(device)
    if isinstance(model_or_state_dict, nn.Module):
        model = model_or_state_dict
        if model.dtype != dtype:
            raise ValueError(f"model computes in {model.dtype}, export asked "
                             f"for {dtype}; pass its state_dict to rebuild it")
        if model.mesh is not None or model.head_split:
            raise ValueError(
                "export takes a model of one process: no mesh and no split "
                "head; pass parallel.full_model_state(model) instead")
        model = model.to(device)
    else:
        model = create_model(cfg, dtype=dtype, device=device, init=False)
        model.load_state_dict(model_or_state_dict)
    views = cfg.TEST.NUM_TEMPORAL_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    if batch_clips is not None and (batch_clips < 1 or batch_clips % views):
        raise ValueError(f"batch_clips {batch_clips} is not a positive "
                         f"multiple of the {views} views")
    clip = (cfg.DATA.TEMP_DURATION, cfg.DATA.TEST_CROP_SIZE,
            cfg.DATA.TEST_CROP_SIZE, cfg.DATA.NUM_INPUT_CHANNELS)
    # a traced batch of two videos: a size of 1 would be specialised
    example = torch.zeros((batch_clips or 2 * views, *clip),
                          dtype=torch.uint8, device=device)
    batch = {"serve_clips": Dim("clips", min=1),
             "serve_videos": views * Dim("videos", min=1)}
    os.makedirs(export_dir, exist_ok=True)
    was_training = model.training
    model.eval()
    # backed_size_oblivious: the view average's reshape would otherwise
    # guard the batch against 1 video (its contiguity check), and a request
    # of one video would fail the program's input check
    try:
        with torch.no_grad(), fx_config.patch(backed_size_oblivious=True), \
                (ops.plain_versions() if portable
                 else contextlib.nullcontext()):
            for name in SIGNATURES:
                shapes = None if batch_clips else ({0: batch[name]},)
                program = torch.export.export(
                    _Serve(cfg, model, name == "serve_clips"), (example,),
                    dynamic_shapes=shapes)
                # the example batch is no state (48 MB of zeros at X3D-M)
                program.example_inputs = None
                torch.export.save(program,
                                  os.path.join(export_dir, name + ".pt2"))
    finally:
        model.train(was_training)
    meta = {"variant": _variant(cfg, model), "views": views,
            "classes": cfg.NETWORK.NUM_CLASSES, "clip": list(clip),
            "dtype": str(dtype).replace("torch.", ""), "portable": portable,
            "batch_clips": batch_clips, "device": device.type}
    with open(os.path.join(export_dir, META), "w") as f:
        json.dump(meta, f, indent=1)
    return export_dir


class Program(nn.Module):
    """A loaded program: uint8 clips -> probabilities, without autograd.
    ``meta`` is the export's ``export.json``.  The program checks its
    input's dtype and shape (a fixed batch, the clip) and raises on a
    mismatch."""

    def __init__(self, module: nn.Module, meta: dict, signature: str):
        super().__init__()
        self.module, self.meta, self.signature = module, meta, signature

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.module(clips)


def load(export_dir: str, signature: str = "serve_videos",
         device=None) -> Program:
    """One signature of an export, on ``device`` (CUDA unless the caller
    asks for the CPU): the program is moved there when it was traced on
    another device.  A float32 program on the card turns TF32 off
    (process-wide), as a float32 engine does."""
    from x3d_tpu_torch.ops import library  # noqa: F401  (the x3d:: ops)

    if signature not in SIGNATURES:
        raise ValueError(f"unknown signature {signature!r}; expected one of "
                         f"{SIGNATURES}")
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with open(os.path.join(export_dir, META)) as f:
        meta = json.load(f)
    program = torch.export.load(os.path.join(export_dir, signature + ".pt2"))
    traced_on = {t.device for t in program.state_dict.values()}
    if traced_on != {device}:
        program = move_to_device_pass(program, device)
    if meta["dtype"] == "float32" and device.type == "cuda":
        use_full_float32()
    return Program(program.module(), meta, signature)
