"""Serving: multi-view X3D inference on one CUDA card.

``InferenceEngine`` takes raw uint8 clips, copies them to the device and
normalises them there (4x less host-to-device traffic than float input),
runs the eval-mode forward at a fixed capacity of ``max_videos`` videos ×
views clips (ragged requests are padded to it and un-padded on return),
and returns per-video class probabilities averaged over views, or top-k.

Typical use::

    engine = InferenceEngine.random_init(cfg, max_videos=8)   # on CUDA
    engine = InferenceEngine.from_checkpoint(cfg, model_dir)  # trained
    probs = engine.predict(clips_uint8)          # (videos*views, T, S, S, 3)
    idx, p = engine.top_k(clips_uint8, k=5)
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from x3d_tpu_torch import ops
from x3d_tpu_torch.models import create_model
from x3d_tpu_torch.utils import normalize, resolve_device, use_full_float32


def _default_dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def serve_forward(model: nn.Module, clips_u8: torch.Tensor,
                  mean: Sequence[float], std: Sequence[float],
                  return_logits: bool = False) -> torch.Tensor:
    """The eval forward on raw uint8 clips: normalise, cast to the model's
    compute dtype, run the model -- per-video probabilities averaged over
    the views, or with ``return_logits`` the per-clip logits.  The engine
    and the exported programs (``x3d_tpu_torch.export``) both run this."""
    x = normalize(clips_u8, mean, std)
    return model(x.to(model.dtype), return_logits=return_logits)


def restore_model(cfg, model_dir: str, dtype: torch.dtype,
                  device: torch.device) -> nn.Module:
    """An eval-mode model with the latest checkpoint written by the train
    CLI under ``model_dir/checkpoints`` (weights only; optimizer slots
    ignored).  Raises ``FileNotFoundError`` when there is none."""
    import os

    from x3d_tpu_torch.train import create_train_state
    from x3d_tpu_torch.train.checkpoint import CheckpointManager

    model = create_model(cfg, dtype=dtype, device=device, init=False)
    state = create_train_state(cfg, model, steps_per_epoch=1)
    mgr = CheckpointManager(os.path.join(model_dir, "checkpoints"),
                            max_to_keep=0)
    mgr.restore_weights_only(state)
    mgr.close()
    return model


# the engine's layouts, in the JAX engine's order: unfolded, time-folded,
# the first two stages folded
LAYOUTS = (False, True, "mixed")


class InferenceEngine:
    def __init__(self, cfg, module_or_state_dict: Union[nn.Module, dict],
                 max_videos: int = 8, dtype: Optional[torch.dtype] = None,
                 device=None, time_fold=None):
        """
        Args:
          cfg: experiment config (TEST.* defines the view ensemble).
          module_or_state_dict: an X3D model (used as is, moved to
            ``device``) or a state_dict for one (see ``convert``).
          max_videos: batch capacity in videos (videos × views clips).
          dtype: compute dtype; bfloat16 on CUDA, float32 on the CPU.  A
            float32 engine on the card turns TF32 off (process-wide), as
            the tools' ``setup_runtime`` does.
          device: CUDA unless the caller asks for another (the CPU serves
            the tests); raises when no card is present.
          time_fold: the layout of every request (``self.layout``), as
            the JAX package's engine names it: None folds where a request
            at capacity is at most 16 clips; True / False pin the folded or
            the unfolded layout; "mixed" folds the first two stages;
            "measure" keeps the fastest of the three, the first on a tie.
            The port runs one body for every layout (``models/x3d.py``:
            on a GPU the folded tensor is the NDHWC one's memory), so the
            layouts tie and "measure" keeps the unfolded one untimed.
        """
        self.device = resolve_device(device)
        dtype = dtype or _default_dtype(self.device)
        if dtype == torch.float32 and self.device.type == "cuda":
            use_full_float32()
        if isinstance(module_or_state_dict, nn.Module):
            model = module_or_state_dict
            if model.dtype != dtype:
                raise ValueError(
                    f"model computes in {model.dtype}, engine asked for "
                    f"{dtype}; pass its state_dict to rebuild it")
            model = model.to(self.device).eval()
        else:
            model = create_model(cfg, dtype=dtype, device=self.device,
                                 init=False)
            model.load_state_dict(module_or_state_dict)
        self.model = model
        self._views = cfg.TEST.NUM_TEMPORAL_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        self._max_videos = max_videos
        self._mean, self._std = tuple(cfg.DATA.MEAN), tuple(cfg.DATA.STD)
        self.clip_shape = (max_videos * self._views, cfg.DATA.TEMP_DURATION,
                           cfg.DATA.TEST_CROP_SIZE, cfg.DATA.TEST_CROP_SIZE,
                           cfg.DATA.NUM_INPUT_CHANNELS)
        # the request buffer on the device, reused by every request
        self._clips = torch.zeros(self.clip_shape, dtype=torch.uint8,
                                  device=self.device)
        if time_fold is None:
            time_fold = max_videos * self._views <= 16
        if time_fold == "measure":
            time_fold = LAYOUTS[0]
        if time_fold not in LAYOUTS:
            raise ValueError(f"time_fold {time_fold!r}: expected None, "
                             "True, False, 'mixed' or 'measure'")
        self.layout = time_fold
        self.requests = 0        # requests taken, the next one's number

    @classmethod
    def random_init(cls, cfg, max_videos: int = 8,
                    dtype: Optional[torch.dtype] = None, device=None,
                    seed: int = 0, time_fold=None) -> "InferenceEngine":
        """Engine with fresh weights drawn from ``seed`` (smoke tests,
        benchmarking)."""
        device = resolve_device(device)
        dtype = dtype or _default_dtype(device)
        model = create_model(cfg, dtype=dtype, device=device, seed=seed)
        return cls(cfg, model, max_videos=max_videos, dtype=dtype,
                   device=device, time_fold=time_fold)

    @classmethod
    def from_checkpoint(cls, cfg, model_dir: str, max_videos: int = 8,
                        dtype: Optional[torch.dtype] = None, device=None,
                        time_fold=None) -> "InferenceEngine":
        """Engine on the latest checkpoint written by the train CLI under
        ``model_dir/checkpoints`` (weights only; optimizer slots ignored).
        Raises ``FileNotFoundError`` when there is none."""
        device = resolve_device(device)
        dtype = dtype or _default_dtype(device)
        model = restore_model(cfg, model_dir, dtype, device)
        return cls(cfg, model, max_videos=max_videos, dtype=dtype,
                   device=device, time_fold=time_fold)

    @property
    def views(self) -> int:
        return self._views

    def _forward(self, clips_u8: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return serve_forward(self.model, clips_u8, self._mean, self._std)

    def predict(self, clips_u8) -> np.ndarray:
        """(videos*views, T, S, S, 3) uint8 (numpy, or a tensor on any
        device) -> (videos, classes) float32 probabilities.  Fewer than ``max_videos`` videos are padded to the
        capacity and un-padded on return.

        Under an open ``ops.span_log`` a request records the span
        ``engine.request`` (with its ``request`` number, ``videos`` and
        ``clips``) around four in turn: ``engine.convert`` (the input as a
        tensor, and its checks), ``engine.upload`` (the copy into the
        device buffer and the padding), ``engine.forward`` (normalise and
        the model, as launched) and ``engine.fetch`` (the probabilities to
        the host, where the host waits for the card)."""
        number = self.requests
        self.requests += 1
        with ops.span("engine.request") as request:
            with ops.span("engine.convert"):
                clips, n_clips, n_videos = self._checked(clips_u8)
            with ops.span("engine.upload"):
                self._clips[:n_clips].copy_(clips)
                self._clips[n_clips:].zero_()
            with ops.span("engine.forward"):
                probs = self._forward(self._clips)
            with ops.span("engine.fetch"):
                out = probs[:n_videos].to(torch.float32).cpu().numpy()
            if request is not None:
                request.update(request=number, videos=n_videos,
                               clips=n_clips)
        return out

    def _checked(self, clips_u8) -> Tuple[torch.Tensor, int, int]:
        """The request as a uint8 tensor, its clips and its videos; raises
        where its shape does not fit the engine."""
        clips = clips_u8 if isinstance(clips_u8, torch.Tensor) \
            else torch.as_tensor(np.asarray(clips_u8))
        if clips.dtype != torch.uint8 or tuple(clips.shape[1:]) \
                != self.clip_shape[1:]:
            raise ValueError(
                f"expected uint8 clips of shape (N,) + {self.clip_shape[1:]}, "
                f"got {clips.dtype} {tuple(clips.shape)}")
        n_clips = clips.shape[0]
        if n_clips % self._views:
            raise ValueError(
                f"clip count {n_clips} not divisible by views={self._views}")
        n_videos = n_clips // self._views
        if n_videos > self._max_videos:
            raise ValueError(
                f"{n_videos} videos exceeds engine capacity "
                f"{self._max_videos}; split the request")
        return clips, n_clips, n_videos

    def top_k(self, clips_u8, k: int = 5) -> Tuple[np.ndarray, np.ndarray]:
        """-> (indices (videos, k), probabilities (videos, k))."""
        probs = self.predict(clips_u8)
        idx = np.argsort(-probs, axis=-1)[:, :k]
        return idx, np.take_along_axis(probs, idx, axis=-1)

    def device_latency_s(self, iters: int = 8, warmup: int = 2) -> float:
        """Seconds of one request at full capacity, timed on the card with
        CUDA events over ``iters`` back-to-back requests (after ``warmup``).
        The span covers the device's work and any gap the host leaves
        between launches."""
        if self.device.type != "cuda":
            raise RuntimeError("device_latency_s times the card with CUDA "
                               "events; this engine runs on the CPU")
        from x3d_tpu_torch.ops.timing import time_fn

        return time_fn(self._forward, self._clips, iters=iters,
                       warmup=warmup)

    def wall_latency_s(self, samples: int = 20) -> float:
        """Median host wall-clock seconds per request at full capacity,
        upload, forward and result fetch included."""
        clips = np.zeros(self.clip_shape, np.uint8)
        self.predict(clips)                                  # warm path
        times = []
        for _ in range(samples):
            t0 = time.perf_counter()
            self.predict(clips)
            times.append(time.perf_counter() - t0)
        return float(np.median(times))
