"""Debug-mode tensor health dump.

The counterpart of the JAX package's ``x3d_tpu/train/debug.py``: one
eval-mode forward pass with a forward hook on every module, reducing each
module's output to a small health record on the device (finite fraction,
min, max, mean, absmax); only those scalars cross to the host, once, after
the pass.  Written as JSON next to the checkpoints by the train CLI under
``--debug``; also usable standalone::

    from x3d_tpu_torch.train.debug import dump_tensor_health
    report = dump_tensor_health(model, state, batch["video"], out_path)
"""

from __future__ import annotations

import json
import logging
from typing import Dict, Optional

import torch

log = logging.getLogger(__name__)

_FIELDS = ("finite_frac", "min", "max", "mean", "absmax")


def _health(t: torch.Tensor) -> torch.Tensor:
    """(finite_frac, min, max, mean, absmax) as a float64 tensor on t's
    device.  The finite fraction comes from a count, so it is exactly 1.0
    when every value is finite (a float32 mean of ones need not be)."""
    t32 = t.detach().to(torch.float32)
    bad = (~torch.isfinite(t32)).sum().to(torch.float64)
    stats = torch.stack([t32.min(), t32.max(), t32.mean(), t32.abs().max()])
    return torch.cat([(1.0 - bad / t32.numel()).reshape(1),
                      stats.to(torch.float64)])


def tensor_health(model, video) -> Dict[str, Dict]:
    """Per-module output health of one eval-mode forward pass, keyed by the
    module's path (``stage2_block0/bottleneck/bn_a``; ``__call__`` for the
    model's own output).  The model's mode is restored afterwards."""
    records, handles = {}, []

    def watch(name):
        def hook(_module, _inputs, output):
            if isinstance(output, torch.Tensor) and output.numel():
                records[name] = _health(output)
        return hook

    for name, module in model.named_modules():
        key = name.replace(".", "/") if name else "__call__"
        handles.append(module.register_forward_hook(watch(key)))
    was_training = model.training
    try:
        model.eval()
        with torch.no_grad():
            model(video, return_logits=True)   # per clip: no view averaging
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    if not records:
        return {}
    names = list(records)
    table = torch.stack([records[n] for n in names]).cpu().tolist()
    return {n: dict(zip(_FIELDS, row)) for n, row in zip(names, table)}


def dump_tensor_health(model, state, video, out_path: Optional[str] = None
                       ) -> Dict[str, Dict]:
    """Run :func:`tensor_health` on ``state``'s model, log non-finite
    modules, optionally write the JSON report; returns the report dict."""
    if state.model is not model:
        raise ValueError("the state holds another model than the one given")
    report = tensor_health(model, video)
    bad = {k: v for k, v in report.items() if v["finite_frac"] < 1.0}
    for k, v in bad.items():
        log.error("NON-FINITE values in %s: finite_frac=%.6f", k,
                  v["finite_frac"])
    if not bad:
        log.info("tensor health: all %d module outputs finite", len(report))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        log.info("tensor health report written to %s", out_path)
    return report
