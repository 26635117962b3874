"""The numbers that decide ``correct``, each from the program's and the
reference's readings of the same inputs.  A cell's limits file
(``benchmark/limits/<cell>.json``) names the numbers it holds; every
number is printed, a number without a limit beside ``None``.

Training, the first steps of the window's own train step; a leaf's gap is
``| |p| - |r| | / max(|r|, median leaf |r|)`` (norms, not the norm of the
difference):

* ``loss_gap``: ``|L_p - L_r| / |L_r|`` of the first step's loss;
  ``loss_gap_worst`` the worst step's.
* ``stats_gap``: the median leaf's distance of the first forward's
  BatchNorm batch statistics from the reference's (each BN's mean and
  variance, the stem's and every block's, worked out from the running
  statistics' change over the first step): ``|v_p - v_r| / |v_r|`` of a
  variance, ``|m_p - m_r| / |sqrt(v_r)|`` of a mean.  The first forward
  has no earlier step to part the two sides, so the distance itself is
  steady.  ``stats_gap_worst`` the worst leaf's, which a fault in one
  kernel call of the forward moves (the BN after it sees other
  statistics).
* ``grad_gap``, ``grad_gap_worst``: the median and the worst leaf's gap of
  the first gradient as the optimizer holds it.
* ``change_gap``, ``change_gap_worst``: the median and the worst leaf's
  gap of the change over all the steps, parameters and running
  statistics, leaving out parameters whose reference gradient is under a
  thousandth of the median leaf's (moved by round-off alone).

Serving, over every answer of the window:

* ``prob_gap``: the largest gap of a video's centred log-probabilities
  (``log p - mean(log p)``, the logits up to a constant) from the
  reference's, over the largest centred reference value of that video.
* ``video_gap``: the same log-probabilities centred across the videos of
  a request too (what tells one video's answer from another's, which the
  common part of the answers hides): the largest video's distance from
  the reference's, over the root mean square of the reference's
  distances from 0 in that request.  An answer given to the wrong video
  moves it by about its whole scale.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

ROUND_OFF = 1e-3


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names: Optional[Iterable[str]] = None) -> List[float]:
    """Each leaf's ``| |p| - |r| | / max(|r|, median leaf |r|)``."""
    names = list(ref) if names is None else list(names)
    p, r = _norms({k: prog[k] for k in names}), _norms(
        {k: ref[k] for k in names})
    floor = statistics.median(r.values())
    return [abs(p[k] - r[k]) / max(r[k], floor) for k in names]


def moved_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    """Parameters whose reference gradient is above round-off."""
    norms = _norms(ref_grad)
    floor = ROUND_OFF * statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= floor]


def batch_stats(record: dict, names: List[str], momentum: float
                ) -> Dict[str, torch.Tensor]:
    """The first forward's batch statistics, from the running ones folded
    as ``m * running + (1 - m) * batch``."""
    return {k: record["init"][k].double() + (
        record["first"][k].double() - record["init"][k].double())
        / (1.0 - momentum) for k in names}


def train_leaf_gaps(prog: dict, ref: dict, momentum: float
                    ) -> Dict[str, Dict[str, float]]:
    """``prog`` and ``ref``: ``losses``, ``first_grad`` (name -> tensor),
    ``init``, ``first`` and ``after`` (the state before the first step,
    after it and after the last: parameters and running statistics);
    ``momentum`` the BatchNorm's.  Each leaf's gap, by number: ``grad``,
    ``stats``, ``change``."""
    grad = leaf_gaps(prog["first_grad"], ref["first_grad"])
    stats = [k for k in ref["after"] if k.endswith((".mean", ".var"))]
    names = moved_leaves(ref["first_grad"]) + stats
    dp = {k: prog["after"][k].double() - prog["init"][k].double()
          for k in names}
    dr = {k: ref["after"][k].double() - ref["init"][k].double()
          for k in names}
    bp, br = batch_stats(prog, stats, momentum), \
        batch_stats(ref, stats, momentum)
    scale = {k: br[k] if k.endswith(".var")
             else br[k[:-len("mean")] + "var"].clamp_min(0).sqrt()
             for k in stats}
    folded = [float((bp[k] - br[k]).norm() / scale[k].norm())
              for k in stats]
    return {"grad": dict(zip(ref["first_grad"], grad)),
            "stats": dict(zip(stats, folded)),
            "change": dict(zip(names, leaf_gaps(dp, dr)))}


def train_numbers(prog: dict, ref: dict, momentum: float
                  ) -> Dict[str, float]:
    losses = [abs(a - b) / abs(b) for a, b in
              zip(prog["losses"], ref["losses"])]
    out = {"loss_gap": losses[0], "loss_gap_worst": max(losses)}
    for name, gaps in train_leaf_gaps(prog, ref, momentum).items():
        out[f"{name}_gap"] = statistics.median(gaps.values())
        out[f"{name}_gap_worst"] = max(gaps.values())
    return out


def _centred(p: np.ndarray) -> np.ndarray:
    lp = np.log(np.maximum(p.astype(np.float64), 1e-30))
    return lp - lp.mean(axis=-1, keepdims=True)


def prob_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """(videos, classes) probabilities of one request against the
    reference's."""
    cp, cr = _centred(prog), _centred(ref)
    scale = np.abs(cr).max(axis=-1)
    return float((np.abs(cp - cr).max(axis=-1) / scale).max())


def video_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """(videos, classes) probabilities of one request against the
    reference's, centred across the request's videos too."""
    cp, cr = _centred(prog), _centred(ref)
    dp, dr = cp - cp.mean(axis=0), cr - cr.mean(axis=0)
    scale = np.sqrt(np.mean(np.sum(dr * dr, axis=-1)))
    return float(np.linalg.norm(dp - dr, axis=-1).max() / scale)


def serve_numbers(answers: List[np.ndarray], ref: List[np.ndarray]
                  ) -> Dict[str, float]:
    """Every answer against the reference's answer to its request
    (``answers[i]`` to request ``i`` of the pool, cycled)."""
    n = len(ref)
    return {name: max(fn(a, ref[i % n]) for i, a in enumerate(answers))
            for name, fn in (("prob_gap", prob_gap), ("video_gap", video_gap))}


def judge(numbers: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """Every number beside its limit (None where the cell holds it to
    none); the held ones first."""
    held = [k for k in numbers if k in limits]
    return {k: {"value": numbers[k],
                "limit": limits[k]["limit"] if k in limits else None}
            for k in held + [k for k in numbers if k not in limits]}


def passed(checks: Dict[str, dict]) -> bool:
    held = [c for c in checks.values() if c["limit"] is not None]
    return bool(held) and all(
        np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in held)
