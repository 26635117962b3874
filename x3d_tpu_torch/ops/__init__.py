"""Tensor ops of the port: plain PyTorch code and the wrappers of the CUDA
kernels, each beside its plain version.

A wrapper runs its plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises.  :func:`plain_versions` lets a
caller run the model through the plain versions on any device, to check
the kernels against them at full size; no default path takes it.

The differentiable ops launch a kernel's forward in one of two ways: by a
direct call of its launch function (eager serving and training), or
through its ``torch.library`` op (``ops/library.py``) where something must
see the call as one op: ``torch.export`` while the model is exported, and
the selective checkpoint of remat "convs", whose policy keeps the ops'
outputs (:func:`library_calls`, :func:`via_library`).
"""

from __future__ import annotations

import contextlib
import threading

import torch

_plain = False
# per thread, as the selective checkpoint's dispatch mode it pairs with:
# autograd runs a CUDA backward, and so the recompute, on a thread of its own
class _Library(threading.local):
    on = False


_library = _Library()


@contextlib.contextmanager
def plain_versions():
    """Within this context the model calls the kernels' plain versions."""
    global _plain
    prev, _plain = _plain, True
    try:
        yield
    finally:
        _plain = prev


def plain_versions_enabled() -> bool:
    return _plain


@contextlib.contextmanager
def library_calls():
    """Within this context the differentiable ops launch their kernels'
    forwards through the ``x3d::`` ops (a remat "convs" region); in this
    thread only."""
    prev, _library.on = _library.on, True
    try:
        yield
    finally:
        _library.on = prev


def via_library() -> bool:
    """Whether a kernel's forward goes through its ``x3d::`` op: while the
    model is exported or inside :func:`library_calls` in this thread."""
    return _library.on or torch.compiler.is_exporting()
