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

Each wrapper that counts its launches also appends one record a call to
the open :func:`launch_log`, if there is one: which kernel and body ran,
on what shape, in which direction, and the call's least bytes and
operations from the kernel's ``cost`` function beside the wrapper.

The engine's request and the train step mark their phases as spans
(:func:`span`), which an open :func:`span_log` keeps with their host times
(``tools/trace.span_times`` maps them onto a device trace's timeline, by
anchors it takes on both clocks).  Spans and launch records are switched
apart: a span costs a clock read, a launch record its ``cost`` function.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

_plain = False
# the open launch log's list, or None: the one check a wrapper makes when
# no log is open.  Module-wide, not per thread: autograd runs a CUDA
# backward on a thread of its own, and its launches belong to the same log
records = None
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


@contextlib.contextmanager
def _log(name: str):
    """Open a log: the module global ``name`` holds a fresh list within the
    context, which is yielded; on closing, the global gets back the list it
    held before, and that outer list, if any, the records."""
    g = globals()
    prev, mine = g[name], []
    g[name] = mine
    try:
        yield mine
    finally:
        g[name] = prev
        if prev is not None:
            prev.extend(mine)


def launch_log():
    """Within this context every kernel wrapper's call appends one record
    to the yielded list, from any thread, in the order the calls were
    made (on a CUDA tensor: the order their kernels were enqueued):

    * ``kernel``: "K1", "K2", "K3", "K4 dx", "K4 dk", "K5", "K6", "K7",
      "K8";
    * ``body``: the body that ran ("ring", "wg", ...; "plain" on the CPU);
    * ``shape``: ``{"taps": [kt, kh, kw], "C": C}`` for the depthwise
      kernels, ``{"M": M, "K": K, "N": N}`` for the GEMMs;
    * ``direction``: "fwd" or "bwd" (K3, K4, K8 and K7's dx);
    * ``dtype``: the activations' dtype, as "bfloat16" or "float32";
    * ``bytes`` and ``flops``: the call's least bytes moved and operations
      (the kernel's ``cost`` function, its epilogue's included);
    * ``epilogue``: the eval BatchNorm the call applies to its output
      (``ops/epilogue.py``): "bn", "bn_relu", or "none" (every call of a
      kernel other than K1, K2 and K7).

    A log opened inside another hands its records on to the outer one when
    it closes."""
    return _log("records")


def log_launch(kernel: str, body: str, shape: dict, direction: str,
               dtype: torch.dtype, cost, epilogue: str = "none") -> None:
    """Append one record to the open :func:`launch_log` (the caller has
    checked that one is open); ``cost`` is the (bytes, flops) pair."""
    log = records
    if log is not None:
        log.append({"kernel": kernel, "body": body, "shape": shape,
                    "direction": direction,
                    "dtype": str(dtype).removeprefix("torch."),
                    "bytes": int(cost[0]), "flops": int(cost[1]),
                    "epilogue": epilogue})


# the open span log's list, or None: the one check a span makes when no
# log is open
spans = None
# span ids, unique over the process: a child names its parent's, and a
# request's or step's spans share their outermost span's id as ``call``
_ids = itertools.count()


class _Open(threading.local):
    """The spans open in this thread, innermost last."""

    def __init__(self):
        self.stack = []


_open = _Open()


class _Closed:
    """The span of a call made with no span log open: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_CLOSED = _Closed()


class _Span:
    """One span of an open log: its record, and the stack of the thread
    that opened it."""

    __slots__ = ("name", "log", "record", "stack")

    def __init__(self, name: str, log: list):
        self.name, self.log = name, log

    def __enter__(self) -> dict:
        stack = _open.stack
        ident = next(_ids)
        parent = stack[-1] if stack else None
        record = {"name": self.name, "id": ident,
                  "parent": parent["id"] if parent else None,
                  "call": parent["call"] if parent else ident,
                  "start_ns": time.time_ns(), "end_ns": None}
        self.record, self.stack = record, stack
        self.log.append(record)
        stack.append(record)
        return record

    def __exit__(self, *exc):
        self.record["end_ns"] = time.time_ns()
        self.stack.pop()
        return False


def span(name: str):
    """A context that marks one phase of a call in the open
    :func:`span_log`, and yields its record, to which the caller may add
    keys; with no log open it records nothing and yields None."""
    log = spans
    if log is None:
        return _CLOSED
    return _Span(name, log)


def span_log():
    """Within this context every :func:`span` appends one record to the
    yielded list when it opens, in the order they open:

    * ``name``: "engine.request", "engine.upload", "train.step", ...;
    * ``id``: unique over the process; ``parent``: the id of the span
      open around it in the same thread, or None;
    * ``call``: the id of its outermost span, shared by every span of one
      request or step;
    * ``start_ns`` and ``end_ns``: ``time.time_ns()`` at its open and
      close (None while open);
    * whatever keys the span's owner added.

    A log opened inside another hands its records on to the outer one when
    it closes.  Opens no :func:`launch_log`."""
    return _log("spans")
