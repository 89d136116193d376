"""The serving session's compiled decode step: captured once as a CUDA
graph and replayed every step after (the port's counterpart of the
reference session's ``jax.jit``).

``StepGraph`` runs one step function that reads and writes only static
buffers (the session's tokens, positions, cache and params) and returns a
static output. Called with a key, as ``jax.jit`` is keyed on its static
shapes, it runs the step eagerly the first time it sees a key (the
warm-up: the kernels are built and loaded, the cuBLAS handles and the
split-K ticket counters made, every function attribute set), captures it
the second time and replays the capture from then on. A new key (a buffer
reallocated, another engine, a kernel route patched) drops the graph and
starts again with a warm-up. On the card a capture that fails raises,
naming the op at fault (the port's line that called it, ``op_at_fault``);
nothing falls back to the eager step quietly.

The kernel wrappers count their launches in Python, which a replay does
not run: a capture records each counter's delta and puts the counter
back, and each replay adds the delta (``counted``, ``add_counters``), so N
replayed steps read what N eager steps would.

``eager()`` runs every session's step eagerly, op by op, inside its window
(the counterpart of ``jax.disable_jit``): a captured step stays captured
and is replayed again after the window.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
import time
import traceback
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.kernels.convlayer.kernel import conv_layer_cuda
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.gemm import kernel as gk
from repro_torch.kernels.leakyrelu.kernel import leakyrelu_cuda
from repro_torch.kernels.maxpool.kernel import maxpool_cuda

# the kernel wrappers whose ``launches`` (and ``variants``) a replay moves
COUNTED = (gk.gemm_cuda, dk.decode_attention_cuda, fk.flash_attention_cuda,
           conv_layer_cuda, maxpool_cuda, leakyrelu_cuda)
# the functions that pick a kernel's route and plan from its operands, by
# module: a step captured under one set of them replays that set's launches
ROUTES = ((gk, ("gemm_variant", "b_layout", "gemv_plan")),
          (dk, ("decode_variant", "decode_splits", "mla_variant", "mla_splits")),
          (fk, ("flash_variant",)))

_EAGER = threading.local()      # this thread's open eager() windows


# ------------------------------------------------------------ counters
def counters() -> dict:
    """Every counted wrapper's launches and variants, by wrapper name."""
    return {w.__name__: (w.launches, dict(getattr(w, "variants", {})))
            for w in COUNTED}


def set_counters(snapshot: dict) -> None:
    """Put every counted wrapper's counters back to ``snapshot``."""
    for w in COUNTED:
        n, variants = snapshot[w.__name__]
        w.launches = n
        for k, v in variants.items():
            w.variants[k] = v


def counted(fn: Callable):
    """``fn()`` with the counters it moves recorded and put back: returns
    (its result, the delta: [(wrapper, launches, [(variant, n), ...])]
    for each wrapper it moved). The counters are put back if it raises."""
    before = counters()
    try:
        out = fn()
        after = counters()
    finally:
        set_counters(before)
    delta = []
    for w in COUNTED:
        (n0, v0), (n1, v1) = before[w.__name__], after[w.__name__]
        moved = [(k, v1[k] - v0.get(k, 0)) for k in v1 if v1[k] != v0.get(k, 0)]
        if n1 != n0 or moved:
            delta.append((w, n1 - n0, moved))
    return out, delta


def add_counters(delta) -> None:
    """Move the counters by a delta of ``counted``, as its run did."""
    for w, n, moved in delta:
        w.launches += n
        for k, v in moved:
            w.variants[k] += v


# ------------------------------------------------------------- routes
@contextlib.contextmanager
def eager():
    """Run every session's decode step eagerly inside the window, in this
    thread (the counterpart of ``jax.disable_jit``): a step inside it takes
    the routes in force then (a patched ``mla_variant``, say), and a
    captured step is kept and replayed again after it."""
    _EAGER.depth = getattr(_EAGER, "depth", 0) + 1
    try:
        yield
    finally:
        _EAGER.depth -= 1


def is_eager() -> bool:
    """Whether an ``eager()`` window is open in this thread."""
    return getattr(_EAGER, "depth", 0) > 0


def routes() -> tuple:
    """The route and plan functions in force (``ROUTES``), as a key."""
    return tuple(getattr(m, name) for m, names in ROUTES for name in names)


# -------------------------------------------------------------- graph
def op_at_fault(err: BaseException) -> str:
    """The port's innermost line in an error's traceback: the op that
    failed, where the step called it."""
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if "repro_torch" in f.filename and not f.filename.endswith("graphs.py")]
    if not frames:
        return "an op outside the port"
    f = frames[-1]
    return f"{f.filename.split('repro_torch')[-1].lstrip('/')}:{f.lineno} ({f.line})"


class StepGraph:
    """One step, warmed up, captured and replayed by key.

    ``graph(key, fn)``: ``fn()`` reads and writes static buffers only and
    returns its output, which the capture makes static: each replay
    overwrites it. The step is passed with each call and not kept, so the
    graph holds no reference to its owner (a session's cache is freed
    with the session). ``stats``
    holds the captures, replays, the last capture's seconds, its private
    pool's bytes (the memory reserved across it), and its nodes and kernel
    nodes (by kernel name, where libcuda gives names); ``delta`` the
    counters' moves of one replay (``counted``'s)."""

    def __init__(self, device: torch.device, name: str):
        self.device, self.name = resolve_device(device), name
        self.key = None
        self.graph = None
        self.stats = {"captures": 0, "replays": 0, "capture_s": None,
                      "pool_bytes": None, "nodes": None, "kernel_nodes": None}
        self._out = self.delta = self._stream = self._tickets = None

    def __call__(self, key, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        if key != self.key:
            self.drop()
            self.key = key
            return fn()                       # the warm-up
        if self.graph is None:
            self._capture(fn)
        self.graph.replay()
        add_counters(self.delta)
        self.stats["replays"] += 1
        return self._out

    def drop(self) -> None:
        """Forget the capture (its graph, pool and counters' delta)."""
        self.key = self.graph = None
        self._out = self.delta = self._tickets = None

    def _capture(self, fn: Callable[[], torch.Tensor]) -> None:
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        stream = self._stream
        # the GEMVs' split-K counters of the capture stream, made outside
        # the graph's pool and kept as long as the graph
        tickets = gk.reserve_tickets(dev, stream.cuda_stream, like=cur.cuda_stream)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        stream.wait_stream(cur)

        def capture():
            with torch.cuda.stream(stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = fn()
                except BaseException:
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                graph.capture_end()
            return out

        try:
            out, delta = counted(capture)
        except Exception as e:
            raise RuntimeError(f"{self.name}: the capture failed at "
                               f"{op_at_fault(e)}: {e}") from e
        cur.wait_stream(stream)
        self.stats["nodes"], self.stats["kernel_nodes"] = graph_nodes(graph)
        graph.instantiate()
        self.stats.update(captures=self.stats["captures"] + 1,
                          capture_s=time.perf_counter() - t0,
                          pool_bytes=torch.cuda.memory_reserved(dev) - reserved)
        self.graph, self._out, self.delta, self._tickets = graph, out, delta, tickets


# libcuda's CU_GRAPH_NODE_TYPE_KERNEL, and the offsets of func and kern in
# CUDA_KERNEL_NODE_PARAMS_v2
_KERNEL_NODE, _FUNC_AT, _KERN_AT = 0, 0, 56


def graph_nodes(graph) -> tuple[Optional[int], Optional[dict]]:
    """(the captured graph's nodes, its kernel nodes by kernel name) read
    through libcuda, the names mangled; the names are None where libcuda
    does not give them, both where the graph cannot be read."""
    try:
        cu = ctypes.CDLL("libcuda.so.1")
        g = ctypes.c_void_p(graph.raw_cuda_graph())
    except (OSError, RuntimeError, AttributeError):
        return None, None
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(g, None, ctypes.byref(n)) != 0:
        return None, None
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)) != 0:
        return None, None
    names: dict = {}
    kinds = ctypes.c_int()
    params = (ctypes.c_byte * 256)()
    name = ctypes.c_char_p()
    try:
        for node in nodes:
            node = ctypes.c_void_p(node)
            if cu.cuGraphNodeGetType(node, ctypes.byref(kinds)) != 0:
                return n.value, None
            if kinds.value != _KERNEL_NODE:
                continue
            if cu.cuGraphKernelNodeGetParams_v2(node, params) != 0:
                return n.value, None
            func = ctypes.c_void_p.from_buffer(params, _FUNC_AT).value
            kern = ctypes.c_void_p.from_buffer(params, _KERN_AT).value
            err = cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func)) if func \
                else cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(kern))
            if err != 0 or not name.value:
                return n.value, None
            key = name.value.decode()
            names[key] = names.get(key, 0) + 1
    except AttributeError:                    # a libcuda without these entries
        return n.value, None
    return n.value, names
