"""The serving session's compiled steps: the decode step captured once as
a CUDA graph and replayed every step after, the prefill captured once for
each prompt length and replayed whenever that length comes again (the
port's counterparts of the reference session's two ``jax.jit``s,
``_decode`` and ``_prefill1``).

``StepGraph`` runs one step function that reads and writes only static
buffers (the session's tokens, positions, caches and params) and returns a
static output. Called with a key, as ``jax.jit`` is keyed on its static
shapes, it runs the step eagerly the first time it sees a key (the
warm-up: the kernels are built and loaded, the cuBLAS handles and the
split-K ticket counters made, every function attribute set), captures it
the second time and replays the capture from then on. A new key (a buffer
reallocated, another engine, a kernel route patched) drops the graph and
starts again with a warm-up. On the card a capture that fails raises,
naming the op at fault (the port's line that called it, ``op_at_fault``);
nothing falls back to the eager step quietly.

``StepGraphs`` is a family of StepGraphs live at once, one for each value
of a part of the key (the prefill's prompt length), as jit keeps a trace
for each shape it has seen. Its members share one private memory pool
(``GraphPool``), so N lengths do not hold N pools: a member's static
output may lie in memory that another member uses as a temporary, so each
replay's output is read before another member replays. A change in the
rest of the key (an address, a route) drops every member. A lone
StepGraph (the decode step) has a pool of its own.

Every graph of a device is captured on one stream (``capture_stream``),
made once: a stream keeps its cuBLAS workspace and its split-K counters as
long as the process, so they are held once a device, not once a session.

The kernel wrappers count their launches in Python, which a replay does
not run: a capture records each counter's delta and puts the counter
back, and each replay adds the delta (``counted``, ``add_counters``), so N
replayed steps read what N eager steps would.

``eager()`` runs every session's steps eagerly, op by op, the prefill and
the decode step alike, inside its window (the counterpart of
``jax.disable_jit``): a captured step stays captured and is replayed again
after the window.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
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
    """Run every session's prefill and decode step eagerly inside the
    window, in this thread (the counterpart of ``jax.disable_jit``): a step
    inside it takes the routes in force then (a patched ``mla_variant``,
    say), and a captured step is kept and replayed again after it."""
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


_STREAMS: dict = {}     # device index -> the stream its graphs are captured on


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream every graph of ``device`` is captured on, made at its
    first capture (so captures of one device are made one at a time)."""
    s = _STREAMS.get(device.index)
    if s is None:
        s = _STREAMS[device.index] = torch.cuda.Stream(device)
    return s


class GraphPool:
    """A private memory pool that graphs are captured into (a handle of
    ``torch.cuda.graph_pool_handle``), shared by the graphs that hold it
    (``take``, ``give_back``). A handle is made when a capture takes the
    pool and no graph holds it: the allocator frees a pool once its last
    graph is gone and refuses its handle after."""

    def __init__(self):
        self.handle = None
        self.holders: set = set()

    def take(self, holder) -> tuple:
        if not self.holders:
            self.handle = torch.cuda.graph_pool_handle()
        self.holders.add(id(holder))
        return self.handle

    def give_back(self, holder) -> None:
        self.holders.discard(id(holder))


class StepGraph:
    """One step, warmed up, captured and replayed by key.

    ``graph(key, fn)``: ``fn()`` reads and writes static buffers only and
    returns its output, which the capture makes static: each replay
    overwrites it. The step is passed with each call and not kept, so the
    graph holds no reference to its owner (a session's cache is freed
    with the session). ``stats`` holds the captures, replays, the last
    capture's seconds, its pool's bytes (the memory reserved across it),
    and its nodes and kernel nodes (by kernel name, where libcuda gives
    names); ``captured_s`` every capture's seconds, summed (a drop keeps
    it); ``delta`` the counters' moves of one replay (``counted``'s). It
    captures into ``pool``, a pool of its own unless a ``StepGraphs``
    passes the family's (which holds no reference back to the members: a
    family freed with its session is freed at once, not left for the
    cyclic collector to destroy its graphs in the middle of a later
    capture)."""

    def __init__(self, device: torch.device, name: str,
                 pool: Optional[GraphPool] = None):
        self.device, self.name = resolve_device(device), name
        self.pool = pool or GraphPool()
        self.key = None
        self.graph = None
        self.captured_s = 0.0
        self.stats = {"captures": 0, "replays": 0, "capture_s": None,
                      "pool_bytes": None, "nodes": None, "kernel_nodes": None}
        self._out = self.delta = self._tickets = None

    def __call__(self, key, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        if key != self.key:
            self.drop()
            self.key = key
            return fn()                       # the warm-up
        if self.graph is None:
            self._capture(fn)
            self.captured_s += self.stats["capture_s"]
        self.graph.replay()
        add_counters(self.delta)
        self.stats["replays"] += 1
        return self._out

    def drop(self) -> None:
        """Forget the capture (its graph, its hold on the pool and its
        counters' delta)."""
        self.pool.give_back(self)
        self.key = self.graph = None
        self._out = self.delta = self._tickets = None

    def _capture(self, fn: Callable[[], torch.Tensor]) -> None:
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        stream = capture_stream(dev)
        # the GEMVs' split-K counters of the capture stream, made outside
        # the graph's pool and kept as long as the graph
        tickets = gk.reserve_tickets(dev, stream.cuda_stream, like=cur.cuda_stream)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        pool = self.pool.take(self)
        stream.wait_stream(cur)

        def capture():
            # no cyclic collection inside the capture: garbage holding
            # another graph, destroyed mid-capture, would invalidate it
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.stream(stream):
                    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                    try:
                        out = fn()
                    except BaseException:
                        with contextlib.suppress(Exception):
                            graph.capture_end()
                        raise
                    graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
            return out

        try:
            out, delta = counted(capture)
        except Exception as e:
            self.pool.give_back(self)
            raise RuntimeError(f"{self.name}: the capture failed at "
                               f"{op_at_fault(e)}: {e}") from e
        cur.wait_stream(stream)
        self.stats["nodes"], self.stats["kernel_nodes"] = graph_nodes(graph)
        graph.instantiate()
        self.stats.update(captures=self.stats["captures"] + 1,
                          capture_s=time.perf_counter() - t0,
                          pool_bytes=torch.cuda.memory_reserved(dev) - reserved)
        self.graph, self._out, self.delta, self._tickets = graph, out, delta, tickets


class StepGraphs:
    """StepGraphs by a part of their key, all live at once.

    ``graphs(part, shared, fn)`` calls the member for ``part`` (made at its
    first call, which is its warm-up) with the key ``(part, shared)``:
    ``shared`` is what every member's key holds beside its part (shapes,
    engine, routes, addresses), and one that differs from the last call's
    drops every member first. The members capture into one pool
    (``pool``). ``members`` maps each part to its StepGraph; ``stats``
    sums theirs (``pool_bytes``: the memory reserved across all the
    family's captures); ``captured_s`` every capture's seconds, summed
    (a drop keeps it)."""

    def __init__(self, device: torch.device, name: str):
        self.device, self.name = resolve_device(device), name
        self.members: dict = {}
        self.shared = None
        self.pool = GraphPool()
        self.captured_s = 0.0

    def __call__(self, part, shared, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        if shared != self.shared:
            self.drop()
            self.shared = shared
        g = self.members.get(part)
        if g is None:
            g = self.members[part] = StepGraph(self.device, f"{self.name} at {part}",
                                               pool=self.pool)
        before = g.captured_s
        out = g((part, shared), fn)
        self.captured_s += g.captured_s - before
        return out

    def drop(self) -> None:
        """Forget every member (the pool is made anew at the next capture)."""
        for g in self.members.values():
            g.drop()
        self.members, self.shared = {}, None

    @property
    def stats(self) -> dict:
        """The members' captures, replays, capture seconds and pool bytes,
        summed."""
        out = {"members": len(self.members), "captures": 0, "replays": 0,
               "capture_s": 0.0, "pool_bytes": 0}
        for g in self.members.values():
            st = g.stats
            out["captures"] += st["captures"]
            out["replays"] += st["replays"]
            out["capture_s"] += st["capture_s"] or 0.0
            out["pool_bytes"] += st["pool_bytes"] or 0
        return out


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
