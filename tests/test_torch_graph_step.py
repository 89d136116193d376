"""The serving session's compiled decode step (``serving/graphs.py``) on
the CPU: what a CUDA graph capture of ``LM.decode_step`` needs, and the
session's static-buffer step against the JAX session.

- Capturability: every served arch's decode step, run under a dispatch
  mode with the kernels opaque (as a ctypes launch is to the dispatcher
  on the card), reads no scalar on the host, makes no tensor from host
  memory and writes every cache leaf in place.
- The counters: a StepGraph whose card capture is stood in by a replay
  that reruns the step with its counters held moves ``launches`` and
  ``variants`` as the same number of eager steps does, in a session too.
- The plans depend on shapes only.
- ``eager()``: its steps take the routes in force, the captured step
  returns after it.
- The session's greedy tokens equal the JAX session's.

    PYTHONPATH=src python -m pytest tests/test_torch_graph_step.py
"""
import contextlib
import dataclasses
import re
import threading
import traceback

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as jax_smoke
from repro.core.engine import ArcaneEngine as JaxEngine
from repro.models.transformer import LM as JaxLM
from repro.serving.engine import ServeSession as JaxServeSession
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.gemm import kernel as gk
from repro_torch.launch.serve import SERVED
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import LM, tree_leaves
from repro_torch.serving import graphs
from repro_torch.serving.engine import ServeSession

SMS = 132                      # the H100 SXM's SMs
F32 = dict(param_dtype="float32", compute_dtype="float32")
SLOTS, MAX_LEN = 3, 32
POSITIONS = (5, 0, 9)

# Ops that read a scalar on the host in their CPU kernel only, by the line
# of the port that calls them: ATen's one_hot checks its classes with
# .item() (min >= 0, max < num_classes) on the CPU, and on CUDA leaves them
# to scatter's device-side assert and reads nothing
# (aten/src/ATen/native/Onehot.cpp), so the MoE step captures on the card.
CPU_ONLY_SYNCS = {("models/moe.py", "F.one_hot("):
                  "one_hot's value checks: .item() on the CPU only"}


def smoke_model(arch, engine, seed=0, **repl):
    cfg = dataclasses.replace(get_smoke_config(arch), **repl)
    model = LM(cfg, engine, device="cpu")
    return model, model.init_params(torch.Generator().manual_seed(seed))


def step_inputs(vocab, positions=POSITIONS):
    """The session's static buffers: row 0 the tokens, row 1 the positions."""
    toks = np.random.default_rng(3).integers(0, vocab, len(positions))
    return torch.tensor(np.stack((toks, positions)), dtype=torch.int32)


# ------------------------------------------------------- capturability
def static_index(func, args) -> bool:
    """``aten.index.Tensor`` with integer indices: its tag says a dynamic
    shape for a boolean mask's sake, but integer indices give the shape of
    their broadcast, whatever their values."""
    return func == torch.ops.aten.index.Tensor and all(
        i is None or not (i.dtype == torch.bool or i.dtype == torch.uint8)
        for i in args[1])


class OpAudit(TorchDispatchMode):
    """Records every op dispatched outside ``paused()``; of the ops that
    read a value on the host or whose output's shape depends on the data
    (their tags), the port's calling line too."""

    def __init__(self):
        super().__init__()
        self.ops, self.syncs, self._paused = [], [], 0

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self._paused:
            self.ops.append(str(func))
            if torch.Tag.data_dependent_output in func.tags \
                    or (torch.Tag.dynamic_output_shape in func.tags
                        and not static_index(func, args)):
                port = [f for f in traceback.extract_stack()
                        if "repro_torch" in f.filename]
                self.syncs.append((str(func), port[-1] if port else None))
        return func(*args, **(kwargs or {}))


class OpaqueKernels(ArcaneEngine):
    """The card's route on the CPU: each kernel's plain version runs with
    the audit paused, as a ctypes launch is opaque to the dispatcher."""

    def __init__(self, audit):
        super().__init__("ref")
        self.audit = audit

    def gemm(self, *a, **kw):
        with self.audit.paused():
            return super().gemm(*a, **kw)

    def attention(self, *a, **kw):
        with self.audit.paused():
            return super().attention(*a, **kw)

    def decode_attention(self, *a, **kw):
        with self.audit.paused():
            return super().decode_attention(*a, **kw)

    def mla_decode_attention(self, *a, **kw):
        with self.audit.paused():
            return super().mla_decode_attention(*a, **kw)


def cpu_only(frame) -> bool:
    return frame is not None and any(
        frame.filename.replace("\\", "/").endswith(path) and call in (frame.line or "")
        for path, call in CPU_ONLY_SYNCS)


@pytest.mark.parametrize("arch", SERVED)
def test_decode_step_is_capturable(arch, monkeypatch):
    """No op reads a value on the host or makes a data-dependent shape
    (one_hot's CPU-only checks named apart), no tensor is made from host
    memory, every cache leaf is written in place: the same objects at the
    same addresses, their contents moved."""
    audit = OpAudit()
    model, params = smoke_model(arch, OpaqueKernels(audit))
    cache = model.init_cache(SLOTS, MAX_LEN)
    inputs = step_inputs(model.cfg.vocab)
    leaves = tree_leaves(cache)
    before = [(id(t), t.data_ptr(), t.clone()) for t in leaves]
    from_host = []

    def spy(name, fn):
        def made(*a, **kw):
            from_host.append(name)
            return fn(*a, **kw)
        return made

    for name in ("tensor", "as_tensor", "asarray", "from_numpy"):
        monkeypatch.setattr(torch, name, spy(name, getattr(torch, name)))
    with audit:
        logits, out = model.decode_step(params, inputs[0], inputs[1], cache)
    monkeypatch.undo()
    assert logits.shape == (SLOTS, model.cfg.vocab)
    assert audit.ops, "the audit saw no op"
    bad = [(op, None if f is None else f"{f.filename}:{f.lineno}")
           for op, f in audit.syncs if not cpu_only(f)]
    assert not bad, f"{arch}: ops that sync with the host on the step: {bad}"
    named = [op for op, f in audit.syncs if cpu_only(f)]
    assert all(op == "aten._local_scalar_dense.default" for op in named)
    assert bool(named) == (model.cfg.moe is not None), named
    assert not from_host and "aten.lift_fresh.default" not in audit.ops, from_host
    assert out is cache
    after = tree_leaves(out)
    assert [(id(t), t.data_ptr()) for t in after] == [b[:2] for b in before]
    assert all(not torch.equal(t, b[2]) for t, b in zip(after, before))


# ------------------------------------------------------------ counters
class CountingEngine(ArcaneEngine):
    """The plain versions on the CPU, each call counted on its CUDA
    wrapper as the wrapper counts a launch on the card: its variant picked
    by the kernel module's route function in force."""

    def __init__(self):
        super().__init__("ref")

    def gemm(self, x, w, c=None, **kw):
        gk.gemm_cuda.launches += 1
        gk.gemm_cuda.variants[gk.gemm_variant(x.reshape(-1, x.shape[-1]), w)] += 1
        return super().gemm(x, w, c, **kw)

    def attention(self, q, k, v, **kw):
        fk.flash_attention_cuda.launches += 1
        fk.flash_attention_cuda.variants[fk.flash_variant(q, k, v)] += 1
        return super().attention(q, k, v, **kw)

    def decode_attention(self, q, k, v, lengths, **kw):
        dk.decode_attention_cuda.launches += 1
        g = q.shape[1] // k.shape[1]
        dk.decode_attention_cuda.variants[dk.decode_variant(g, q.shape[-1])] += 1
        return super().decode_attention(q, k, v, lengths, **kw)

    def mla_decode_attention(self, q, c, kr, lengths, **kw):
        dk.decode_attention_cuda.launches += 1
        dk.decode_attention_cuda.variants[dk.mla_variant(q, c, kr)] += 1
        return super().mla_decode_attention(q, c, kr, lengths, **kw)


class CpuStepGraph(graphs.StepGraph):
    """StepGraph with the card's capture stood in on the CPU: the capture
    runs the step once through ``graphs.counted`` (as on the card, where
    Python runs it into the graph), and a replay reruns it into the static
    output with its counters held, as a graph's replay runs no Python. The
    replay that follows the capture is the capture's own run: on the card
    a capture records the step and its first replay runs it, so a
    recurrent state is written once."""

    def _capture(self, fn):
        out, delta = graphs.counted(fn)
        captured = [True]          # the capture's run stands for a replay

        class Replay:
            def replay(self):
                if captured:
                    captured.pop()
                    return
                out.copy_(graphs.counted(fn)[0])

        self.stats.update(captures=self.stats["captures"] + 1, capture_s=0.0)
        self.graph, self._out, self.delta = Replay(), out, delta


@pytest.fixture
def zeroed_counters():
    saved = graphs.counters()
    graphs.set_counters({w.__name__: (0, dict.fromkeys(getattr(w, "variants", {}), 0))
                         for w in graphs.COUNTED})
    yield
    graphs.set_counters(saved)


def graphed_session(arch, **kw):
    model, params = smoke_model(arch, CountingEngine(), **F32)
    sess = ServeSession(model, params, max_slots=SLOTS, max_len=64, **kw)
    sess.graph = CpuStepGraph(sess.device, f"{arch} decode step")
    return sess


@pytest.mark.parametrize("arch", ["gemma2-9b", "minicpm3-4b", "granite-moe-1b-a400m"])
def test_replays_move_counters_as_eager_steps(arch, zeroed_counters):
    """N calls of a StepGraph (a warm-up, a capture, replays) leave the
    counters where N eager steps do, with the same outputs."""
    model, params = smoke_model(arch, CountingEngine(), **F32)
    cache = model.init_cache(SLOTS, MAX_LEN)
    inputs = step_inputs(model.cfg.vocab)

    def step():
        return model.decode_step(params, inputs[0], inputs[1], cache)[0]

    n = 5
    snap = [t.clone() for t in tree_leaves(cache)]
    eager = [step().clone() for _ in range(n)]
    want = graphs.counters()
    for t, s in zip(tree_leaves(cache), snap):
        t.copy_(s)
    graphs.set_counters({k: (0, dict.fromkeys(v, 0)) for k, (_, v) in want.items()})
    g = CpuStepGraph(torch.device("cpu"), arch)
    outs = [g("key", step).clone() for _ in range(n)]
    assert g.stats["captures"] == 1 and g.stats["replays"] == n - 1
    assert graphs.counters() == want
    assert want["gemm_cuda"][0] > 0 and want["decode_attention_cuda"][0] > 0
    for a, b in zip(outs, eager):
        assert torch.equal(a, b)


def test_counted_puts_counters_back_when_the_step_raises(zeroed_counters):
    def bad():
        gk.gemm_cuda.launches += 3
        gk.gemm_cuda.variants["gemv"] += 3
        raise RuntimeError("planted")

    before = graphs.counters()
    with pytest.raises(RuntimeError, match="planted"):
        graphs.counted(bad)
    assert graphs.counters() == before


def test_session_counts_each_step_once(zeroed_counters):
    """A graphed session's run: every step's launches counted once, the
    warm-up's, the capture's and the replays' alike, as an eager run's."""
    def run(graphed):
        graphs.set_counters({w.__name__: (0, dict.fromkeys(getattr(w, "variants", {}), 0))
                             for w in graphs.COUNTED})
        sess = graphed_session("gemma2-9b")
        if not graphed:
            sess.graph = None
        prompts = np.random.default_rng(4).integers(0, sess.model.cfg.vocab, (5, 9))
        reqs = [sess.submit(p[:n], max_new_tokens=4) for p, n in zip(prompts, (3, 9, 5, 7, 2))]
        sess.run_to_completion()
        return [r.out_tokens for r in reqs], graphs.counters(), sess

    toks, counts, sess = run(True)
    assert sess.graph.stats["captures"] == 1
    assert sess.graph.stats["replays"] == sess.stats["decode_steps"] - 1
    assert run(False)[:2] == (toks, counts)


# ---------------------------------------------------------- the plans
def test_plans_depend_on_shapes_only():
    """The plans of every GEMV and decode attention a step launches (on
    the card's 132 SMs) are the same at other positions (other lengths)
    over the same cache."""
    class PlanSpy(CountingEngine):
        def __init__(self):
            super().__init__()
            self.plans = []

        def gemm(self, x, w, c=None, **kw):
            x2 = x.reshape(-1, x.shape[-1])
            if gk.gemm_variant(x2, w) == "gemv":
                self.plans.append(("gemv", gk.gemv_plan(w.shape[1], w.shape[0],
                                                        gk.b_layout(w), SMS)))
            return super().gemm(x, w, c, **kw)

        def decode_attention(self, q, k, v, lengths, **kw):
            self.plans.append(("decode", dk.decode_splits(q.shape[0], k.shape[1],
                                                          k.shape[2], SMS)))
            return super().decode_attention(q, k, v, lengths, **kw)

        def mla_decode_attention(self, q, c, kr, lengths, **kw):
            self.plans.append(("mla", dk.mla_splits(q.shape[0], c.shape[1], SMS),
                               dk.decode_splits(q.shape[0], 1, c.shape[1], SMS)))
            return super().mla_decode_attention(q, c, kr, lengths, **kw)

    for arch in ("gemma2-9b", "minicpm3-4b", "jamba-1.5-large-398b"):
        spy = PlanSpy()
        model, params = smoke_model(arch, spy, **F32)
        cache = model.init_cache(SLOTS, MAX_LEN)
        seen = []
        for pos in (POSITIONS, (31, 1, 17), (0, 0, 0)):
            spy.plans = []
            inputs = step_inputs(model.cfg.vocab, pos)
            model.decode_step(params, inputs[0], inputs[1], cache)
            seen.append(spy.plans)
        assert seen[0] and seen[0] == seen[1] == seen[2], arch


# ------------------------------------------------------ the eager window
def test_eager_window_runs_its_routes_and_the_capture_returns(zeroed_counters):
    """Inside ``eager()`` the session steps eagerly under the route in
    force there (decode attention patched onto ``wide``: its variants say
    so, and no replay runs); after the window the captured step replays
    again on its own route, not captured anew, its key the captured one."""
    sess = graphed_session("gemma2-9b")
    prompts = np.random.default_rng(5).integers(0, sess.model.cfg.vocab, (3, 6))
    for p in prompts:
        sess.submit(p, max_new_tokens=12)
    sess.step()
    sess.step()
    assert sess.graph.stats["captures"] == 1 and not graphs.is_eager()
    key = sess.graph_key()
    variants = dk.decode_attention_cuda.variants
    real = dk.decode_variant

    def replays_and_variants(n, window):
        r0, v0 = sess.graph.stats["replays"], dict(variants)
        with window:
            for _ in range(n):
                sess.step()
        return (sess.graph.stats["replays"] - r0,
                {k: variants[k] - v0[k] for k in variants})

    @contextlib.contextmanager
    def wide_route():
        dk.decode_variant = lambda g, d: "wide"
        try:
            with graphs.eager():
                assert graphs.is_eager() and sess.graph_key() != key
                yield
        finally:
            dk.decode_variant = real

    n_attn = sum(s.kind in ("attn", "attn_local") for s in sess.model.cfg.pattern) \
        * sess.model.cfg.n_periods
    assert replays_and_variants(2, wide_route()) == (0, {"narrow": 0, "wide": 2 * n_attn,
                                                         "mla": 0})
    assert not graphs.is_eager() and sess.graph_key() == key
    assert replays_and_variants(2, contextlib.nullcontext()) == (
        2, {"narrow": 2 * n_attn, "wide": 0, "mla": 0})
    assert sess.graph.stats["captures"] == 1
    with pytest.raises(RuntimeError, match="planted"), graphs.eager():
        raise RuntimeError("planted")
    assert not graphs.is_eager()
    seen = []
    with graphs.eager():                  # a window is the opening thread's
        other = threading.Thread(target=lambda: seen.append(graphs.is_eager()))
        other.start()
        other.join(timeout=10)
    assert not other.is_alive() and seen == [False]


def test_a_new_key_drops_the_capture_and_warms_up_again():
    """A route patched outside ``eager()`` or a reallocated cache leaf is
    a new key: the next step runs eagerly (a warm-up), the one after is
    captured anew; the tokens do not change."""
    def run(change):
        sess = graphed_session("stablelm-3b")
        reqs = [sess.submit(p, max_new_tokens=8) for p in
                np.random.default_rng(6).integers(0, sess.model.cfg.vocab, (3, 5))]
        for _ in range(4):
            sess.step()
        change(sess)
        sess.run_to_completion()
        return [r.out_tokens for r in reqs], sess.graph.stats["captures"]

    def realloc(sess):
        c = sess.cache[0]
        c["k"] = c["k"].clone()

    def patch(sess):
        gk.gemv_plan = lambda *a, _f=gk.gemv_plan: _f(*a)

    real = gk.gemv_plan
    try:
        base, caps = run(lambda sess: None)
        assert caps == 1
        assert run(realloc) == (base, 2)
        assert run(patch) == (base, 2)
    finally:
        gk.gemv_plan = real


def test_op_at_fault_names_the_ports_line():
    """A capture's error names the port's innermost line in its traceback:
    here the embedding's lookup of a token past the vocabulary."""
    model, params = smoke_model("stablelm-3b", ArcaneEngine("ref"))
    cache = model.init_cache(SLOTS, MAX_LEN)
    bad = torch.tensor([[model.cfg.vocab, 0, 1], [0, 1, 2]], dtype=torch.int32)
    with pytest.raises(IndexError) as err:
        model.decode_step(params, bad[0], bad[1], cache)
    assert re.fullmatch(r'models/layers\.py:\d+ \(out = params\["table"\]\[tokens\]\)',
                        graphs.op_at_fault(err.value))


def test_reserve_tickets_copies_the_eager_streams_size():
    dev = torch.device("cpu")
    saved = dict(gk._TICKETS)
    try:
        gk._TICKETS.clear()
        assert gk.reserve_tickets(dev, 11, like=10) is None
        gk._TICKETS[(None, 10)] = torch.zeros(9000, dtype=torch.int32)
        t = gk.reserve_tickets(dev, 11, like=10)
        assert t.numel() == 9000 and not t.any() and gk._TICKETS[(None, 11)] is t
        assert gk.reserve_tickets(dev, 11, like=10) is t
    finally:
        gk._TICKETS.clear()
        gk._TICKETS.update(saved)


# -------------------------------------------------- the session vs JAX
@pytest.mark.parametrize("arch", SERVED)
def test_static_buffer_session_matches_jax_session(arch):
    """The port's session (its static-buffer step, 2 slots for 5 requests
    of ragged lengths and budgets, so slots free and refill mid-run)
    gives the JAX session's greedy tokens on the same f32 weights."""
    jcfg = dataclasses.replace(jax_smoke(arch), **F32)
    cfg = dataclasses.replace(get_smoke_config(arch), **F32)
    jmodel = JaxLM(jcfg, JaxEngine(backend="ref"))
    jparams = jmodel.init_params(jax.random.key(2))
    model = LM(cfg, ArcaneEngine("auto"), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(7)
    lens = (16, 4, 16, 9, 3) if cfg.mamba or cfg.rwkv else (12, 4, 17, 9, 3)
    jobs = [(rng.integers(0, cfg.vocab, n), new) for n, new in zip(lens, (5, 3, 6, 2, 4))]

    def serve(sess):
        reqs = [sess.submit(p, max_new_tokens=new) for p, new in jobs]
        sess.run_to_completion()
        return [r.out_tokens for r in reqs]

    sess = ServeSession(model, params, max_slots=2, max_len=40)
    mine = serve(sess)
    assert sess.graph is None and sess.logits.shape == (2, cfg.vocab)
    assert mine == serve(JaxServeSession(jmodel, jparams, max_slots=2, max_len=40))
