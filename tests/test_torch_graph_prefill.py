"""The serving session's compiled prefill (``serving/graphs.py:
StepGraphs``, ``serving/engine.py: ServeSession.prefill``) on the CPU:
what a CUDA graph capture of an admit needs, the graphs by prompt length,
and the session's batch-1 cache and insert against the JAX session.

- Capturability: every served arch's prefill function (the batch-1 cache
  zeroed, ``LM.prefill`` on the static prompt buffer, the insert into the
  slot's rows), run under a dispatch mode with the kernels opaque, reads
  no scalar on the host, makes no tensor from host memory, writes both
  caches in place and leaves the other slots' rows as they were.
- The counters: replayed prefills (the card's capture stood in on the
  CPU, ``CpuStepGraph``) move ``launches`` and ``variants`` as eager ones.
- The graphs by length follow StepGraph's rule for each length; a new
  length drops no other, a new address drops them all, an admit leaves
  the decode step's graph; ``eager()`` runs the prefill eagerly; a freed
  session frees its graphs without the cyclic collector.
- The session's greedy tokens equal the JAX session's, and after each
  admit the slot's cache rows equal the JAX session's ``_insert_slot``.

    PYTHONPATH=src python -m pytest tests/test_torch_graph_prefill.py
"""
import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.engine import ArcaneEngine as JaxEngine
from repro.models.transformer import LM as JaxLM
from repro.serving.engine import ServeSession as JaxServeSession
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.launch.serve import SERVED
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.models.transformer import LM, tree_leaves
from repro_torch.serving import graphs
from repro_torch.serving.engine import ServeSession
from test_torch_graph_step import (F32, CountingEngine, CpuStepGraph, OpAudit,
                                   OpaqueKernels, cpu_only, smoke_model,
                                   zeroed_counters)

SLOTS, MAX_LEN = 3, 64
# after each admit the slot's rows against the JAX session's at f32: the
# same tolerance both ways
ROWS_TOL = 1e-4

__all__ = ["zeroed_counters"]


def recurrent(cfg) -> bool:
    return cfg.mamba is not None or cfg.rwkv is not None


def two_lengths(cfg) -> tuple:
    """Two prompt lengths the prefill takes: the recurrent scans' over one
    chunk and over three (16-token chunks at smoke size)."""
    return (16, 48) if recurrent(cfg) else (5, 23)


def prompts(cfg, lens, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]


@pytest.fixture
def cpu_graphs(monkeypatch):
    """Sessions made after it capture on the CPU stand-in: their decode
    StepGraph and their prefill StepGraphs' members are CpuStepGraphs."""
    monkeypatch.setattr(graphs, "StepGraph", CpuStepGraph)

    def graphed(sess):
        name = sess.model.cfg.name
        sess.graph = CpuStepGraph(sess.device, f"{name} decode step")
        sess.prefill_graphs = graphs.StepGraphs(sess.device, f"{name} prefill")
        return sess

    return graphed


# ------------------------------------------------------- capturability
@pytest.mark.parametrize("arch", SERVED)
def test_prefill_is_capturable(arch, monkeypatch):
    """At two lengths (several scan chunks for the recurrent archs), into
    slots 1 and 2 of a cache whose rows all hold random values: no op reads
    a value on the host or makes a data-dependent shape (one_hot's CPU-only
    checks named apart), no tensor is made from host memory, the batch-1
    and the batched cache are the same objects at the same addresses, the
    slot's rows are the batch-1 cache (equal to a prefill into a fresh
    cache) and the other slots' rows are untouched."""
    audit = OpAudit()
    model, params = smoke_model(arch, OpaqueKernels(audit))
    sess = ServeSession(model, params, max_slots=SLOTS, max_len=MAX_LEN)
    gen = torch.Generator().manual_seed(1)
    for t in tree_leaves((sess.cache, sess.one_cache)):
        t.copy_(torch.randn(t.shape, generator=gen))
    from_host = []

    def spy(name, fn):
        def made(*a, **kw):
            from_host.append(name)
            return fn(*a, **kw)
        return made

    lens = two_lengths(model.cfg)
    for slot, prompt in zip((1, 2), prompts(model.cfg, lens)):
        s = len(prompt)
        sess._load_prompt(prompt, slot)
        leaves = tree_leaves((sess.cache, sess.one_cache))
        before = [(id(t), t.data_ptr(), t.clone()) for t in leaves]
        audit.ops, audit.syncs = [], []
        for name in ("tensor", "as_tensor", "asarray", "from_numpy"):
            monkeypatch.setattr(torch, name, spy(name, getattr(torch, name)))
        with audit:
            logits = sess._eager_prefill(s)
        monkeypatch.undo()
        assert logits.shape == (1, model.cfg.vocab)
        assert audit.ops, "the audit saw no op"
        bad = [(op, None if f is None else f"{f.filename}:{f.lineno}")
               for op, f in audit.syncs if not cpu_only(f)]
        assert not bad, f"{arch} at {s}: ops that sync with the host: {bad}"
        named = [op for op, f in audit.syncs if cpu_only(f)]
        assert all(op == "aten._local_scalar_dense.default" for op in named)
        assert bool(named) == (model.cfg.moe is not None), named
        assert not from_host and "aten.lift_fresh.default" not in audit.ops, from_host
        after = tree_leaves((sess.cache, sess.one_cache))
        assert [(id(t), t.data_ptr()) for t in after] == [b[:2] for b in before]
        fresh = model.init_cache(1, MAX_LEN)
        want, _ = model.prefill(params, {"tokens": torch.from_numpy(prompt[None])}, fresh)
        assert torch.equal(logits, want)
        for big, one, ref, (_, _, old) in zip(tree_leaves(sess.cache),
                                              tree_leaves(sess.one_cache),
                                              tree_leaves(fresh), before):
            assert torch.equal(one, ref) and torch.equal(big[:, slot], one[:, 0])
            others = [i for i in range(SLOTS) if i != slot]
            assert torch.equal(big[:, others], old[:, others])


# ------------------------------------------------------------ counters
def serve(sess, jobs):
    reqs = [sess.submit(p, max_new_tokens=new) for p, new in jobs]
    sess.run_to_completion()
    return [r.out_tokens for r in reqs]


def repeated_jobs(cfg, seed=4):
    """Six requests whose prompt lengths repeat (two of three lengths, one
    once), ragged budgets so slots free and refill mid-run."""
    lens = (16, 32, 16, 32, 16, 4) if recurrent(cfg) else (7, 12, 7, 12, 7, 3)
    return list(zip(prompts(cfg, lens, seed), (3, 5, 2, 4, 3, 2)))


@pytest.mark.parametrize("arch", ["gemma2-9b", "granite-moe-1b-a400m", "minicpm3-4b",
                                  "rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_replayed_prefills_move_counters_as_eager_ones(arch, cpu_graphs, zeroed_counters):
    """A run whose prompt lengths repeat, its prefills warmed up, captured
    and replayed on the CPU stand-in: the tokens and every wrapper's
    launches and variants equal an eager run's."""
    def run(graphed):
        graphs.set_counters({w.__name__: (0, dict.fromkeys(getattr(w, "variants", {}), 0))
                             for w in graphs.COUNTED})
        model, params = smoke_model(arch, CountingEngine(), **F32)
        sess = ServeSession(model, params, max_slots=2, max_len=MAX_LEN)
        if graphed:
            cpu_graphs(sess)
        return serve(sess, repeated_jobs(model.cfg)), graphs.counters(), sess

    toks, counts, sess = run(True)
    st = sess.prefill_graphs.stats
    assert (st["members"], st["captures"], st["replays"]) == (3, 2, 3)
    assert counts["gemm_cuda"][0] > 0
    eager_toks, eager_counts, _ = run(False)
    assert (toks, counts) == (eager_toks, eager_counts)


# ------------------------------------------------------ graphs by length
def test_graphs_by_length_follow_the_step_rule(cpu_graphs):
    """Prompt lengths a, b, a, a, b, c into one slot: each length's first
    admit runs eagerly, its second captures (and replays), later ones
    replay; a new length drops no other member, an admit leaves the decode
    step's captured graph, a new param address drops every member, and
    inside ``eager()`` the prefill runs eagerly, no member moved. The
    tokens equal an eager session's."""
    model, params = smoke_model("gemma2-9b", ArcaneEngine("ref"), **F32)
    lens = (7, 12, 7, 7, 12, 3)
    jobs = list(zip(prompts(model.cfg, lens, 6), (4,) * len(lens)))
    sess = cpu_graphs(ServeSession(model, params, max_slots=1, max_len=MAX_LEN))
    fam = sess.prefill_graphs
    seen, decode_graphs = [], set()
    reqs = [sess.submit(p, max_new_tokens=new) for p, new in jobs]
    while sess.pending or sess.slots[0] is not None:
        admitted = sess.stats["prefill_tokens"]
        sess.step()
        if sess.stats["prefill_tokens"] != admitted:
            seen.append({s: (g.stats["captures"], g.stats["replays"])
                         for s, g in fam.members.items()})
        if sess.graph.graph is not None:
            decode_graphs.add(id(sess.graph.graph))
    assert seen == [{7: (0, 0)},
                      {7: (0, 0), 12: (0, 0)},
                      {7: (1, 1), 12: (0, 0)},
                      {7: (1, 2), 12: (0, 0)},
                      {7: (1, 2), 12: (1, 1)},
                      {7: (1, 2), 12: (1, 1), 3: (0, 0)}]
    assert len(decode_graphs) == 1 and sess.graph.stats["captures"] == 1
    assert sess.stats["prefill_capture_s"] == fam.captured_s >= 0.0
    eager_model, eager_params = smoke_model("gemma2-9b", ArcaneEngine("ref"), **F32)
    eager = ServeSession(eager_model, eager_params, max_slots=1, max_len=MAX_LEN)
    assert [r.out_tokens for r in reqs] == serve(eager, jobs)

    kept = dict(fam.members)
    with graphs.eager():
        sess.submit(jobs[0][0], max_new_tokens=2)
        sess.run_to_completion()
    assert fam.members == kept
    assert {s: (g.stats["captures"], g.stats["replays"]) for s, g in kept.items()} \
        == seen[-1]
    sess.submit(jobs[0][0], max_new_tokens=2)
    sess.run_to_completion()
    assert fam.members[7].stats["replays"] == 3
    table = sess.params["embed"]["table"]
    sess.params["embed"]["table"] = table.clone()
    sess.submit(jobs[0][0], max_new_tokens=2)
    sess.run_to_completion()
    assert list(fam.members) == [7] and fam.members[7].stats["captures"] == 0
    assert not any(g.graph is not None for g in kept.values())
    assert sess.stats["prefill_capture_s"] == fam.captured_s


def test_a_graph_pool_is_made_anew_once_no_graph_holds_it(monkeypatch):
    """The pool's handle (``GraphPool``): the graphs that capture into it
    while another holds it share its handle; once every holder gave it
    back (its graphs dropped, or its capture failed) the next capture
    takes a new one, as the allocator refuses the handle of a pool whose
    graphs are gone. A lone StepGraph has a pool of its own, a family's
    members the family's."""
    made = iter(range(100))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, next(made)))
    pool = graphs.GraphPool()
    a, b, c = object(), object(), object()
    assert pool.take(a) == (0, 0) and pool.take(b) == (0, 0)
    pool.give_back(a)
    assert pool.take(c) == (0, 0)
    pool.give_back(b)
    pool.give_back(c)
    pool.give_back(c)                         # twice, or never taken: no-op
    assert pool.take(a) == (0, 1)
    fam = graphs.StepGraphs("cpu", "prefill")
    fam(3, "k", lambda: torch.zeros(1))
    fam(5, "k", lambda: torch.zeros(1))
    assert all(g.pool is fam.pool for g in fam.members.values())
    lone = graphs.StepGraph("cpu", "decode step")
    assert lone.pool is not fam.pool and lone.pool is not \
        graphs.StepGraph("cpu", "decode step").pool


def test_a_freed_session_frees_its_prefill_graphs(cpu_graphs):
    """No reference cycle runs through the prefill graphs: with the cyclic
    collector off, a session dropped after serving frees its graphs by
    length and every member at once. Left in a cycle, they would wait for
    the collector, which may run in the middle of a later capture, and a
    CUDA graph destroyed there invalidates that capture."""
    model, params = smoke_model("gemma2-9b", ArcaneEngine("ref"), **F32)
    sess = cpu_graphs(ServeSession(model, params, max_slots=1, max_len=MAX_LEN))
    # the decode step's stand-in replays by running the step, so it holds
    # the session; the card's graph holds no Python
    sess.graph = None
    serve(sess, list(zip(prompts(model.cfg, (7, 12), 6), (2, 2))))
    fam = sess.prefill_graphs
    assert sorted(fam.members) == [7, 12]
    refs = [weakref.ref(o) for o in (sess, fam, fam.pool, *fam.members.values())]
    del fam
    gc.disable()
    try:
        del sess
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()


def test_a_stale_prompt_replay_gives_the_previous_prompts_logits(cpu_graphs):
    """The planted fault of chip_smoke's prefill check, on the stand-in: a
    replay whose prompt buffer was not refilled (the slot refreshed) gives
    the previous prompt's logits, not the new prompt's eager ones."""
    model, params = smoke_model("stablelm-3b", ArcaneEngine("ref"), **F32)
    sess = cpu_graphs(ServeSession(model, params, max_slots=2, max_len=MAX_LEN))
    a, b, c = prompts(model.cfg, (9, 9, 9), 8)
    first = sess.prefill(a, 0).clone()            # warm-up
    assert torch.equal(sess.prefill(a, 1), first)  # captured, replayed
    sess._load_prompt = lambda prompt, slot: sess._slot.fill_(slot)
    stale = sess.prefill(b, 0).clone()
    del sess._load_prompt
    assert torch.equal(stale, first)
    assert not torch.equal(sess.prefill(c, 0), first)


# -------------------------------------------------- the session vs JAX
def admit_lens(cfg) -> tuple:
    """Repeated lengths, a long prompt with a short budget first, so that a
    short prompt is admitted into the slot it leaves."""
    return (32, 5, 16, 32, 5, 16) if recurrent(cfg) else (21, 5, 3, 21, 5, 3)


def by_path(tree, path="") -> list:
    """A cache's leaves with their paths, in the paths' order: the JAX
    cache's dicts come back from ``jax.tree.map`` with their keys sorted."""
    if isinstance(tree, dict):
        return sorted((kv for k, v in tree.items() for kv in by_path(v, f"{path}/{k}")),
                      key=lambda kv: kv[0])
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree) for kv in by_path(v, f"{path}/{i}")]
    return [(path, tree)]


@pytest.mark.parametrize("arch", SERVED)
def test_graphed_prefill_session_matches_jax_session(arch, cpu_graphs):
    """2 slots on f32 smoke weights, the port's prefills and steps on the
    CPU stand-in of their graphs: after each admit the slot's rows of every
    cache leaf equal the JAX session's after its ``_insert_slot`` (within
    ROWS_TOL), and the greedy tokens equal the JAX session's."""
    jcfg = dataclasses.replace(jax_smoke(arch), **F32)
    cfg = dataclasses.replace(get_smoke_config(arch), **F32)
    jmodel = JaxLM(jcfg, JaxEngine(backend="ref"))
    jparams = jmodel.init_params(jax.random.key(3))
    model = LM(cfg, ArcaneEngine("auto"), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    jobs = list(zip(prompts(cfg, admit_lens(cfg), 9), (2, 6, 4, 3, 2, 3)))
    sess = cpu_graphs(ServeSession(model, params, max_slots=2, max_len=48))
    jsess = JaxServeSession(jmodel, jparams, max_slots=2, max_len=48)
    reqs = [sess.submit(p, max_new_tokens=new) for p, new in jobs]
    jreqs = [jsess.submit(p, max_new_tokens=new) for p, new in jobs]
    admitted = 0
    while sess.pending or any(r is not None for r in sess.slots):
        free = [i for i, r in enumerate(sess.slots) if r is None]
        sess._admit()
        jsess._admit()
        new = [i for i in free if sess.slots[i] is not None]
        jcache = cache_from_numpy(jax.tree.map(np.asarray, jsess.cache), cfg, "cpu")
        for slot in new:
            for (path, mine), (_, ref) in zip(by_path(sess.cache), by_path(jcache)):
                np.testing.assert_allclose(mine[:, slot].numpy(), ref[:, slot].numpy(),
                                           atol=ROWS_TOL, rtol=ROWS_TOL, err_msg=path)
        admitted += len(new)
        sess.step()
        jsess.step()
    assert admitted == len(jobs)
    assert sess.prefill_graphs.stats["replays"] > 0
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
