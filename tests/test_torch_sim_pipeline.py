"""The port's pipelined C-RT, events, configs and traces against the
reference's.

Both packages' ``PipelinedRuntime`` run the same programs on the CPU: 30
seeded mixed programs (``chip_smoke.mixed_program``, built with the
reference's builder and carried into the port through ``to_obj``) under
seeded scheduler knobs, the reference's regression scenarios driven through
the coprocessor, fault plans, a mid-run hard VPU fault, open sessions with
staggered arrivals. Held equal: flushed images byte for byte, the makespan,
``PipelineReport``'s cycle fields, every resource's intervals, the metrics
report and the Chrome trace. ``sim_seconds`` (host wall time) is left out.
"""
import dataclasses
import importlib
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
import repro.sim as RS
import repro_torch.core as T
import repro_torch.sim as TS
from repro.core.session import RuntimeSession as RSession
from repro_torch.core.session import RuntimeSession as TSession
from repro_torch.examples import pipelined_cnn

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "src" / "repro" / "sim" / "configs"


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def chip_smoke():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module("chip_smoke")


def as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def cycles(stats) -> dict:
    """PhaseStats without its host wall-time fields."""
    return {k: v for k, v in dataclasses.asdict(stats).items()
            if not k.endswith("_s")}


def images(run) -> dict:
    return {k: as_np(v) for k, v in run.flushed_images().items()}


def assert_images_equal(a: dict, b: dict, what: str = "") -> None:
    assert a.keys() == b.keys(), what
    for k in a:
        assert a[k].dtype == b[k].dtype, (what, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def report(rt) -> dict:
    """PipelineReport without the simulator's own wall time."""
    d = dataclasses.asdict(rt.report())
    d.pop("sim_seconds")
    return d


def metrics(rt) -> dict:
    """The metrics report without the simulator's own wall time."""
    rep = rt.metrics_report()
    rep.get("extra", {}).pop("sim_seconds", None)
    return rep


def intervals(rt) -> list:
    return [(r.name, [dataclasses.astuple(iv) for iv in r.intervals])
            for r in rt._all_resources()]


def assert_schedules_equal(trt, rrt, what: str = "") -> None:
    """Makespan, report, resource intervals, stats, metrics and trace."""
    assert trt.sim_time == rrt.sim_time, what
    assert report(trt) == report(rrt), what
    assert intervals(trt) == intervals(rrt), what
    assert cycles(trt.stats) == cycles(rrt.stats), what
    assert metrics(trt) == metrics(rrt), what
    assert trt.tracer.to_chrome() == rrt.tracer.to_chrome(), what


def port_program(prog):
    mine = T.KernelProgram.from_obj(prog.to_obj())
    assert mine.to_obj() == prog.to_obj()
    return mine


# ------------------------------------------------------------------ events
def test_event_queue_time_then_insertion_order():
    for mod in (RS, TS):
        eq = mod.EventQueue()
        for t, k in ((5, "a"), (5, "b"), (3, "c"), (5, "d"), (0, "e")):
            eq.push(t, k)
        assert [e.kind for e in eq.drain()] == ["e", "c", "a", "b", "d"]
        with pytest.raises(ValueError, match="non-negative"):
            mod.EventQueue().push(-1, "x")


def test_resource_fifo_and_timeline_as_the_reference():
    got = []
    for mod in (RS, TS):
        r = mod.Resource("dma")
        ivs = [r.acquire(10, 5), r.acquire(0, 3), r.acquire(30, 0),
               r.acquire(31, 4, label="x")]
        res = [[dataclasses.astuple(iv) for iv in ivs], r.busy_cycles,
               r.idle_at(35), r.idle_at(34), r.utilization(70)]
        r.fence(50)
        for call in (lambda: r.acquire(60, 1), lambda: mod.Resource("a").acquire(0, -1),
                     lambda: mod.Timeline().post(3, "not callable")):
            try:
                call()
            except Exception as e:
                res.append((type(e).__name__, str(e)))
        tl = mod.Timeline()
        for t in (7, 2, 7, 0):
            tl.post(t, lambda now: now)
        tl.advance_clock(5)
        tl.advance_clock(4)
        tl.post(1, lambda now: now)          # in the past: clamped to now
        res.append((tl.now, [(e.time, e.seq, e.kind) for e in tl.drain()]))
        got.append(res)
    assert got[0] == got[1]
    assert got[0][0][:2] == [(10, 15, ""), (15, 18, "")]


def _flows(dataflow, rng):
    FK = dataflow.FlowKind
    kinds = list(FK)
    out = []
    for _ in range(4):
        k, ck = kinds[int(rng.integers(len(kinds)))], \
            kinds[int(rng.integers(len(kinds)))]
        out.append(dataflow.OperandFlow(
            k, window_rows=int(rng.integers(1, 3)) if k is FK.WINDOWED else 0,
            col_kind=ck,
            window_cols=int(rng.integers(1, 3)) if ck is FK.WINDOWED else 0))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_split_helpers_and_tile_trains_as_the_reference(seed):
    """row_chunks, split_proportional (the scalar and the int64 cumsum
    paths), interleave_blocks, tile_entries and TileTrain/ChunkTrain gating
    (the small-grid loop and the np.maximum.accumulate path) on seeded
    inputs."""
    import repro.core.dataflow as RD
    import repro_torch.core.dataflow as TD
    out = []
    for mod, dataflow in ((RS, RD), (TS, TD)):
        rng = np.random.default_rng(seed)
        rows, chunk = int(rng.integers(0, 40)), int(rng.integers(-1, 9))
        weights = [int(w) for w in rng.integers(0, 50, int(rng.integers(1, 60)))]
        weights[0] += 1
        total = int(rng.integers(0, 10_000_000))
        blocks = [mod.row_chunks(int(rng.integers(1, 30)), int(rng.integers(1, 6)))
                  for _ in range(int(rng.integers(1, 4)))]
        cols = mod.row_chunks(int(rng.integers(1, 40)), int(rng.integers(1, 12)))
        res = [mod.row_chunks(rows, chunk),
               mod.split_proportional(total, weights),
               mod.split_proportional(total, weights[:5]),
               mod.interleave_blocks(blocks),
               mod.tile_entries(blocks, cols),
               mod.tile_entries(blocks, cols, col_major=True)]
        for call in (lambda: mod.split_proportional(10, [0, 0]),
                     lambda: mod.split_proportional(10, [3, -1] * 20)):
            try:
                call()
            except ValueError as e:
                res.append(str(e))
        cum_cols = list(np.cumsum(cols))
        cum_rows = [list(np.cumsum(b)) for b in blocks]
        ends = [[[int(rng.integers(0, 1000)) for _ in cols] for _ in b]
                for b in blocks]
        train = mod.TileTrain(cum_rows=[[int(x) for x in c] for c in cum_rows],
                              cum_cols=[int(x) for x in cum_cols],
                              end_times=ends)
        chunks = mod.ChunkTrain([[int(x) for x in c] for c in cum_rows],
                                [[g[0] for g in grid] for grid in ends])
        res += [train.pace, train.col_pace, train.piece_weights(),
                train.col_weights(), chunks.pace]
        for flow in _flows(dataflow, rng):
            for n, m in ((1, 1), (3, 2), (train.pace, train.col_pace)):
                for p in range(n):
                    for q in range(m):
                        res.append((train.gate(flow, p, n, q, m),
                                    train.gate_source(flow, p, n, q, m),
                                    chunks.gate(flow, p, n)))
        out.append(res)
    assert out[0] == out[1]


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("name", ["arcane-default", "arcane-8vpu"])
def test_builtin_dicts_equal_the_reference_yaml(name):
    """Each builtin dict is what yaml.safe_load gives for the reference's
    file (on/off as booleans), and both load to the same SimConfig."""
    yaml = pytest.importorskip("yaml")
    with open(CONFIGS / f"{name}.yaml") as f:
        assert TS.config.BUILTINS[name] == yaml.safe_load(f)
    assert TS.load_raw(TS.builtin_config_path(name)) == \
        RS.load_raw(RS.builtin_config_path(name))
    assert dataclasses.asdict(TS.load_config(name)) == \
        dataclasses.asdict(RS.load_config(name))


def test_builtins_load_without_yaml(monkeypatch, tmp_path):
    """With pyyaml blocked both builtins (and an extends chain between
    them) load; a .yaml path raises the reference's ConfigError."""
    rcfg = {n: dataclasses.asdict(RS.load_config(n))
            for n in ("arcane-default", "arcane-8vpu")}
    monkeypatch.setitem(sys.modules, "yaml", None)
    for name, want in rcfg.items():
        assert dataclasses.asdict(TS.load_config(name)) == want
        assert TS.config_from_overrides(name, {"cache.n_vpus": 2}).n_vpus == 2
    p = tmp_path / "x.yaml"
    p.write_text("extends: arcane-default\n")
    with pytest.raises(TS.ConfigError,
                       match=r"requires pyyaml \(pip install repro\[dev\]\)"):
        TS.load_config(str(p))


def _yaml_cases(tmp_path):
    """Config files of the reference's tests: extends chains (builtin and
    relative), overrides, replace, a cycle, a missing target, a non-mapping
    top level, bad knobs."""
    files = {
        "child.yaml": "extends: arcane-default\ncache: {n_vpus: 8}\n"
                      "vpu: {lanes: 8}\npipeline: {row_chunk: 2}\n",
        "grand.yaml": "extends: child.yaml\ndescription: grand\n"
                      "pipeline: {tiling: {rows: 4, cols: 16}, reuse: on}\n",
        "replace.yaml": "extends: arcane-default\n"
                        "faults: {replace: true, flip_rate: 0.5, seed: 3}\n",
        "a.yaml": "extends: b.yaml\n",
        "b.yaml": "extends: a.yaml\n",
        "missing.yaml": "extends: nowhere.yaml\n",
        "list.yaml": "- 1\n- 2\n",
        "badknob.yaml": "extends: arcane-default\npipeline: {dataflow: maybe}\n",
        "badtile.yaml": "extends: arcane-default\npipeline: {tiling: 4}\n",
        "nodf.yaml": "extends: arcane-default\n"
                     "pipeline: {dataflow: off, reuse: on}\n",
        "unknown.yaml": "extends: arcane-8vpu\ncache: {n_vpu: 2}\n",
        "builtin_missing.yaml": "extends: warp9\n",
    }
    for n, text in files.items():
        (tmp_path / n).write_text(text)
    return sorted(files)


def _load(mod, path):
    try:
        return ("ok", dataclasses.asdict(mod.load_config(str(path))))
    except Exception as e:
        return (type(e).__name__, str(e))


def test_yaml_extends_chains_and_errors_as_the_reference(tmp_path):
    pytest.importorskip("yaml")
    for name in _yaml_cases(tmp_path):
        got = _load(TS, tmp_path / name)
        assert got == _load(RS, tmp_path / name), name
    assert _load(TS, tmp_path / "grand.yaml")[1]["tile_cols"] == 16
    assert "cyclic extends chain" in _load(TS, tmp_path / "a.yaml")[1]


BAD_DICTS = [
    {"cache": 4}, {"cache": {"nvpus": 2}}, {"bogus": 1},
    {"pipeline": {"tiling": {"rows": 2, "depth": 1}}},
    {"pipeline": {"tiling": {"rows": -1}}}, {"pipeline": {"tiling": "4x4"}},
    {"pipeline": {"dataflow": "sometimes"}}, {"metrics": {"enabled": "loud"}},
    {"pipeline": {"dataflow": "off", "reuse": True}},
    {"cache": {"n_vpus": 0}}, {"pipeline": {"row_chunk": -2}},
    {"faults": {"flip_rate": 2.0}}, {"faults": {"schedule": 3}},
    {"faults": {"hard_at": 10, "hard_vpu": 9}},
    {"faults": {"schedule": [{"kernel": 1, "kind": "melt"}]}},
    {"pipeline": {"dataflow": "OFF"}, "metrics": {"enabled": "no"}},
    {"description": "ok", "memory": {"bytes": 4096}},
]


@pytest.mark.parametrize("i", range(len(BAD_DICTS)))
def test_from_dict_validation_as_the_reference(i):
    got = []
    for mod in (RS, TS):
        try:
            got.append(dataclasses.asdict(mod.SimConfig.from_dict(BAD_DICTS[i])))
        except Exception as e:
            got.append((type(e).__name__, str(e)))
    assert got[0] == got[1]


def test_overrides_and_merges_as_the_reference():
    raw = TS.config.BUILTINS["arcane-default"]
    cases = [({"cache.n_vpus": 8, "pipeline.tiling.rows": 4},),
             ({"pipeline.tiling": {"rows": 2}},),
             ({"pipeline.tiling": 1, "pipeline.tiling.rows": 4},),
             ({"cache.n_vpus.x": 1},)]
    for (ov,) in cases:
        out = []
        for mod in (RS, TS):
            try:
                out.append(mod.apply_overrides(raw, ov))
            except Exception as e:
                out.append((type(e).__name__, str(e)))
        assert out[0] == out[1], ov
    for maps in (({"a": 1}, {"b": 2}), ({"a": 1}, {"a": 2}),
                 ({"a.b": 1}, {"a": 2}), ({"": 1},)):
        out = []
        for mod in (RS, TS):
            try:
                out.append(mod.merge_overrides(*maps, sources=None))
            except Exception as e:
                out.append((type(e).__name__, str(e)))
        assert out[0] == out[1], maps
    base = {"a": {"x": 1, "y": {"z": 2}}, "b": 3}
    over = {"a": {"y": {"w": 4}}, "c": {"replace": True, "k": 1},
            "b": {"replace": True, "q": 2}}
    assert TS.deep_merge(base, over) == RS.deep_merge(base, over)
    with pytest.raises(TS.ConfigError, match="available"):
        TS.builtin_config_path("warp9")


def test_make_runtime_runs_on_the_card_unless_asked():
    """make_runtime's memory defaults to the card (raises without one);
    with device="cpu" both schedulers keep memory and lines on the CPU; a
    device that disagrees with a given memory raises; an unknown scheduler
    raises the reference's ConfigError."""
    cfg = TS.SimConfig(n_vpus=2, vregs_per_vpu=8, vlen_bytes=256,
                       memory_bytes=1 << 16)
    if not torch.cuda.is_available():
        for sch in ("serial", "pipelined"):
            with pytest.raises(RuntimeError, match="CUDA was asked for"):
                cfg.make_runtime(sch)
    rt = cfg.make_runtime("pipelined", device="cpu")
    assert isinstance(rt, TS.PipelinedRuntime)
    assert rt.memory.data.device.type == rt.cache.data.device.type == "cpu"
    assert rt.memory.size == 1 << 16
    assert isinstance(cfg.make_runtime("serial", device="cpu"), T.CacheRuntime)
    mem = T.MainMemory(1 << 16, device="cpu")
    assert cfg.make_runtime("pipelined", memory=mem).memory is mem
    with pytest.raises(ValueError, match="is not the"):
        cfg.make_runtime("pipelined", memory=mem, device="meta")
    rcfg = RS.SimConfig(n_vpus=2)
    with pytest.raises(RS.ConfigError) as re_:
        rcfg.make_runtime("eager")
    with pytest.raises(TS.ConfigError) as te_:
        cfg.make_runtime("eager", device="cpu")
    assert str(te_.value) == str(re_.value)
    rt8 = TS.load_config("arcane-8vpu").make_runtime("pipelined", device="cpu")
    assert (rt8.row_chunk, rt8.dataflow, rt8.tiling, rt8.reuse) == \
        (4, True, (4, 32), True)
    assert rt8.geometry == T.VPUGeometry(lanes=8, dma_bytes_per_cycle=8)


# ----------------------------------------------- 30 seeded programs
def _knobs(seed: int) -> tuple[dict, dict]:
    """Seeded runtime geometry and pipeline knobs: row_chunk, dataflow,
    tiling, reuse, the dispatch engine, VPUs and the queue's capacity."""
    rng = np.random.default_rng(20_000 + seed)
    rt = {"n_vpus": int(rng.choice((1, 2, 4))),
          "vregs_per_vpu": int(rng.choice((16, 32))),
          "vlen_bytes": int(rng.choice((256, 512))),
          "queue_capacity": int(rng.choice((2, 4, 16))),
          "lanes": int(rng.choice((2, 4, 8)))}
    dataflow = bool(rng.random() < 0.8)
    pipe = {"row_chunk": int(rng.choice((0, 2, 4, 8))), "dataflow": dataflow,
            "wakeup": bool(rng.random() < 0.7)}
    if dataflow:
        pipe["tiling"] = [None, (2, 4), (4, 0), (0, 4), (3, 2)][
            int(rng.integers(5))]
        pipe["reuse"] = bool(rng.random() < 0.5)
    return rt, pipe


def _pipelined_pair(rprog, rt_kw, pipe_kw, **extra):
    rrun = R.run_program(RS.PipelinedRuntime(**rt_kw, **pipe_kw, **extra), rprog)
    trun = T.run_program(TS.PipelinedRuntime(**rt_kw, **pipe_kw, **extra,
                                             device="cpu"),
                         port_program(rprog))
    return rrun, trun


@pytest.mark.parametrize("seed", range(30))
def test_seeded_program_pipelined_as_the_reference(seed):
    """Port pipelined == port serial == port reference_images == the
    reference's pipelined images; the makespan, the report, every
    resource's intervals, the metrics report and the trace equal the
    reference's."""
    cs = chip_smoke()
    n_ops = 5 + seed % 11
    rprog = cs.mixed_program(seed, n_ops, R.ProgramBuilder, R.ElemWidth)
    rt_kw, pipe_kw = _knobs(seed)
    rrun, trun = _pipelined_pair(rprog, rt_kw, pipe_kw)
    prog = trun.prog
    tserial = T.run_program(T.CacheRuntime(**rt_kw, device="cpu"), prog)
    timgs = images(trun)
    assert_images_equal(timgs, images(rrun), f"seed {seed} vs reference")
    assert_images_equal(timgs, images(tserial), f"seed {seed} vs serial")
    oracle = {k: as_np(v)
              for k, v in T.reference_images(prog, device="cpu").items()}
    assert_images_equal(timgs, oracle, f"seed {seed} vs oracle")
    assert_schedules_equal(trun.rt, rrun.rt, f"seed {seed}")
    assert trun.rt.stats.kernels_run == n_ops
    assert trun.rt.sim_time <= tserial.rt.stats.total_cycles
    for r in trun.rt._all_resources():
        ivs = sorted((iv.start, iv.end) for iv in r.intervals)
        assert all(a[1] <= b[0] for a, b in zip(ivs, ivs[1:])), r.name


def test_knobs_cover_the_space():
    seen = {"tiling": set(), "reuse": set(), "dataflow": set(),
            "wakeup": set(), "n_vpus": set(), "row_chunk": set()}
    for seed in range(30):
        rt_kw, pipe_kw = _knobs(seed)
        for k in seen:
            v = {**rt_kw, **pipe_kw}.get(k)
            seen[k].add(v)
    assert len(seen["tiling"]) >= 4 and seen["reuse"] >= {True, False}
    assert seen["dataflow"] == seen["wakeup"] == {True, False}
    assert seen["n_vpus"] == {1, 2, 4} and len(seen["row_chunk"]) == 4


@pytest.mark.parametrize("mode", [{}, {"dataflow": False},
                                  {"tiling": (4, 8)},
                                  {"tiling": (2, 4), "reuse": True},
                                  {"reuse": True}],
                         ids=["default", "legacy", "tiled", "tiled-reuse",
                              "reuse"])
def test_wakeup_and_rescan_engines_as_the_reference(mode):
    """A strip-mined program on both dispatch engines: the same schedule as
    each other and as the reference's."""
    cs = chip_smoke()
    rprog = cs.mixed_program(5, 16, R.ProgramBuilder, R.ElemWidth)
    rt_kw = {"n_vpus": 4, "queue_capacity": 32}
    runs = [_pipelined_pair(rprog, rt_kw, {**mode, "wakeup": w})
            for w in (True, False)]
    for rrun, trun in runs:
        assert_schedules_equal(trun.rt, rrun.rt, str(mode))
        assert_images_equal(images(trun), images(rrun))
    assert runs[0][1].rt.sim_time == runs[1][1].rt.sim_time


def test_metrics_off_keeps_the_schedule():
    cs = chip_smoke()
    rprog = cs.mixed_program(8, 12, R.ProgramBuilder, R.ElemWidth)
    rt_kw, pipe_kw = _knobs(8)
    on = _pipelined_pair(rprog, rt_kw, pipe_kw)[1]
    roff, toff = _pipelined_pair(rprog, rt_kw, pipe_kw, metrics=False)
    assert intervals(toff.rt) == intervals(on.rt) == intervals(roff.rt)
    assert metrics(toff.rt) == metrics(roff.rt)
    assert_images_equal(images(toff), images(on))


# ------------------------------------- the reference's scenarios, both
def _cop(mod, sim, scheduler, **kw):
    kw.setdefault("n_vpus", 4)
    kw.setdefault("vregs_per_vpu", 16)
    kw.setdefault("vlen_bytes", 512)
    cls = sim.PipelinedRuntime if scheduler == "pipelined" else mod.CacheRuntime
    if mod is T:
        kw["device"] = "cpu"
    return mod.ArcaneCoprocessor(runtime=cls(**kw))


def _chain(cop, W, rng, batch=2, n=16):
    """GEMM → LeakyReLU → MaxPool per image (the reference's chain)."""
    addrs = []
    for _ in range(batch):
        A = rng.integers(-9, 9, (n, n), dtype=np.int32)
        aA = cop.place(A, W)
        aT, aR = cop.malloc(n * n * 4), cop.malloc(n * n * 4)
        aP = cop.malloc((n // 2) * (n // 2) * 4)
        cop._xmr_w(0, aA, 0, n, n)
        cop._xmr_w(1, aT, 0, n, n)
        cop._xmr_w(2, aR, 0, n, n)
        cop._xmr_w(3, aP, 0, n // 2, n // 2)
        cop._gemm_w(1, 0, 0, 0, alpha=1.0, beta=0.0)
        cop._leakyrelu(W, 2, 1, alpha=0.25)
        cop._maxpool(W, 3, 2, 2, 2)
        addrs.append((aP, n // 2, n // 2))
    return addrs


def _cross_vpu(cop, W, rng):
    A = rng.integers(-9, 9, (8, 8), dtype=np.int32)
    B = rng.integers(-9, 9, (8, 8), dtype=np.int32)
    aA, aB = cop.place(A, W), cop.place(B, W)
    aT1, aT2, aO = (cop.malloc(256) for _ in range(3))
    for m, a in enumerate((aA, aB, aT1, aT2, aO)):
        cop._xmr_w(m, a, 0, 8, 8)
    cop._gemm_w(2, 0, 0, 0)
    cop._gemm_w(3, 1, 1, 1)
    cop._gemm_w(4, 2, 3, 2, alpha=1.0, beta=1.0)
    return [(aT1, 8, 8), (aT2, 8, 8), (aO, 8, 8)]


def _rebind(cop, W, rng):
    A = rng.integers(-9, 9, (8, 8), dtype=np.int32)
    aA = cop.place(A, W)
    aT, aR, aZ, aO = (cop.malloc(256) for _ in range(4))
    cop._xmr_w(0, aA, 0, 8, 8)
    cop._xmr_w(1, aT, 0, 8, 8)
    cop._xmr_w(2, aR, 0, 8, 8)
    cop._gemm_w(1, 0, 0, 0)
    cop._leakyrelu(W, 2, 1, alpha=0.25)
    cop._xmr_w(1, aZ, 0, 8, 8)               # rebind m1 to an unrelated one
    cop._xmr_w(3, aO, 0, 8, 8)
    cop._gemm_w(3, 0, 0, 0)
    cop._leakyrelu(W, 3, 3, alpha=0.25)      # WAW rebinding of m3
    return [(aT, 8, 8), (aR, 8, 8), (aO, 8, 8)]


def _partial_overlap(cop, W, rng):
    A = rng.integers(-9, 9, (8, 8), dtype=np.int32)
    aA = cop.place(A, W)
    aT, aR = cop.malloc(256), cop.malloc(256)
    cop._xmr_w(0, aA, 0, 8, 8)
    cop._xmr_w(1, aT, 0, 8, 8)
    cop._xmr_w(2, aR, 0, 8, 8)
    cop._gemm_w(1, 0, 0, 0)
    cop._leakyrelu(W, 2, 1, alpha=0.25)
    cop._xmr_w(3, aT + 128, 0, 4, 8)
    cop._xmr_w(4, aA, 0, 4, 8)
    cop._leakyrelu(W, 3, 4, alpha=0.5)
    return [(aT, 8, 8), (aR, 8, 8)]


def _aliased_reads(cop, W, rng):
    A = rng.integers(-9, 9, (8, 8), dtype=np.int32)
    B = rng.integers(-9, 9, (8, 8), dtype=np.int32)
    aP, aB = cop.place(A, W), cop.place(B, W)
    aD, aO1, aO2, aO3 = (cop.malloc(256) for _ in range(4))
    cop.store(aD, np.full((8, 8), 7, np.int32), W)
    cop._xmr_w(0, aP, 0, 8, 8)
    cop._xmr_w(1, aO1, 0, 8, 8)
    cop._leakyrelu(W, 1, 0, alpha=0.5)
    cop._xmr_w(2, aP, 0, 8, 8)
    cop._xmr_w(3, aB, 0, 8, 8)
    cop._leakyrelu(W, 2, 3, alpha=0.0)
    cop._xmr_w(4, aO2, 0, 8, 8)
    cop._leakyrelu(W, 4, 0, alpha=0.0)
    cop._xmr_w(5, aO3, 0, 8, 8)
    cop._leakyrelu(W, 5, 2, alpha=0.0)
    cop._xmr_w(6, aD, 0, 8, 8)
    cop._gemm_w(6, 3, 3, 3)
    cop._xmr_w(7, aD, 0, 8, 8)
    cop._leakyrelu(W, 1, 7, alpha=0.0)
    return [(aP, 8, 8), (aO1, 8, 8), (aO2, 8, 8), (aO3, 8, 8), (aD, 8, 8)]


def _unequal_strides(cop, W, rng):
    n = 16
    A = rng.integers(-9, 9, (n, 4), dtype=np.int32)
    B = rng.integers(-9, 9, (8, 8), dtype=np.int32)
    aA, aB = cop.place(A, W), cop.place(B, W)
    aD, aO = cop.malloc(n * n * 4), cop.malloc(n * n * 4)
    cop.store(aD, np.full((n, n), 7, np.int32), W)
    cop._xmr_w(0, aA, 0, n, 4)
    cop._xmr_w(1, aB, 0, 8, 8)
    cop._xmr_w(2, aD, n, n, 4)
    cop._xmr_w(3, aD + 16, 2 * n, 8, 8)
    cop._leakyrelu(W, 2, 0, alpha=0.5)
    cop._leakyrelu(W, 3, 1, alpha=0.25)
    cop._xmr_w(4, aD, 0, n, n)
    cop._xmr_w(5, aO, 0, n, n)
    cop._leakyrelu(W, 5, 4, alpha=0.0)
    return [(aD, n, n), (aO, n, n)]


def _tight_vpu(cop, W, rng):
    A = rng.integers(-9, 9, (16, 16), dtype=np.int32)
    aA = cop.place(A, W)
    aD = cop.malloc(16 * 16 * 4)
    cop._xmr_w(0, aA, 0, 16, 16)
    cop._xmr_w(1, aD, 0, 16, 16)
    cop._gemm_w(1, 0, 0, 0)
    return [(aD, 16, 16)]


def _strips(cop, W, rng):
    a = cop.place(rng.integers(-5, 5, (32, 64)).astype(np.int32), W)
    out, chain = cop.malloc(32 * 64 * 4), cop.malloc(16 * 16 * 4)
    cop._xmr(W, 0, a, 64, 16, 16)
    cop._xmr(W, 3, chain, 16, 16, 16)
    cop._leakyrelu(W, 3, 0, alpha=0.5)
    for i in range(12):
        c0 = (i % 8) * 8
        cop._xmr(W, 0, a + c0 * 4, 64, 32, 8)
        cop._xmr(W, 3, out + c0 * 4, 64, 32, 8)
        cop._leakyrelu(W, 3, 0, alpha=0.5)
        cop._xmr(W, 0, chain, 16, 16, 16)
        cop._xmr(W, 3, chain, 16, 16, 16)
        cop._leakyrelu(W, 3, 0, alpha=-0.25)
    return [(out, 32, 64), (chain, 16, 16)]


SCENARIOS = {
    "chain": (_chain, {}), "cross_vpu": (_cross_vpu, {}),
    "rebind": (_rebind, {}), "partial_overlap": (_partial_overlap, {}),
    "aliased_reads": (_aliased_reads, {}),
    "unequal_strides": (_unequal_strides, {}),
    "tight_vpu": (_tight_vpu, {"n_vpus": 2, "vregs_per_vpu": 5}),
    "chunked": (_chain, {"row_chunk": 4}),
    "unchunked": (_chain, {"row_chunk": 0}),
    "strips_tiled_reuse": (_strips, {"queue_capacity": 32, "tiling": (2, 4),
                                     "reuse": True}),
    "strips_legacy": (_strips, {"queue_capacity": 32, "dataflow": False}),
}


def _scenario(mod, sim, name, scheduler):
    fn, kw = SCENARIOS[name]
    if scheduler == "serial":
        kw = {k: v for k, v in kw.items()
              if k not in ("row_chunk", "tiling", "reuse", "dataflow")}
    cop = _cop(mod, sim, scheduler, **kw)
    outs = fn(cop, mod.ElemWidth.W, np.random.default_rng(0))
    cop.barrier()
    got = [as_np(cop.gather(a, r, c, mod.ElemWidth.W)) for a, r, c in outs]
    cop.rt.cache.flush_all()
    return cop.rt, got, as_np(cop.rt.memory.data)


# the serial runtime counts gemm(A, A)'s repeated operand twice: the tight
# VPU runs pipelined only, as in the reference's test
PIPELINED_ONLY = {"tight_vpu"}


@pytest.mark.parametrize("name,scheduler", [
    (n, s) for n in sorted(SCENARIOS) for s in ("serial", "pipelined")
    if s == "pipelined" or n not in PIPELINED_ONLY])
def test_reference_scenarios_on_both_schedulers(name, scheduler):
    """The reference's pipelined regression scenarios (cross-VPU moves,
    rebinding, partial overlaps, aliased reads of deferred results,
    unequal-stride strips, a tight VPU, row chunks, tiled reuse, the legacy
    stream) driven through both packages' coprocessors: the same gathers,
    memory, cycles and, pipelined, the same schedule and trace."""
    rrt, rgot, rmem = _scenario(R, RS, name, scheduler)
    trt, tgot, tmem = _scenario(T, TS, name, scheduler)
    for a, b in zip(tgot, rgot):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tmem, rmem)
    assert cycles(trt.stats) == cycles(rrt.stats)
    if scheduler == "pipelined":
        assert_schedules_equal(trt, rrt, name)
        assert trt.at.live_count() == 0
        if name not in PIPELINED_ONLY:
            np.testing.assert_array_equal(_scenario(T, TS, name, "serial")[2],
                                          tmem)
        if name == "tight_vpu":      # dispatched through the event loop
            assert any(r.phase == "compute" for r in trt.tracer.records)


def test_free_and_dirty_line_counters_stay_consistent():
    """The per-VPU busy/dirty counters the dispatcher reads track the
    line flags (host metadata) through claims, DMA-outs and flushes."""
    mem = T.MainMemory(1 << 16, device="cpu")
    c = T.ArcaneCache(mem, n_vpus=2, vregs_per_vpu=4, vlen_bytes=256)
    rng = np.random.default_rng(3)

    def check():
        for v in range(2):
            assert c.free_line_count(v) == sum(
                1 for i in c.vpu_lines(v) if not c.lines[i].busy_computing)
            assert c.dirty_line_count(v) == sum(
                1 for i in c.vpu_lines(v) if c.lines[i].dirty)

    check()
    c.host_write(0, torch.from_numpy(rng.integers(0, 255, 600, dtype=np.uint8)))
    check()
    idxs = c.claim_vregs(0, 2)
    check()
    c.dma_out_2d(0, idxs, 128, 2, 100, 256)
    check()
    c.release_vregs(idxs)
    c.flush_all()
    check()


# ---------------------------------------------------------------- faults
TIERS = dict(max_replays=3, ecc_penalty=17, replay_backoff=23,
             schedule=({"kernel": 0, "kind": "single"},
                       {"kernel": 1, "kind": "double"},
                       {"kernel": 2, "kind": "corrupt", "replays": 2}))
RANDOM = dict(flip_rate=0.6, double_bit_fraction=0.5, corrupt_rate=0.4,
              max_replays=4, seed=3)
EXHAUST = dict(max_replays=2, schedule=({"kernel": 3, "kind": "hard"},))


def _fault_pair(seed, faults):
    cs = chip_smoke()
    rprog = cs.mixed_program(seed, 10, R.ProgramBuilder, R.ElemWidth)
    rt_kw, pipe_kw = _knobs(seed)
    rt_kw["n_vpus"] = 4
    rf = RS.FaultConfig(**faults) if faults else None
    tf = TS.FaultConfig(**faults) if faults else None
    rrun = R.run_program(RS.PipelinedRuntime(**rt_kw, **pipe_kw, faults=rf),
                         rprog)
    trun = T.run_program(TS.PipelinedRuntime(**rt_kw, **pipe_kw, faults=tf,
                                             device="cpu"),
                         port_program(rprog))
    return rrun, trun


@pytest.mark.parametrize("seed", [1, 4, 7])
@pytest.mark.parametrize("plan", ["tiers", "random", "exhaust"])
def test_pipelined_fault_plans_as_the_reference(seed, plan):
    """ECC flips (corrected and re-fetched), replays and a replay
    exhaustion that fences a VPU, on the pipelined runtime: the same
    schedule, offlined VPUs and metrics as the reference's, and the
    fault-free images."""
    faults = {"tiers": TIERS, "random": RANDOM, "exhaust": EXHAUST}[plan]
    rrun, trun = _fault_pair(seed, faults)
    assert trun.rt.offline == rrun.rt.offline
    assert_schedules_equal(trun.rt, rrun.rt, plan)
    timgs = images(trun)
    assert_images_equal(timgs, images(rrun), plan)
    assert_images_equal(timgs, images(_fault_pair(seed, None)[1]), "clean")
    if plan == "exhaust":
        assert len(trun.rt.offline) == 1
    else:
        assert trun.rt.stats.fault_cycles > 0


@pytest.mark.parametrize("seed", [2, 5, 9])
def test_pipelined_hard_vpu_fault_mid_run_as_the_reference(seed):
    """A hard fault halfway through the fault-free makespan fences VPU 1
    mid-run (its in-flight work evacuated); both runtimes finish on the
    survivors with the same schedule and the fault-free image."""
    clean = _fault_pair(seed, None)[0]
    hard = dict(hard_at=max(1, clean.rt.sim_time // 2), hard_vpu=1)
    rrun, trun = _fault_pair(seed, hard)
    assert trun.rt.offline == rrun.rt.offline == {1}
    assert_schedules_equal(trun.rt, rrun.rt, "hard")
    assert_images_equal(images(trun), images(clean), "hard vs clean")


def test_last_vpu_dying_raises_as_the_reference():
    cs = chip_smoke()
    rprog = cs.mixed_program(2, 6, R.ProgramBuilder, R.ElemWidth)
    fc = dict(max_replays=1, schedule=({"kernel": 0, "kind": "hard"},))
    with pytest.raises(RS.FaultError) as re_:
        R.run_program(RS.PipelinedRuntime(n_vpus=1,
                                          faults=RS.FaultConfig(**fc)), rprog)
    with pytest.raises(TS.FaultError) as te_:
        T.run_program(TS.PipelinedRuntime(n_vpus=1, faults=TS.FaultConfig(**fc),
                                          device="cpu"), port_program(rprog))
    assert str(te_.value) == str(re_.value)


# --------------------------------------------------------------- sessions
def _staggered(mod, sim, Session, dev, sched):
    """Programs posted 50,000 cycles apart into an open session on the
    pipelined runtime, one chained from a retire callback, an advance short
    of an arrival, then a drain."""
    cs = chip_smoke()
    progs = [cs.mixed_program(s, 6, R.ProgramBuilder, R.ElemWidth)
             for s in (3, 11, 27, 42)]
    if mod is T:
        progs = [port_program(p) for p in progs]
    cls = sim.PipelinedRuntime if sched == "pipelined" else mod.CacheRuntime
    rt = cls(n_vpus=2, queue_capacity=8, **dev)
    sess = Session(rt)
    handles, done = [], []
    for i, p in enumerate(progs[:3]):
        sess.post(i * 50_000, lambda t, p=p: handles.append(
            sess.issue(p, on_done=done.append)))
    sess.post(120_000, lambda t: handles.append(sess.issue(
        progs[3], on_done=lambda tt: (done.append(tt), handles.append(
            sess.issue(progs[0], on_done=done.append))))))
    sess.advance(until=60_000)
    early = (sess.now(), len(handles), [h.done_at for h in handles])
    sess.drain()
    rt.cache.flush_all()
    return (early, [(h.issued_at, h.done_at, len(h.kernel_ids))
                    for h in handles], done, sess.now(), cycles(rt.stats),
            metrics(rt)), as_np(rt.memory.data), rt


@pytest.mark.parametrize("sched", ["pipelined", "serial"])
def test_staggered_sessions_as_the_reference(sched):
    ref, rmem, rrt = _staggered(R, RS, RSession, {}, sched)
    mine, tmem, trt = _staggered(T, TS, TSession, {"device": "cpu"}, sched)
    assert mine == ref
    np.testing.assert_array_equal(tmem, rmem)
    if sched == "pipelined":
        assert_schedules_equal(trt, rrt, "sessions")
        assert trt.metrics.stalls.conservation_ok()
    assert ref[0][0] == 60_000 and len(ref[1]) == 5


@pytest.mark.parametrize("seed", range(3))
def test_session_at_t0_equals_the_batch_path(seed):
    """A whole program issued at t0 through an open session gives the
    batch path's schedule (ample queue), as the reference's does."""
    cs = chip_smoke()
    rprog = cs.mixed_program(seed + 40, 9, R.ProgramBuilder, R.ElemWidth)
    rt_kw, pipe_kw = _knobs(seed + 40)
    rt_kw["queue_capacity"] = 32
    got = []
    for mod, sim, Session, dev, prog in (
            (R, RS, RSession, {}, rprog),
            (T, TS, TSession, {"device": "cpu"}, port_program(rprog))):
        batch = mod.run_program(sim.PipelinedRuntime(**rt_kw, **pipe_kw, **dev),
                                prog)
        rt = sim.PipelinedRuntime(**rt_kw, **pipe_kw, **dev)
        sess = Session(rt)
        h = sess.issue(prog)
        sess.drain()
        assert h.done and rt.sim_time == batch.rt.sim_time
        assert intervals(rt) == intervals(batch.rt)
        got.append((rt.sim_time, intervals(rt), h.done_at))
    assert got[0] == got[1]


# ----------------------------------------------------------------- traces
@pytest.mark.parametrize("name", ["chain", "cross_vpu", "strips_tiled_reuse",
                                  "strips_legacy"])
def test_chrome_export_equals_the_reference_json(name, tmp_path):
    """The dumped Chrome trace (slices, counter tracks, flow arrows, the
    sorted order, the process name) equals the reference's after
    json.load."""
    rrt = _scenario(R, RS, name, "pipelined")[0]
    trt = _scenario(T, TS, name, "pipelined")[0]
    rp = rrt.tracer.dump(str(tmp_path / "r" / "trace.json"))
    tp = trt.tracer.dump(str(tmp_path / "t" / "trace.json"))
    with open(rp) as f, open(tp) as g:
        rdoc, tdoc = json.load(f), json.load(g)
    assert tdoc == rdoc
    phs = {e["ph"] for e in tdoc["traceEvents"]}
    assert {"M", "X", "C"} <= phs
    assert trt.tracer.phase_cycles() == rrt.tracer.phase_cycles()


def test_tracer_validation_as_the_reference():
    got = []
    for mod in (RS, TS):
        tr = mod.Tracer()
        res = []
        for call in (lambda: tr.emit("x", "mystery", "r", 0, 1),
                     lambda: tr.emit("x", "compute", "r", 0, 3, instant=True),
                     lambda: tr.counter("c", 0),
                     lambda: tr.flow("f", "bogus", "a", 0, "b", 1),
                     lambda: tr.emit("k", "compute", "r", 5, 2, lane="op0",
                                     kernel=1),
                     lambda: tr.counter("c", 3, a=1, b=2),
                     lambda: tr.flow("f", "compute", "r/op0", 5, "r", 6)):
            try:
                out = call()
                res.append(dataclasses.astuple(out) if out else out)
            except Exception as e:
                res.append((type(e).__name__, str(e)))
        res.append(tr.to_chrome())
        off = mod.Tracer(enabled=False)
        res.append((off.emit("x", "compute", "r", 0, 1), off.records))
        got.append(res)
    assert got[0] == got[1]


# ----------------------------------------------------------------- example
@pytest.mark.parametrize("config", ["arcane-default", "arcane-8vpu"])
def test_example_prints_the_reference_examples_numbers(config, tmp_path):
    """``python -m repro_torch.examples.pipelined_cnn --device cpu``: every
    printed line (kernels, serial cycles, makespan, concurrency speedup,
    busiest resources, the stall table, the critical path) is the
    reference example's, and its trace is the reference's JSON."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        ref_ex = importlib.import_module("pipelined_cnn")
    finally:
        sys.path.remove(str(ROOT / "examples"))
    outs = []
    for main, extra, path in (
            (ref_ex.main, [], tmp_path / "r.json"),
            (pipelined_cnn.main, ["--device", "cpu"], tmp_path / "t.json")):
        buf = io.StringIO()
        with redirect_stdout(buf):
            main(["--config", config, "--trace", str(path), *extra])
        outs.append(buf.getvalue().splitlines())
    rlines, tlines = outs
    last = [i for i, ln in enumerate(rlines) if " ✓ " in ln][0]
    assert tlines[:last] == rlines[:last]
    assert tlines[last].startswith("serial == pipelined == plain oracle ✓")
    assert tlines[last + 1:] == rlines[last + 1:]
    assert any(ln.startswith("pipelined makespan:") for ln in tlines)
    with open(tmp_path / "r.json") as f, open(tmp_path / "t.json") as g:
        assert json.load(g) == json.load(f)


def test_example_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device does not raise")
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        pipelined_cnn.main(["--trace", "/dev/null"])
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        TS.PipelinedRuntime()


# ------------------------------------------------------- no device reads
def test_event_loop_reads_no_tensor_value(monkeypatch):
    """The pipelined loop decides on host metadata only: over a whole run
    (issue to drain, before the flush) no tensor value is read back
    (.item(), bool(), .tolist(), nonzero()) — on the card each such read
    would wait for the device."""
    cs = chip_smoke()
    rprog = cs.mixed_program(3, 14, R.ProgramBuilder, R.ElemWidth)
    prog = port_program(rprog)
    rt_kw, pipe_kw = _knobs(3)
    rt = TS.PipelinedRuntime(**rt_kw, **pipe_kw, device="cpu")
    cop = T.ArcaneCoprocessor(runtime=rt)
    addrs = T.place_program(cop, prog)
    reads = []
    for name in ("item", "__bool__", "tolist", "nonzero", "__int__",
                 "__index__", "__float__"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **kw):
            reads.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, spy)
    T.issue_program(cop, prog, addrs)
    cop.barrier()
    monkeypatch.undo()
    assert reads == []
    assert rt.stats.kernels_run == len(prog.ops)


def test_exports_are_the_references():
    """repro_torch.sim and repro_torch.lower export every name the
    reference's packages do (sim also keeps as_fault_plan)."""
    import repro.lower as RL
    import repro_torch.lower as TL
    assert set(TS.__all__) == set(RS.__all__) | {"as_fault_plan"}
    assert set(TL.__all__) == set(RL.__all__)
    for mod in (TS, TL):
        assert all(hasattr(mod, n) for n in mod.__all__)
