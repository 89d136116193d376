"""The port's serial C-RT end to end against the reference's.

Both packages' serial runtimes (``CacheRuntime`` behind the bridge and the
program IR) run the same programs on the CPU: Listing 1 in the three
widths, 30 seeded mixed programs carried into the port through
``to_obj``/``from_obj``, host load/store hazards, seeded fault plans and a
hard VPU fault, open sessions, malformed programs. Held equal: flushed
memory images byte for byte, ``PhaseStats`` cycle fields, ``CacheStats``,
``metrics_report()``, the sequential oracles, the errors. The ``*_s`` wall
fields are host time and left out.
"""
import dataclasses
import importlib
import io
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.isa import _convlayer_preamble
from repro.core.runtime import CacheRuntime as RRuntime
from repro.core.session import RuntimeSession as RSession
from repro.sim.faults import FaultConfig as RFaultConfig
from repro.sim.faults import FaultError as RFaultError
import repro_torch.core as T
from repro_torch.core.runtime import CacheRuntime as TRuntime
from repro_torch.core.session import RuntimeSession as TSession
from repro_torch.examples import arcane_cnn
from repro_torch.sim.faults import FaultConfig as TFaultConfig
from repro_torch.sim.faults import FaultError as TFaultError

ROOT = Path(__file__).resolve().parents[1]
NP_DT = {"w": np.int32, "h": np.int16, "b": np.int8}


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


def cycles(stats) -> dict:
    """PhaseStats without its host wall-time fields."""
    return {k: v for k, v in dataclasses.asdict(stats).items()
            if not k.endswith("_s")}


def images(run) -> dict:
    """A run's flushed images as numpy arrays (either package)."""
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in run.flushed_images().items()}


def assert_images_equal(a: dict, b: dict, what: str = "") -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, (what, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def memory_equal(rrt, trt) -> None:
    np.testing.assert_array_equal(trt.memory.data.numpy(), rrt.memory.data)


def port_program(prog):
    """The reference program carried into the port through its dict."""
    mine = T.KernelProgram.from_obj(prog.to_obj())
    assert mine.to_obj() == prog.to_obj()
    return mine


# ------------------------------------------------------------- Listing 1
def _ref_listing1(width):
    b = R.ProgramBuilder("listing1", R.ElemWidth.from_suffix(width))
    b.buffer("A", 3 * 64, 64, init="random", seed=0, lo=-8, hi=8)
    b.buffer("F", 9, 3, init="random", seed=1, lo=-4, hi=4)
    b.buffer("R", 31, 31)
    b.op("conv_layer", [b.full("A"), b.full("F")], b.full("R"),
         comment="_conv_layer_w(m3, m0, m1)   // Listing 1 Matrix Kernel")
    prog = b.build()
    cop = R.ArcaneCoprocessor(**arcane_cnn.GEOMETRY)
    addrs = R.place_program(cop, prog)
    cop.rt.stats.reset()
    R.issue_program(cop, prog, addrs)
    run = R.ProgramRun(prog=prog, cop=cop, addrs=addrs)
    return prog, run, run.gather("R")


def _ref_speedup(stats):
    _, cost = _convlayer_preamble([(192, 64), (9, 3)], {}, R.ElemWidth.W)
    return (3 * cost.macs + 3 * cost.elementwise) / stats.total_cycles


@pytest.mark.parametrize("width", ["w", "h", "b"])
def test_listing1_as_the_reference(width):
    """Listing 1 (64x64, k=3, 4 VPUs of 64 vregs of 1 KiB, 8 lanes): R, the
    phase cycles and kernels run, CacheStats, the metrics report and the
    example's modeled speedup are the reference's."""
    rprog, rrun, rR = _ref_listing1(width)
    prog = arcane_cnn.build_listing1(64, 64, 3, T.ElemWidth.from_suffix(width))
    assert prog.to_obj() == rprog.to_obj()
    res = arcane_cnn.run_listing1(prog, "cpu")
    np.testing.assert_array_equal(res["R"].numpy(), rR)
    assert res["R"].dtype == getattr(torch, np.dtype(NP_DT[width]).name)
    trt, rrt = res["run"].rt, rrun.rt
    assert cycles(trt.stats) == cycles(rrt.stats)
    assert trt.stats.total_cycles == rrt.stats.total_cycles
    assert trt.stats.shares() == rrt.stats.shares()
    assert dataclasses.asdict(trt.cache.stats) == dataclasses.asdict(rrt.cache.stats)
    rep = trt.metrics_report()
    assert rep == rrt.metrics_report()
    assert rep["conservation_ok"] and rep["schema_version"] == 1
    assert arcane_cnn.scalar_cycles(64, 64, 3) / trt.stats.total_cycles == \
        _ref_speedup(rrt.stats)
    assert_images_equal(images(res["run"]), images(rrun), width)
    # the flush's write-backs too
    assert dataclasses.asdict(trt.cache.stats) == dataclasses.asdict(rrt.cache.stats)


@pytest.mark.parametrize("width", ["w", "h", "b"])
def test_example_prints_the_reference_simulators_numbers(width):
    """The port's example with ``--device cpu``: its cycles, phase shares
    and speedup lines are the reference simulator's, and its check of R
    against the plain conv_layer passes."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        arcane_cnn.main(["--device", "cpu", "--width", width])
    out = buf.getvalue()
    _, rrun, rR = _ref_listing1(width)
    st = rrun.rt.stats
    assert f"kernels run: {st.kernels_run}, cycles: {st.total_cycles}" in out
    assert "phase split: " + "  ".join(
        f"{k}={v:.1%}" for k, v in st.shares().items()) in out
    assert f"modeled speedup vs scalar RV32IMC: {_ref_speedup(st):.1f}x" in out
    assert f"checksum {int(rR.astype(np.int64).sum())}" in out
    assert "simulator == plain conv_layer ✓" in out


# ------------------------------------------------- 30 seeded programs
def _rt_kwargs(seed: int) -> dict:
    rng = np.random.default_rng(10_000 + seed)
    return {"n_vpus": int(rng.choice((1, 2, 4))),
            "vregs_per_vpu": int(rng.choice((16, 32))),
            "vlen_bytes": int(rng.choice((256, 512))),
            "queue_capacity": int(rng.choice((2, 4, 16))),
            "lanes": int(rng.choice((2, 4, 8)))}


@pytest.mark.parametrize("seed", range(30))
def test_seeded_program_as_the_reference(seed):
    """A seeded mixed program (gemm with beta-accumulate, leakyrelu,
    maxpool, conv2d, conv_layer; strided views, reads of earlier results,
    aliased destinations), built with the reference's ProgramBuilder and
    carried into the port through to_obj/from_obj, on both serial
    runtimes: flushed images byte for byte, PhaseStats, CacheStats, the
    metrics report and both sequential oracles equal. The port's own
    ProgramBuilder gives the same program dict."""
    cs = chip_smoke()
    n_ops = 4 + seed % 9
    rprog = cs.mixed_program(seed, n_ops, R.ProgramBuilder, R.ElemWidth)
    assert cs.mixed_program(seed, n_ops, T.ProgramBuilder, T.ElemWidth).to_obj() \
        == rprog.to_obj()
    prog = port_program(rprog)
    kw = _rt_kwargs(seed)
    rrun = R.run_program(RRuntime(**kw), rprog)
    trun = T.run_program(TRuntime(**kw, device="cpu"), prog)
    assert cycles(trun.rt.stats) == cycles(rrun.rt.stats)
    assert trun.rt.stats.kernels_run == n_ops
    timgs, rimgs = images(trun), images(rrun)
    assert_images_equal(timgs, rimgs, f"seed {seed}")
    assert dataclasses.asdict(trun.rt.cache.stats) == dataclasses.asdict(rrun.rt.cache.stats)
    assert trun.rt.metrics_report() == rrun.rt.metrics_report()
    memory_equal(rrun.rt, trun.rt)
    oracle = {k: v.numpy() for k, v in T.reference_images(prog, device="cpu").items()}
    assert_images_equal(oracle, R.reference_images(rprog), "oracle")
    assert_images_equal(timgs, oracle, "run vs oracle")


def test_chip_smokes_mixed_program_covers_every_kernel():
    """Phase 4b's program (the same generator, in the port's builder) has
    every kernel, beta-accumulating gemms and aliased destinations, and
    runs on the CPU to the reference's image."""
    cs = chip_smoke()
    prog = cs.mixed_program(cs.SIM_MIXED_SEED, cs.SIM_MIXED_OPS, T.ProgramBuilder,
                            T.ElemWidth)
    assert {op.kernel for op in prog.ops} == set(cs.SIM_KERNELS)
    assert any(op.kernel == "gemm" and op.params.get("beta") for op in prog.ops)
    dsts = [op.dst.buf for op in prog.ops]
    srcs = {v.buf for op in prog.ops for v in op.srcs}
    assert len(set(dsts)) < len(dsts) or set(dsts) & srcs
    rprog = R.KernelProgram.from_obj(prog.to_obj())
    rrun = R.run_program(RRuntime(**cs.SIM_MIXED_RT), rprog)
    trun = T.run_program(None, prog, device="cpu")
    assert trun.rt.device.type == "cpu"
    trun = T.run_program(TRuntime(**cs.SIM_MIXED_RT, device="cpu"), prog)
    assert_images_equal(images(trun), images(rrun), "phase 4b program")
    assert cycles(trun.rt.stats) == cycles(rrun.rt.stats)


def test_chip_smokes_planted_leakyrelu_fault_shows_on_the_cpu():
    """Phase 4b's second planted fault (leakyrelu scaled in float32) moves
    the image of its program off the reference's; the sound library's run
    matches the reference."""
    cs = chip_smoke()
    prog = cs.leaky_near_2_30(T.ProgramBuilder, T.ElemWidth)
    ref = images(R.run_program(RRuntime(**cs.SIM_MIXED_RT),
                               R.KernelProgram.from_obj(prog.to_obj())))
    sound = cs.sim_run(torch, prog, "cpu", cs.SIM_MIXED_RT)
    f32 = cs.sim_run(torch, prog, "cpu", cs.SIM_MIXED_RT,
                     library=cs.leaky_f32_library())
    assert_images_equal({k: v.numpy() for k, v in sound["images"].items()}, ref)
    assert cs.images_equal(torch, sound["images"], sound["images"])
    assert not cs.images_equal(torch, f32["images"], sound["images"])
    assert cs.first_diff(torch, f32["images"]["Y"], sound["images"]["Y"])["n_differ"] > 16


# ------------------------------------------------------ host hazards
def _hazard_steps(mod, Runtime, device_kw, rng_seed):
    """The host-store/load hazard scenarios of the reference's runtime
    tests, recording what the tracker has pending after each access (a
    barrier drains it) and the final buffers."""
    rng = np.random.default_rng(rng_seed)
    cop = mod.ArcaneCoprocessor(runtime=Runtime(n_vpus=4, vregs_per_vpu=16,
                                                vlen_bytes=512, **device_kw))
    W = mod.ElemWidth.W
    A = rng.integers(-9, 9, (8, 4)).astype(np.int32)
    log = []
    base = cop.malloc(8 * 16 * 4)
    for r in range(8):                              # a strided 8x4 strip
        cop.store(base + r * 64, A[r:r + 1], W)
    aD = cop.malloc(8 * 4 * 4)
    aE = cop.malloc(8 * 4 * 4)
    cop._xmr_w(0, base, 16, 8, 4)
    cop._xmr_w(1, aD, 0, 8, 4)
    cop._leakyrelu(W, 1, 0, alpha=0.5)
    log.append(cop.rt.tracker.pending_count())
    cop.store(base + 32, np.ones((1, 4), np.int32), W)   # in a gap: no stall
    log.append(cop.rt.tracker.pending_count())
    cop.store(base + 64, np.zeros((1, 4), np.int32), W)  # WAR on the strip
    log.append(cop.rt.tracker.pending_count())
    cop._xmr_w(2, aE, 0, 8, 4)
    cop._leakyrelu(W, 2, 1, alpha=0.25)
    log.append(cop.rt.tracker.pending_count())
    E = cop.gather(aE, 8, 4, W)                          # RAW: stall, drain
    log.append(cop.rt.tracker.pending_count())
    log.append(cop.rt.at.blocks_load(aE, aE + 1) is None)
    cop.store(aD, np.full((8, 4), 7, np.int32), W)       # WAW after the drain
    D = cop.gather(aD, 8, 4, W)
    cop.rt.cache.flush_all()
    E = E.numpy() if isinstance(E, torch.Tensor) else E
    D = D.numpy() if isinstance(D, torch.Tensor) else D
    return log, E, D, cycles(cop.rt.stats), cop.rt


@pytest.mark.parametrize("seed", range(3))
def test_host_hazards_as_the_reference(seed):
    """Host stores into a strided gap, into a live source (WAR), a load of
    a pending result (RAW): the same stalls (barriers), the same images."""
    rlog, rE, rD, rst, rrt = _hazard_steps(R, RRuntime, {}, seed)
    tlog, tE, tD, tst, trt = _hazard_steps(T, TRuntime, {"device": "cpu"}, seed)
    assert tlog == rlog == [1, 1, 0, 1, 0, True]
    np.testing.assert_array_equal(tE, rE)
    np.testing.assert_array_equal(tD, rD)
    assert tst == rst
    memory_equal(rrt, trt)


def test_xmr_stride_and_preamble_errors_as_the_reference():
    """KernelError for a stride below cols and a preamble's shape check; a
    rejected word raises RuntimeError at the coprocessor."""
    outs = []
    for mod, Runtime, kw in ((R, RRuntime, {}), (T, TRuntime, {"device": "cpu"})):
        cop = mod.ArcaneCoprocessor(runtime=Runtime(**kw))
        a = cop.malloc(1024)
        got = []
        for call in (lambda: cop._xmr_w(0, a, 2, 4, 4),
                     lambda: cop._xmr_w(0, a, 9, 4, 4),
                     lambda: cop._xmr_w(1, a + 64, 0, 3, 4),
                     lambda: cop._xmr_w(2, a + 128, 0, 4, 4),
                     lambda: cop._gemm_w(2, 0, 1, 0),
                     lambda: cop._gemm_w(2, 0, 0, 0, alpha=200.0),
                     lambda: cop.xmk(9, mod.ElemWidth.W, md=2, ms1=0)):
            try:
                call()
                got.append("ok")
            except Exception as e:
                got.append((type(e).__name__, str(e)))
        outs.append(got)
    assert outs[0] == outs[1]
    assert outs[0][0][0] == "KernelError" and outs[0][4][0] == "KernelError"


# ------------------------------------------------------------- faults
TIERS = dict(max_replays=3, ecc_penalty=17, replay_backoff=23,
             schedule=({"kernel": 0, "kind": "single"},
                       {"kernel": 1, "kind": "double"},
                       {"kernel": 2, "kind": "corrupt", "replays": 2}))
RANDOM = dict(flip_rate=0.6, double_bit_fraction=0.5, corrupt_rate=0.4,
              max_replays=4, seed=3)
EXHAUST = dict(max_replays=2, schedule=({"kernel": 3, "kind": "hard"},))


def _fault_runs(seed, faults, rt_over=None):
    cs = chip_smoke()
    rprog = cs.mixed_program(seed, 8, R.ProgramBuilder, R.ElemWidth)
    kw = {**_rt_kwargs(seed), "n_vpus": 4, **(rt_over or {})}
    out = []
    for mod, Runtime, FC, dev in ((R, RRuntime, RFaultConfig, {}),
                                  (T, TRuntime, TFaultConfig, {"device": "cpu"})):
        prog = rprog if mod is R else port_program(rprog)
        rt = Runtime(**kw, **dev, faults=FC(**faults) if faults else None)
        run = mod.run_program(rt, prog)
        out.append((run, images(run)))
    return rprog, out


@pytest.mark.parametrize("seed", [1, 4, 7])
@pytest.mark.parametrize("plan", ["tiers", "random", "exhaust"])
def test_fault_plans_run_as_the_reference(seed, plan):
    """Seeded ECC flips (corrected and re-fetched), replays, and replay
    exhaustion that fences a VPU: the same fault_cycles and counters, the
    same offlined VPUs and the fault-free images."""
    faults = {"tiers": TIERS, "random": RANDOM, "exhaust": EXHAUST}[plan]
    rprog, ((rrun, rimg), (trun, timg)) = _fault_runs(seed, faults)
    assert cycles(trun.rt.stats) == cycles(rrun.rt.stats)
    assert trun.rt.offline == rrun.rt.offline
    assert trun.rt.metrics_report() == rrun.rt.metrics_report()
    assert_images_equal(timg, rimg, plan)
    _, ((_, clean), _) = _fault_runs(seed, None)
    assert_images_equal(timg, clean, "fault-free")
    if plan == "exhaust":
        assert trun.rt.offline == {next(iter(rrun.rt.offline))}
    else:
        assert trun.rt.stats.fault_cycles > 0


@pytest.mark.parametrize("seed", [2, 5])
def test_hard_vpu_fault_mid_run_as_the_reference(seed):
    """A scheduled hard fault halfway through the fault-free run's cycles
    fences VPU 1: both runtimes fence it at the same kernel and complete on
    the survivors with the fault-free image."""
    rprog, ((rrun, _), _) = _fault_runs(seed, None)
    hard = dict(hard_at=max(1, rrun.rt.stats.total_cycles // 2), hard_vpu=1)
    _, ((rf, rimg), (tf, timg)) = _fault_runs(seed, hard)
    assert tf.rt.offline == rf.rt.offline == {1}
    assert cycles(tf.rt.stats) == cycles(rf.rt.stats)
    assert_images_equal(timg, rimg, "hard fault")
    assert tf.rt.metrics_report() == rf.rt.metrics_report()


def test_last_vpu_dying_raises_fault_error_as_the_reference():
    cs = chip_smoke()
    rprog = cs.mixed_program(2, 6, R.ProgramBuilder, R.ElemWidth)
    fc = dict(max_replays=1, schedule=({"kernel": 0, "kind": "hard"},))
    with pytest.raises(RFaultError, match="no healthy VPU remains") as re_:
        R.run_program(RRuntime(n_vpus=1, faults=RFaultConfig(**fc)), rprog)
    with pytest.raises(TFaultError, match="no healthy VPU remains") as te_:
        T.run_program(TRuntime(n_vpus=1, faults=TFaultConfig(**fc), device="cpu"),
                      port_program(rprog))
    assert str(te_.value) == str(re_.value)
    with pytest.raises(ValueError, match="hard_vpu"):
        TRuntime(n_vpus=2, faults=TFaultConfig(hard_at=5, hard_vpu=3), device="cpu")


# ------------------------------------------------------------ sessions
def _session_trace(mod, Runtime, Session, dev):
    """Programs posted at spaced sim times into an open session, one issued
    from a retire callback, an advance short of a posted arrival, then a
    drain: every handle's issue and done times, the clock, the images."""
    cs = chip_smoke()
    progs = [cs.mixed_program(s, 5, R.ProgramBuilder, R.ElemWidth) for s in (3, 11, 27)]
    if mod is T:
        progs = [port_program(p) for p in progs]
    rt = Runtime(n_vpus=2, queue_capacity=8, **dev)
    sess = Session(rt)
    handles, done = [], []
    h0 = sess.issue(progs[0], on_done=done.append)

    def chained(t):
        handles.append(sess.issue(progs[2], on_done=done.append))

    h1_box = []
    sess.post(50_000, lambda t: h1_box.append(
        sess.issue(progs[1], on_done=lambda tt: (done.append(tt), chained(tt)))))
    sess.advance(until=20_000)
    early = (h0.done_at, sess.now(), len(h1_box))
    sess.drain()
    hs = [h0, h1_box[0], *handles]
    rt.cache.flush_all()
    mem = rt.memory.data
    return (early, [(h.issued_at, h.done_at, len(h.kernel_ids)) for h in hs],
            done, sess.now(), cycles(rt.stats),
            mem.numpy() if isinstance(mem, torch.Tensor) else mem)


def test_sessions_as_the_reference():
    """post / advance / drain on the serial runtime: the same done_at for
    every program (a chained issue from a retire callback included), the
    same clock and the same memory."""
    ref = _session_trace(R, RRuntime, RSession, {})
    mine = _session_trace(T, TRuntime, TSession, {"device": "cpu"})
    assert mine[:5] == ref[:5]
    np.testing.assert_array_equal(mine[5], ref[5])
    early, hs = ref[0], ref[1]
    assert early[1] == 20_000 and early[2] == 0 and early[0] is not None
    assert hs[1][0] >= 50_000 and all(h[1] is not None for h in hs)


# -------------------------------------------------------------- errors
def _malformed(mod):
    W = mod.ElemWidth.W
    B = lambda **kw: mod.Buffer(**{"name": "a", "rows": 4, "cols": 4, **kw})  # noqa: E731
    V = mod.View
    op = lambda k, srcs, dst, **p: mod.KernelOp(kernel=k, srcs=srcs, dst=dst,  # noqa: E731
                                                params=p)
    good = (B(init="random"), B(name="d"))
    return [
        mod.KernelProgram("dup", W, (B(), B()), ()),
        mod.KernelProgram("empty", W, (B(name=""),), ()),
        mod.KernelProgram("shape", W, (B(rows=0),), ()),
        mod.KernelProgram("init", W, (B(init="ones"),), ()),
        mod.KernelProgram("data", W, (B(init="data", data=((1, 2),)),), ()),
        mod.KernelProgram("kernel", W, good, (op("softmax", (V("a", 4, 4),), V("d", 4, 4)),)),
        mod.KernelProgram("arity", W, good, (op("leakyrelu", (V("a", 4, 4),) * 2, V("d", 4, 4)),)),
        mod.KernelProgram("view", W, good, (op("leakyrelu", (V("a", 4, 4, 1),), V("d", 4, 4)),)),
        mod.KernelProgram("buf", W, good, (op("leakyrelu", (V("z", 4, 4),), V("d", 4, 4)),)),
        mod.KernelProgram("param", W, good, (op("leakyrelu", (V("a", 4, 4),), V("d", 4, 4), beta=1.0),)),
        mod.KernelProgram("q88", W, good, (op("leakyrelu", (V("a", 4, 4),), V("d", 4, 4), alpha=300.0),)),
        mod.KernelProgram("pre", W, good, (op("gemm", (V("a", 4, 4), V("a", 3, 4), V("d", 4, 4)), V("d", 4, 4)),)),
        mod.KernelProgram("dst", W, good, (op("maxpool", (V("a", 4, 4),), V("d", 4, 4)),)),
        mod.KernelProgram("ok", W, good, (op("maxpool", (V("a", 4, 4),), V("d", 2, 2)),)),
    ]


def test_malformed_programs_raise_as_the_reference():
    """ProgramError with the reference's message for each malformed
    program (the preamble's KernelError wrapped as the reference wraps
    it); a sound one validates. Malformed dicts raise ProgramError too."""
    for rp, tp in zip(_malformed(R), _malformed(T)):
        got = []
        for p in (rp, tp):
            try:
                p.validate()
                got.append("ok")
            except Exception as e:
                got.append((type(e).__name__, str(e)))
        assert got[0] == got[1], rp.name
        assert (got[0] == "ok") == (rp.name == "ok")
    for bad in ({"width": "w"}, {"width": "q", "buffers": [], "ops": []},
                {"width": "w", "buffers": [{"rows": 1}], "ops": []}):
        with pytest.raises(R.ProgramError) as re_:
            R.KernelProgram.from_obj(bad)
        with pytest.raises(T.ProgramError) as te_:
            T.KernelProgram.from_obj(bad)
        assert str(te_.value) == str(re_.value)


def test_builder_data_buffers_as_the_reference():
    """Explicit-data buffers (a wider value wraps to the width), from an
    array or a tensor, give the reference's program and image."""
    x = np.arange(-300, 366, 37).reshape(2, 9)
    rb, tb = R.ProgramBuilder("d", R.ElemWidth.B), T.ProgramBuilder("d", T.ElemWidth.B)
    rb.data("x", x)
    tb.data("x", torch.from_numpy(x))
    for b in (rb, tb):
        b.buffer("y", 2, 9)
        b.op("leakyrelu", [b.full("x")], b.full("y"), alpha=-0.75)
    rprog, tprog = rb.build(), tb.build()
    assert tprog.to_obj() == rprog.to_obj()
    np.testing.assert_array_equal(tprog.buffer("x").materialize(tprog.width).numpy(),
                                  rprog.buffer("x").materialize(rprog.width))
    ref = images(R.run_program(RRuntime(), rprog))
    assert_images_equal(images(T.run_program(TRuntime(device="cpu"), tprog)), ref)


# ----------------------------------------------------- device rules
def test_entry_points_run_on_the_card_unless_asked():
    """MainMemory, CacheRuntime, ArcaneCoprocessor, run_program and
    reference_images resolve their device through resolve_device: without a card the
    default raises, --device cpu runs; a device that disagrees with a
    given memory or runtime raises."""
    if torch.cuda.is_available():
        pytest.skip("this container's contract: no card")
    prog = arcane_cnn.build_listing1(8, 8, 3)
    for make in (lambda: T.MainMemory(64), lambda: TRuntime(),
                 lambda: T.ArcaneCoprocessor(),
                 lambda: T.run_program(None, prog),
                 lambda: T.reference_images(prog)):
        with pytest.raises(RuntimeError, match="CUDA was asked for"):
            make()
    rt = TRuntime(device="cpu")
    assert rt.memory.data.device.type == rt.cache.data.device.type == "cpu"
    mem = T.MainMemory(1 << 16, device="cpu")
    assert TRuntime(memory=mem).device.type == "cpu"
    with pytest.raises(ValueError, match="is not the"):
        TRuntime(memory=mem, device="meta")
    with pytest.raises(ValueError, match="is not the"):
        T.ArcaneCoprocessor(runtime=rt, device="meta")
    with pytest.raises(ValueError, match="is not the"):
        T.run_program(rt, prog, device="meta")
