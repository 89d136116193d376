"""The port's serving driver and request log against the reference's.

Both packages' ``ServingDriver`` run the same seeded arrivals over the open
runtime session on the CPU, on the serial and the pipelined runtime: the
arrival lists, the run's dict (per-request TTFT, latency, queue waits,
percentiles), the session clock, the decode steps issued, the KV images the
requests leave behind and the metrics report must be the reference's.
``RequestLog``'s lifecycle math, percentiles and errors too.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.sim as RS
import repro_torch.sim as TS
from repro.core.runtime import CacheRuntime as RRuntime
from repro.sim.metrics import MetricsError as RMetricsError
from repro.sim.metrics import RequestLog as RRequestLog
from repro.sim.metrics import _exact_percentile as r_percentile
from repro_torch.core.matrix import torch_dtype
from repro_torch.core.runtime import CacheRuntime as TRuntime
from repro_torch.sim.metrics import MetricsError as TMetricsError
from repro_torch.sim.metrics import RequestLog as TRequestLog
from repro_torch.sim.metrics import _exact_percentile as t_percentile

ARRIVAL_KW = dict(prompt_range=(3, 6), new_range=(2, 4))


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_dicts(reqs) -> list:
    return [dataclasses.asdict(r) for r in reqs]


def runtimes(scheduler: str, **kw):
    """The reference's and the port's runtime of one kind."""
    if scheduler == "serial":
        return RRuntime(**kw), TRuntime(**kw, device="cpu")
    return (RS.PipelinedRuntime(**kw, metrics=True),
            TS.PipelinedRuntime(**kw, metrics=True, device="cpu"))


def metrics(rt) -> dict:
    rep = rt.metrics_report()
    rep.get("extra", {}).pop("sim_seconds", None)
    return rep


def drive(scheduler, cfg_kw, reqs_kw, rt_kw=None):
    """Run the same requests through both packages' drivers; returns each
    package's (driver, dict)."""
    rrt, trt = runtimes(scheduler, **(rt_kw or {"n_vpus": 2}))
    out = []
    for mod, rt in ((RS, rrt), (TS, trt)):
        reqs = reqs_kw(mod)
        drv = mod.ServingDriver(rt, mod.ServingConfig(**cfg_kw))
        out.append((drv, drv.run(reqs)))
    return out


def kv_image(drv, name, rows, cols, width):
    """One request buffer's bytes after a flush (either package)."""
    rt = drv.rt
    rt.cache.flush_all()
    nbytes = rows * cols * width.nbytes
    a = drv.addrs[name]
    raw = rt.memory.data[a:a + nbytes]
    if isinstance(raw, torch.Tensor):
        return raw.clone().view(torch_dtype(width)).reshape(rows, cols).numpy()
    return raw.copy().view(f"i{width.nbytes}").reshape(rows, cols)


# ------------------------------------------------------- arrival processes
@pytest.mark.parametrize("seed", range(5))
def test_arrivals_as_the_reference(seed):
    """One seed gives one request list in both packages (numpy's
    generator, as the reference draws)."""
    for kw in (ARRIVAL_KW, {}, {"prompt_range": (3, 8), "new_range": (2, 5)}):
        assert as_dicts(TS.poisson_arrivals(20, 5_000, seed=seed, **kw)) == \
            as_dicts(RS.poisson_arrivals(20, 5_000, seed=seed, **kw))
        assert as_dicts(TS.bursty_arrivals(12, 4, 100_000, spread=50,
                                           seed=seed, **kw)) == \
            as_dicts(RS.bursty_arrivals(12, 4, 100_000, spread=50, seed=seed,
                                        **kw))
    reqs = TS.poisson_arrivals(20, 5_000, seed=seed, **ARRIVAL_KW)
    assert [r.rid for r in reqs] == list(range(20))
    assert all(x.arrival <= y.arrival for x, y in zip(reqs, reqs[1:]))


# ---------------------------------------------------------- the programs
def test_programs_as_the_reference():
    """weights_program, prefill_program and decode_step_program give the
    reference's program dicts; the prefill's capacity check raises the
    reference's ProgramError."""
    from repro.sim import serving as rsv
    from repro_torch.sim import serving as tsv
    for cfg_kw in ({}, {"kv_max": 24, "slots": 4, "vregs": 32, "vlen": 1024},
                   {"d": 16, "ff": 40, "kv_max": 12, "vregs": 8, "vlen": 256}):
        rc, tc = rsv.ServingConfig(**cfg_kw), tsv.ServingConfig(**cfg_kw)
        assert tsv.weights_program(tc).to_obj() == rsv.weights_program(rc).to_obj()
        for rid, plen in ((0, 1), (3, 5), (1, rc.kv_max)):
            assert tsv.prefill_program(tc, rid, plen).to_obj() == \
                rsv.prefill_program(rc, rid, plen).to_obj()
        states = [(0, 3, 0), (2, 5, 1), (5, rc.kv_max - 1, 0)]
        rstates = [rsv.SlotState(rid=r, prompt_len=2, max_new=4, kv_len=L,
                                 parity=p, ready=True) for r, L, p in states]
        tstates = [tsv.SlotState(**dataclasses.asdict(s)) for s in rstates]
        assert tsv.decode_step_program(tc, tstates, 7).to_obj() == \
            rsv.decode_step_program(rc, rstates, 7).to_obj()
        errs = []
        for sv, c, st in ((rsv, rc, rstates[0]), (tsv, tc, tstates[0])):
            for make in (lambda: sv.prefill_program(c, 0, c.kv_max + 1),
                         lambda: sv.decode_step_program(
                             c, [dataclasses.replace(st, kv_len=c.kv_max)], 0)):
                with pytest.raises(Exception) as e:
                    make()
                errs.append((type(e.value).__name__, str(e.value)))
        assert errs[:2] == errs[2:]
        assert "outside" in errs[0][1] and "at capacity" in errs[1][1]


# ------------------------------------------------------------- the driver
SCENARIOS = {
    # serving-poisson (dse/scenarios.py) on arcane-default's register file
    "serving-poisson": (dict(kv_max=24, slots=4, vregs=32, vlen=1024),
                        lambda m: m.poisson_arrivals(
                            8, 20_000, prompt_range=(3, 8), new_range=(2, 5),
                            seed=0),
                        {"n_vpus": 4, "vregs_per_vpu": 32, "vlen_bytes": 1024}),
    "saturated": (dict(kv_max=24, slots=3),
                  lambda m: m.poisson_arrivals(6, 4_000, seed=1, **ARRIVAL_KW),
                  None),
    "bursty": (dict(kv_max=16, slots=2),
               lambda m: m.bursty_arrivals(8, 4, 150_000, spread=40, seed=5,
                                           **ARRIVAL_KW),
               {"n_vpus": 4}),
    "burst-fifo": (dict(kv_max=16, slots=2),
                   lambda m: [m.Request(rid=i, arrival=10 + i, prompt_len=3,
                                        max_new=2) for i in range(6)],
                   None),
    "rejects": (dict(kv_max=8),
                lambda m: [m.Request(rid=0, arrival=0, prompt_len=7, max_new=3),
                           m.Request(rid=1, arrival=10, prompt_len=4,
                                     max_new=2),
                           m.Request(rid=2, arrival=20, prompt_len=9,
                                     max_new=1)],
                None),
}


@pytest.mark.parametrize("scheduler", ["serial", "pipelined"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_driver_dict_as_the_reference(name, scheduler):
    """The run's dict (per-request arrival, admission, first token, finish,
    TTFT, TPOT, queue wait; the exact percentiles; goodput), the session
    clock, the steps issued, the request KV images and the metrics report
    equal the reference's, on both schedulers."""
    cfg_kw, reqs, rt_kw = SCENARIOS[name]
    (rdrv, rres), (tdrv, tres) = drive(scheduler, cfg_kw, reqs, rt_kw)
    assert tres == rres
    assert tdrv.session.now() == rdrv.session.now()
    assert tdrv.steps_issued == rdrv.steps_issued
    assert tdrv.addrs == rdrv.addrs
    assert metrics(tdrv.rt) == metrics(rdrv.rt)
    assert tdrv.rt.stats.kernels_run == rdrv.rt.stats.kernels_run
    cfg = tdrv.cfg
    for r in tres["per_request"]:
        if r["admitted"] is None:
            continue
        for buf, rows, cols in ((f"r{r['rid']}_kt", cfg.d, cfg.kv_max),
                                (f"r{r['rid']}_v", cfg.kv_max, cfg.d)):
            np.testing.assert_array_equal(
                kv_image(tdrv, buf, rows, cols, cfg.width),
                kv_image(rdrv, buf, rows, cols, cfg.width), err_msg=buf)
    if name == "rejects":
        assert (tres["rejected"], tres["finished"]) == (2, 1)
    else:
        assert tres["finished"] == tres["requests"]
    if scheduler == "pipelined":
        assert tdrv.rt.metrics.stalls.conservation_ok()


def test_serving_poisson_pipelined_beats_serial_ttft():
    """serving-poisson's numbers the card's phase prints: the pipelined
    runtime's TTFT percentiles under the serial one's, both the
    reference's."""
    cfg_kw, reqs, rt_kw = SCENARIOS["serving-poisson"]
    res = {s: drive(s, cfg_kw, reqs, rt_kw)[1][1] for s in ("serial",
                                                          "pipelined")}
    assert res["pipelined"]["ttft_p99"] < res["serial"]["ttft_p99"]
    assert res["pipelined"]["finished"] == res["serial"]["finished"] == 8


def test_driver_runs_on_the_runtimes_device():
    """The driver takes the runtime its caller built: on the CPU here, and
    the card by default (which raises without one)."""
    rt = TS.load_config("arcane-default").make_runtime("pipelined",
                                                       device="cpu")
    drv = TS.ServingDriver(rt, TS.ServingConfig(kv_max=8, slots=1))
    drv.run([TS.Request(rid=0, arrival=5, prompt_len=2, max_new=2)])
    assert drv.rt.memory.data.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA was asked for"):
            TS.ServingDriver(TS.load_config("arcane-default").make_runtime(
                "pipelined"))


# -------------------------------------------------------- request lifecycle
def _log_steps(Log, Runtime):
    log = Log(Runtime(n_vpus=1, metrics=True).metrics)
    log.arrive(0, prompt_len=4, max_new=3, t=100)
    log.admit(0, t=150)
    log.first_token(0, t=400)
    log.token(0)
    log.token(0)
    log.finish(0, t=1000)
    for i, ttft in enumerate([100, 200, 300, 400, 1000], start=1):
        log.arrive(i, prompt_len=1, max_new=1, t=0)
        log.admit(i, t=ttft // 3)
        log.first_token(i, t=ttft)
        log.finish(i, t=ttft)
    log.arrive(9, prompt_len=2, max_new=2, t=50)
    log.reject(9, t=60)
    log.arrive(10, prompt_len=2, max_new=2, t=70)       # still waiting
    r = log.records[0]
    return ((r.queue_wait, r.ttft, r.tpot, r.done), log.summary(now=1000),
            log.summary(), r.to_dict())


def test_request_log_as_the_reference():
    mine = _log_steps(TRequestLog, _cpu_pipelined)
    ref = _log_steps(RRequestLog, RS.PipelinedRuntime)
    assert mine == ref
    assert ref[0] == (50, 300, 300.0, True)
    assert ref[1]["ttft_p50"] == 300 and ref[1]["rejected"] == 1


def _cpu_pipelined(**kw):
    return TS.PipelinedRuntime(**kw, device="cpu")


def test_request_log_errors_as_the_reference():
    got = []
    for Log, Err, make in ((RRequestLog, RMetricsError, RS.PipelinedRuntime),
                           (TRequestLog, TMetricsError, _cpu_pipelined)):
        res = []
        for steps in (lambda lg: (lg.arrive(7, 1, 1, 0), lg.arrive(7, 1, 1, 5)),
                      lambda lg: lg.admit(3, 0),
                      lambda lg: lg.first_token(4, 0),
                      lambda lg: lg.finish(5, 0),
                      lambda lg: lg.token(6)):
            log = Log(make(n_vpus=1, metrics=True).metrics)
            try:
                steps(log)
                res.append("ok")
            except Err as e:
                res.append(str(e))
            except Exception as e:
                res.append((type(e).__name__, str(e)))
        got.append(res)
    assert got[0] == got[1]
    assert "already arrived" in got[0][0]


@pytest.mark.parametrize("seed", range(4))
def test_exact_percentile_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    vals = [int(v) for v in rng.integers(0, 10_000, int(rng.integers(0, 300)))]
    for q in (0, 1, 50, 90, 99, 99.9, 100):
        assert t_percentile(vals, q) == r_percentile(vals, q)
