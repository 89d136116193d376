"""Tensor parallelism over the mesh's ``model`` axis
(``repro_torch/distributed/tensor_parallel.py``) on gloo ranks (one process
a rank, a ``FileStore`` under the test's tmp dir, one thread a rank; the
helpers of tests/test_torch_distributed.py).

* The sharded train step on a 2 (data) × 4 (model) mesh, now computing
  each rank's share of the products, against the JAX package's
  single-device ``make_train_step`` and the port's, at the limits of
  tests/test_distributed.py:33 (atol 2e-4, rtol 2e-3): qwen2.5-32b smoke
  (its kv heads split mid-head), gemma2-9b smoke (softcaps, local windows,
  a tied vocab-parallel table), granite smoke (one expert a rank), a
  ``loss_mask`` batch, minicpm3 (head-parallel MLA), jamba (channel-parallel
  Mamba, its in_proj columns routed) and rwkv6 smoke (head-parallel
  RWKV-6), whisper smoke (the encoder, cross-attention and the classic
  MLP's biases) and internvl2 smoke (the vision prefix); and attention on
  column blocks: qwen2.5-32b and whisper smoke on a 1 × 8 mesh (half a q
  head a rank; whisper's encoder, self- and cross-attention) and a qwen
  smoke of 6 q / 3 kv heads on 2 × 4 (a rank's heads straddling GQA
  groups). All cases run in one launch of 8 ranks; nothing is gathered
  over ``model``; every batch is split over data, granite's one dispatch
  group and the ``loss_mask`` too. In the same launch, granite smoke with
  every token routed to experts 0 and 1: the grads of the split step,
  its routing shared over data, against one device's, and three planted
  faults that must leave them.
* A census of one rank's forward on a 1 × 4 mesh: the q, o, gate, up,
  down and unembed products and the expert and attention products at
  exactly 1/4 of one device's, no such leaf gathered over ``model``; the
  MLA, RWKV-6 and Mamba mixers' products likewise, and a planted fault
  (Mamba's in_proj columns used unrouted) moving the loss.
* The vocab-parallel cross-entropy and embedding against
  ``F.cross_entropy`` and a plain lookup, targets at the shard edges.
* A prefill and 8 decode steps on a 1 × 4 mesh over a cache sharded by
  heads (stablelm), by sequence (gemma2; gemma2 with a ring cache for its
  local layers; jamba's attention; the straddling config on column
  blocks), MLA's latents by sequence (minicpm3) and the recurrent states
  by head or channel (rwkv6, jamba), and on a 1 × 8 mesh qwen2.5-32b and
  whisper smoke on column blocks (their caches by sequence, whisper's
  cross cache replicated), against one device and the JAX package's
  serve steps; on the kernels' route (a spy
  standing in for the kernels on the CPU) the decode steps ask the decode
  attention for its log-sum-exp at the rank-local lengths.
* The same serve on a 2 × 4 mesh, the rows split over data, of
  minicpm3, rwkv6, jamba, granite and llama4-scout smoke, and of
  llama4-scout with every token routed to one expert (its capacity drops
  decided across the data ranks), each rank's cache leaves holding its
  rows only, against one device's and the JAX package's serve steps; the
  same with each rank routing its own tokens alone, which must leave them;
  chip_smoke.py's ``tp_serve`` of the MoE rows on a 2 × 2 mesh (launches,
  the cache's bytes, what crosses the data axis, the planted fault) and
  its ``tp_train`` of granite on (1, 4) and (2, 2) (the data-axis census,
  the MoE rows' planted fault).
* The decode attention's log-sum-exp (the plain version) against
  ``partial_decode_attention`` and the JAX package's plain version, empty
  slices included; the ring's slot positions.
* The per-layer and per-mixer head-parallel/column-block/gathered
  choice; the column blocks' head ranges and flash launches.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_smoke_config as jax_smoke
from repro.core.engine import ArcaneEngine as JaxEngine
from repro.models.transformer import LM as JaxLM
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import LM
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.step import loss_and_grads, make_train_step
from test_torch_distributed import F32, assert_close, run_ranks


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(arch: str, **extra):
    """(port LM, port params, jax LM, jax params): the smoke config in f32
    (and ``extra``'s changes) on the reference's weights
    (``init_params(key(0))``)."""
    jcfg = dataclasses.replace(jax_smoke(arch), **F32, **extra)
    cfg = dataclasses.replace(get_smoke_config(arch), **F32, **extra)
    jmodel = JaxLM(jcfg, JaxEngine(backend="ref"))
    jparams = jmodel.init_params(jax.random.key(0))
    model = LM(cfg, ArcaneEngine("ref"), device="cpu")
    return model, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu"), jmodel, jparams


# ------------------------------------------------------- the train step
# qwen2.5-32b smoke with 6 q heads over 3 kv heads (hd 16): on 4 ranks a
# rank's column block is 1.5 q heads, and rank 1's (q heads 1 and 2) and
# rank 2's (3 and 4) straddle two GQA groups each
STRADDLE = dict(n_heads=6, n_kv_heads=3, head_dim=16)
# case: (arch, loss_mask, config changes, model axis: a 2 x 4 or 1 x 8
# mesh); jamba is held to the port's single-device step only (its jitted
# JAX step takes 19 s to compile here; tests/test_torch_train.py holds the
# port's jamba loss and grads to the JAX package's)
STEP_CASES = {"qwen": ("qwen2.5-32b", False, {}, 4),
              "gemma2": ("gemma2-9b", False, {}, 4),
              "granite": ("granite-moe-1b-a400m", False, {}, 4),
              "qwen-loss-mask": ("qwen2.5-32b", True, {}, 4),
              "minicpm3": ("minicpm3-4b", False, {}, 4),
              "jamba": ("jamba-1.5-large-398b", False, {}, 4),
              "rwkv6": ("rwkv6-1.6b", False, {}, 4),
              "whisper": ("whisper-large-v3", False, {}, 4),
              "internvl2": ("internvl2-1b", False, {}, 4),
              "qwen-blocks": ("qwen2.5-32b", False, {}, 8),
              "straddle": ("qwen2.5-32b", False, STRADDLE, 4),
              "whisper-blocks": ("whisper-large-v3", False, {}, 8)}
# the cases whose attention runs on column blocks
BLOCK_STEPS = ("qwen-blocks", "straddle", "whisper-blocks")
STEP_KW = dict(total_steps=10, warmup_steps=0)

TP_STEP = """
import dataclasses
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed.sharding import (distribute, param_pspecs,
                                              to_shardings, zero_pspecs)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import LM, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.step import make_train_step, tp_view
meshes = {{m: make_host_mesh(model_axis=m) for m in (4, 8)}}   # 2 x 4, 1 x 8
res = {{}}
for name, (arch, extra, m) in {cases!r}.items():
    mesh = meshes[m]
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                              compute_dtype="float32", **extra)
    model = LM(cfg, ArcaneEngine("ref"), device="cpu")
    params = torch.load(OUT + f"/params_{{name}}.pt")
    batch = torch.load(OUT + f"/batch_{{name}}.pt")
    opt_cfg = AdamWConfig(**{kw!r})
    opt = adamw_init(opt_cfg, params)
    p = distribute(params, to_shardings(param_pspecs(params, mesh), mesh))
    o = distribute(opt, to_shardings(zero_pspecs(opt, mesh), mesh))
    plan = tp_view(model, p, mesh)[0].tp
    step = make_train_step(model, opt_cfg, grad_shardings=to_shardings(
        zero_pspecs(params, mesh), mesh))
    p, o, m = step(p, o, batch)
    res[name] = {{"params": tree_map(lambda t: t.full_tensor(), p),
                 "metrics": {{k: float(v) for k, v in m.items()}},
                 "gathered": dict(plan.gathered), "choices": dict(plan.choices)}}

# the MoE rows' grads on 2 x 4, sound and with each planted fault
import contextlib, types
import chip_smoke
import repro_torch.models.moe as moe
from torch.distributed.tensor import DTensor
from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.train import step as step_mod


@contextlib.contextmanager
def planted(fault):
    real_tpm, real_rows = moe.tpm, step_mod.rows_group
    if fault == "no_copy_to_model":
        moe.tpm = types.SimpleNamespace(**dict(vars(tpm), copy_to_model=lambda x, mg: x))
    elif fault == "own_ids":
        step_mod.rows_group = lambda mesh, axes: None
    try:
        if fault == "rows_gather_without_reduce_scatter":
            with chip_smoke.tp_fault(torch, fault, RANK, WORLD):
                yield
        else:
            yield
    finally:
        moe.tpm, step_mod.rows_group = real_tpm, real_rows


mesh = meshes[4]
cfg = dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"),
                          param_dtype="float32", compute_dtype="float32")
model = LM(cfg, ArcaneEngine("ref"), device="cpu")
params = torch.load(OUT + "/rows_params.pt")
batch = torch.load(OUT + "/rows_batch.pt")
p = distribute(params, to_shardings(param_pspecs(params, mesh), mesh))
grads = {{}}
for fault in (None, *{faults!r}):
    with planted(fault):
        _, _, g, axes = step_mod.sharded_grads(model, p, batch)
    grads[fault] = tree_map(lambda t, q: DTensor.from_local(
        t, mesh, q.placements, run_check=False).full_tensor(), g, p)
res["rows_grads"] = {{"axes": axes, "grads": grads}}
if RANK == 0:
    torch.save(res, OUT + "/result.pt")
"""
# the MoE rows' planted faults in a train step (``rows_grads``): the
# outputs' all-gather without its reduce-scatter backward, ``_moe_rows``
# without ``copy_to_model`` under expert parallelism, each rank routing its
# own tokens alone
ROWS_FAULTS = ("rows_gather_without_reduce_scatter", "no_copy_to_model", "own_ids")


@pytest.fixture(scope="module")
def tp_steps(tmp_path_factory):
    """Every STEP_CASES case: the TP step on 8 gloo ranks (one launch, run
    while this process steps the references), the port's single-device
    step and the JAX package's jitted step, each from the reference's
    weights on the same seeded batch of 8 x 32."""
    tmp = tmp_path_factory.mktemp("tp_steps")
    cases = {}
    for name, (arch, mask, extra, _) in STEP_CASES.items():
        model, params, jmodel, jparams = pair(arch, **extra)
        rng = np.random.default_rng(7)
        cfg = model.cfg
        batch = {"tokens": rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32)}
        if mask:
            batch["loss_mask"] = (rng.random((8, 32)) < 0.6).astype(np.float32)
        if cfg.vision_prefix:
            batch["vision_embeds"] = rng.standard_normal(
                (8, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
        if cfg.enc_dec:
            batch["audio_embeds"] = rng.standard_normal(
                (8, 32, cfg.d_model)).astype(np.float32)
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        torch.save(params, tmp / f"params_{name}.pt")
        torch.save(tbatch, tmp / f"batch_{name}.pt")
        cases[name] = (model, params, jmodel, jparams, batch, tbatch)
    rows_model, _, rows_jmodel, jparams = pair("granite-moe-1b-a400m")
    rows_jparams = plant_overflow(jax.tree.map(np.asarray, jparams))
    rows_params = params_from_numpy(rows_jparams, rows_model.cfg, "cpu")
    rows_batch = {"tokens": torch.from_numpy(np.random.default_rng(3).integers(
        0, rows_model.cfg.vocab, (8, 32)).astype(np.int32))}
    torch.save(rows_params, tmp / "rows_params.pt")
    torch.save(rows_batch, tmp / "rows_batch.pt")
    errors = []
    ranks = threading.Thread(target=lambda: _catch(errors, run_ranks, 8, TP_STEP.format(
        cases={n: (a, extra, m) for n, (a, _, extra, m) in STEP_CASES.items()},
        kw=STEP_KW, faults=ROWS_FAULTS), tmp))
    ranks.start()
    refs = {}
    try:
        for name, (model, params, jmodel, jparams, batch, tbatch) in cases.items():
            o_p, _, o_m = make_train_step(model, AdamWConfig(**STEP_KW))(
                params, adamw_init(AdamWConfig(**STEP_KW), params), tbatch)
            refs[name] = {"one": (o_p, float(o_m["loss"]))}
            if model.cfg.name.startswith("jamba"):
                continue
            j_p, _, j_m = jax.jit(jax_make_train_step(jmodel, JaxAdamWConfig(**STEP_KW)))(
                jparams, jax_adamw_init(JaxAdamWConfig(**STEP_KW), jparams),
                {k: jnp.asarray(v) for k, v in batch.items()})
            refs[name]["jax"] = (j_p, float(j_m["loss"]))
        refs["rows_grads"] = loss_and_grads(rows_model, rows_params, rows_batch)[2]
        refs["rows_grads_jax"] = jax.jit(jax.grad(
            lambda p, b: rows_jmodel.loss(p, b)[0]))(
            jax.tree.map(jnp.asarray, rows_jparams),
            {"tokens": jnp.asarray(rows_batch["tokens"].numpy())})
    finally:
        ranks.join()
    if errors:
        raise errors[0]
    return refs, torch.load(tmp / "result.pt")


def _catch(errors: list, fn, *args):
    try:
        fn(*args)
    except BaseException as e:        # re-raised by the fixture
        errors.append(e)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_tp_step_matches_single_device(tp_steps, case):
    """One TP step on 2 x 4 (or 1 x 8) gloo ranks: the loss within 1e-4 and
    every param within atol 2e-4, rtol 2e-3 of the JAX package's
    single-device step (but jamba's) and of the port's; no leaf gathered
    over ``model``: every attention and MLA by heads, RWKV-6 by heads,
    Mamba by channels, but for BLOCK_STEPS, whose every attention (an
    encoder's and a cross-attention too) runs on column blocks."""
    refs, res = tp_steps
    mine = res[case]
    for params, loss in refs[case].values():
        assert abs(mine["metrics"]["loss"] - loss) < 1e-4
        assert_close(mine["params"], params, atol=2e-4, rtol=2e-3)
    assert mine["gathered"] == {}
    # the batch split over the data axes, granite's MoE and a loss_mask too
    assert mine["metrics"]["data_split"] == 1.0
    kinds = {spec.kind for spec in get_smoke_config(STEP_CASES[case][0]).pattern}
    expect = {"heads"} | ({"channels"} if "mamba" in kinds else set())
    if case in BLOCK_STEPS:
        expect = {"blocks"}
    assert set(mine["choices"].values()) == expect, mine["choices"]


def grad_gaps(mine, ref) -> dict:
    """Each leaf's |mine − ref| / |ref| (Frobenius norms), by path."""
    flat, out = {}, {}
    sh.map_with_path(lambda p, t: flat.__setitem__(p, t), ref)
    sh.map_with_path(lambda p, t: out.__setitem__(p, float(
        torch.linalg.vector_norm(t - flat[p]) / torch.linalg.vector_norm(flat[p]))), mine)
    return out


def test_moe_rows_train_grads_match_one_device(tp_steps):
    """granite smoke (f32) on 2 x 4, every token routed to experts 0 and 1
    (``plant_overflow``: the capacity drops of the one dispatch group of
    256 tokens decided across the data ranks), the batch split over data
    and the routing shared (``_moe_rows``): the grads reduced over data
    (``sharded_grads``) against one device's within the limits of the
    2 x 4 test, each of the three flows through the shared routing: the
    router's (through the gates), the tokens' (through the dispatch index:
    every leaf below the MoE layer) and the experts' (through the rank's
    block of the capacity rows); and against ``jax.grad`` of the JAX
    package's loss on the same planted weights, within the same limits."""
    refs, res = tp_steps
    rows = res["rows_grads"]
    assert rows["axes"] == ("data",)
    mine, one = rows["grads"][None], refs["rows_grads"]
    assert_close(mine, one, atol=2e-4, rtol=2e-3)
    assert_close(mine, refs["rows_grads_jax"], atol=2e-4, rtol=2e-3)
    gaps = grad_gaps(mine, one)
    for flow in ("ffn/router/w", "attn/q/w", "embed/table", "ffn/gate", "ffn/down"):
        assert any(flow in k for k in gaps), flow
    assert max(gaps.values()) < 1e-4, gaps


@pytest.mark.parametrize("fault", ROWS_FAULTS)
def test_moe_rows_train_fault_leaves_one_device(tp_steps, fault):
    """The same grads with a planted fault: the outputs' all-gather left
    without its reduce-scatter backward (each rank's experts learn from
    its own tokens only), ``_moe_rows`` without ``copy_to_model`` under
    expert parallelism (the tokens' and gates' grads of one model rank's
    experts only), each rank routing its own tokens alone (its capacity
    and drops its rows'): some leaf's grad more than 1e-2 off one
    device's."""
    refs, res = tp_steps
    gaps = grad_gaps(res["rows_grads"]["grads"][fault], refs["rows_grads"])
    assert max(gaps.values()) > 1e-2, gaps


# ---------------------------------------------------------- the census
CENSUS = """
import dataclasses
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed.sharding import distribute, param_pspecs, to_shardings
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import LM, tree_map
from repro_torch.train.step import tp_view
mesh = make_host_mesh(model_axis=4)                 # 1 data x 4 model
res = {{}}
for arch in {archs!r}:
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                              compute_dtype="float32")
    params = LM(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32))
    out = {{}}
    for mode in ("one", "tp"):
        model = LM(cfg, ArcaneEngine("ref", record=True), device="cpu")
        p = params
        if mode == "tp":
            d = distribute(params, to_shardings(param_pspecs(params, mesh), mesh))
            model, pl = tp_view(model, d, mesh)
            p = tree_map(lambda t, q: t.redistribute(mesh, q).to_local(), d, pl)
        with torch.no_grad(), FlopCounterMode(display=False) as fc, \\
                CommDebugMode() as comm:
            model.loss(p, {{"tokens": tokens}})
        counts = fc.get_flop_counts()["Global"]
        out[mode] = {{"gemm": [e.flops for e in model.engine.trace],
                     "bmm": int(counts.get(torch.ops.aten.bmm, 0)),
                     "comm": {{str(k): v for k, v in comm.get_comm_counts().items()}},
                     "gathered": {{}} if mode == "one" else dict(model.tp.gathered)}}
    res[arch] = out
torch.save(res, OUT + f"/census{{RANK}}.pt")
"""
CENSUS_ARCHS = ("qwen2.5-32b", "granite-moe-1b-a400m", "gemma2-9b")


def product_names(cfg) -> list:
    """The engine's products of one forward, in order."""
    names = []
    for _ in range(cfg.n_periods):
        for spec in cfg.pattern:
            names += ["q", "k", "v", "attention", "o"]
            if not spec.moe:
                names += ["gate", "up", "down"]
    return names + ["unembed"]


def test_rank_census_is_a_quarter_of_one_device(tmp_path):
    """On each rank of a 1 x 4 mesh, one forward (``LM.loss``) of qwen
    (kv heads split mid-head: gathered columns), granite (one expert a
    rank) and gemma2 (vocab-parallel softcapped table): the engine's q, o,
    gate, up, down and unembed products each exactly 1/4 of one device's
    FLOPs, k and v at the share of the kv heads the rank reads, the
    engine's attention and the batched products (attention, experts) at
    1/4, the plan gathering no
    leaf over ``model``, and the only all-gathers those of qwen's and
    gemma2's k/v columns (weight and bias: 2 or 4 a layer)."""
    run_ranks(4, CENSUS.format(archs=CENSUS_ARCHS), tmp_path)
    for r in range(4):
        res = torch.load(tmp_path / f"census{r}.pt")
        for arch in CENSUS_ARCHS:
            cfg = get_smoke_config(arch)
            one, tp = res[arch]["one"], res[arch]["tp"]
            names = product_names(cfg)
            assert len(one["gemm"]) == len(tp["gemm"]) == len(names)
            _, nq, _, nk = tpm.head_ranges(cfg.n_heads, cfg.n_kv_heads, r, 4)
            for name, f1, ft in zip(names, one["gemm"], tp["gemm"]):
                share = nk / cfg.n_kv_heads if name in ("k", "v") else 0.25
                assert ft == f1 * share, (arch, name, f1, ft)
            assert tp["bmm"] * 4 == one["bmm"] > 0, arch
            assert tp["gathered"] == {}
            gathers = sum(v for k, v in tp["comm"].items() if "allgather" in k
                          or "all_gather" in k)
            per_layer = (4 if cfg.qkv_bias else 2) if nk * 4 != cfg.n_kv_heads else 0
            assert gathers == per_layer * cfg.n_layers, (arch, tp["comm"])
            assert not any("allgather" in k or "all_gather" in k
                           for k in one["comm"])


MIXER_CENSUS = """
import dataclasses
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.distributed.sharding import distribute, param_pspecs, to_shardings
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import LM, tree_map
from repro_torch.train.step import tp_view
mesh = make_host_mesh(model_axis=4)                 # 1 data x 4 model
res = {{}}
route = tpm.route_channels
for arch in {archs!r}:
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                              compute_dtype="float32")
    params = LM(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    batch = {{"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32))}}
    out = {{}}
    for mode in ("one", "tp", "fault"):
        if mode == "fault" and "mamba" not in {{s.kind for s in cfg.pattern}}:
            continue
        model = LM(cfg, ArcaneEngine("ref", record=True), device="cpu")
        p = params
        if mode != "one":
            d = distribute(params, to_shardings(param_pspecs(params, mesh), mesh))
            model, pl = tp_view(model, d, mesh)
            p = tree_map(lambda t, q: t.redistribute(mesh, q).to_local(), d, pl)
        if mode == "fault":           # in_proj's column block used unrouted
            tpm.route_channels = lambda x, mg: x
        try:
            with torch.no_grad(), FlopCounterMode(display=False) as fc:
                model.loss(p, batch)
            gemm = [e.flops for e in model.engine.trace]
            with torch.no_grad():
                logits = model.forward(p, batch)[0]
        finally:
            tpm.route_channels = route
        counts = fc.get_flop_counts()["Global"]
        out[mode] = {{"gemm": gemm,
                     "bmm": int(counts.get(torch.ops.aten.bmm, 0)),
                     "logits": logits,
                     "gathered": {{}} if mode == "one" else dict(model.tp.gathered)}}
    res[arch] = out
torch.save(res, OUT + f"/mixers{{RANK}}.pt")
"""
MIXER_ARCHS = ("minicpm3-4b", "rwkv6-1.6b", "jamba-1.5-large-398b")


def mixer_products(cfg, r: int, m: int = 4) -> list:
    """(name, share of one device's FLOPs a rank) of the engine's products
    of one forward, in order, for the MLA, RWKV-6 and Mamba mixers' archs:
    the replicated q_down, kv_down and RWKV-6's wA whole, every other
    product of a mixer 1/m, attention's k and v the share of the kv heads
    the rank reads."""
    mixer = {"mla": [("q_down", 1), ("q_up", 1 / m), ("kv_down", 1),
                     ("attention", 1 / m), ("o", 1 / m)],
             "rwkv": [(n, 1 / m) for n in ("r", "k", "v", "g")] + [
                 ("wA", 1), ("wB", 1 / m), ("o", 1 / m), ("cm_k", 1 / m),
                 ("cm_v", 1 / m), ("cm_r", 1 / m)],
             "mamba": [(n, 1 / m) for n in ("in_proj", "x_proj", "dt_proj",
                                              "out_proj")]}
    _, _, _, nk = tpm.head_ranges(cfg.n_heads, cfg.n_kv_heads, r, m)
    kv = nk / cfg.n_kv_heads
    attn = [("q", 1 / m), ("k", kv), ("v", kv), ("attention", 1 / m), ("o", 1 / m)]
    out = []
    for _ in range(cfg.n_periods):
        for spec in cfg.pattern:
            out += mixer.get(spec.kind, attn)
            if not spec.moe and spec.kind != "rwkv":
                out += [("gate", 1 / m), ("up", 1 / m), ("down", 1 / m)]
    return out + [("unembed", 1 / m)]


def test_mixer_census_is_a_quarter_of_one_device(tmp_path):
    """On each rank of a 1 x 4 mesh, one forward (``LM.loss``) of minicpm3
    (head-parallel MLA), rwkv6 (head-parallel RWKV-6) and jamba (Mamba by
    channels, attention by heads over 2 kv heads): each engine product at
    the share ``mixer_products`` names (1/4, but the replicated q_down,
    kv_down and wA), the batched products (MLA's k_up/v_up, the scans'
    readouts, attention, experts) at exactly 1/4, nothing gathered over
    ``model``, the logits within 1e-5 of one device's; with jamba's in_proj
    column block used unrouted (a planted fault) the logits leave that by
    over 100 times."""
    run_ranks(4, MIXER_CENSUS.format(archs=MIXER_ARCHS), tmp_path)
    for r in range(4):
        res = torch.load(tmp_path / f"mixers{r}.pt")
        for arch in MIXER_ARCHS:
            cfg = get_smoke_config(arch)
            one, tp = res[arch]["one"], res[arch]["tp"]
            names = mixer_products(cfg, r)
            assert len(one["gemm"]) == len(tp["gemm"]) == len(names), arch
            for (name, share), f1, ft in zip(names, one["gemm"], tp["gemm"]):
                assert ft == f1 * share, (arch, name, f1, ft)
            assert tp["bmm"] * 4 == one["bmm"] > 0, arch
            assert tp["gathered"] == {}, arch
            gap = float((tp["logits"] - one["logits"]).abs().max())
            assert gap < 1e-5, (arch, gap)
            if "fault" in res[arch]:
                bad = float((res[arch]["fault"]["logits"] - one["logits"]).abs().max())
                assert bad > 100 * max(gap, 1e-6), (arch, bad, gap)


# ------------------------------------------------------ vocab parallel
VOCAB = """
from repro_torch.distributed import tensor_parallel as tpm
mg = tpm.ModelGroup(dist.group.WORLD, RANK, WORLD)
data = torch.load(OUT + "/vocab.pt")
v = data["logits"].shape[-1] // WORLD
lg = data["logits"][..., RANK * v:(RANK + 1) * v].clone().requires_grad_()
loss = (tpm.vocab_logsumexp(lg, mg) - tpm.vocab_gold(lg, data["targets"], mg)).mean()
loss.backward()
table = data["table"][RANK * v:(RANK + 1) * v].clone().requires_grad_()
emb = tpm.vocab_embed(table, data["targets"], mg)
(emb * data["weights"]).sum().backward()
torch.save({"loss": loss.detach(), "grad": lg.grad, "emb": emb.detach(),
            "table_grad": table.grad}, OUT + f"/vocab{RANK}.pt")
"""


def test_vocab_parallel_loss_and_embedding(tmp_path):
    """On 4 ranks, a vocab of 64 in shards of 16: the vocab-parallel
    log-sum-exp minus gold logit equals ``F.cross_entropy`` and its
    gradient, and the vocab-parallel lookup equals ``table[ids]`` with the
    table's gradient, for targets at every shard edge (0, 15, 16, 31, 32,
    47, 48, 63) and inside, within 1e-6."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((2, 8, 64)).astype(np.float32) * 4)
    edges = [0, 15, 16, 31, 32, 47, 48, 63]
    targets = torch.tensor([edges, rng.integers(0, 64, 8).tolist()])
    table = torch.from_numpy(rng.standard_normal((64, 5)).astype(np.float32))
    weights = torch.from_numpy(rng.standard_normal((2, 8, 5)).astype(np.float32))
    torch.save({"logits": logits, "targets": targets, "table": table,
                "weights": weights}, tmp_path / "vocab.pt")
    run_ranks(4, VOCAB, tmp_path)
    lg = logits.clone().requires_grad_()
    ref = F.cross_entropy(lg.reshape(-1, 64), targets.reshape(-1))
    ref.backward()
    tb = table.clone().requires_grad_()
    (tb[targets] * weights).sum().backward()
    outs = [torch.load(tmp_path / f"vocab{r}.pt") for r in range(4)]
    for r, o in enumerate(outs):
        torch.testing.assert_close(o["loss"], ref.detach(), atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(o["emb"], table[targets], atol=0, rtol=0)
    torch.testing.assert_close(torch.cat([o["grad"] for o in outs], -1), lg.grad,
                               atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(torch.cat([o["table_grad"] for o in outs]), tb.grad,
                               atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------- serving
# layout → (arch, config changes, the cache leaf whose model placement is
# checked, its sharded dim, the model axis); "spy" runs gemma2 on the
# kernels' route; "straddle" and BLOCK_SERVES run on column blocks
SERVE_CASES = {
    "heads": ("stablelm-3b", {}, "k", 2, 4),
    "seq": ("gemma2-9b", {}, "k", 3, 4),
    "ring": ("gemma2-9b", {"ring_local_cache": True}, "k", 3, 4),
    "mla": ("minicpm3-4b", {}, "c", 2, 4),
    "rwkv": ("rwkv6-1.6b", {}, "S", 2, 4),
    "mamba": ("jamba-1.5-large-398b", {}, "ssm", 2, 4),
    "spy": ("gemma2-9b", {"ring_local_cache": True}, "k", 3, 4),
    "moe": ("granite-moe-1b-a400m", {}, "k", 3, 4),
    "straddle": ("qwen2.5-32b", STRADDLE, "k", 3, 4),
}
# on a 1 x 8 mesh: half a q head a rank, the caches by sequence (2 and 4 kv
# heads); whisper's cross cache of ENC_FRAMES, which 8 does not divide, is
# replicated, as whisper-large-v3's 1,500 frames are on 16 ranks
BLOCK_SERVES = {
    "qwen-blocks": ("qwen2.5-32b", {}, "k", 3, 8),
    "whisper-blocks": ("whisper-large-v3", {}, "k", 3, 8),
}
# MoE serves on the 2 x 4 mesh only: llama4-scout smoke (top-1 of 4
# experts), and the same with router weights that send every token to
# expert 0 (``plant_overflow``), so that the capacity drops are decided
# across the data ranks; "-own-ids" serves it with each rank routing its
# own tokens alone (no ``rows_group``), which must leave one device's logits
MOE_SERVES = {
    "llama4": ("llama4-scout-17b-a16e", {}, "k", 3, 4),
    # granite behind a vision prefix of 4 rows a sequence: the prompt's
    # group counts them (2 x (4 + 12) tokens)
    "moe-vision": ("granite-moe-1b-a400m", {"vision_prefix": 4}, "k", 3, 4),
    "moe-overflow": ("llama4-scout-17b-a16e", {}, "k", 3, 4),
    "moe-overflow-own-ids": ("llama4-scout-17b-a16e", {}, "k", 3, 4),
}
ALL_SERVES = {**SERVE_CASES, **BLOCK_SERVES, **MOE_SERVES}
PROMPT, STEPS, MAX_LEN, SLOTS, ENC_FRAMES = 12, 8, 32, 2, 12


def plant_overflow(jparams):
    """The reference's params with every token routed to expert 0: channel
    0 of the residual stream held at 1 (the embedding's column 0, no
    attention or expert output written to it), so that every MoE layer's
    normed input has the same positive channel 0, and the router reading
    that channel alone, expert 0 first by a wide margin."""
    p = jax.tree.map(lambda a: np.array(a, copy=True), jparams)
    p["embed"]["table"][:, 0] = 1.0
    for blk in p["blocks"]:
        blk["attn"]["o"]["w"][..., 0] = 0.0
        blk["ffn"]["down"][..., 0] = 0.0
        router = blk["ffn"]["router"]["w"]
        router[...] = 0.0
        router[..., 0, :] = np.linspace(8.0, 1.0, router.shape[-1])
    return p

TP_SERVE = """
import dataclasses
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed.sharding import (cache_pspecs, distribute,
                                              param_pspecs, to_shardings)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import LM, tree_leaves, tree_map
from repro_torch.train import step
from repro_torch.train.step import serve_on_mesh, tp_view


class KernelRoute(ArcaneEngine):
    \"\"\"The ``cuda`` engine's route, each kernel's plain version standing in
    for it on the CPU: records every decode attention's lengths and whether
    it asked for the log-sum-exp.\"\"\"

    def __init__(self):
        super().__init__("cuda")
        self.calls = []

    def _kernel(self, t):
        return False

    def decode_attention(self, q, k, v, lengths, **kw):
        self.calls.append((lengths.clone(), bool(kw.get("return_lse")),
                           kw.get("window")))
        return super().decode_attention(q, k, v, lengths, **kw)


meshes = {{}}


def whole(lg):
    # the logits of every sequence: each data rank's rows gathered
    n = mesh.shape[0]
    if n == 1:
        return lg
    out = lg.new_empty((n * lg.shape[0], *lg.shape[1:]))
    dist.all_gather_into_tensor(out, lg.contiguous(), group=mesh.get_group("data"))
    return out


res = {{}}
for layout, (arch, extra, leaf, _, m) in {cases!r}.items():
    if m not in meshes:                 # 1 x 4, 2 x 4 or 1 x 8
        meshes[m] = make_host_mesh(model_axis=m)
    mesh = meshes[m]
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                              compute_dtype="float32", **extra)
    engine = KernelRoute() if layout == "spy" else ArcaneEngine("ref")
    model = LM(cfg, engine, device="cpu")
    params = torch.load(OUT + f"/serve_params_{{layout}}.pt")
    prompt = torch.load(OUT + f"/serve_prompt_{{layout}}.pt")
    enc = {enc} if cfg.enc_dec else 0
    cache = model.init_cache({slots}, {max_len}, enc_len=enc)
    p = distribute(params, to_shardings(param_pspecs(params, mesh), mesh))
    c = distribute(cache, to_shardings(cache_pspecs(cache, mesh), mesh))
    j = next(i for i, b in enumerate(c) if leaf in b)
    placements = str(c[j][leaf].placements)
    plan = tp_view(model, p, mesh, c)[0].tp
    rows_group = step.rows_group
    if layout.endswith("own-ids"):      # the planted fault
        step.rows_group = lambda mesh, axes: None
    logits, c = serve_on_mesh(model, "prefill", p, c, prompt, mesh, enc_len=enc)
    logits = whole(logits)
    out = [logits]
    tok = torch.argmax(logits, -1).to(torch.int32)
    if layout == "spy":
        engine.calls.clear()
    for i in range({steps}):
        pos = torch.full(({slots},), {prompt} + cfg.vision_prefix + i, dtype=torch.int32)
        logits, c = serve_on_mesh(model, "decode", p, c,
                                  {{"tokens": tok, "position": pos}}, mesh,
                                  enc_len=enc)
        logits = whole(logits)
        out.append(logits)
        tok = torch.argmax(logits, -1).to(torch.int32)
    step.rows_group = rows_group
    res[layout] = {{"logits": torch.stack(out), "placements": placements,
                   "data": mesh.shape[0],
                   "local_rows": sorted({{t.to_local().shape[1] for t in tree_leaves(c)}}),
                   "choices": dict(plan.choices), "gathered": dict(plan.gathered),
                   "cache": tree_map(lambda t: t.full_tensor(), c),
                   "calls": getattr(engine, "calls", None)}}
torch.save(res, OUT + f"/serve{{RANK}}.pt")
"""


def one_device_serve(model, params, prompt, enc: int = 0):
    """Prefill of the ``prompt`` batch, then STEPS greedy decode steps on
    one device: the logits of each (STEPS + 1, SLOTS, V) and the final
    cache."""
    cache = model.init_cache(SLOTS, MAX_LEN, enc_len=enc)
    logits, cache = model.prefill(params, prompt, cache)
    out = [logits]
    for i in range(STEPS):
        tok = torch.argmax(logits, -1).to(torch.int32)
        pos = torch.full((SLOTS,), PROMPT + model.cfg.vision_prefix + i, dtype=torch.int32)
        logits, cache = model.decode_step(params, tok, pos, cache, enc_len=enc)
        out.append(logits)
    return torch.stack(out), cache


def jax_serve(jmodel, jparams, prompt, tokens, enc: int = 0):
    """The JAX package's prefill of the ``prompt`` batch and decode steps
    fed the given greedy tokens: the logits of each."""
    import functools
    jcache = jmodel.init_cache(SLOTS, MAX_LEN, dtype=jnp.float32, enc_len=enc)
    lg, jcache = jax.jit(jmodel.prefill)(
        jparams, {k: jnp.asarray(v.numpy()) for k, v in prompt.items()}, jcache)
    out = [np.asarray(lg)]
    dec = jax.jit(functools.partial(jmodel.decode_step, enc_len=enc))
    for i in range(STEPS):
        lg, jcache = dec(jparams, jnp.asarray(tokens[i]),
                         jnp.full((SLOTS,), PROMPT + jmodel.cfg.vision_prefix + i,
                                  jnp.int32), jcache)
        out.append(np.asarray(lg))
    return np.stack(out)


def serve_refs(cases: dict, tmp) -> dict:
    """One device's serve and the JAX package's of each case on the same
    weights and prompt, the weights and prompt saved under ``tmp`` for the
    ranks."""
    refs = {}
    for layout, (arch, extra, *_) in cases.items():
        model, params, jmodel, jparams = pair(arch, **extra)
        if layout.startswith("moe-overflow"):
            planted = plant_overflow(jparams)
            jparams = jax.tree.map(jnp.asarray, planted)
            params = params_from_numpy(planted, model.cfg, "cpu")
        rng = np.random.default_rng(5)
        prompt = {"tokens": torch.from_numpy(rng.integers(
            0, model.cfg.vocab, (SLOTS, PROMPT)).astype(np.int32))}
        enc = ENC_FRAMES if model.cfg.enc_dec else 0
        if enc:
            prompt["audio_embeds"] = torch.from_numpy(rng.standard_normal(
                (SLOTS, enc, model.cfg.d_model)).astype(np.float32))
        if model.cfg.vision_prefix:
            prompt["vision_embeds"] = torch.from_numpy(rng.standard_normal(
                (SLOTS, model.cfg.vision_prefix, model.cfg.d_model)).astype(np.float32))
        torch.save(params, tmp / f"serve_params_{layout}.pt")
        torch.save(prompt, tmp / f"serve_prompt_{layout}.pt")
        logits, cache = one_device_serve(model, params, prompt, enc)
        toks = torch.argmax(logits, -1).to(torch.int32).numpy()
        refs[layout] = (model.cfg, logits, cache,
                        jax_serve(jmodel, jparams, prompt, toks, enc))
    return refs


@pytest.fixture(scope="module")
def tp_serves(tmp_path_factory):
    """Every SERVE_CASES case served on 4 gloo ranks (a 1 x 4 mesh, one
    launch), beside one device's serve and the JAX package's on the same
    weights and prompt."""
    tmp = tmp_path_factory.mktemp("tp_serves")
    refs = serve_refs(SERVE_CASES, tmp)
    run_ranks(4, TP_SERVE.format(cases=SERVE_CASES, slots=SLOTS, max_len=MAX_LEN,
                                 steps=STEPS, prompt=PROMPT, enc=ENC_FRAMES), tmp)
    return refs, [torch.load(tmp / f"serve{r}.pt") for r in range(4)]


# the mixers' and MoE models' serves on a 2 x 4 mesh: each data rank serves
# one of the 2 sequences, its caches' rows split over data; the MoE layers'
# dispatch groups (24 prompt or 2 step tokens) are the whole step's, their
# routing shared over data (``models/moe.py``)
MIXER_SERVES = {k: SERVE_CASES[k] for k in ("mla", "rwkv", "mamba", "moe")}
MIXER_SERVES.update({k: v for k, v in MOE_SERVES.items() if not k.endswith("own-ids")})


@pytest.fixture(scope="module")
def tp_serves_2x4(tmp_path_factory):
    """The MLA, RWKV-6 and Mamba cases served on 8 gloo ranks (a 2 x 4
    mesh) and BLOCK_SERVES in the same launch (a 1 x 8 mesh), beside one
    device's and the JAX package's serves."""
    tmp = tmp_path_factory.mktemp("tp_serves_2x4")
    cases = {**MIXER_SERVES, **BLOCK_SERVES, **MOE_SERVES}
    refs = serve_refs(cases, tmp)
    run_ranks(8, TP_SERVE.format(cases=cases, slots=SLOTS, max_len=MAX_LEN,
                                 steps=STEPS, prompt=PROMPT, enc=ENC_FRAMES), tmp)
    return refs, [torch.load(tmp / f"serve{r}.pt") for r in range(8)]


@pytest.mark.parametrize("layout", sorted(SERVE_CASES))
def test_tp_serve_matches_one_device(tp_serves, layout):
    """A prefill of 2 x 12 tokens and 8 greedy decode steps on a 1 x 4 mesh
    through ``serve_on_mesh``: stablelm smoke (4 kv heads, the cache
    sharded by heads), gemma2 smoke (2 kv heads, the cache sharded by
    sequence: slices of 8 of 32 positions, the decode steps crossing two
    slices and the local layers' window of 16; with ``ring_local_cache``
    the local layers' ring of 16 slots in slices of 4, wrapping at
    position 16), minicpm3 (MLA by heads, its latents by sequence), rwkv6
    (by heads, its wkv state by heads), jamba (Mamba by channels, its
    states by channel; attention by heads over a cache sharded by
    sequence) and the straddling config on column blocks (3 kv heads: the
    cache by sequence). Every rank's greedy tokens equal one device's and
    the JAX package's, its f32 logits within 1e-5 of one device's and of
    the JAX package's, and the cache gathered from the ranks equals one
    device's cache; nothing is gathered over ``model``."""
    check_serve(*tp_serves, layout)


@pytest.mark.parametrize("layout", sorted(MIXER_SERVES))
def test_tp_serve_2x4_matches_one_device(tp_serves_2x4, layout):
    """The same prefill and 8 decode steps of minicpm3, rwkv6, jamba,
    granite (also behind a vision prefix of 4 rows a sequence) and
    llama4-scout (with and without the planted overflow) on a 2 x 4 mesh:
    the batch and the caches' rows split over data, each rank's local cache
    leaves holding 1 of the 2 rows; the MoE layers' dispatch groups of 24
    (32 with the prefix) prompt or 2 step tokens, which do not split, the
    whole step's, their expert ids shared over data; the mixers and
    experts over model. Every rank's greedy tokens and logits as on the
    1 x 4 mesh (one device's and the JAX package's within 1e-5), and the
    gathered cache within 1e-5 of one device's (relatively, for RWKV-6's
    state, whose sums order differs with the split rows)."""
    check_serve(*tp_serves_2x4, layout, rtol=1e-5)


def test_moe_serve_routing_own_ids_alone_is_rejected(tp_serves_2x4):
    """The planted overflow served on 2 x 4 with each rank routing its own
    tokens alone (its groups, capacity and drops those of its one row):
    its logits leave one device's by far more than the 1e-5 the sound path
    keeps to, at the prefill and at every decode step (one device keeps
    the first row's token of each step's group and drops the second's)."""
    refs, ranks = tp_serves_2x4
    _, logits, *_ = refs["moe-overflow"]
    assert refs["moe-overflow-own-ids"][1].equal(logits)
    for res in ranks:
        mine = res["moe-overflow-own-ids"]
        assert mine["local_rows"] == [SLOTS // 2]
        gap = (mine["logits"] - logits).abs().amax(dim=(1, 2))
        assert torch.all(gap > 1e-2), gap


@pytest.mark.parametrize("layout", sorted(BLOCK_SERVES))
def test_tp_serve_on_column_blocks_matches_one_device(tp_serves_2x4, layout):
    """The same prefill and 8 decode steps of qwen2.5-32b smoke (4 q heads
    over 2 kv heads: half a q head a rank) and whisper smoke (4 heads: its
    encoder, self- and cross-attention; 12 audio frames) on a 1 x 8 mesh,
    every attention on column blocks over a cache sharded by sequence
    (whisper's cross cache replicated, used whole): every rank's greedy
    tokens and logits as one device's and the JAX package's, the gathered
    cache one device's; nothing is gathered over ``model``."""
    check_serve(*tp_serves_2x4, layout)


def check_serve(refs, ranks, layout, rtol=0.0):
    """Each rank's serve of ``layout`` against one device's and the JAX
    package's (``test_tp_serve_matches_one_device``)."""
    cfg, logits, cache, jlogits = refs[layout]
    arch, extra, leaf, dim, m = ALL_SERVES[layout]
    blocks = not tpm.head_parallel(cfg.n_heads, cfg.n_kv_heads, m)
    for res in ranks:
        mine = res[layout]
        assert f"Shard(dim={dim})" in mine["placements"]
        assert mine["local_rows"] == [SLOTS // mine["data"]]
        assert mine["gathered"] == {}
        assert set(mine["choices"].values()) <= ({"blocks"} if blocks
                                                 else {"heads", "channels"})
        assert torch.equal(torch.argmax(mine["logits"], -1), torch.argmax(logits, -1))
        assert np.array_equal(np.argmax(jlogits, -1), torch.argmax(logits, -1).numpy())
        torch.testing.assert_close(mine["logits"], logits, atol=1e-5, rtol=0)
        np.testing.assert_allclose(mine["logits"].numpy(), jlogits, atol=1e-5, rtol=0)
        for j, blk in enumerate(cache):
            for name, t in blk.items():
                torch.testing.assert_close(mine["cache"][j][name], t, atol=1e-5,
                                           rtol=rtol, msg=f"{layout} {j}/{name}")


def test_kernel_route_asks_for_the_lse_at_rank_local_lengths(tp_serves):
    """On the ``cuda`` engine's route (``KernelRoute``: the kernels' plain
    versions standing in on the CPU) gemma2 smoke's decode steps over its
    caches sharded by sequence ask each decode attention for its
    log-sum-exp, at the rank-local lengths, unclamped: the global layer's
    ``position + 1 − r·8``, the local layers' ring of 16 slots in slices of
    4 ``min(position + 1, 16) − r·4``, with no window on either; and the
    logits equal the ``ref`` engine's run bit for bit."""
    refs, ranks = tp_serves
    cfg = refs["spy"][0]
    for r, res in enumerate(ranks):
        calls = res["spy"]["calls"]
        assert len(calls) == STEPS * cfg.n_layers
        for n, (lengths, lse, window) in enumerate(calls):
            step, layer = divmod(n, cfg.n_layers)
            pos = PROMPT + step
            spec = cfg.pattern[layer % len(cfg.pattern)]
            if spec.kind == "attn_local":
                want, want_window = min(pos + 1, 16) - r * 4, None
            else:
                want, want_window = pos + 1 - r * 8, None
            assert lse and window == want_window
            assert lengths.tolist() == [want] * SLOTS, (r, n, lengths)
        assert torch.equal(res["spy"]["logits"], res["ring"]["logits"])


def test_decode_lse_matches_the_partial_yardstick():
    """The plain decode attention's (out, lse) at rank-local lengths over
    one of 4 slices of 8 (lengths from below the slice, an empty one, to
    above it; a window that starts inside it, after it or before it; with
    and without a softcap) against ``partial_decode_attention``'s [lo, hi)
    within 1e-6 (an empty slice: out 0, lse −inf, no NaN); the non-empty
    rows' out against the JAX package's plain version; and the 4 slices'
    partials merged (``merge_partials``' arithmetic) against the whole
    cache's decode within 1e-6."""
    from repro.kernels.decode_attention.ref import \
        decode_attention_ref as jax_decode_ref
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    rng = np.random.default_rng(11)
    b, hkv, g, d, s_l, m = 6, 2, 2, 16, 8, 4
    q = torch.from_numpy(rng.standard_normal((b, hkv * g, d)).astype(np.float32))
    kv = [torch.from_numpy(rng.standard_normal((b, hkv, m * s_l, d)).astype(np.float32))
          for _ in range(2)]
    position = torch.tensor([0, 5, 7, 13, 20, 31])
    for softcap in (None, 50.0):
        for window in (None, 5, 11):
            parts = []
            for r in range(m):
                k, v = (t[:, :, r * s_l:(r + 1) * s_l] for t in kv)
                lengths = (position + 1 - r * s_l).to(torch.int32)
                out, lse = decode_attention_ref(
                    q.reshape(b, hkv, g, d), k, v, lengths, softcap=softcap,
                    window=window, return_lse=True)
                out, lse = out.reshape(b, hkv * g, d), lse.reshape(b, hkv * g)
                hi = (position + 1 - r * s_l).clamp(0, s_l)
                lo = ((position + 1 - window - r * s_l).clamp(0, s_l)
                      if window is not None else torch.zeros_like(hi))
                y_out, y_lse = tpm.partial_decode_attention(q, k, v, lo, hi,
                                                            softcap=softcap)
                torch.testing.assert_close(out, y_out, atol=1e-6, rtol=1e-6)
                torch.testing.assert_close(lse, y_lse, atol=1e-6, rtol=1e-6)
                assert not torch.isnan(out).any() and not torch.isnan(lse).any()
                empty = hi <= lo
                assert torch.all(out[empty] == 0) and torch.all(lse[empty] == -np.inf)
                jout = np.asarray(jax_decode_ref(
                    jnp.asarray(q.reshape(b, hkv, g, d).numpy()), jnp.asarray(k.numpy()),
                    jnp.asarray(v.numpy()), jnp.asarray(lengths.numpy()),
                    softcap=softcap, window=window)).reshape(b, hkv * g, d)
                np.testing.assert_allclose(out[~empty].numpy(), jout[~empty.numpy()],
                                           atol=1e-6, rtol=1e-6)
                parts.append((out, lse))
            lse_all = torch.stack([l for _, l in parts])
            mx = lse_all.amax(0)
            w = torch.exp(lse_all - mx)
            merged = sum(o * wi[..., None] for (o, _), wi in zip(parts, w)) / w.sum(0)[..., None]
            whole = decode_attention_ref(q.reshape(b, hkv, g, d), *kv,
                                         (position + 1).to(torch.int32),
                                         softcap=softcap, window=window)
            torch.testing.assert_close(merged, whole.reshape(b, hkv * g, d),
                                       atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("s", [1, 7, 16, 17, 23, 40])
def test_ring_slot_positions(s):
    """The prompt position each slot of a ring of 16 holds after s tokens:
    the reference's ring write (``slots = arange(s - keep, s) % w``) fills
    the first min(s, 16) slots with the same positions; without a ring,
    slot g holds position g."""
    from repro_torch.models.attention import slot_positions
    w = 16
    pos = slot_positions(s, w, True, "cpu")
    keep = min(w, s)
    want = {p % w: p for p in range(s - keep, s)}
    assert sorted(want) == list(range(min(s, w)))     # the filled slots: a prefix
    assert [int(pos[g]) for g in want] == list(want.values())
    assert slot_positions(s, 32, False, "cpu")[:min(s, 32)].tolist() == \
        list(range(min(s, 32)))


# ------------------------------------------------------------ the plan
def spec_dims(pspecs) -> dict:
    """path → the dim a spec shards over ``model`` (``model_dims`` of a
    spec tree instead of DTensors)."""
    out = {}
    sh.map_with_path(lambda p, s: out.__setitem__(
        p, next((i for i, e in enumerate(s) if e == "model"), None)), pspecs)
    return out


def test_serve_split_gives_the_batch_axes_for_moe_models():
    """``serve_split`` splits a serve step's rows over the axes that shard
    the cache's rows whatever the model: an MoE model's decode step of 128
    rows (one dispatch group, which does not split) and its prompt of 32 x
    32,768 tokens alike, on the production meshes; a single row stays on
    every rank. The MoE layers keep the one device's groups by sharing
    their routing (``models/moe.py: splits_whole`` is false for the
    decode step's rows)."""
    from repro_torch.models.moe import splits_whole
    from repro_torch.train.step import serve_split
    single = {"data": 16, "model": 16}
    multi = {"pod": 2, "data": 16, "model": 16}
    for arch in ("granite-moe-1b-a400m", "llama4-scout-17b-a16e"):
        cache = LM(get_config(arch), device="cpu").cache_shapes(128, 64)
        rows = set()
        sh.map_with_path(lambda _, sp: rows.add(tuple(sp)[1]),
                         sh.cache_pspecs(cache, single))
        assert rows == {"data"}
    assert serve_split(single, torch.zeros(128, dtype=torch.int32)) == ("data",)
    assert serve_split(multi, torch.zeros(128, dtype=torch.int32)) == ("pod", "data")
    assert serve_split(single, torch.zeros((32, 4), dtype=torch.int32)) == ("data",)
    assert serve_split(single, torch.zeros(1, dtype=torch.int32)) == ()
    assert not splits_whole(128 // 16, 16) and not splits_whole(128 // 32, 32)
    assert splits_whole(32 * 32_768 // 16, 16)


def test_head_parallel_rule():
    """Head-parallel where the q heads divide and a rank's heads are whole
    GQA groups or sit inside one; the ranges read the right kv heads."""
    assert tpm.head_parallel(16, 8, 16) and tpm.head_parallel(16, 8, 4)
    assert tpm.head_parallel(4, 2, 4) and tpm.head_parallel(4, 2, 2)
    assert not tpm.head_parallel(40, 8, 16)           # 2.5 heads a rank
    assert not tpm.head_parallel(12, 3, 2)            # 6 heads: 1.5 groups
    assert tpm.head_parallel(12, 4, 2) and tpm.head_parallel(12, 4, 4)
    assert tpm.head_ranges(16, 8, 5, 16) == (5, 1, 2, 1)     # inside group 2
    assert tpm.head_ranges(16, 8, 3, 4) == (12, 4, 6, 2)     # groups 6, 7
    assert tpm.head_ranges(40, 8, 1, 4) == (10, 10, 2, 2)


def test_column_blocks_and_their_flash_launches():
    """A rank's column block of q, the q heads that overlap it and the kv
    heads they read (``column_block``), and the flash launches over them
    (``head_groups``): one where the heads sit inside one GQA group or are
    whole groups, one a kv head where they straddle groups."""
    cb = tpm.column_block
    # qwen2.5-32b on 16: 2.5 heads a rank, inside a group of 5
    assert cb(40, 8, 128, 0, 16) == (0, 320, 0, 3, 0, 1)
    assert cb(40, 8, 128, 1, 16) == (320, 320, 2, 3, 0, 1)
    assert cb(40, 8, 128, 2, 16) == (640, 320, 5, 3, 1, 1)
    # internvl2-1b on 4: 3.5 heads a rank, inside a group of 7
    assert cb(14, 2, 64, 1, 4) == (224, 224, 3, 4, 0, 1)
    assert cb(14, 2, 64, 2, 4) == (448, 224, 7, 4, 1, 1)
    # whisper-large-v3 on 16: 1.25 heads a rank, groups of one
    assert cb(20, 20, 64, 3, 16) == (240, 80, 3, 2, 3, 2)
    assert tpm.head_groups(3, 2, 3, 2, 1) == ((3, 2, 3, 2),)
    # 6 q / 3 kv heads on 4: rank 1's heads 1 and 2 read kv heads 0 and 1
    assert cb(6, 3, 16, 1, 4) == (24, 24, 1, 2, 0, 2)
    assert tpm.head_groups(1, 2, 0, 2, 2) == ((1, 1, 0, 1), (2, 1, 1, 1))
    assert tpm.head_groups(0, 2, 0, 1, 2) == ((0, 2, 0, 1),)
    # 10 q / 5 kv on 4: heads 2..4 straddle groups 1 and 2 unevenly
    assert cb(10, 5, 16, 1, 4) == (40, 40, 2, 3, 1, 2)
    assert tpm.head_groups(2, 3, 1, 2, 2) == ((2, 2, 1, 1), (4, 1, 2, 1))
    assert tpm.head_groups(4, 4, 2, 2, 2) == ((4, 4, 2, 2),)     # whole groups


# (arch, m) → each attention-bearing pattern position's choice (or the
# mixer computed whole), the k/v columns' source, and gathered leaf roots
PLAN_CASES = {
    ("gemma2-9b", 16): ("heads", "gather", set()),
    ("gemma2-9b", 4): ("heads", "local", set()),
    ("granite-moe-1b-a400m", 16): ("heads", "gather", set()),
    ("granite-moe-1b-a400m", 4): ("heads", "local", set()),
    ("qwen2.5-32b", 16): ("blocks", None, set()),
    ("qwen2.5-32b", 4): ("heads", "local", set()),
    ("llama4-scout-17b-a16e", 16): ("blocks", None, set()),
    ("whisper-large-v3", 16): ("blocks", None, set()),
    ("internvl2-1b", 4): ("blocks", None, set()),
    ("minicpm3-4b", 16): ("mla whole", None, {"attn"}),
    ("minicpm3-4b", 4): ("mla", None, set()),
    ("rwkv6-1.6b", 16): ("rwkv", None, set()),
    ("jamba-1.5-large-398b", 16): ("heads", "gather", set()),
}


@pytest.mark.parametrize("arch,m", sorted(PLAN_CASES))
def test_plan_chooses_per_layer(arch, m):
    """``plan`` on the production widths' layouts (``param_pspecs`` on a
    (16 / m, m) mesh): each layer's attention head-parallel, on column
    blocks or whole (the reason named), where its k/v columns come from,
    and the leaves it gathers over ``model`` (a whole layer's sharded
    leaves, a gathered mixer's): minicpm3's 40-head MLA on 16 gathers,
    with its reason; qwen2.5-32b's and llama4-scout's 40 heads over 8 kv
    heads on 16 ranks, whisper-large-v3's 20 (self, cross and the
    encoder's) on 16 and internvl2-1b's 14 over 2 on 4 run on column
    blocks, gathering nothing; minicpm3's MLA on 4, rwkv6's mixer on 16
    and jamba's Mamba mixers on 16 run on their shards (MLA and RWKV-6 by
    heads, Mamba by channels); the rest is head-parallel."""
    cfg = get_config(arch)
    params = LM(cfg, device="cpu").param_shapes()
    dims = spec_dims(sh.param_pspecs(params, {"data": 16 // m, "model": m}))
    choice, kv, roots = PLAN_CASES[(arch, m)]
    for r in (0, m - 1):
        plan = tpm.plan(cfg, dims, tpm.ModelGroup(None, r, m))
        assert {p.split("/")[2] for p in plan.gathered} == roots
        for j, (blk, spec) in enumerate(zip(plan.blocks, cfg.pattern)):
            if spec.kind == "mla":
                why = plan.choices[f"blocks/{j}/attn"]
                assert blk.attn.heads == (choice == "mla")
                assert why == ("heads" if choice == "mla" else
                               "whole: 40 heads do not divide over 16 ranks; "
                               "the rules replicate k_up, v_up")
                continue
            if spec.kind in ("rwkv", "mamba"):
                assert blk.mixer and blk.attn is None
                assert plan.choices[f"blocks/{j}/mixer"] == \
                    ("heads" if spec.kind == "rwkv" else "channels")
                continue
            assert blk.attn.heads == (choice == "heads")
            assert blk.attn.blocks == (choice == "blocks")
            if kv is not None:
                assert blk.attn.kv == kv
            if choice == "blocks":
                assert plan.choices[f"blocks/{j}/attn"] == "blocks"
            if blk.cross is not None:
                assert blk.cross.blocks == (choice == "blocks")
                assert plan.choices[f"blocks/{j}/cross"] == choice
        if cfg.enc_dec:
            assert plan.enc.attn.blocks == (choice == "blocks")
        assert plan.embed == plan.unembed == (cfg.vocab % m == 0)
        assert all(b.experts == (cfg.moe is not None and cfg.moe.n_experts % m == 0)
                   for b, s in zip(plan.blocks, cfg.pattern) if s.moe)


@pytest.mark.parametrize("arch,m,max_len", [
    ("qwen2.5-32b", 16, 32768), ("llama4-scout-17b-a16e", 16, 4096),
    ("whisper-large-v3", 16, 448), ("internvl2-1b", 4, 512)])
def test_column_block_plan_keeps_the_rules_caches(arch, m, max_len):
    """While serving, on the production layouts of the params and of a
    cache of 16 rows (``cache_pspecs``): every attention on column blocks
    over its self-attention cache sharded by sequence (the kv heads do not
    divide the axis), whisper's cross cache of 1,500 frames replicated and
    used whole (``cache_kept`` false: nothing to gather), nothing gathered
    over ``model``."""
    cfg = get_config(arch)
    model = LM(cfg, device="cpu")
    mesh = {"data": 16 // m, "model": m}
    dims = spec_dims(sh.param_pspecs(model.param_shapes(), mesh))
    enc = 1500 if cfg.enc_dec else 0
    cache = spec_dims(sh.cache_pspecs(model.cache_shapes(16, max_len, enc_len=enc),
                                      mesh))
    for r in (0, m - 1):
        plan = tpm.plan(cfg, dims, tpm.ModelGroup(None, r, m), cache)
        assert plan.gathered == {}
        assert set(plan.choices.values()) == {"blocks"}
        for j, blk in enumerate(plan.blocks):
            assert blk.attn.blocks and blk.attn.cache == "seq"
            assert tpm.cache_kept(plan, f"{j}/k")
            if cfg.enc_dec:
                assert cache[f"{j}/xk"] is None
                assert blk.cross.blocks and blk.cross.cache == "whole"
                assert not tpm.cache_kept(plan, f"{j}/xk")


def test_plan_names_a_mixer_it_cannot_split():
    """A mixer whose leaves the rules do not lay out by heads or channels
    (here rwkv6's on a model axis of 3: 32 heads, 2,048 channels) or whose
    state cache is laid out otherwise computes whole, its sharded leaves
    gathered, and the plan says why; a Mamba mixer over a cache whose
    channels are whole (a layout the rules never give) too."""
    cfg = get_config("rwkv6-1.6b")
    dims = spec_dims(sh.param_pspecs(LM(cfg, device="cpu").param_shapes(),
                                     {"data": 1, "model": 3}))
    plan = tpm.plan(cfg, dims, tpm.ModelGroup(None, 0, 3))
    assert not plan.blocks[0].mixer
    assert plan.choices["blocks/0/mixer"] == (
        "whole: 32 heads do not divide over 3 ranks; the rules replicate r/w, "
        "k/w, v/w, g/w, o/w, w0, wB, u, ln_scale, cm_k/w, cm_v/w, cm_r/w")
    assert plan.gathered == {}        # nothing of it is sharded on 3
    cfg = get_smoke_config("jamba-1.5-large-398b")
    model = LM(cfg, device="cpu")
    mesh = {"data": 1, "model": 4}
    dims = spec_dims(sh.param_pspecs(model.param_shapes(), mesh))
    cache = spec_dims(sh.cache_pspecs(model.cache_shapes(2, 32), mesh))
    cache["0/ssm"] = None
    plan = tpm.plan(cfg, dims, tpm.ModelGroup(None, 0, 4), cache)
    assert not plan.blocks[0].mixer and plan.blocks[1].mixer
    assert plan.choices["blocks/0/mixer"] == \
        "whole: its cache ssm is not sharded by its channels"
    assert all(p.startswith("blocks/0/mixer/") for p in plan.gathered)
    assert "blocks/0/mixer/in_proj/w" in plan.gathered


# --------------------------------- chip_smoke.py's TP serve checks, on gloo
# the engine calls of a serve counted by the variant the card's wrapper
# would pick (a format string of the rank scripts below)
SPY = """
from repro_torch.core.engine import ArcaneEngine
from repro_torch.kernels.decode_attention.kernel import decode_variant, mla_variant
from repro_torch.kernels.flash_attention.kernel import VARIANTS as FLASH_VARIANTS
from repro_torch.kernels.flash_attention.kernel import flash_variant
from repro_torch.kernels.gemm.kernel import VARIANTS, gemm_variant
from repro_torch.models.transformer import LM
from repro_torch.train.step import serve_on_mesh, tp_view


class Spy(ArcaneEngine):
    def __init__(self):
        super().__init__("ref")
        self.counts = {{"gemm_cuda": 0, "flash_attention_cuda": 0,
                       "decode_attention_cuda": 0}}
        self.variants = {{"gemm_cuda": dict.fromkeys(VARIANTS, 0),
                         "flash_attention_cuda": dict.fromkeys(FLASH_VARIANTS, 0),
                         "decode_attention_cuda": {{"narrow": 0, "wide": 0, "mla": 0}}}}

    def _count(self, wrapper, variant):
        self.counts[wrapper] += 1
        self.variants[wrapper][variant] += 1

    def gemm(self, x, w, c=None, **kw):
        self._count("gemm_cuda", gemm_variant(x.reshape(-1, x.shape[-1]), w))
        return super().gemm(x, w, c, **kw)

    def attention(self, q, k, v, **kw):
        self._count("flash_attention_cuda", flash_variant(q, k, v))
        return super().attention(q, k, v, **kw)

    def decode_attention(self, q, k, v, lengths, **kw):
        self._count("decode_attention_cuda",
                    decode_variant(q.shape[1] // k.shape[1], q.shape[2]))
        return super().decode_attention(q, k, v, lengths, **kw)

    def mla_decode_attention(self, q, c, kr, lengths, **kw):
        self._count("decode_attention_cuda", mla_variant(q, c, kr))
        return super().mla_decode_attention(q, c, kr, lengths, **kw)


"""
CHIP_TP = """
import dataclasses
import importlib
sys.path.insert(0, {root!r})
cs = importlib.import_module("chip_smoke")
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed.sharding import cache_pspecs, distribute, param_pspecs, to_shardings
""" + SPY + """
mesh = cs.tp_mesh((1, WORLD))
out = {{}}
for arch, kw in {cases}.items():
    cfg = dataclasses.replace(get_smoke_config(arch), **kw.get("changes", {{}}))
    b, s, steps, max_len = cs.TP_SERVE_SLOTS, kw["prompt_len"], cs.TP_SERVE_NEW - 1, kw["max_len"]
    spy = Spy()
    model = LM(cfg, spy, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    p = distribute(params, to_shardings(param_pspecs(params, mesh), mesh))
    c0 = model.init_cache(b, max_len)
    c = distribute(c0, to_shardings(cache_pspecs(c0, mesh), mesh))
    plan = tp_view(model, p, mesh, c)[0].tp
    prompt = {{"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, s)).astype(np.int32))}}
    if cfg.vision_prefix:
        prompt["vision_embeds"] = torch.randn((b, cfg.vision_prefix, cfg.d_model))
    with torch.no_grad():
        lg, c = serve_on_mesh(model, "prefill", p, c, prompt, mesh)
        for i in range(steps):
            pos = torch.full((b,), cfg.vision_prefix + s + i, dtype=torch.int32)
            lg, c = serve_on_mesh(model, "decode", p, c, {{"tokens": torch.argmax(
                lg, -1).to(torch.int32), "position": pos}}, mesh)
    want = cs.expected_launches(torch, cfg, [b * s], steps, b, prompt_batch=b, plan=plan)
    sv = cs.tp_serve(torch, mesh, "cpu", "ref", smoke=True, arch=arch, profile=False, **kw)
    blocks = "changes" in kw
    merge = (None if cfg.rwkv is not None or blocks
             else cs.tp_lse_merge(torch, mesh, "cpu", "ref", arch, smoke=True, **kw))
    train = (cs.tp_train(torch, "cpu", ((1, WORLD),), smoke=True, arch=arch,
                         batch=(2, 16, 2), changes=kw["changes"]) if blocks else None)
    out[arch] = {{"counts": [spy.counts, want[0]], "variants": [spy.variants, want[1]],
                 "choices": plan.choices, "serve": sv["f32_copy"], "merge": merge,
                 "train": train}}
torch.save(out, OUT + f"/chip_tp{{RANK}}.pt")
"""
# internvl2 smoke with the straddling heads: its attention on column blocks
# on 4 ranks (chip_smoke's --tp-case internvl2-blocks at smoke width)
CHIP_TP_CASES = {"minicpm3-4b": dict(prompt_len=64, max_len=128),
                 "rwkv6-1.6b": dict(prompt_len=64, max_len=128),
                 "jamba-1.5-large-398b": dict(prompt_len=64, max_len=128),
                 "gemma2-9b": dict(prompt_len=64, max_len=128),
                 "internvl2-1b": dict(prompt_len=24, max_len=64, changes=STRADDLE)}


@pytest.fixture(scope="module")
def chip_tp(tmp_path_factory):
    """chip_smoke.py's launch model, ``tp_serve`` and ``tp_lse_merge`` on 4
    gloo ranks (a 1 x 4 mesh) at smoke widths, the engine ``ref``."""
    import pathlib
    tmp = tmp_path_factory.mktemp("chip_tp")
    root = str(pathlib.Path(__file__).resolve().parents[1])
    run_ranks(4, CHIP_TP.format(root=root, cases=CHIP_TP_CASES), tmp, timeout=600)
    return [torch.load(tmp / f"chip_tp{r}.pt") for r in range(4)]


@pytest.mark.parametrize("arch", sorted(CHIP_TP_CASES))
def test_chip_smoke_tp_launch_model_equals_the_engine_calls(chip_tp, arch):
    """``expected_launches`` with a TP plan (each layer's attention or
    mixer, FFN and unembed at a rank's shards) against the engine calls of
    a smoke serve through ``serve_on_mesh`` on 4 ranks, each call counted
    by the variant the card's wrapper would pick for its operands: MLA by
    heads with its latents by sequence, RWKV-6 by heads, Mamba by channels
    (in_proj routed on the product or on the weight), gemma2's attention
    by heads, internvl2's (6 q heads over 3 kv heads, behind its vision
    prefix) on column blocks, its straddling ranks' prompt attention one
    flash launch a kv head; every rank alike."""
    for res in chip_tp:
        r = res[arch]
        assert r["counts"][0] == r["counts"][1]
        assert r["variants"][0] == r["variants"][1]
        assert all(not v.startswith("whole") for v in r["choices"].values())


@pytest.mark.parametrize("arch", ["internvl2-1b", "jamba-1.5-large-398b", "minicpm3-4b",
                                  "rwkv6-1.6b"])
def test_chip_smoke_tp_serve_verdict_on_the_cpu(chip_tp, arch):
    """``tp_serve``'s hold on a mixer's bf16 TP serve, or one on column
    blocks, at smoke width: the f32 copy's greedy tokens and logits
    (SERVE_F32_RTOL) and the bf16 run's drift from it within
    TP_SERVE_DRIFT times the plain run's, every greedy token that differs
    from the plain run's at a near tie. (Phase 3's limits, calibrated at
    full width, are the card's check only.) On column blocks the same
    check rejects the planted fault, each rank's block of the attention
    output cut at its first q head's boundary (``block_cut_at_head``)."""
    for r, res in enumerate(chip_tp):
        f32 = res[arch]["serve"]
        assert f32["greedy_equal"] and f32["max_abs"] <= f32["limit"]
        v = f32["bf16"]
        tp, plain = v["drift_from_f32"]["tp"], v["drift_from_f32"]["plain"]
        assert all(t <= 1.5 * q for t, q in zip(tp, plain))
        assert v["greedy_flips"] == v["flips_at_near_ties"]
        if arch == "internvl2-1b":
            assert not f32["faults"]["block_cut_at_head"]["ok"], r


def test_chip_smoke_tp_train_on_column_blocks_rejects_its_fault(chip_tp):
    """``tp_train`` of the straddling internvl2 smoke on 4 ranks (2 x 16
    text tokens behind its vision prefix, 2 microbatches): every attention
    on column blocks and nothing gathered; step 1 within its limits (the
    plain bf16 step's own update gap to its f32 copy) and the steps' drift
    within TP_DRIFT of the plain run's; the planted fault (the
    activations' gather left without its reduce-scatter backward) leaves
    the step-1 limits."""
    for res in chip_tp:
        tr = res["internvl2-1b"]["train"]
        m = tr["meshes"]["1x4"]
        assert set(m["choices"].values()) == {"blocks"} and m["gathered_over_model"] == {}
        assert m["ok"], (m["step1"], tr["step1_limits"], m["drift"], tr["drift_plain"])
        assert set(tr["faults"]) == {"gather_without_reduce_scatter"}
        assert all(f["rejected"] for f in tr["faults"].values()), tr["faults"]


@pytest.mark.parametrize("arch", ["gemma2-9b", "jamba-1.5-large-398b", "minicpm3-4b"])
def test_chip_smoke_lse_merge_check_rejects_rounded_partials(chip_tp, arch):
    """``tp_lse_merge`` at a smoke serve's shapes on 4 ranks: the ranks'
    merged decode attention has the whole cache's bits in all but
    TP_MERGE_SHARE of the elements, its rows giving ranks empty, partial
    and full slices, and with each rank's partial rounded to bf16 before
    the merge (``rounded_partials``) it does not."""
    for res in chip_tp:
        m = res[arch]["merge"]
        assert m["ok"] and m["fault_rejected"], m
        assert m["fault_share_bits_differ"] > 10 * m["share_bits_differ"]
    lens = [res[arch]["merge"]["shape"]["rank_lengths"] for res in chip_tp]
    s_l = chip_tp[0][arch]["merge"]["shape"]["S_l"]
    assert min(lens[-1]) <= 0 and max(lens[0]) >= s_l
    assert any(0 < n < s_l for ls in lens for n in ls)


# ------------------- chip_smoke.py's --tp-case moe-rows, on gloo (2 x 2)
CHIP_ROWS = """
import importlib
sys.path.insert(0, {root!r})
cs = importlib.import_module("chip_smoke")
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import cache_pspecs, distribute, param_pspecs, to_shardings
""" + SPY + """
mesh = cs.tp_mesh((2, 2))
arch, kw = {arch!r}, {kw!r}
cfg = get_smoke_config(arch)
b, s, steps = cs.TP_SERVE_SLOTS, kw["prompt_len"], kw["new"] - 1
spy = Spy()
model = LM(cfg, spy, device="cpu")
params = model.init_params(torch.Generator().manual_seed(0))
p = distribute(params, to_shardings(param_pspecs(params, mesh), mesh))
c0 = model.init_cache(b, kw["max_len"])
c = distribute(c0, to_shardings(cache_pspecs(c0, mesh), mesh))
plan = tp_view(model, p, mesh, c)[0].tp
prompt = {{"tokens": torch.from_numpy(np.random.default_rng(0).integers(
    0, cfg.vocab, (b, s)).astype(np.int32))}}


def whole(lg):
    # every row's logits: the data ranks' rows gathered
    out = lg.new_empty((2 * lg.shape[0], *lg.shape[1:]))
    dist.all_gather_into_tensor(out, lg.contiguous(), group=mesh.get_group("data"))
    return out


with torch.no_grad():
    lg, c = serve_on_mesh(model, "prefill", p, c, prompt, mesh)
    for i in range(steps):
        pos = torch.full((b,), s + i, dtype=torch.int32)
        lg, c = serve_on_mesh(model, "decode", p, c, {{"tokens": torch.argmax(
            whole(lg), -1).to(torch.int32), "position": pos}}, mesh)
want = cs.expected_launches(torch, cfg, [b // 2 * s], steps, b // 2, prompt_batch=b // 2,
                            plan=plan)
sv = cs.tp_serve(torch, mesh, "cpu", "ref", smoke=True, arch=arch, **kw)
train = cs.tp_train(torch, "cpu", ((1, 4), (2, 2)), smoke=True, batch={train_batch!r})
torch.save({{"counts": [spy.counts, want[0]], "variants": [spy.variants, want[1]],
            "serve": sv, "train": train}}, OUT + f"/chip_rows{{RANK}}.pt")
"""
# chip_smoke's granite-train at smoke width: 8 rows of 32 tokens in 2
# microbatches, so that on (2, 2) a rank's 64 tokens of a microbatch are
# half its one dispatch group
CHIP_ROWS_TRAIN = (8, 32, 2)
CHIP_ROWS_CASE = ("llama4-scout-17b-a16e",
                  dict(prompt_len=16, max_len=64, new=9, profile=False))


@pytest.fixture(scope="module")
def chip_rows(tmp_path_factory):
    """chip_smoke.py's ``tp_serve`` of an MoE model whose rows the mesh
    splits over data (its --tp-case moe-rows) on 4 gloo ranks, a 2 x 2
    mesh, at smoke width on the engine ``ref``: llama4-scout smoke (top-1
    of 4 experts), 4 prompts of 16 tokens, 8 decode steps; then its
    ``tp_train`` of granite smoke (--tp-case granite-train) on (1, 4) and
    (2, 2), CHIP_ROWS_TRAIN's batch."""
    import pathlib
    tmp = tmp_path_factory.mktemp("chip_rows")
    root = str(pathlib.Path(__file__).resolve().parents[1])
    arch, kw = CHIP_ROWS_CASE
    run_ranks(4, CHIP_ROWS.format(root=root, arch=arch, kw=kw,
                                  train_batch=CHIP_ROWS_TRAIN), tmp, timeout=600)
    return [torch.load(tmp / f"chip_rows{r}.pt") for r in range(4)]


def test_chip_smoke_moe_rows_serve_on_the_cpu(chip_rows):
    """On each rank: the launch model with the rank's 2 of 4 rows
    (``expected_launches``) equal to the engine calls of the serve, each
    counted by the variant the card's wrapper would pick; the local cache
    half the (1, 2) layout's bytes; one decode step's collectives over the
    data axis exactly the MoE layers' shared routing (``rows_census``: the
    expert ids gathered, the capacity rows reduce-scattered and gathered
    back), no cache leaf among them; the f32 copy greedy-equal to one
    device's and within SERVE_F32_RTOL; and the planted ``own_ids`` fault
    (each rank routing its own tokens alone) rejected by the f32 copy's
    verdict. (Phase 3's bf16 limits, calibrated at full width, are the
    card's check only.)"""
    for r, res in enumerate(chip_rows):
        assert res["counts"][0] == res["counts"][1], r
        assert res["variants"][0] == res["variants"][1], r
        sv = res["serve"]
        sp, f32 = sv["rows_split"], sv["f32_copy"]
        assert sp["n_data"] == 2 and sp["ok"], sp
        assert sp["local_cache_bytes"] * 2 == sp["one_data_rank_cache_bytes"] > 0
        assert set(sp["data_axes_bytes"]) == {"all-gather", "reduce-scatter"}
        assert sp["data_axes_bytes"] == sp["expected_data_axes_bytes"]
        assert f32["greedy_equal"] and f32["max_abs"] <= f32["limit"], f32
        assert not f32["faults"]["own_ids"]["ok"], f32["faults"]


def test_chip_smoke_granite_train_splits_its_rows_on_the_cpu(chip_rows):
    """chip_smoke's ``tp_train`` of granite smoke (bf16) on each rank of
    4: on (2, 2) the batch split over data (a rank's 128 tokens), the
    step's bytes over the data axis by op exactly ``train_rows_census``
    (the MoE layers' shared routing, forward, backward and remat's replay,
    the aux loss's means, the grads' reduction and the ZeRO gathers), step
    1 within TP_STEP1 and the plain step's update gap (its loss and update
    in bf16, its grad norm with the embedding's index sums in f32 on both
    sides, as on every mesh that splits the batch over data), the drift
    within TP_DRIFT; the planted
    ``rows_gather_without_reduce_scatter`` fault run on (2, 2) and
    rejected, with the model-axis faults on (1, 4)."""
    for r, res in enumerate(chip_rows):
        tr = res["train"]
        m = tr["meshes"]["2x2"]
        assert m["ok"], (r, m["step1"], tr["step1_limits"], m["drift"], tr["drift_plain"])
        assert m["data_split"] and m["rank_tokens"] == 128
        assert m["data_axes_bytes"] == m["expected_data_axes_bytes"]
        assert set(m["data_axes_bytes"]) == {"all-gather", "reduce-scatter", "all-reduce"}
        assert tr["meshes"]["1x4"]["ok"]
        assert {f: v["mesh"] for f, v in tr["faults"].items()} == {
            "combine_sum_dropped": "1x4", "last_rank_experts_zeroed": "1x4",
            "rows_gather_without_reduce_scatter": "2x2"}
        # on (2, 2) step 1 is held with the embedding's index sums in f32
        assert "step1_f32_index_sums" in m and "step1_f32_index_sums" not in \
            tr["meshes"]["1x4"]
        assert tr["faults"]["rows_gather_without_reduce_scatter"]["f32_index_sums"]
        assert all(f["rejected"] for f in tr["faults"].values()), tr["faults"]
