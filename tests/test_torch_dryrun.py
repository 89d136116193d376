"""The port's dry-run tooling against the reference's, on the CPU.

``LM.param_shapes``/``cache_shapes`` and ``launch/specs.py`` give the JAX
package's shapes and dtypes leaf for leaf (all ten archs, smoke and full
width; every cell of ``grid(arch)``). ``launch/dryrun.py: trace_cell`` runs
smoke configs on a fake world of 8 ranks (a 2 × 4 mesh): its FLOPs equal a
real CPU run of the rank's share of the same step, its FLOPs and collective
bytes are linear in depth (what the reference's ``extrapolate`` assumes),
and its collective census equals the bytes worked out from the sharding
specs. The production meshes (256 and 512 ranks) trace and tear down.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import jax
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.configs import grid as ref_grid
from repro.core.engine import ArcaneEngine as RefEngine
from repro.launch import specs as ref_specs
from repro.models.transformer import LM as RefLM
from repro_torch.configs import (ARCHS, SHAPES, ShapeConfig, get_config,
                                 get_smoke_config, grid)
from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed.sharding import (map_with_path, param_pspecs,
                                              placements, zero_pspecs)
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.transformer import LM, tree_leaves, tree_map
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.step import make_serve_steps, make_train_step
from torch.utils.flop_counter import FlopCounterMode

def chip_smoke():
    """chip_smoke.py at the repo's root, whose yardsticks the card's census
    shares."""
    import importlib
    import sys
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


CELLS = [(arch, s.name) for arch in sorted(REF_ARCHS) for s in ref_grid(arch)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat_torch(tree) -> dict:
    out: dict = {}
    map_with_path(lambda p, x: out.__setitem__(
        p, (tuple(x.shape), str(x.dtype).removeprefix("torch."))), tree)
    return out


def flat_jax(tree) -> dict:
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = (tuple(x.shape), str(x.dtype))
    return out


def smoke_overrides(arch: str) -> dict:
    smk = get_smoke_config(arch)
    return {f.name: getattr(smk, f.name) for f in dataclasses.fields(smk)}


# ---------------------------------------------------------------- shapes
def test_shape_grid_equals_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    for arch in ARCHS:
        assert [s.name for s in grid(arch)] == [s.name for s in ref_grid(arch)]
    assert len(CELLS) == 32


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_cache_shapes_equal_the_reference(arch, smoke):
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    rcfg = ref_get_smoke_config(arch) if smoke else ref_get_config(arch)
    model, ref = LM(cfg, device="cpu"), RefLM(rcfg, RefEngine("ref"))
    params = model.param_shapes()
    assert flat_torch(params) == flat_jax(ref.param_shapes())
    assert all(t.is_meta for t in tree_leaves(params))
    enc = 16 if cfg.enc_dec else 0
    for dtype in (None, torch.float32):
        cache = model.cache_shapes(3, 64, dtype=dtype, enc_len=enc)
        assert all(t.is_meta for t in tree_leaves(cache))
        assert flat_torch(cache) == flat_jax(ref.cache_shapes(
            3, 64, dtype=None if dtype is None else jax.numpy.float32,
            enc_len=enc))


def test_meta_trees_equal_the_real_ones():
    """The meta trees are ``init_params``'/``init_cache``'s, paths, shapes
    and dtypes, and their bytes what those allocate."""
    cfg = get_smoke_config("whisper-large-v3")
    model = LM(cfg, device="cpu")
    real = model.init_params(torch.Generator().manual_seed(0))
    assert flat_torch(model.param_shapes()) == flat_torch(real)
    cache = model.init_cache(2, 32, enc_len=8)
    assert flat_torch(model.cache_shapes(2, 32, enc_len=8)) == flat_torch(cache)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape):
    cfg = get_config(arch)
    mine = specs.input_specs(arch, SHAPES[shape], LM(cfg, device="cpu"))
    ref = ref_specs.input_specs(arch, REF_SHAPES[shape],
                                RefLM(ref_get_config(arch), RefEngine("ref")))
    assert list(mine) == list(ref)
    for key in ref:
        assert flat_torch(mine[key]) == flat_jax(ref[key]), key
        assert all(t.is_meta for t in tree_leaves(mine[key]))
    assert specs.FSDP_ARCHS == ref_specs.FSDP_ARCHS
    assert specs.BF16_MOMENT_ARCHS == ref_specs.BF16_MOMENT_ARCHS
    assert dataclasses.asdict(specs.opt_config_for(arch)) == \
        dataclasses.asdict(ref_specs.opt_config_for(arch))


# ------------------------------------------------------------ trace_cell
TRAIN = ShapeConfig("train_smoke", 32, 8, "train")
PREFILL = ShapeConfig("prefill_smoke", 32, 8, "prefill")
DECODE = ShapeConfig("decode_smoke", 32, 8, "decode")


def trace_smoke(arch, shape, world=8, model_axis=4, **ov):
    with dryrun.fake_world(world):
        mesh = make_host_mesh(model_axis=model_axis)
        return dryrun.trace_cell(arch, shape, mesh,
                                 cfg_overrides={**smoke_overrides(arch), **ov})


def real_flops(arch, shape, model_axis=4) -> float:
    """FLOPs of rank 0's share of the cell's step on real CPU tensors: the
    same step (``make_train_step`` or ``serve_on_mesh``) on real DTensors
    of the smoke config's weights in the fake world of 8 (the 2 x 4 mesh,
    or 1 x 8 with ``model_axis`` 8), outside FakeTensorMode. The fake group moves no data, so the values are
    meaningless, but every product has the rank's shapes: its rows of the
    batch (4 of 8 over a data axis of 2; granite's MoE groups, which do
    not split, share their routing over data) and its share of the
    tensor-parallel products."""
    from repro_torch.distributed.sharding import (cache_pspecs, distribute,
                                                  to_shardings)
    from repro_torch.train.step import serve_on_mesh
    cfg = get_smoke_config(arch)
    model = LM(cfg, ArcaneEngine("ref"), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    b = shape.global_batch
    with dryrun.fake_world(8):
        mesh = make_host_mesh(model_axis=model_axis)
        p = distribute(params, to_shardings(param_pspecs(
            params, mesh, fsdp=arch in specs.FSDP_ARCHS), mesh))
        with FlopCounterMode(display=False) as fc:
            if shape.kind == "train":
                opt = adamw_init(specs.opt_config_for(arch), params)
                o = distribute(opt, to_shardings(zero_pspecs(opt, mesh), mesh))
                step = make_train_step(model, specs.opt_config_for(arch))
                step(p, o, {"tokens": torch.randint(0, cfg.vocab, (b, shape.seq_len),
                                                    generator=gen)})
            else:
                cache = model.init_cache(b, shape.seq_len)
                c = distribute(cache, to_shardings(cache_pspecs(cache, mesh), mesh))
                batch = ({"tokens": torch.randint(0, cfg.vocab, (b,), generator=gen),
                          "position": torch.full((b,), 3)} if shape.kind == "decode"
                         else {"tokens": torch.randint(0, cfg.vocab, (b, shape.seq_len),
                                                       generator=gen)})
                serve_on_mesh(model, shape.kind, p, c, batch, mesh)
    return float(fc.get_total_flops())


@pytest.mark.parametrize("arch,shape", [
    ("gemma2-9b", TRAIN), ("gemma2-9b", PREFILL), ("gemma2-9b", DECODE),
    ("granite-moe-1b-a400m", TRAIN), ("granite-moe-1b-a400m", DECODE),
    ("rwkv6-1.6b", PREFILL)],
    ids=["gemma2-train", "gemma2-prefill", "gemma2-decode", "granite-train",
         "granite-decode", "rwkv6-prefill"])
def test_trace_flops_equal_a_real_cpu_run(arch, shape):
    """The fake trace's per-rank FLOPs are those of a real run of the rank's
    share (``real_flops``); granite's decode step computes its experts on
    the rank's block of the capacity rows (``models/moe.py``), whose shape
    the data do not change, whatever the fake group leaves in the ids it
    gathers."""
    rec = trace_smoke(arch, shape)
    assert rec["flops"] > 0
    assert rec["flops"] == real_flops(arch, shape)
    assert rec["mesh"] == "2x4" and rec["n_devices"] == 8
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    assert rec["bytes_accessed_kind"].startswith("unfused")
    assert {k for k, v in rec["memory"].items() if v is None} == \
        {"output_bytes", "temp_bytes", "alias_bytes"}
    json.dumps(rec)


@pytest.mark.parametrize("arch,shape", [("gemma2-9b", TRAIN),
                                        ("stablelm-3b", PREFILL)],
                         ids=["gemma2-train", "stablelm-prefill"])
def test_trace_is_linear_in_depth(arch, shape):
    """X(L) = X(1) + (L - 1)(X(2) - X(1)) at L = 3 for the FLOPs and each
    collective's bytes: the property the reference's ``extrapolate``
    assumes, met here by counting every layer. The calls are linear too:
    one DTensor collective a stacked leaf, whatever its depth, the model
    axis' collectives a layer each, and those of the embedding, the
    unembedding and the loss once. (The unfused bytes are
    not linear: a train step's backward of each period's slice of a stacked
    leaf writes a zero stack of every period, and a stack of one period
    needs no copy to gather.)"""
    period = get_smoke_config(arch).period
    recs = [trace_smoke(arch, shape, n_layers=n * period) for n in (1, 2, 3)]

    def lin(get):
        x1, x2, x3 = (get(r) for r in recs)
        return x3 == x1 + 2 * (x2 - x1) and x2 >= x1

    assert lin(lambda r: r["flops"]) and recs[1]["flops"] > recs[0]["flops"]
    assert recs[0]["collective_bytes"]
    for op in recs[0]["collective_bytes"]:
        assert lin(lambda r: r["collective_bytes"][op]), op
        assert lin(lambda r: r["collective_calls"][op]), op
    assert sum(recs[1]["collective_bytes"].values()) > \
        sum(recs[0]["collective_bytes"].values())


def expected_census(arch: str, mesh_sizes: dict, data_split: bool,
                    rows: int, seq: int = 32) -> dict:
    """The tensor-parallel train step's collectives from the specs and the
    model's shapes (each collective counted by the tensor it returns):

    * each param leaf sharded over data by the params' specs (ZeRO-3)
      gathered over data, its ``model`` shard kept; each grad, model-local,
      reduced over the data axis where the batch is split (a reduce-scatter
      where the ZeRO leaf is sharded there, else an all-reduce); the
      updated ZeRO shards gathered back to the params' layout; the 4-byte
      all-reduces of the norm and, where the batch is split, of the
      masked-in token count (``LM.loss``) and the four metrics;
    * in the model, over ``model``, on the rank's ``rows`` x ``seq``
      tokens: the vocab-parallel embedding's sum (forward) and the
      unembedding's input-grad sum (backward, f32), the loss's max and two
      sums; a layer's k and v weight columns gathered (kv heads split
      between ranks; forward) and reduce-scattered (backward), o's partial
      products summed (f32), the q, k, v inputs' grads summed (f32); a
      dense FFN's down summed and its gate and up inputs' grads summed; an
      MoE layer's partial combine summed (f32) and its tokens' and gates'
      grads summed. Remat runs each period's forward again in the
      backward, but for its last collective: the checkpoint stops once the
      tensors the backward needs are rebuilt;
    * in an MoE layer, over data, where the batch is split: the aux loss's
      per-expert means and, where the rank's tokens are not whole dispatch
      groups, the shared routing (``models/moe.py: _moe_rows``), as
      chip_smoke.py's ``moe_data_collectives`` counts them for the card's
      census. Remat's replay repeats all of these: the period's last
      collective is its combine's sum over ``model``."""
    cfg = get_smoke_config(arch)
    model = LM(cfg, device="cpu")
    params = model.param_shapes()
    names, sizes = list(mesh_sizes), list(mesh_sizes.values())
    fsdp = arch in specs.FSDP_ARCHS
    psp, zsp = param_pspecs(params, mesh_sizes, fsdp=fsdp), \
        zero_pspecs(params, mesh_sizes)
    out = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    def flat(tree) -> dict:
        out: dict = {}
        map_with_path(lambda p, x: out.__setitem__(p, x), tree)
        return out

    t_, p_, z_ = flat(params), flat(psp), flat(zsp)
    d, m = names.index("data"), mesh_sizes["model"]
    for path in t_:
        t, ps, zs = t_[path], p_[path], z_[path]
        full = t.numel() * t.element_size()
        sharded = lambda spec, i: any(   # noqa: E731
            e is not None and names[i] in ((e,) if isinstance(e, str) else e)
            for e in spec)
        model_local = full // (m if sharded(ps, names.index("model")) else 1)
        if sharded(ps, d):                             # gathered over data
            out["all-gather"] += model_local
        if data_split:
            out["reduce-scatter" if sharded(zs, d) else "all-reduce"] += \
                model_local // sizes[d] if sharded(zs, d) else model_local
        local = full // math.prod(sizes[i] for i in range(len(sizes))
                                  if sharded(zs, i))
        for i in reversed(range(len(sizes))):          # back to the params
            if sharded(zs, i) and not sharded(ps, i):
                local *= sizes[i]
                out["all-gather"] += local
    out["all-reduce"] += 4 * (6 if data_split else 1)

    it = torch.empty((), dtype=cfg.cdtype).element_size()
    tok, dm = rows * seq, cfg.d_model
    act, act32 = tok * dm * it, tok * dm * 4
    nk = cfg.n_kv_heads * cfg.resolved_head_dim
    gather_kv = cfg.n_kv_heads % m != 0
    out["all-reduce"] += act + act32 + 3 * rows * (seq - 1) * 4
    n_data = sizes[d] if data_split else 1
    moe_fwd, moe_bwd = [], []                          # one MoE layer's, over data
    if cfg.moe is not None and n_data > 1:
        moe_fwd, moe_bwd = chip_smoke().moe_data_collectives(cfg, tok, n_data, m)
    for _ in range(cfg.n_periods):
        fwd = []
        for spec in cfg.pattern:
            if gather_kv:
                fwd += [("all-gather", dm * nk * it)] * 2
                out["reduce-scatter"] += 2 * dm * nk // m * it
            fwd += [("all-reduce", act32)]               # o
            out["all-reduce"] += 3 * act32               # q, k, v inputs
            if spec.moe:
                fwd += moe_fwd
                for op, n in moe_bwd:
                    out[op] += n
            fwd += [("all-reduce", act32)]               # down / combine
            out["all-reduce"] += (act + tok * cfg.moe.top_k * 4 if spec.moe
                                  else 2 * act32)
        for op, n in fwd + fwd[:-1]:
            out[op] += n
    return {k: v for k, v in out.items() if v}


@pytest.mark.parametrize("arch", ["gemma2-9b", "granite-moe-1b-a400m"],
                         ids=["gemma2-fsdp-split", "granite-split"])
def test_census_equals_the_specs(arch):
    """The train step's census on the 2 x 4 mesh, its batch of 8 split over
    data (4 rows a rank): gemma2 under FSDP, and granite, whose one
    dispatch group of the ranks' 256 tokens shares its routing over
    data."""
    rec = trace_smoke(arch, TRAIN)
    assert rec["collective_bytes"] == expected_census(
        arch, {"data": 2, "model": 4}, True, rows=4)
    assert set(rec["collective_calls"]) == set(rec["collective_bytes"])
    assert rec["gathered_over_model"] == {}


@pytest.mark.parametrize("shape", [TRAIN, PREFILL, DECODE],
                         ids=["train", "prefill", "decode"])
def test_tp_cell_flops_and_peak_fall_by_the_model_axis(shape):
    """stablelm smoke (4 q and 4 kv heads, a d_ff of 128 and an untied
    vocab of 256: on 4 ranks every product is head-, column-, row- or
    vocab-parallel) traced on a (2, 1) and a (2, 4) mesh: the rank's FLOPs
    fall by exactly the model axis, its peak falls, and nothing is
    gathered over ``model``."""
    one = trace_smoke("stablelm-3b", shape, world=2, model_axis=1)
    tp = trace_smoke("stablelm-3b", shape, world=8, model_axis=4)
    assert tp["flops"] * 4 == one["flops"] > 0
    assert tp["memory"]["peak_bytes"] < one["memory"]["peak_bytes"]
    assert tp["gathered_over_model"] == {}


@pytest.mark.parametrize("arch,shape", [
    ("minicpm3-4b", PREFILL), ("minicpm3-4b", DECODE), ("rwkv6-1.6b", DECODE),
    ("jamba-1.5-large-398b", PREFILL), ("jamba-1.5-large-398b", DECODE)],
    ids=["minicpm3-prefill", "minicpm3-decode", "rwkv6-decode", "jamba-prefill",
         "jamba-decode"])
def test_mixer_cells_compute_on_their_shards(arch, shape):
    """The MLA, RWKV-6 and Mamba mixers on the 2 x 4 mesh (heads, heads,
    channels): nothing gathered over ``model``, and the trace's FLOPs those
    of a real run of the rank's share (``real_flops``)."""
    rec = trace_smoke(arch, shape)
    assert rec["gathered_over_model"] == {}
    assert rec["flops"] == real_flops(arch, shape)


@pytest.mark.parametrize("shape", [TRAIN, PREFILL, DECODE],
                         ids=["train", "prefill", "decode"])
def test_column_block_cells_gather_nothing(shape):
    """qwen2.5-32b smoke's 4 q heads over 2 kv heads on a model axis of 8
    (half a q head a rank: attention on column blocks, its cache by
    sequence) on the 1 x 8 mesh: nothing gathered over ``model``, and the
    trace's FLOPs those of a real run of the rank's share
    (``real_flops``)."""
    rec = trace_smoke("qwen2.5-32b", shape, model_axis=8)
    assert rec["mesh"] == "1x8"
    assert rec["gathered_over_model"] == {}
    assert rec["flops"] == real_flops("qwen2.5-32b", shape, model_axis=8) > 0


@pytest.mark.parametrize("shape", [PREFILL, DECODE], ids=["prefill", "decode"])
def test_ring_cache_sharded_by_sequence_traces(shape):
    """gemma2 smoke with ``ring_local_cache`` (``--ring-local-cache``): its
    local layers' ring of 16 slots, sharded by sequence over 4 ranks,
    traces; a prefill's FLOPs are the plain cache's, a decode step's
    fewer (its local layers attend 16 slots, not 32)."""
    ring = trace_smoke("gemma2-9b", shape, ring_local_cache=True)
    plain = trace_smoke("gemma2-9b", shape)
    assert ring["gathered_over_model"] == {}
    if shape is PREFILL:
        assert ring["flops"] == plain["flops"]
    else:
        assert 0 < ring["flops"] < plain["flops"]


@pytest.mark.parametrize("multi", [False, True], ids=["256", "512"])
def test_production_meshes_trace_and_tear_down(multi):
    world = 512 if multi else 256
    with dryrun.fake_world(world):
        mesh = make_production_mesh(multi_pod=multi)
        rec = dryrun.trace_cell("gemma2-9b", DECODE, mesh,
                                cfg_overrides=smoke_overrides("gemma2-9b"))
        assert rec["n_devices"] == world
        assert rec["mesh"] == ("2x16x16" if multi else "16x16")
        assert rec["collective_calls"]["all-gather"] > 0
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="already initialised"):
        with dryrun.fake_world(8):
            with dryrun.fake_world(8):
                pass
    assert not dist.is_initialized()


def test_cuda_backend_is_refused():
    with dryrun.fake_world(8):
        mesh = make_host_mesh(model_axis=4)
        with pytest.raises(ValueError, match="fake tensors"):
            dryrun.trace_cell("gemma2-9b", TRAIN, mesh, backend="cuda")


def test_main_writes_a_record(tmp_path, capsys):
    out = tmp_path / "dryrun"
    dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "long_500k",
                 "--mesh", "single", "--out", str(out)])
    rec = json.loads((out / "rwkv6-1.6b__long_500k__single.json").read_text())
    assert rec["mesh"] == "16x16" and rec["flops"] > 0
    assert rec["model"]["params"] == ref_get_config("rwkv6-1.6b").param_count()
    assert "[ok]   rwkv6-1.6b__long_500k__single" in capsys.readouterr().out
    assert not dist.is_initialized()
    dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "long_500k",
                 "--out", str(out)])
    assert "[skip]" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "rwkv6-1.6b", "--out", str(out)])
