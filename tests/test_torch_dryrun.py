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


def real_flops(arch, shape, rows: int) -> float:
    """FLOPs of rank 0's share of the cell's step on real CPU tensors: the
    whole model on its ``rows`` rows (the first ones: data coordinate 0)."""
    cfg = get_smoke_config(arch)
    model = LM(cfg, ArcaneEngine("ref"), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    if shape.kind == "decode":
        cache = model.init_cache(rows, shape.seq_len)
        batch = (torch.randint(0, cfg.vocab, (rows,), generator=gen),
                 torch.full((rows,), 3))
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab, (rows, shape.seq_len),
                                         generator=gen)}
    with FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            step = make_train_step(model, specs.opt_config_for(arch))
            step(params, adamw_init(specs.opt_config_for(arch), params), batch)
        else:
            prefill, decode = make_serve_steps(model)
            with torch.no_grad():
                if shape.kind == "prefill":
                    prefill(params, batch, model.init_cache(rows, shape.seq_len))
                else:
                    decode(params, *batch, cache)
    return float(fc.get_total_flops())


@pytest.mark.parametrize("arch,shape,rows", [
    ("gemma2-9b", TRAIN, 4), ("gemma2-9b", PREFILL, 4), ("gemma2-9b", DECODE, 4),
    ("granite-moe-1b-a400m", TRAIN, 8), ("rwkv6-1.6b", PREFILL, 4)],
    ids=["gemma2-train", "gemma2-prefill", "gemma2-decode", "granite-train",
         "rwkv6-prefill"])
def test_trace_flops_equal_a_real_cpu_run(arch, shape, rows):
    """The fake trace's per-rank FLOPs are those of a real run of the rank's
    share: its rows of the batch (4 of 8 over a data axis of 2; granite's
    MoE groups do not split, so every rank takes all 8), the whole model."""
    rec = trace_smoke(arch, shape)
    assert rec["flops"] > 0
    assert rec["flops"] == real_flops(arch, shape, rows)
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
    assumes, met here by counting every layer. The calls stay the same: one
    collective a stacked leaf, whatever its depth. (The unfused bytes are
    not linear: a train step's backward of each period's slice of a stacked
    leaf writes a zero stack of every period, and a stack of one period
    needs no copy to gather.)"""
    period = get_smoke_config(arch).period
    recs = [trace_smoke(arch, shape, n_layers=n * period) for n in (1, 2, 3)]

    def lin(get):
        x1, x2, x3 = (get(r) for r in recs)
        return x3 == x1 + 2 * (x2 - x1) and x2 > x1

    assert lin(lambda r: r["flops"])
    assert recs[0]["collective_bytes"]
    for op in recs[0]["collective_bytes"]:
        assert lin(lambda r: r["collective_bytes"][op]), op
        assert len({r["collective_calls"][op] for r in recs}) == 1, op


def expected_census(arch: str, mesh_sizes: dict, data_split: bool) -> dict:
    """The train step's collectives from the specs: each sharded param leaf
    gathered whole (mesh dims innermost first, each gather's output
    counted), each grad reduced over the data axis (a reduce-scatter where
    the ZeRO leaf is sharded there, else an all-reduce), the updated ZeRO
    shards gathered back to the params' layout, and the 4-byte all-reduces
    of the norm and, where the batch is split, of the four metrics."""
    model = LM(get_smoke_config(arch), device="cpu")
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
    for path in t_:
        t, ps, zs = t_[path], p_[path], z_[path]
        full = t.numel() * t.element_size()
        sharded = lambda spec, i: any(   # noqa: E731
            e is not None and names[i] in ((e,) if isinstance(e, str) else e)
            for e in spec)
        local = full // math.prod(sizes[i] for i in range(len(sizes))
                                  if sharded(ps, i))
        for i in reversed(range(len(sizes))):          # full_tensor
            if sharded(ps, i):
                local *= sizes[i]
                out["all-gather"] += local
        if data_split:
            d = names.index("data")
            out["reduce-scatter" if sharded(zs, d) else "all-reduce"] += \
                full // sizes[d] if sharded(zs, d) else full
        local = full // math.prod(sizes[i] for i in range(len(sizes))
                                  if sharded(zs, i))
        for i in reversed(range(len(sizes))):          # back to the params
            if sharded(zs, i) and not sharded(ps, i):
                local *= sizes[i]
                out["all-gather"] += local
    out["all-reduce"] += 4 * (5 if data_split else 1)
    return {k: v for k, v in out.items() if v}


@pytest.mark.parametrize("arch,split", [("gemma2-9b", True),
                                        ("granite-moe-1b-a400m", False)],
                         ids=["gemma2-fsdp-split", "granite-unsplit"])
def test_census_equals_the_specs(arch, split):
    rec = trace_smoke(arch, TRAIN)
    assert rec["collective_bytes"] == expected_census(
        arch, {"data": 2, "model": 4}, split)
    assert set(rec["collective_calls"]) == set(rec["collective_bytes"])


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
