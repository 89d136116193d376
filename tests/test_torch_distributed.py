"""The port's multi-device layer against the reference's: the sharding
rules entry for entry (``repro.distributed.sharding`` on stand-in meshes of
the five shapes, every arch at smoke and full width), the meshes (the
production ones under torch's fake process group), and the four scenarios
of tests/test_distributed.py on gloo ranks (one process a rank, a
``FileStore`` under the test's tmp dir, one thread a rank): the 2 × 4
sharded train step against the single-device step (the port's and the
JAX package's), compressed against uncompressed data parallelism, the
GPipe forward, and the elastic restore across meshes; then the MoE data
split (dispatch groups whole a rank or shared over data, in one or two
microbatches, a ``loss_mask`` with an empty share), ``grad_shardings=None``
and the launcher on 4 ranks."""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap
import types
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core.engine import ArcaneEngine as JaxEngine
from repro.distributed import sharding as jsh
from repro.models import moe as jax_moe
from repro.models.transformer import LM as JaxLM
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed import sharding as sh
from repro_torch.models import moe as moe_mod
from repro_torch.models.convert import params_from_numpy, tree_to_numpy
from repro_torch.models.transformer import LM, tree_leaves, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.step import make_train_step

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the rules
MESHES = {"2x4": {"data": 2, "model": 4}, "8x1": {"data": 8, "model": 1},
          "1x8": {"data": 1, "model": 8}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def stand_in(sizes: dict):
    """What the reference's rules read of a mesh: ``shape`` and
    ``axis_names``."""
    return types.SimpleNamespace(shape=dict(sizes), axis_names=tuple(sizes))


def flat_specs(tree) -> dict:
    """path → spec entries of a reference spec tree (PartitionSpec leaves)."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jsh._path_str(p): tuple(s) for p, s in leaves}


def my_specs(tree) -> dict:
    out = {}
    sh.map_with_path(lambda p, s: out.__setitem__(p, tuple(s)), tree)
    return out


def my_shapes(tree) -> dict:
    out = {}
    sh.map_with_path(lambda p, x: out.__setitem__(p, tuple(x.shape)), tree)
    return out


def ref_shapes_by_path(tree) -> dict:
    return {jsh._path_str(p): tuple(x.shape)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@lru_cache(maxsize=None)
def ref_shapes(arch: str, smoke: bool):
    """The reference's params, AdamW state and a 4-slot cache of 64
    positions as ShapeDtypeStructs (abstract: no weights drawn)."""
    cfg = (jax_get_smoke_config if smoke else jax_get_config)(arch)
    model = JaxLM(cfg, JaxEngine(backend="ref"))
    params = model.param_shapes()
    opt = jax.eval_shape(lambda p: jax_adamw_init(JaxAdamWConfig(), p), params)
    cache = model.cache_shapes(4, 64, enc_len=16 if cfg.enc_dec else 0)
    return params, opt, cache


def as_meta(tree):
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), tree)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_reference(arch, smoke):
    """``param_pspecs`` (tp and fsdp), ``zero_pspecs`` of the AdamW state,
    ``cache_pspecs`` and ``batch_pspecs`` equal the reference's entry for
    entry on the five mesh shapes. At smoke width the port's own trees
    (``init_params``, ``adamw_init``, ``init_cache`` on the CPU), whose
    paths and shapes equal the reference's; at full width meta tensors of
    the reference's shapes."""
    jparams, jopt, jcache = ref_shapes(arch, smoke)
    if smoke:
        model = LM(get_smoke_config(arch), ArcaneEngine("ref"), device="cpu")
        params = model.init_params(torch.Generator().manual_seed(0))
        opt = adamw_init(AdamWConfig(), params)
        cache = model.init_cache(4, 64, enc_len=16 if model.cfg.enc_dec else 0)
        for mine, ref in ((params, jparams), (opt, jopt), (cache, jcache)):
            assert my_shapes(mine) == ref_shapes_by_path(ref)
    else:
        params, opt, cache = as_meta(jparams), as_meta(jopt), as_meta(jcache)
    for sizes in MESHES.values():
        mesh = stand_in(sizes)
        for fsdp in (False, True):
            assert my_specs(sh.param_pspecs(params, sizes, fsdp=fsdp)) == \
                flat_specs(jsh.param_pspecs(jparams, mesh, fsdp=fsdp))
        assert my_specs(sh.zero_pspecs(opt, sizes)) == \
            flat_specs(jsh.zero_pspecs(jopt, mesh))
        assert my_specs(sh.cache_pspecs(cache, sizes)) == \
            flat_specs(jsh.cache_pspecs(jcache, mesh))
        for b in (1, 2, 6, 8, 16, 32, 64, 256):
            batch = {"tokens": torch.empty((b, 32), device="meta"),
                     "pos": torch.empty((), device="meta")}
            jbatch = {"tokens": jax.ShapeDtypeStruct((b, 32), jnp.int32),
                      "pos": jax.ShapeDtypeStruct((), jnp.int32)}
            assert my_specs(sh.batch_pspecs(batch, sizes)) == \
                flat_specs(jsh.batch_pspecs(jbatch, mesh))


def test_rules_equal_reference_helpers():
    """``shard_dim``, ``axis_size`` and ``batch_axes`` on the five meshes."""
    for sizes in MESHES.values():
        mesh = stand_in(sizes)
        assert sh.batch_axes(sizes) == jsh.batch_axes(mesh)
        for axes in (None, "data", "model", ("data", "model"), sh.batch_axes(sizes)):
            assert sh.axis_size(sizes, axes) == jsh.axis_size(mesh, axes)
        for dim in (1, 2, 3, 8, 12, 16, 48, 256, 4096):
            cands = [sh.batch_axes(sizes), "model", None]
            assert sh.shard_dim(dim, sizes, cands) == jsh.shard_dim(dim, mesh, cands)


CONSTRAIN_CASES = [
    ((8, 4096, 14336), ("batch", None, "model")),
    ((16, 32, 4096, 128), ("batch", "model", None, None)),
    ((8, 24, 2048, 128), ("batch", "model", None, None)),    # heads don't divide
    ((40, 4096, 2048), ("model", "batch", None)),            # MoE xe
    ((3, 4096, 4096), ("batch", None, None)),                # batch doesn't divide
    ((1, 1, 4096), ("batch", None, None)),                   # decode-sized
    ((8, 512, 1023), ("batch", None, "model")),              # just under 2^22 ...
    ((8, 512, 1024), ("batch", None, "model")),              # ... and at it
    ((5, 7, 4096, 128), ("batch", "model", None, None)),     # nothing pinned
    ((8, 4096, 14336), ("batch", None)),                     # wrong rank
]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_constrain_pins_the_reference_dims(mesh_name, monkeypatch):
    """``constrain_spec`` pins the dims the reference's ``constrain``
    pins (read from its ``with_sharding_constraint`` call), leaves the
    rest UNCONSTRAINED, and does nothing below 2^22 elements, on a wrong
    rank or outside an activation mesh; on plain tensors ``constrain``
    returns the tensor itself."""
    sizes = MESHES[mesh_name]
    seen = []
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(spec) or x)
    jsh.set_activation_mesh(stand_in(sizes))
    pinned = 0
    try:
        for shape, roles in CONSTRAIN_CASES:
            seen.clear()
            x = types.SimpleNamespace(shape=shape, ndim=len(shape),
                                      size=int(np.prod(shape)))
            jsh.constrain(x, *roles)
            mine = sh.constrain_spec(shape, roles, sizes)
            if not seen:
                assert mine is None, (shape, roles)
                continue
            pinned += 1
            ref = tuple(sh.UNCONSTRAINED if e is jax.sharding.PartitionSpec.UNCONSTRAINED
                        else e for e in seen[0])
            assert mine is not None and tuple(mine) == ref, (shape, roles, mine, ref)
    finally:
        jsh.set_activation_mesh(None)
    assert pinned >= 4
    assert sh.MIN_CONSTRAIN_ELEMS == jsh.MIN_CONSTRAIN_ELEMS == 1 << 22
    assert sh.constrain_spec((8, 4096, 14336), ("batch", None, "model"), None) is None
    t = torch.zeros(2, 3)
    sh.set_activation_mesh(sizes)
    try:
        assert sh.constrain(t, "batch", "model") is t
    finally:
        sh.set_activation_mesh(None)


def test_production_meshes_under_the_fake_process_group():
    """``make_production_mesh`` builds (16, 16) over ("data", "model") and
    (2, 16, 16) over ("pod", "data", "model") in one process standing in
    for 256 and 512 ranks; ``make_host_mesh`` refuses a model axis that
    does not divide the world; the rules run on the mesh itself."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    for world, multi, shape, names in ((256, False, (16, 16), ("data", "model")),
                                       (512, True, (2, 16, 16),
                                        ("pod", "data", "model"))):
        dist.init_process_group("fake", store=FakeStore(), rank=5, world_size=world)
        try:
            mesh = make_production_mesh(multi_pod=multi)
            assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == names
            assert mesh.device_type == "cpu"
            assert sh.mesh_sizes(mesh) == dict(zip(names, shape))
            host = make_host_mesh(model_axis=8)
            assert tuple(host.shape) == (world // 8, 8)
            with pytest.raises(ValueError, match="does not divide"):
                make_host_mesh(model_axis=3)
            w = {"blocks": ({"attn": {"q": {"w": torch.empty((2, 4096, 4096),
                                                              device="meta")}}},)}
            spec = sh.zero_pspecs(w, mesh)["blocks"][0]["attn"]["q"]["w"]
            dax = ("pod", "data") if multi else "data"
            assert tuple(spec) == (None, dax, "model")
            pl = sh.placements(spec, mesh)
            assert [type(p).__name__ for p in pl] == ["Shard"] * len(shape)
            assert [p.dim for p in pl] == ([1, 1, 2] if multi else [1, 2])
        finally:
            dist.destroy_process_group()


# ------------------------------------------------------------ gloo ranks
PRELUDE = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD, OUT = int(sys.argv[1]), {world}, {out!r}
dist.init_process_group("gloo", store=dist.FileStore(OUT + "/store", WORLD),
                        rank=RANK, world_size=WORLD)
"""


def run_ranks(world: int, body: str, tmp_path, *, env=None, join=True,
              timeout=300) -> list:
    """``body`` in ``world`` processes (``RANK`` and ``WORLD_SIZE`` in the
    environment; with ``join``, after PRELUDE: gloo joined, one thread) →
    each rank's stdout; fails with a rank's stderr where one fails."""
    code = textwrap.dedent(body)
    if join:
        code = textwrap.dedent(PRELUDE).format(world=world, out=str(tmp_path)) \
            + code + "\ndist.destroy_process_group()\n"
    base = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env or {}))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r)],
        env=dict(base, RANK=str(r), WORLD_SIZE=str(world)), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{err[-6000:]}"
    return [o for o, _ in outs]


def qwen_pair():
    """(port LM, port params, jax LM, jax params): qwen2.5-32b smoke in
    f32 on the reference's weights (``init_params(key(0))``)."""
    jcfg = dataclasses.replace(jax_get_smoke_config("qwen2.5-32b"), **F32)
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-32b"), **F32)
    jmodel = JaxLM(jcfg, JaxEngine(backend="ref"))
    jparams = jmodel.init_params(jax.random.key(0))
    model = LM(cfg, ArcaneEngine("ref"), device="cpu")
    return model, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu"), \
        jmodel, jparams


def by_path(tree) -> dict:
    """path → numpy array of a port tree or a reference pytree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    return {jsh._path_str(p): np.asarray(x.numpy() if isinstance(x, torch.Tensor)
                                         else x) for p, x in leaves}


def assert_close(mine, ref, atol, rtol):
    mine, ref = by_path(mine), by_path(ref)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(mine[k], ref[k], atol=atol, rtol=rtol, err_msg=k)


SHARDED_STEP = """
import dataclasses
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed.sharding import (distribute, param_pspecs,
                                              to_shardings, zero_pspecs)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import LM, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.step import make_train_step
cfg = dataclasses.replace(get_smoke_config("qwen2.5-32b"),
                          param_dtype="float32", compute_dtype="float32")
model = LM(cfg, ArcaneEngine("ref"), device="cpu")
params = torch.load(OUT + "/params.pt")
batch = {"tokens": torch.load(OUT + "/tokens.pt")}
opt_cfg = AdamWConfig(total_steps=10, warmup_steps=0)
mesh = make_host_mesh(model_axis=4)                 # 2 data x 4 model
p_sh = to_shardings(param_pspecs(params, mesh), mesh)
res = {}
for name, gs in (("zero", to_shardings(zero_pspecs(params, mesh), mesh)),
                 ("none", None)):
    opt = adamw_init(opt_cfg, params)
    o_sh = to_shardings(zero_pspecs(opt, mesh), mesh)
    p, o = distribute(params, p_sh), distribute(opt, o_sh)
    p, o, m = make_train_step(model, opt_cfg, grad_shardings=gs)(p, o, batch)
    q, mv = p["blocks"][0]["attn"]["q"]["w"], o["m"]["blocks"][0]["attn"]["q"]["w"]
    res[name] = {"params": tree_map(lambda t: t.full_tensor(), p),
                 "master": tree_map(lambda t: t.full_tensor(), o["master"]),
                 "metrics": {k: float(v) for k, v in m.items()},
                 "q_local": tuple(q.to_local().shape), "m_local": tuple(mv.to_local().shape),
                 "q_placements": str(q.placements), "m_placements": str(mv.placements)}
if RANK == 0:
    torch.save(res, OUT + "/result.pt")
"""


def test_sharded_train_step_matches_single_device(tmp_path):
    """tests/test_distributed.py:33 on gloo: qwen2.5-32b smoke in f32, a
    2 (data) × 4 (model) mesh, params under ``param_pspecs`` and the AdamW
    state under ``zero_pspecs``: the step's loss within 1e-4 of the
    single-device step's and every param within atol 2e-4, rtol 2e-3 (the
    reference's limits), against the port's own step and the JAX
    package's ``jit(step)`` on the same weights. The batch is split over
    data (``data_split``), a q weight is sharded over model and its
    optimizer state over data and model too, and ``grad_shardings=None``
    gives the same bits as the ZeRO tree."""
    model, params, jmodel, jparams = qwen_pair()
    tokens = np.random.default_rng(0).integers(0, model.cfg.vocab, (8, 32))
    kw = dict(total_steps=10, warmup_steps=0)
    p_ref, _, m_ref = jax.jit(jax_make_train_step(jmodel, JaxAdamWConfig(**kw)))(
        jparams, jax_adamw_init(JaxAdamWConfig(**kw), jparams),
        {"tokens": jnp.asarray(tokens)})
    torch.save(params, tmp_path / "params.pt")
    torch.save(torch.from_numpy(tokens.astype(np.int32)), tmp_path / "tokens.pt")
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
    p_one, _, m_one = make_train_step(model, AdamWConfig(**kw))(
        params, adamw_init(AdamWConfig(**kw), params), batch)
    run_ranks(8, SHARDED_STEP, tmp_path)
    res = torch.load(tmp_path / "result.pt")
    mine = res["zero"]
    assert mine["metrics"]["data_split"] == 1.0
    for ref_loss in (float(m_ref["loss"]), float(m_one["loss"])):
        assert abs(mine["metrics"]["loss"] - ref_loss) < 1e-4
    assert_close(mine["params"], p_ref, atol=2e-4, rtol=2e-3)
    assert_close(mine["params"], p_one, atol=2e-4, rtol=2e-3)
    # (d_model 64, 4 heads x 16): q's columns over model; its moments over data too
    assert mine["q_local"] == (2, 64, 16) and "Shard(dim=2)" in mine["q_placements"]
    assert mine["m_local"] == (2, 32, 16) and mine["m_placements"].count("Shard") == 2
    for a, b in zip(tree_leaves(mine["params"]) + tree_leaves(mine["master"]),
                    tree_leaves(res["none"]["params"]) + tree_leaves(res["none"]["master"])):
        assert torch.equal(a, b)
    assert mine["metrics"] == res["none"]["metrics"]


COMPRESSED_DP = """
import dataclasses
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distributed.collectives import (init_error_feedback,
                                                 make_compressed_dp_step)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import LM
from repro_torch.optim.adamw import AdamWConfig, adamw_init
cfg = dataclasses.replace(get_smoke_config("stablelm-3b"),
                          param_dtype="float32", compute_dtype="float32")
model = LM(cfg, ArcaneEngine("ref"), device="cpu")
group = make_host_mesh(model_axis=1).get_group("data")     # 8-way DP
opt_cfg = AdamWConfig(lr=3e-3, total_steps=30, warmup_steps=3)
src = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))

def train(compress):
    params = model.init_params(torch.Generator().manual_seed(0))
    opt = adamw_init(opt_cfg, params)
    err = init_error_feedback(params)
    step = make_compressed_dp_step(model, opt_cfg, group, compress=compress)
    losses = []
    for i in range(30):
        batch = {k: torch.from_numpy(v) for k, v in src.batch_at(i).items()}
        params, opt, err, m = step(params, opt, err, batch)
        losses.append(float(m["loss"]))
    return losses, float(params["embed"]["table"].sum())

lc, sc = train(True)
lu, su = train(False)
sums = [torch.zeros(2) for _ in range(WORLD)]
dist.all_gather(sums, torch.tensor([sc, su]))
if RANK == 0:
    json.dump({"lc": lc, "lu": lu, "sums": [s.tolist() for s in sums]},
              open(OUT + "/result.json", "w"))
"""


def test_compressed_dp_converges_like_uncompressed(tmp_path):
    """tests/test_distributed.py:75 on 8 gloo ranks: stablelm-3b smoke in
    f32, 30 steps of 8 x 32 (one row a rank) with the int8 error-feedback
    all-reduce and without: the compressed run's loss falls by more than
    0.3 and ends within 0.25 of the uncompressed run's (the reference's
    bounds), and every rank holds the same params after either run."""
    run_ranks(8, COMPRESSED_DP, tmp_path)
    res = json.loads((tmp_path / "result.json").read_text())
    lc, lu = res["lc"], res["lu"]
    assert lc[-1] < lc[0] - 0.3, lc
    assert abs(lc[-1] - lu[-1]) < 0.25, (lc[-1], lu[-1])
    assert all(s == res["sums"][0] for s in res["sums"])


PIPELINE = """
from repro_torch.distributed.pipeline import pipeline_forward
rngn = np.random.default_rng(0)
ws = torch.from_numpy((rngn.standard_normal((4, 16, 16)) * 0.3).astype(np.float32))
x = torch.from_numpy(rngn.standard_normal((8, 16)).astype(np.float32))
outs = {m: pipeline_forward(lambda w, h: torch.tanh(h @ w), ws[RANK], x,
                            n_micro=m) for m in (1, 2, 4, 8)}
np.save(OUT + f"/out{RANK}.npy", np.stack([o.numpy() for o in outs.values()]))
"""


def test_pipeline_parallel_forward_parity(tmp_path):
    """tests/test_distributed.py:120 on 4 gloo ranks (a stage each): the
    GPipe forward of ``tanh(h @ w_s)`` equals the sequential stages (the
    JAX package's arithmetic) within atol 1e-5 on every rank, at 1, 2, 4
    and 8 microbatches."""
    rngn = np.random.default_rng(0)
    ws = jnp.asarray(rngn.standard_normal((4, 16, 16)) * 0.3, jnp.float32)
    x = jnp.asarray(rngn.standard_normal((8, 16)), jnp.float32)
    ref = x
    for i in range(4):
        ref = jnp.tanh(ref @ ws[i])
    run_ranks(4, PIPELINE, tmp_path)
    for r in range(4):
        for out in np.load(tmp_path / f"out{r}.npy"):
            np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)


ELASTIC = """
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed.sharding import NamedSharding, P
from repro_torch.launch.mesh import make_host_mesh
from torch.distributed.device_mesh import init_device_mesh
checks = {}
w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
mgr = CheckpointManager(OUT + "/ck")
mesh8 = make_host_mesh(model_axis=8)                     # (1, 8)
t8 = NamedSharding(mesh8, P(None, "model")).distribute(w)
checks["saved_block"] = torch.equal(t8.to_local(), w[:, RANK:RANK + 1])
mgr.save(1, {"w": t8})
mesh2 = make_host_mesh(model_axis=2)                     # (4, 2)
restored, _ = mgr.restore(1, {"w": torch.empty(8, 8, device="meta")},
                          shardings={"w": NamedSharding(mesh2, P("model", None))})
r = restored["w"]
c = mesh2.get_coordinate()
checks["restored_block"] = torch.equal(r.to_local(), w[c[1] * 4:(c[1] + 1) * 4])
checks["restored_whole"] = torch.equal(r.full_tensor(), w)
# async: every rank meets rank 0 in wait()
mgr.save(2, {"w": r}, blocking=False)
mgr.wait()
checks["latest"] = mgr.latest_step() == 2
# P(("pod", "data"), "model") on (2, 2, 2): rows in pod-major blocks, as JAX
# puts them (device (p, d, m) holds row block 2p + d, column block m)
mesh3 = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
x = torch.arange(32.0).reshape(8, 4)
t3 = NamedSharding(mesh3, P(("pod", "data"), "model")).distribute(x)
p, d, m = mesh3.get_coordinate()
blk = 2 * p + d
checks["pod_major_block"] = torch.equal(t3.to_local(),
                                        x[2 * blk:2 * blk + 2, 2 * m:2 * m + 2])
checks["pod_major_placements"] = str(t3.placements)
json.dump(checks, open(OUT + f"/checks{RANK}.json", "w"))
"""


def test_elastic_checkpoint_restore_across_meshes(tmp_path):
    """tests/test_distributed.py:145 on 8 gloo ranks: an 8 x 8 leaf saved
    from a (1, 8) mesh sharded on dim 1 (each rank gathers, rank 0
    writes), restored onto a (4, 2) mesh sharded on dim 0: each rank's
    block is its rows and the whole array is equal; an async save of the
    restored DTensor is on disk after ``wait`` on every rank; and a leaf
    under ``P(("pod", "data"), "model")`` on a (2, 2, 2) mesh puts each
    rank's block where JAX's NamedSharding does (pod-major rows)."""
    run_ranks(8, ELASTIC, tmp_path)
    for r in range(8):
        checks = json.loads((tmp_path / f"checks{r}.json").read_text())
        assert checks.pop("pod_major_placements") == \
            "(Shard(dim=0), Shard(dim=0), Shard(dim=1))"
        assert all(checks.values()), (r, checks)
    assert sorted(os.listdir(tmp_path / "ck")) == ["LATEST", "step_000000001",
                                                  "step_000000002"]


# the MoE data split's variants: name → (GROUP_TOKENS, microbatches, a
# loss_mask whose second half of the rows, data rank 1's share, is zeros)
MOE_VARIANTS = {"groups-split": (64, 1, False), "one-group": (8192, 1, False),
                "one-group-2-micro": (8192, 2, False),
                "one-group-empty-share": (8192, 1, True)}

MOE_SPLIT = """
import dataclasses
import repro_torch.models.moe as moe
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed.sharding import (distribute, param_pspecs,
                                              to_shardings, zero_pspecs)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import LM, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.step import make_train_step
cfg = dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"),
                          param_dtype="float32", compute_dtype="float32")
model = LM(cfg, ArcaneEngine("ref"), device="cpu")
params0 = torch.load(OUT + "/params.pt")
batches = torch.load(OUT + "/batches.pt")
opt_cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=3)
mesh = make_host_mesh(model_axis=1)                      # 2-way data
res = {}
for name, (group_tokens, micro, _) in %r.items():
    moe.GROUP_TOKENS = group_tokens
    params = tree_map(lambda t: t.clone(), params0)
    opt = adamw_init(opt_cfg, params)
    p = distribute(params, to_shardings(param_pspecs(params, mesh), mesh))
    o = distribute(opt, to_shardings(zero_pspecs(opt, mesh), mesh))
    step = make_train_step(model, opt_cfg, microbatches=micro,
                           grad_shardings=to_shardings(zero_pspecs(params, mesh), mesh))
    ms = []
    for b in batches[name]:
        p, o, m = step(p, o, b)
        ms.append({k: float(v) for k, v in m.items()})
    res[name] = {"params": tree_map(lambda t: t.full_tensor(), p), "metrics": ms}
if RANK == 0:
    torch.save(res, OUT + "/result.pt")
""" % (MOE_VARIANTS,)


@pytest.fixture(scope="module")
def moe_split(tmp_path_factory):
    """granite-moe-1b smoke (f32) on a 2-way data mesh (one launch of 2
    gloo ranks), two steps of 8 x 32 tokens in each MOE_VARIANTS variant,
    and the single-device steps of the same, the port's and the JAX
    package's jitted step (its ``GROUP_TOKENS`` set alike) on the same
    weights: name → (the ranks' metrics and params, the port's single
    device's, the JAX package's)."""
    tmp = tmp_path_factory.mktemp("moe_split")
    cfg = dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"), **F32)
    model = LM(cfg, ArcaneEngine("ref"), device="cpu")
    params0 = model.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8, 32)).astype(np.int32))
    mask = torch.from_numpy((rng.random((2, 8, 32)) < 0.6).astype(np.float32))
    mask[:, 4:] = 0.0
    batches = {name: [{"tokens": tokens[i], **({"loss_mask": mask[i]} if masked else {})}
                      for i in range(2)]
               for name, (_, _, masked) in MOE_VARIANTS.items()}
    torch.save(params0, tmp / "params.pt")
    torch.save(batches, tmp / "batches.pt")
    run_ranks(2, MOE_SPLIT, tmp)
    res = torch.load(tmp / "result.pt")
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=3)
    jmodel = JaxLM(dataclasses.replace(jax_get_smoke_config("granite-moe-1b-a400m"),
                                       **F32), JaxEngine(backend="ref"))
    jparams0 = jax.tree.map(jnp.asarray, tree_to_numpy(params0))
    out = {}
    real, jax_real = moe_mod.GROUP_TOKENS, jax_moe.GROUP_TOKENS
    try:
        for name, (group_tokens, micro, _) in MOE_VARIANTS.items():
            moe_mod.GROUP_TOKENS = jax_moe.GROUP_TOKENS = group_tokens
            params = tree_map(lambda t: t.clone(), params0)
            opt = adamw_init(AdamWConfig(**kw), params)
            step = make_train_step(model, AdamWConfig(**kw), microbatches=micro)
            jp = jparams0
            jo = jax_adamw_init(JaxAdamWConfig(**kw), jp)
            jstep = jax.jit(jax_make_train_step(jmodel, JaxAdamWConfig(**kw),
                                                microbatches=micro))
            ms, jms = [], []
            for b in batches[name]:
                params, opt, m = step(params, opt, b)
                ms.append({k: float(v) for k, v in m.items()})
                jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
                jms.append({k: float(v) for k, v in jm.items()})
            out[name] = (res[name], {"params": params, "metrics": ms},
                         {"params": jp, "metrics": jms})
    finally:
        moe_mod.GROUP_TOKENS, jax_moe.GROUP_TOKENS = real, jax_real
    return out


def assert_moe_split(mine: dict, *refs: dict):
    """Every step's metrics within 1e-4 (relative past 1) of each single
    device's (the port's, the JAX package's), ``data_split`` true, the
    token count equal; the params within the limits of the 2 x 4 test."""
    for one in refs:
        assert len(mine["metrics"]) == len(one["metrics"])
        for a, b in zip(mine["metrics"], one["metrics"]):
            assert a["data_split"] == 1.0
            assert set(a) == set(b) | {"data_split"}
            for k in b:
                assert abs(a[k] - b[k]) < 1e-4 * max(1.0, abs(b[k])), k
            if "tokens" in b:
                assert a["tokens"] == b["tokens"]
        assert_close(mine["params"], one["params"], atol=2e-4, rtol=2e-3)


def test_moe_data_split_matches_single_device(moe_split):
    """granite-moe-1b smoke (f32) on a 2-way data mesh, two steps of 8 x
    32 tokens, the batch split over data (``data_split`` true) whatever the
    dispatch groups, each against the single-device step (the port's and
    the JAX package's) within the limits of the 2 x 4 test: with groups of 64 tokens (``GROUP_TOKENS`` set to
    64 on both sides: 4 groups, 2 a rank) each rank dispatches its own
    groups; with the reference's 8192 (one group, which no rank holds
    whole) the ranks share its routing (``models/moe.py: _moe_rows``).
    The aux loss's per-expert means are averaged over the ranks, and the
    aux metric is the single device's in both."""
    for name in ("groups-split", "one-group"):
        assert_moe_split(*moe_split[name])


def test_moe_split_in_two_microbatches_matches_single_device(moe_split):
    """The same in 2 microbatches of 4 x 32: a rank holds 2 rows of each,
    and each microbatch's one group shares its routing over data."""
    assert_moe_split(*moe_split["one-group-2-micro"])


def test_loss_mask_with_an_empty_share_matches_single_device(moe_split):
    """A ``loss_mask`` that holds no token of data rank 1's rows: the ce is
    the whole batch's masked mean (the count summed over the ranks, rank 1
    adding no nll), ``tokens`` one device's count, the step one
    device's."""
    assert_moe_split(*moe_split["one-group-empty-share"])


LAUNCH = """
import dataclasses, json, os, torch
torch.set_num_threads(1)
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as launcher
args = launcher.parse_args({argv!r})
cfg = dataclasses.replace(get_smoke_config(args.arch), **{dtypes!r})
res = launcher.train(cfg, args)
json.dump(res["history"], open({out!r} + f"/history{{os.environ['RANK']}}.json", "w"))
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# granite (MoE with one dispatch group a microbatch, its routing shared
# over data) and qwen, their batches split over data, both in f32: on the
# (2, 2) mesh the step is tensor-parallel over model, and a
# tensor-parallel product sums the ranks' f32 partials in another order
# than one device. bf16 carries that rounding: with granite as
# ``--smoke`` gives it (bf16), one element of the unembedding's input grad
# one ulp off at step 2 put the loss 4.8e-4 off at step 3, as each rank's
# grads of half the tokens in a data split put qwen's 2.9e-4 off (Adam's
# first steps move a param whose grad changes sign 2·lr apart)
LAUNCH_CASES = [("granite-moe-1b-a400m", F32), ("qwen2.5-32b", F32)]


@pytest.mark.parametrize("arch,dtypes", LAUNCH_CASES, ids=["granite", "qwen-f32"])
def test_launcher_on_four_ranks_matches_one_process(tmp_path, arch, dtypes):
    """``launch/train.py``'s loop with ``--model-axis 2 --device cpu`` on 4
    ranks (a 2 x 2 mesh, tensor-parallel over model; ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` in the
    environment, gloo): 4 steps of 4 x 32 in 2 microbatches give the
    single-process run's loss history within 1e-4 on every rank, and the
    checkpoints rank 0 writes at steps 2 and 4 hold the single-process
    run's params within the limits of the 2 x 4 test."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train as launcher
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "4",
            "--seq", "32", "--lr", "3e-3", "--steps", "4", "--microbatches", "2",
            "--ckpt-every", "2"]
    cfg = dataclasses.replace(get_smoke_config(arch), **dtypes)
    one = launcher.train(cfg, launcher.parse_args(
        argv + ["--ckpt-dir", str(tmp_path / "one")]))
    body = LAUNCH.format(argv=argv + ["--model-axis", "2", "--ckpt-dir",
                                      str(tmp_path / "four")], out=str(tmp_path),
                         dtypes=dtypes)
    run_ranks(4, body, tmp_path, join=False,
              env={"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())})
    for r in range(4):
        hist = json.loads((tmp_path / f"history{r}.json").read_text())
        np.testing.assert_allclose(hist, one["history"], rtol=0, atol=1e-4)
    mgr4 = CheckpointManager(str(tmp_path / "four"))
    assert mgr4.latest_step() == 4
    assert sorted(os.listdir(tmp_path / "four")) == ["LATEST", "step_000000002",
                                                    "step_000000004"]
    with np.load(tmp_path / "one" / "step_000000004" / "arrays.npz") as a, \
            np.load(tmp_path / "four" / "step_000000004" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_allclose(b[k], a[k], atol=2e-4, rtol=2e-3)


# ------------------------------------------- the bf16 TP step's yardstick
# The launcher's 4-rank test above runs in f32: in bf16 a tensor-parallel
# product rounds its f32 partial sums apart from one device's and Adam
# carries it. So a bf16 TP run is held as chip_smoke's phase 5c holds it
# on the card: over YARD_STEPS steps each run's gap to the same steps on an
# f32 copy of the weights (the worst step's loss and grad norm as shares of
# the f32 run's, and the masters' update |Δrun − Δf32| / |Δf32|), the TP
# run's within YARD_FACTOR times the plain bf16 run's own gap. A planted
# fault (the column-parallel inputs' grads left unsummed over the ranks,
# on every rank, so no collective is skipped on one alone) must leave it.
YARD_STEPS = 3
YARD_FACTOR = 1.5
YARD_KW = dict(lr=3e-3, warmup_steps=0, total_steps=10)
YARD_ARCHS = ("granite-moe-1b-a400m", "rwkv6-1.6b")

YARD = """
import contextlib
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.distributed.sharding import (distribute, param_pspecs,
                                              to_shardings, zero_pspecs)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import LM, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.step import make_train_step
mesh = make_host_mesh(model_axis=4)                 # 1 data x 4 model
opt_cfg = AdamWConfig(**{kw!r})
real = tpm.col_input
res = {{}}
for arch in {archs!r}:
    model = LM(get_smoke_config(arch), ArcaneEngine("ref"), device="cpu")
    params = torch.load(OUT + f"/yard_params_{{arch}}.pt")
    batches = torch.load(OUT + f"/yard_batches_{{arch}}.pt")
    for fault in (False, True):
        p = distribute(params, to_shardings(param_pspecs(params, mesh), mesh))
        o = distribute(adamw_init(opt_cfg, params),
                       to_shardings(zero_pspecs(adamw_init(opt_cfg, params), mesh), mesh))
        step = make_train_step(model, opt_cfg, grad_shardings=to_shardings(
            zero_pspecs(params, mesh), mesh))
        if fault:
            tpm.col_input = lambda x, mg: x
        try:
            hist = []
            for b in batches:
                p, o, m = step(p, o, b)
                hist.append({{"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}})
        finally:
            tpm.col_input = real
        res[(arch, fault)] = {{"hist": hist,
                              "master": tree_map(lambda t: t.full_tensor(), o["master"])}}
if RANK == 0:
    torch.save(res, OUT + "/yard.pt")
"""


def yard_gaps(run: dict, f32: dict, master0) -> dict:
    """A run's gaps to the f32 copy's steps: the worst step's loss and grad
    norm as shares of the f32 run's, and the masters' update."""
    from repro_torch.models.transformer import tree_leaves
    num = den = 0.0
    for z, a, b in zip(tree_leaves(master0), tree_leaves(f32["master"]),
                       tree_leaves(run["master"])):
        da, db = a.float() - z.float(), b.float() - z.float()
        num += float(torch.sum(torch.square(db - da)))
        den += float(torch.sum(torch.square(da)))
    pairs = list(zip(run["hist"], f32["hist"]))
    return {"loss_rel": max(abs(x["loss"] - y["loss"]) / abs(y["loss"]) for x, y in pairs),
            "gnorm_rel": max(abs(x["grad_norm"] - y["grad_norm"]) / y["grad_norm"]
                             for x, y in pairs),
            "update_rel": (num / den) ** 0.5}


@pytest.fixture(scope="module")
def yardstick(tmp_path_factory):
    """For each YARD_ARCHS smoke config (bf16, seeded weights and batches
    of 8 x 32): YARD_STEPS plain bf16 steps and the same on an f32 copy of
    the weights in this process, and on 1 x 4 gloo ranks the TP steps with
    and without the planted fault (one launch)."""
    from repro_torch.models.transformer import tree_map
    tmp = tmp_path_factory.mktemp("yard")
    out = {}
    for arch in YARD_ARCHS:
        cfg = get_smoke_config(arch)
        model = LM(cfg, ArcaneEngine("ref"), device="cpu")
        params = model.init_params(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(2)
        batches = [{"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (8, 32)).astype(np.int32))} for _ in range(YARD_STEPS)]
        torch.save(params, tmp / f"yard_params_{arch}.pt")
        torch.save(batches, tmp / f"yard_batches_{arch}.pt")
        opt_cfg = AdamWConfig(**YARD_KW)
        runs = {}
        for name, m, p in (
                ("plain", model, params),
                ("f32", LM(dataclasses.replace(cfg, **F32), ArcaneEngine("ref"),
                           device="cpu"), tree_map(lambda t: t.float(), params))):
            step = make_train_step(m, opt_cfg)
            opt = adamw_init(opt_cfg, p)
            hist = []
            for b in batches:
                p, opt, met = step(p, opt, b)
                hist.append({"loss": float(met["loss"]),
                             "grad_norm": float(met["grad_norm"])})
            runs[name] = {"hist": hist, "master": opt["master"]}
        out[arch] = (runs, adamw_init(opt_cfg, params)["master"])
    run_ranks(4, YARD.format(kw=YARD_KW, archs=YARD_ARCHS), tmp)
    return out, torch.load(tmp / "yard.pt")


@pytest.mark.parametrize("arch", YARD_ARCHS)
def test_bf16_tp_step_drifts_as_the_plain_step(yardstick, arch):
    """In bf16 on a 1 x 4 mesh (granite smoke: one expert a rank; rwkv6
    smoke: head-parallel RWKV-6), YARD_STEPS TP steps drift from an f32
    copy's steps (loss, grad norm, update) within YARD_FACTOR times the
    plain bf16 steps' own drift, and the planted fault leaves that
    limit."""
    refs, ranks = yardstick
    runs, master0 = refs[arch]
    plain = yard_gaps(runs["plain"], runs["f32"], master0)
    tp = yard_gaps(ranks[(arch, False)], runs["f32"], master0)
    bad = yard_gaps(ranks[(arch, True)], runs["f32"], master0)
    assert all(tp[k] <= YARD_FACTOR * plain[k] for k in plain), (tp, plain)
    assert any(bad[k] > YARD_FACTOR * plain[k] for k in plain), (bad, plain)
