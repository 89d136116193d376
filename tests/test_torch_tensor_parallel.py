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
  ``loss_mask`` batch, minicpm3, jamba and rwkv6 smoke, whose mixers are
  gathered over ``model``, whisper smoke (the encoder, cross-attention and
  the classic MLP's biases) and internvl2 smoke (the vision prefix). All
  cases run in one launch of 8 ranks.
* A census of one rank's forward on a 1 × 4 mesh: the q, o, gate, up,
  down and unembed products and the expert and attention products at
  exactly 1/4 of one device's, no such leaf gathered over ``model``.
* The vocab-parallel cross-entropy and embedding against
  ``F.cross_entropy`` and a plain lookup, targets at the shard edges.
* A prefill and 8 decode steps on a 1 × 4 mesh over a cache sharded by
  heads (stablelm) and by sequence (gemma2) against one device and the
  JAX package's serve steps.
* The per-layer head-parallel/gathered choice, and the ``cuda`` engine's
  ``ValueError`` on a cache sharded by sequence.
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
from repro_torch.train.step import make_train_step
from test_torch_distributed import F32, assert_close, run_ranks


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(arch: str):
    """(port LM, port params, jax LM, jax params): the smoke config in f32
    on the reference's weights (``init_params(key(0))``)."""
    jcfg = dataclasses.replace(jax_smoke(arch), **F32)
    cfg = dataclasses.replace(get_smoke_config(arch), **F32)
    jmodel = JaxLM(jcfg, JaxEngine(backend="ref"))
    jparams = jmodel.init_params(jax.random.key(0))
    model = LM(cfg, ArcaneEngine("ref"), device="cpu")
    return model, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu"), jmodel, jparams


# ------------------------------------------------------- the train step
# case: (arch, loss_mask); jamba is held to the port's single-device step
# only (its jitted JAX step takes 19 s to compile here; tests/
# test_torch_train.py holds the port's jamba loss and grads to the JAX
# package's)
STEP_CASES = {"qwen": ("qwen2.5-32b", False), "gemma2": ("gemma2-9b", False),
              "granite": ("granite-moe-1b-a400m", False),
              "qwen-loss-mask": ("qwen2.5-32b", True),
              "minicpm3": ("minicpm3-4b", False),
              "jamba": ("jamba-1.5-large-398b", False),
              "rwkv6": ("rwkv6-1.6b", False),
              "whisper": ("whisper-large-v3", False),
              "internvl2": ("internvl2-1b", False)}
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
mesh = make_host_mesh(model_axis=4)                 # 2 data x 4 model
res = {{}}
for name, arch in {cases!r}.items():
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                              compute_dtype="float32")
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
if RANK == 0:
    torch.save(res, OUT + "/result.pt")
"""


@pytest.fixture(scope="module")
def tp_steps(tmp_path_factory):
    """Every STEP_CASES case: the TP step on 8 gloo ranks (one launch, run
    while this process steps the references), the port's single-device
    step and the JAX package's jitted step, each from the reference's
    weights on the same seeded batch of 8 x 32."""
    tmp = tmp_path_factory.mktemp("tp_steps")
    cases = {}
    for name, (arch, mask) in STEP_CASES.items():
        model, params, jmodel, jparams = pair(arch)
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
    errors = []
    ranks = threading.Thread(target=lambda: _catch(errors, run_ranks, 8, TP_STEP.format(
        cases={n: a for n, (a, _) in STEP_CASES.items()}, kw=STEP_KW), tmp))
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
    """One TP step on 2 x 4 gloo ranks: the loss within 1e-4 and every
    param within atol 2e-4, rtol 2e-3 of the JAX package's single-device
    step (but jamba's) and of the port's; the leaves gathered over
    ``model`` are those of the mixers computed whole (MLA, Mamba, RWKV-6),
    and nothing of qwen, gemma2 or granite."""
    refs, res = tp_steps
    mine = res[case]
    for params, loss in refs[case].values():
        assert abs(mine["metrics"]["loss"] - loss) < 1e-4
        assert_close(mine["params"], params, atol=2e-4, rtol=2e-3)
    gathered = {p.split("/")[2] for p in mine["gathered"]}
    arch = STEP_CASES[case][0]
    expect = {"minicpm3-4b": {"attn"}, "jamba-1.5-large-398b": {"mixer"},
              "rwkv6-1.6b": {"mixer"}}.get(arch, set())
    assert gathered == expect, mine["gathered"]
    assert all(c == "heads" for p, c in mine["choices"].items()
               if p.endswith("/attn") and not expect)


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
SERVE_CASES = {"heads": "stablelm-3b", "seq": "gemma2-9b"}
PROMPT, STEPS, MAX_LEN, SLOTS = 12, 8, 32, 2

TP_SERVE = """
import dataclasses
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed.sharding import (cache_pspecs, distribute,
                                              param_pspecs, to_shardings)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import LM, tree_map
from repro_torch.train.step import serve_on_mesh, tp_view
mesh = make_host_mesh(model_axis=4)                 # 1 data x 4 model
res = {{}}
for layout, arch in {cases!r}.items():
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                              compute_dtype="float32")
    model = LM(cfg, ArcaneEngine("ref"), device="cpu")
    params = torch.load(OUT + f"/serve_params_{{layout}}.pt")
    prompt = torch.load(OUT + f"/serve_prompt_{{layout}}.pt")
    cache = model.init_cache({slots}, {max_len})
    p = distribute(params, to_shardings(param_pspecs(params, mesh), mesh))
    c = distribute(cache, to_shardings(cache_pspecs(cache, mesh), mesh))
    k_pl = str(c[0]["k"].placements)
    plan = tp_view(model, p, mesh, c)[0].tp
    logits, c = serve_on_mesh(model, "prefill", p, c, {{"tokens": prompt}}, mesh)
    out = [logits]
    tok = torch.argmax(logits, -1).to(torch.int32)
    for i in range({steps}):
        pos = torch.full(({slots},), {prompt} + i, dtype=torch.int32)
        logits, c = serve_on_mesh(model, "decode", p, c,
                                  {{"tokens": tok, "position": pos}}, mesh)
        out.append(logits)
        tok = torch.argmax(logits, -1).to(torch.int32)
    res[layout] = {{"logits": torch.stack(out), "k_placements": k_pl,
                   "choices": dict(plan.choices),
                   "cache_k": c[0]["k"].full_tensor()}}
torch.save(res, OUT + f"/serve{{RANK}}.pt")
"""


def one_device_serve(model, params, prompt):
    """Prefill, then STEPS greedy decode steps on one device: the logits of
    each (STEPS + 1, SLOTS, V) and the final cache."""
    cache = model.init_cache(SLOTS, MAX_LEN)
    logits, cache = model.prefill(params, {"tokens": prompt}, cache)
    out = [logits]
    for i in range(STEPS):
        tok = torch.argmax(logits, -1).to(torch.int32)
        pos = torch.full((SLOTS,), PROMPT + i, dtype=torch.int32)
        logits, cache = model.decode_step(params, tok, pos, cache)
        out.append(logits)
    return torch.stack(out), cache


def jax_serve(jmodel, jparams, prompt, tokens):
    """The JAX package's prefill and decode steps fed the given greedy
    tokens: the logits of each."""
    jcache = jmodel.init_cache(SLOTS, MAX_LEN, dtype=jnp.float32)
    lg, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(prompt)},
                                         jcache)
    out = [np.asarray(lg)]
    dec = jax.jit(jmodel.decode_step)
    for i in range(STEPS):
        lg, jcache = dec(jparams, jnp.asarray(tokens[i]),
                         jnp.full((SLOTS,), PROMPT + i, jnp.int32), jcache)
        out.append(np.asarray(lg))
    return np.stack(out)


def test_tp_serve_matches_one_device(tmp_path):
    """A prefill of 2 x 12 tokens and 8 greedy decode steps on a 1 x 4 mesh
    through ``serve_on_mesh``: stablelm smoke (4 kv heads, the cache
    sharded by heads) and gemma2 smoke (2 kv heads, the cache sharded by
    sequence: slices of 8 of 32 positions, the decode steps crossing two
    slices and the local layers' window of 16). Every rank's greedy
    tokens equal one device's and the JAX package's, its f32 logits
    within 1e-5 of one device's and of the JAX package's, and the cache
    gathered from the ranks equals one device's cache."""
    refs = {}
    for layout, arch in SERVE_CASES.items():
        model, params, jmodel, jparams = pair(arch)
        prompt = torch.from_numpy(np.random.default_rng(5).integers(
            0, model.cfg.vocab, (SLOTS, PROMPT)).astype(np.int32))
        torch.save(params, tmp_path / f"serve_params_{layout}.pt")
        torch.save(prompt, tmp_path / f"serve_prompt_{layout}.pt")
        logits, cache = one_device_serve(model, params, prompt)
        toks = torch.argmax(logits, -1).to(torch.int32).numpy()
        refs[layout] = (logits, cache, jax_serve(jmodel, jparams, prompt.numpy(), toks))
    run_ranks(4, TP_SERVE.format(cases=SERVE_CASES, slots=SLOTS, max_len=MAX_LEN,
                                 steps=STEPS, prompt=PROMPT), tmp_path)
    for r in range(4):
        res = torch.load(tmp_path / f"serve{r}.pt")
        for layout, (logits, cache, jlogits) in refs.items():
            mine = res[layout]
            assert ("Shard(dim=2)" if layout == "heads" else "Shard(dim=3)") \
                in mine["k_placements"]
            assert set(mine["choices"].values()) == {"heads"}
            assert torch.equal(torch.argmax(mine["logits"], -1),
                               torch.argmax(logits, -1))
            assert np.array_equal(np.argmax(jlogits, -1),
                                  torch.argmax(logits, -1).numpy())
            torch.testing.assert_close(mine["logits"], logits, atol=1e-5, rtol=0)
            np.testing.assert_allclose(mine["logits"].numpy(), jlogits, atol=1e-5,
                                       rtol=0)
            torch.testing.assert_close(mine["cache_k"], cache[0]["k"], atol=1e-5,
                                       rtol=0)


def test_cuda_engine_refuses_a_sequence_sharded_cache():
    """``serve_on_mesh`` on ArcaneEngine("cuda") over gemma2 smoke's cache,
    sharded by sequence on a 1 x 4 mesh (a fake world of 4 in this
    process), raises ``ValueError`` before any step runs: the decode
    kernel returns no log-sum-exp to merge the ranks' slices."""
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.step import serve_on_mesh
    cfg = get_smoke_config("gemma2-9b")
    model = LM(cfg, ArcaneEngine("cuda"), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 32)
    with fake_world(4):
        mesh = make_host_mesh(model_axis=4)
        p = sh.distribute(params, sh.to_shardings(sh.param_pspecs(params, mesh), mesh))
        c = sh.distribute(cache, sh.to_shardings(sh.cache_pspecs(cache, mesh), mesh))
        assert "Shard(dim=3)" in str(c[0]["k"].placements)
        with pytest.raises(ValueError, match="sharded by sequence"):
            serve_on_mesh(model, "decode", p, c, {
                "tokens": torch.zeros(2, dtype=torch.int32),
                "position": torch.zeros(2, dtype=torch.int32)}, mesh)


# ------------------------------------------------------------ the plan
def spec_dims(pspecs) -> dict:
    """path → the dim a spec shards over ``model`` (``model_dims`` of a
    spec tree instead of DTensors)."""
    out = {}
    sh.map_with_path(lambda p, s: out.__setitem__(
        p, next((i for i, e in enumerate(s) if e == "model"), None)), pspecs)
    return out


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


# (arch, m) → each attention-bearing pattern position's choice (or the
# mixer computed whole), the k/v columns' source, and gathered leaf roots
PLAN_CASES = {
    ("gemma2-9b", 16): ("heads", "gather", set()),
    ("gemma2-9b", 4): ("heads", "local", set()),
    ("granite-moe-1b-a400m", 16): ("heads", "gather", set()),
    ("granite-moe-1b-a400m", 4): ("heads", "local", set()),
    ("qwen2.5-32b", 16): ("whole", None, {"attn"}),
    ("qwen2.5-32b", 4): ("heads", "local", set()),
    ("minicpm3-4b", 16): ("mla", None, {"attn"}),
    ("rwkv6-1.6b", 16): ("rwkv", None, {"mixer"}),
}


@pytest.mark.parametrize("arch,m", sorted(PLAN_CASES))
def test_plan_chooses_per_layer(arch, m):
    """``plan`` on the production widths' layouts (``param_pspecs`` on a
    (16 / m, m) mesh): each layer's attention head-parallel or whole (the
    reason named), where its k/v columns come from, and the leaves it
    gathers over ``model`` (a whole layer's sharded leaves, a gathered
    mixer's): qwen2.5-32b's 40 heads on 16 ranks and minicpm3's MLA and
    rwkv6's mixers gather; the rest is head-parallel."""
    cfg = get_config(arch)
    params = LM(cfg, device="cpu").param_shapes()
    dims = spec_dims(sh.param_pspecs(params, {"data": 16 // m, "model": m}))
    choice, kv, roots = PLAN_CASES[(arch, m)]
    for r in (0, m - 1):
        plan = tpm.plan(cfg, dims, tpm.ModelGroup(None, r, m))
        assert {p.split("/")[2] for p in plan.gathered} == roots
        for j, blk in enumerate(plan.blocks):
            if choice in ("mla", "rwkv"):
                assert plan.choices[f"blocks/{j}/{'attn' if choice == 'mla' else 'mixer'}"] \
                    .startswith("whole")
                continue
            assert blk.attn.heads == (choice == "heads")
            if kv is not None:
                assert blk.attn.kv == kv
            if choice == "whole":
                assert "GQA groups" in plan.choices[f"blocks/{j}/attn"]
                assert all(p in plan.gathered for p in dims
                           if p.startswith(f"blocks/{j}/attn/") and dims[p] is not None)
        assert plan.embed == plan.unembed == (cfg.vocab % m == 0)
        assert all(b.experts == (cfg.moe is not None and cfg.moe.n_experts % m == 0)
                   for b, s in zip(plan.blocks, cfg.pattern) if s.moe)
