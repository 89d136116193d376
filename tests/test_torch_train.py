"""The port's training path against the reference on the same weights:
``LM.loss`` and its gradients for the ten archs (f32 smoke configs),
granite's MoE at capacity drops, remat, ``make_train_step`` (microbatches 1
and 2) against the JAX step, the refusal of an engine other than ref, and
the loss falling on the synthetic stream."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.engine import ArcaneEngine as JaxEngine
from repro.models.transformer import LM as JaxLM
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.convert import (opt_state_from_numpy, params_from_numpy,
                                        tree_to_numpy)
from repro_torch.models.transformer import LM, tree_leaves, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.step import (loss_and_grads, make_serve_steps,
                                    make_train_step, step_grads)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: these tests run many small ops, which
    the parallel suite's workers (several per core) slow by an order of
    magnitude when each op spreads over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32 = dict(param_dtype="float32", compute_dtype="float32")
RECURRENT = ("jamba-1.5-large-398b", "rwkv6-1.6b")   # S a multiple of 16
# Gradients: each leaf within GRAD_RTOL of its largest |reference| element
# (the ten archs read at most 1.1e-5: jamba's and rwkv6's scans sum in
# another order); the loss within LOSS_RTOL (read: 1e-7).
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-5


def pair(arch, **repl):
    """(port LM, port params, jax LM, jax params) on the same f32 weights;
    the port on the ref engine (a train step takes no other)."""
    jcfg = dataclasses.replace(jax_smoke(arch), **F32, **repl)
    cfg = dataclasses.replace(get_smoke_config(arch), **F32, **repl)
    jmodel = JaxLM(jcfg, JaxEngine(backend="ref"))
    jparams = jmodel.init_params(jax.random.key(1))
    model = LM(cfg, ArcaneEngine("ref"), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return model, params, jmodel, jparams


def make_batch(cfg, rng, b, s, mask=False):
    """(reference batch, port batch): tokens, the stub frontends'
    embeddings where the config takes them, and a 0/1 ``loss_mask``."""
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.vision_prefix:
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        batch["audio_embeds"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    if mask:
        batch["loss_mask"] = (rng.random((b, s)) < 0.6).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def assert_trees_close(mine, ref, rtol):
    """Every leaf of the port's tree within ``rtol`` of the largest
    |element| of the reference's leaf."""
    ref = jax.tree.map(np.asarray, ref)

    def one(a, r):
        assert a.shape == r.shape
        np.testing.assert_allclose(a, r, rtol=0,
                                   atol=rtol * max(np.abs(r).max(), 1e-30))

    tree_map(one, tree_to_numpy(mine), ref)


def check_loss_and_grads(arch, rng, mask=False, s=None, **repl):
    model, params, jmodel, jparams = pair(arch, **repl)
    s = s or (32 if arch in RECURRENT else 24)
    jbatch, batch = make_batch(model.cfg, rng, 2, s, mask)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, jbatch)
    loss, metrics, grads = loss_and_grads(model, params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    for k in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    assert_trees_close(grads, jgrads, GRAD_RTOL)
    return metrics


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_grads_match_reference(arch, rng):
    metrics = check_loss_and_grads(arch, rng)
    assert (float(metrics["aux"]) > 0) == (get_smoke_config(arch).moe is not None)


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "internvl2-1b", "whisper-large-v3"])
def test_loss_mask_matches_reference(arch, rng):
    """A 0/1 mask over the targets: the mean over the kept tokens."""
    metrics = check_loss_and_grads(arch, rng, mask=True)
    assert 0 < float(metrics["tokens"]) < 2 * 23


@pytest.mark.parametrize("cf", [8.0, 0.25])
def test_moe_capacity_loss_and_grads_match_reference(cf, rng):
    """granite-smoke with every slot kept (8) and with most dropped (0.25:
    the dispatch's index_put sends them to the spare row, whose gradient
    is sliced off)."""
    moe = dataclasses.replace(jax_smoke("granite-moe-1b-a400m").moe,
                              capacity_factor=cf)
    check_loss_and_grads("granite-moe-1b-a400m", rng, s=32, moe=moe)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "whisper-large-v3"])
def test_remat_changes_no_result(arch, rng):
    """Activation checkpointing recomputes each period in the backward
    pass: the loss and every gradient equal those without it, bit for bit
    on the CPU."""
    model, params, _, _ = pair(arch)
    _, batch = make_batch(model.cfg, rng, 2, 24)
    out = []
    for remat in (True, False):
        m = LM(model.cfg, model.engine, device="cpu", remat=remat)
        out.append(loss_and_grads(m, params, batch))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(tree_leaves(out[0][2]), tree_leaves(out[1][2])):
        assert torch.equal(a, b)


def test_remat_only_where_a_param_needs_grad(rng, monkeypatch):
    """whisper-smoke (encoder and decoder): a train step's loss checkpoints
    every encoder layer and decoder period; serving (``prefill``,
    ``decode_step``) and a forward whose params need no grad, with autograd
    on, checkpoint nothing."""
    import repro_torch.models.transformer as transformer
    calls = []
    real = transformer.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(transformer, "checkpoint", counted)
    model, params, _, _ = pair("whisper-large-v3")
    cfg = model.cfg
    _, batch = make_batch(cfg, rng, 2, 16)
    assert torch.is_grad_enabled()
    model.forward(params, batch)
    cache = model.init_cache(2, 24, enc_len=16)
    _, cache = model.prefill(params, batch, cache)
    model.decode_step(params, batch["tokens"][:, 0], torch.full((2,), 16), cache,
                      enc_len=16)
    assert calls == []
    loss_and_grads(model, params, batch)
    assert len(calls) == cfg.n_periods + cfg.n_enc_layers


def jax_step_grads(vg, jparams, jbatch, microbatches):
    """The reference train step's gradients from ``vg``, its jitted
    value_and_grad: of the batch, or the f32 sum over microbatches divided
    by their count (``train/step.py:50-60``)."""
    if microbatches == 1:
        return vg(jparams, jbatch)[1]
    acc = None
    for i in range(microbatches):
        mb = jax.tree.map(lambda x: x.reshape(microbatches, -1, *x.shape[1:])[i],
                          jbatch)
        g = jax.tree.map(lambda x: x.astype(jnp.float32), vg(jparams, mb)[1])
        acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
    return jax.tree.map(lambda x: x / microbatches, acc)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches, rng):
    """Three steps of granite-smoke (f32), each from the reference's state
    carried over (``params_from_numpy``, ``opt_state_from_numpy``): the
    step's grads within GRAD_RTOL, its loss, grad norm and lr within 1e-5,
    the new m, v and master and params within the atol below. Adam moves
    each element by about lr (the first step by exactly ±lr, the sign of its
    grad), so an element whose grad is near zero and differs in sign
    between the two runs lands 2·lr apart: the params, the master and m
    are held to 2·lr (plus 1e-6); v, the mean of g², to 2·GRAD_RTOL of
    its largest element."""
    model, params, jmodel, jparams = pair("granite-moe-1b-a400m")
    cfg = model.cfg
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=3)
    jstep = jax.jit(jax_make_train_step(jmodel, JaxAdamWConfig(**kw),
                                        microbatches=microbatches))
    step = make_train_step(model, AdamWConfig(**kw), microbatches=microbatches)
    vg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))
    jopt = jax_adamw_init(JaxAdamWConfig(**kw), jparams)
    lr_atol = 2 * kw["lr"] + 1e-6
    for i in range(3):
        jbatch, batch = make_batch(cfg, rng, 4, 16)
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
        opt = opt_state_from_numpy(jax.tree.map(np.asarray, jopt), cfg, "cpu")
        assert_trees_close(step_grads(model, params, batch, microbatches)[2],
                           jax_step_grads(vg, jparams, jbatch, microbatches),
                           GRAD_RTOL)
        jparams, jopt, jm = jstep(jparams, jopt, jbatch)
        params, opt, m = step(params, opt, batch)
        assert sorted(m) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
        assert int(opt["step"]) == int(jopt["step"]) == i + 1
        for mine, ref, atol in ((params, jparams, lr_atol),
                                (opt["master"], jopt["master"], lr_atol),
                                (opt["m"], jopt["m"], lr_atol)):
            tree_map(lambda a, r: np.testing.assert_allclose(
                a, np.asarray(r), rtol=0, atol=atol), tree_to_numpy(mine), ref)
        assert_trees_close(opt["v"], jopt["v"], 2 * GRAD_RTOL)


def test_grad_accumulation_equivalence(rng):
    """microbatches=4 matches microbatches=1 on the same global batch (the
    mirror of tests/test_train_optim.py's, atol 1e-5)."""
    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), **F32)
    model = LM(cfg, ArcaneEngine("ref"), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    opt_cfg = AdamWConfig(total_steps=10, warmup_steps=0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (8, 16)))}
    out = []
    for mb in (1, 4):
        p = tree_map(torch.clone, params)
        out.append(make_train_step(model, opt_cfg, microbatches=mb)(
            p, adamw_init(opt_cfg, p), batch)[0])
    for a, b in zip(tree_leaves(out[0]), tree_leaves(out[1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


@pytest.mark.parametrize("backend", ["auto", "cuda"])
def test_train_step_refuses_kernel_engines(backend):
    """The kernels have no backward: a train step takes the ref engine
    only, and says why."""
    model = LM(get_smoke_config("qwen2.5-32b"), ArcaneEngine(backend),
               device="cpu")
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(model, AdamWConfig())


def test_train_step_refuses_grad_shardings():
    """``grad_shardings`` lays out the grads of DTensor params (the sharded
    step, tests/test_torch_distributed.py); on plain params the step
    refuses it."""
    model = LM(get_smoke_config("qwen2.5-32b"), ArcaneEngine("ref"), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    step = make_train_step(model, AdamWConfig(), grad_shardings={})
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32)}
    with pytest.raises(ValueError, match="DTensor params"):
        step(params, adamw_init(AdamWConfig(), params), batch)


def test_microbatches_must_split_the_batch():
    model = LM(get_smoke_config("qwen2.5-32b"), ArcaneEngine("ref"), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((3, 8), dtype=torch.int32)}
    with pytest.raises(ValueError, match="microbatches"):
        step_grads(model, params, batch, 2)


def test_loss_decreases_tiny_task():
    """About 50 steps on the structured synthetic stream must cut the loss
    (the mirror of tests/test_train_optim.py's, bf16 qwen2.5-smoke)."""
    cfg = get_smoke_config("qwen2.5-32b")
    model = LM(cfg, ArcaneEngine("ref"), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    opt_cfg = AdamWConfig(lr=3e-3, total_steps=50, warmup_steps=5)
    opt = adamw_init(opt_cfg, params)
    step = make_train_step(model, opt_cfg)
    src = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8))
    losses = []
    for i in range(50):
        batch = {k: torch.from_numpy(v) for k, v in src.batch_at(i).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::10]


def test_serve_steps_are_the_models_prefill_and_decode():
    model = LM(get_smoke_config("qwen2.5-32b"), ArcaneEngine("ref"), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    prefill, decode = make_serve_steps(model)
    tokens = torch.arange(12).reshape(2, 6)
    pos = torch.full((2,), 6, dtype=torch.int32)
    out = []
    for pf, dec in ((prefill, decode), (model.prefill, model.decode_step)):
        lg, cache = pf(params, {"tokens": tokens}, model.init_cache(2, 16))
        out += [lg, dec(params, tokens[:, -1], pos, cache)[0]]
    assert torch.equal(out[0], out[2]) and torch.equal(out[1], out[3])


def test_embedding_grad_sums_repeats_in_bf16_as_the_reference():
    """A bf16 table's gradient sums each token's positions in bf16, one
    after another, in the port (``table[tokens]``'s index backward) as in
    the reference (``jnp.take``'s scatter-add): bit for bit on the CPU.
    Those sums stall as they grow: a token at 555 of 755 positions (the
    synthetic stream's commonest token holds 555 of a 4,096-token batch)
    reads 0.93 of the f64 sum along it, the other tokens (a few positions
    each) within 1e-3 of it. The step check of ``chip_smoke.py`` holds
    such repeated rows apart for this reason."""
    from repro.models.layers import embed as jax_embed
    from repro_torch.models.layers import embed
    rng = np.random.default_rng(0)
    vocab, d, n = 64, 256, 555
    tokens = np.concatenate([np.zeros(n, np.int32),
                             rng.integers(1, vocab, 200).astype(np.int32)])
    rng.shuffle(tokens)
    # upstream grads sharing a direction, as a token's positions' do
    up = jnp.asarray(1.0 + 0.5 * rng.standard_normal((len(tokens), d)), jnp.bfloat16)
    table = jnp.asarray(rng.standard_normal((vocab, d)), jnp.bfloat16)
    _, vjp = jax.vjp(lambda t: jax_embed({"table": t}, jnp.asarray(tokens)), table)
    ref = np.asarray(vjp(up)[0].astype(jnp.float32), np.float64)
    t = torch.tensor(np.asarray(table.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_()
    (g,) = torch.autograd.grad(embed({"table": t}, torch.from_numpy(tokens)), [t],
                               torch.tensor(np.asarray(up.astype(jnp.float32)))
                               .to(torch.bfloat16))
    mine = g.double().numpy()
    np.testing.assert_array_equal(mine, ref)
    exact = np.zeros((vocab, d))
    np.add.at(exact, tokens, np.asarray(up.astype(jnp.float32), np.float64))

    def gain(rows):
        return (mine[rows] * exact[rows]).sum() / (exact[rows] ** 2).sum()

    assert gain([0]) < 0.95
    assert abs(gain(slice(1, None)) - 1) < 1e-3
