"""The recurrent mixers of the port (models/mamba.py, models/rwkv6.py) and
their block wiring against the JAX modules on the same weights and inputs:
f32 smoke widths (jamba-smoke's Mamba, rwkv6-smoke), the weights carried
across as numpy leaves, the inputs drawn from a numpy generator. Also the
reference's prompt-length contract (``ValueError`` here, where the
reference asserts), and the in-place writes of the states into a slot of a
batched cache."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.engine import ArcaneEngine as JaxEngine
from repro.models import blocks as jax_blocks
from repro.models import mamba as jax_mamba
from repro.models import rwkv6 as jax_rwkv
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.models import blocks, mamba, rwkv6
from repro_torch.models.convert import (cache_from_numpy, params_from_numpy,
                                        tensor_from_numpy)
from repro_torch.models.transformer import LM, tree_map
from repro_torch.serving.engine import ServeSession

F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = dict(atol=1e-4, rtol=1e-4)       # as tests/test_ssm_moe.py
# bf16 activations: the bf16 tolerance of tests/test_torch_kernels.py's
# flash attention (each engine rounds the same products in its own order)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
JENG = JaxEngine(backend="ref")
ENG = ArcaneEngine("auto")


def configs(arch, dtype=F32, **repl):
    """(port config, JAX config) of the arch's smoke config."""
    return (dataclasses.replace(get_smoke_config(arch), **dtype, **repl),
            dataclasses.replace(jax_smoke(arch), **dtype, **repl))


def with_chunk(cfg, chunk):
    sub = "mamba" if cfg.mamba is not None else "rwkv"
    return dataclasses.replace(cfg, **{sub: dataclasses.replace(
        getattr(cfg, sub), chunk=chunk)})


def to_torch(tree):
    return tree_map(lambda x: tensor_from_numpy(x, "cpu"),
                    jax.tree.map(np.asarray, tree))


def t(x) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(x), "cpu")


def close(mine: torch.Tensor, ref, **tol) -> None:
    np.testing.assert_allclose(mine.float().numpy(),
                               np.asarray(ref, np.float32), **(tol or TOL))


def mamba_pair(key=0, dtype=F32):
    cfg, jcfg = configs("jamba-1.5-large-398b", dtype)
    jp = jax_mamba.mamba_init(jax.random.key(key), jcfg)
    return cfg, jcfg, jp, to_torch(jp)


def rwkv_pair(key=0, dtype=F32):
    cfg, jcfg = configs("rwkv6-1.6b", dtype)
    jp = jax_rwkv.rwkv_init(jax.random.key(key), jcfg)
    return cfg, jcfg, jp, to_torch(jp)


def inputs(rng, shape, dtype=jnp.float32):
    x = jnp.asarray(rng.standard_normal(shape), jnp.float32).astype(dtype)
    return x, t(x)


# ------------------------------------------------------------------ Mamba
@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_mamba_forward_matches_reference(chunk, rng):
    """Output and final state at every chunk of tests/test_ssm_moe.py."""
    cfg, jcfg, jp, p = mamba_pair()
    cfg, jcfg = with_chunk(cfg, chunk), with_chunk(jcfg, chunk)
    jx, x = inputs(rng, (2, 32, cfg.d_model))
    ref_y, ref_h = jax_mamba.mamba_forward(JENG, jp, jcfg, jx)
    y, h = mamba.mamba_forward(ENG, p, cfg, x)
    assert y.shape == x.shape and h.shape == (2, 2 * cfg.d_model, 4)
    close(y, ref_y)
    close(h, ref_h)


def test_mamba_scan_matches_naive_recurrence(rng):
    """The port's log-depth chunk scan against h_t = a_t h_{t-1} + b_t, one
    token at a time, on the port's own terms."""
    cfg, _, _, p = mamba_pair(1)
    cfg = with_chunk(cfg, 8)
    _, x = inputs(rng, (1, 16, cfg.d_model))
    y, h_last = mamba.mamba_forward(ENG, p, cfg, x)
    xi, z = ENG.gemm(x, p["in_proj"]["w"]).chunk(2, dim=-1)
    xc = torch.nn.functional.silu(mamba._causal_conv(p, xi)[0])
    decay, contrib, cmat = mamba._selective_terms(ENG, p, cfg, xc)
    h = torch.zeros(decay.shape[2:])
    ys = []
    for i in range(16):
        h = decay[0, i] * h + contrib[0, i]
        ys.append(h @ cmat[0, i])
    pre = (torch.stack(ys) + p["D"] * xc[0]) * torch.nn.functional.silu(z[0])
    close(y[0], ENG.gemm(pre, p["out_proj"]["w"]).numpy(), atol=1e-3, rtol=1e-3)
    close(h_last[0], h.numpy())


def test_mamba_chunk_scan_matches_sequential_pairs(rng):
    """``_chunk_scan`` at odd lengths: every prefix composition."""
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 13, 3)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 13, 3)).astype(np.float32))
    a_acc, b_acc = mamba._chunk_scan(a, b)
    pa, pb = torch.ones_like(a[:, 0]), torch.zeros_like(b[:, 0])
    for i in range(13):
        pa, pb = pa * a[:, i], pb * a[:, i] + b[:, i]
        close(a_acc[:, i], pa.numpy(), atol=1e-6, rtol=1e-6)
        close(b_acc[:, i], pb.numpy(), atol=1e-6, rtol=1e-6)


def test_mamba_decode_from_reference_state(rng):
    """Three decode steps from the conv and SSM states of a JAX forward."""
    cfg, jcfg, jp, p = mamba_pair(2)
    jx, _ = inputs(rng, (2, 12, cfg.d_model))
    _, jh = jax_mamba.mamba_forward(JENG, jp, jcfg, jx)
    xz = jax_mamba.dense(JENG, jp["in_proj"], jx[:, -3:])
    jconv = jnp.split(xz, 2, axis=-1)[0].astype(jnp.float32)
    conv, h = t(jconv), t(jh)
    for _ in range(3):
        jtok, tok = inputs(rng, (2, cfg.d_model))
        ref, jconv, jh = jax_mamba.mamba_decode(JENG, jp, jcfg, jtok, jconv, jh)
        out, conv, h = mamba.mamba_decode(ENG, p, cfg, tok, conv, h)
        close(out, ref)
        close(conv, jconv)
        close(h, jh)


# ------------------------------------------------------------------- RWKV
@pytest.mark.parametrize("chunk", [4, 16, 32])
def test_rwkv_time_mix_matches_reference(chunk, rng):
    """y, the final state S and the last x at every chunk of
    tests/test_ssm_moe.py."""
    cfg, jcfg, jp, p = rwkv_pair()
    cfg, jcfg = with_chunk(cfg, chunk), with_chunk(jcfg, chunk)
    jx, x = inputs(rng, (2, 32, cfg.d_model))
    ry, rS, rx = jax_rwkv.rwkv_time_mix(JENG, jp, jcfg, jx)
    y, S, last = rwkv6.rwkv_time_mix(ENG, p, cfg, x)
    assert S.shape == (2, 4, 16, 16) and S.dtype == torch.float32
    close(y, ry)
    close(S, rS)
    close(last, rx)


def test_rwkv_time_mix_carries_state(rng):
    """A second segment from the first one's state and last x."""
    cfg, jcfg, jp, p = rwkv_pair(1)
    jx, x = inputs(rng, (2, 16, cfg.d_model))
    _, jS, jl = jax_rwkv.rwkv_time_mix(JENG, jp, jcfg, jx)
    jx2, x2 = inputs(rng, (2, 8, cfg.d_model))
    ry, rS, _ = jax_rwkv.rwkv_time_mix(JENG, jp, jcfg, jx2, jS, jl)
    y, S, _ = rwkv6.rwkv_time_mix(ENG, p, cfg, x2, t(jS), t(jl))
    close(y, ry)
    close(S, rS)


@pytest.mark.parametrize("carried", [False, True])
def test_rwkv_channel_mix_matches_reference(carried, rng):
    cfg, jcfg, jp, p = rwkv_pair(2)
    jx, x = inputs(rng, (2, 8, cfg.d_model))
    jl, last = inputs(rng, (2, cfg.d_model)) if carried else (None, None)
    ref, rx = jax_rwkv.rwkv_channel_mix(JENG, jp, jcfg, jx, jl)
    out, lx = rwkv6.rwkv_channel_mix(ENG, p, cfg, x, last)
    close(out, ref)
    close(lx, rx)


def test_rwkv_time_mix_decode_from_reference_state(rng):
    """Three decode steps from the state and last x of a JAX time mix."""
    cfg, jcfg, jp, p = rwkv_pair(3)
    jx, _ = inputs(rng, (2, 16, cfg.d_model))
    _, jS, jl = jax_rwkv.rwkv_time_mix(JENG, jp, jcfg, jx)
    S, last = t(jS), t(jl)
    for _ in range(3):
        jtok, tok = inputs(rng, (2, cfg.d_model))
        ref, jS, jl = jax_rwkv.rwkv_time_mix_decode(JENG, jp, jcfg, jtok, jS, jl)
        out, S, last = rwkv6.rwkv_time_mix_decode(ENG, p, cfg, tok, S, last)
        close(out, ref)
        close(S, jS)
        close(last, jl)


# ---------------------------------------------------------------- bf16
def test_mamba_bf16_matches_reference(rng):
    """bf16 weights and activations (the serving dtype): dt's softplus, D,
    A_log and dt_bias stay f32 on both sides."""
    cfg, jcfg, jp, p = mamba_pair(4, dtype={})
    assert p["in_proj"]["w"].dtype == torch.bfloat16
    assert p["A_log"].dtype == p["dt_bias"].dtype == torch.float32
    jx, x = inputs(rng, (2, 32, cfg.d_model), jnp.bfloat16)
    ref_y, ref_h = jax_mamba.mamba_forward(JENG, jp, jcfg, jx)
    y, h = mamba.mamba_forward(ENG, p, cfg, x)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    close(y, ref_y, **BF16_TOL)
    close(h, ref_h, **BF16_TOL)


def test_rwkv_bf16_matches_reference(rng):
    """bf16 weights and activations: the lerp in bf16, the decay LoRA's
    tanh in bf16 and its second product widened to f32."""
    cfg, jcfg, jp, p = rwkv_pair(4, dtype={})
    assert p["r"]["w"].dtype == torch.bfloat16
    jx, x = inputs(rng, (2, 32, cfg.d_model), jnp.bfloat16)
    ry, rS, rx = jax_rwkv.rwkv_time_mix(JENG, jp, jcfg, jx)
    y, S, last = rwkv6.rwkv_time_mix(ENG, p, cfg, x)
    assert y.dtype == last.dtype == torch.bfloat16 and S.dtype == torch.float32
    close(y, ry, **BF16_TOL)
    close(S, rS, **BF16_TOL)
    close(last, rx, atol=0, rtol=0)


# --------------------------------------------------------------- blocks
KINDS = {"mamba": ("jamba-1.5-large-398b", 0), "rwkv": ("rwkv6-1.6b", 0)}


def block_pair(kind, moe=False, key=5):
    arch, _ = KINDS[kind]
    cfg, jcfg = configs(arch)
    spec = [s for s in cfg.pattern if s.kind == kind and s.moe == moe][0]
    jspec = [s for s in jcfg.pattern if s.kind == kind and s.moe == moe][0]
    jp = jax_blocks.block_init(jax.random.key(key), jcfg, jspec)
    return cfg, jcfg, spec, jspec, jp, to_torch(jp)


@pytest.mark.parametrize("kind", ["mamba", "rwkv"])
def test_block_params_tree_matches_reference(kind):
    """The names the reference's params tree holds (rwkv: no ffn)."""
    cfg, _, spec, _, jp, _ = block_pair(kind)
    mine = blocks.block_init(torch.Generator().manual_seed(0), cfg, spec, "cpu")
    shapes = tree_map(lambda x: tuple(x.shape), mine)
    assert shapes == jax.tree.map(lambda x: tuple(x.shape), jp,
                                  is_leaf=lambda x: hasattr(x, "shape"))
    dtypes = tree_map(lambda x: str(x.dtype).split(".")[-1], mine)
    assert dtypes == jax.tree.map(lambda x: str(x.dtype), jp)


@pytest.mark.parametrize("kind", ["mamba", "rwkv"])
def test_block_cache_matches_reference(kind):
    cfg, jcfg, spec, jspec, _, _ = block_pair(kind)
    mine = blocks.init_block_cache(cfg, spec, 3, 32, torch.float32, "cpu")
    ref = jax_blocks.init_block_cache(jcfg, jspec, 3, 32, jnp.float32)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in mine.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in ref.items()}


@pytest.mark.parametrize("kind,moe", [("mamba", False), ("mamba", True),
                                      ("rwkv", False)])
def test_block_prefill_and_decode_match_reference(kind, moe, rng):
    """block_prefill's output and cache, then two block_decode steps, each
    against the JAX block on the same weights (MoE at capacity factor 8:
    no drops on either side)."""
    cfg, jcfg, spec, jspec, jp, p = block_pair(kind, moe)
    if moe:
        cfg, jcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=8.0)) for c in (cfg, jcfg))
    b, s = 2, 16
    jx, x = inputs(rng, (b, s, cfg.d_model))
    pos = np.arange(s)
    jcache = jax_blocks.init_block_cache(jcfg, jspec, b, 32, jnp.float32)
    ref, jcache = jax_blocks.block_prefill(JENG, jp, jcfg, jspec, jx,
                                           jnp.asarray(pos), jcache)
    cache = blocks.init_block_cache(cfg, spec, b, 32, torch.float32, "cpu")
    out, _ = blocks.block_prefill(ENG, p, cfg, spec, x, torch.from_numpy(pos),
                                  cache)
    close(out, ref)
    for k in cache:
        close(cache[k], jcache[k])
    for i in range(2):
        jtok, tok = inputs(rng, (b, cfg.d_model))
        posi = np.full((b,), s + i, np.int32)
        ref, jcache = jax_blocks.block_decode(JENG, jp, jcfg, jspec, jtok,
                                              jnp.asarray(posi), jcache)
        out, _ = blocks.block_decode(ENG, p, cfg, spec, tok,
                                     torch.from_numpy(posi), cache)
        close(out, ref)
        for k in cache:
            close(cache[k], jcache[k])


@pytest.mark.parametrize("kind", ["mamba", "rwkv"])
def test_block_states_written_into_slot_views(kind, rng):
    """Prefill and decode through views of one slot of a batched cache (as
    the serving engine admits a request): the slot's rows take the states
    of a batch-1 cache, the other slots stay as they were."""
    cfg, _, spec, _, _, p = block_pair(kind)
    _, x = inputs(rng, (1, 16, cfg.d_model))
    one = blocks.init_block_cache(cfg, spec, 1, 32, torch.float32, "cpu")
    blocks.block_prefill(ENG, p, cfg, spec, x, torch.arange(16), one)
    batched = blocks.init_block_cache(cfg, spec, 3, 32, torch.float32, "cpu")
    view = {k: v[1:2] for k, v in batched.items()}
    blocks.block_prefill(ENG, p, cfg, spec, x, torch.arange(16), view)
    for k, v in batched.items():
        assert float(v[1].abs().max()) > 0, k
        assert torch.equal(v[1:2], one[k]), k
        assert not v[0].any() and not v[2].any(), k
    _, tok = inputs(rng, (1, cfg.d_model))
    pos = torch.tensor([16], dtype=torch.int32)
    blocks.block_decode(ENG, p, cfg, spec, tok, pos, one)
    blocks.block_decode(ENG, p, cfg, spec, tok, pos, view)
    for k, v in batched.items():
        assert torch.equal(v[1:2], one[k]), k
        assert not v[0].any() and not v[2].any(), k


def test_serving_admission_writes_recurrent_states(rng):
    """ServeSession's prefill of a slot leaves that slot's recurrent states
    in the batched cache (nonzero, equal to a batch-1 prefill's)."""
    cfg, _ = configs("jamba-1.5-large-398b")
    model = LM(cfg, ENG, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    prompt = rng.integers(0, cfg.vocab, 16)
    sess = ServeSession(model, params, max_slots=3, max_len=32)
    sess.submit(prompt, max_new_tokens=2)
    sess._admit()
    one = model.init_cache(1, 32)
    model.prefill(params, {"tokens": torch.from_numpy(prompt[None])}, one)
    for j, spec in enumerate(cfg.pattern):
        for k, v in sess.cache[j].items():
            assert torch.equal(v[:, :1], one[j][k]), (spec.kind, k)
            if spec.kind == "mamba":
                assert float(v[:, 0].abs().max()) > 0, k
                assert not v[:, 1:].any(), k


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_decode_from_reference_prefill_cache(arch, rng):
    """The JAX LM's prefill cache carried across (``cache_from_numpy``): the
    port's decode steps from it give the JAX decode steps' logits and
    cache (MoE at capacity factor 8: no drops on either side)."""
    from repro.models.transformer import LM as JaxLM
    cfg, jcfg = configs(arch)
    if cfg.moe is not None:
        cfg, jcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=8.0)) for c in (cfg, jcfg))
    jmodel = JaxLM(jcfg, JENG)
    jparams = jmodel.init_params(jax.random.key(2))
    toks = rng.integers(0, cfg.vocab, (2, 19)).astype(np.int32)
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :16])},
                               jmodel.init_cache(2, 32))
    model = LM(cfg, ENG, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    cache = cache_from_numpy(jax.tree.map(np.asarray, jcache), cfg, "cpu")
    for i in range(16, 19):
        pos = np.full((2,), i, np.int32)
        ref, jcache = jmodel.decode_step(jparams, jnp.asarray(toks[:, i]),
                                         jnp.asarray(pos), jcache)
        out, _ = model.decode_step(params, torch.from_numpy(toks[:, i]),
                                   torch.from_numpy(pos), cache)
        close(out, ref, atol=1e-3, rtol=1e-3)
    for mine, theirs in zip(cache, jcache):
        for k in mine:
            close(mine[k], theirs[k], atol=1e-3, rtol=1e-3)


# ---------------------------------------------------- the length contract
@pytest.mark.parametrize("arch,s", [("rwkv6-1.6b", 17), ("rwkv6-1.6b", 40),
                                    ("jamba-1.5-large-398b", 24),
                                    ("jamba-1.5-large-398b", 2)])
def test_refused_prompt_lengths_raise(arch, s, rng):
    """What the reference refuses (an assert in its scan), and a Mamba
    prompt shorter than the conv state (of which the reference builds a
    short state), the port refuses with ValueError: in the LM's prefill
    and forward and at submission to the serving engine."""
    cfg, jcfg = configs(arch)
    jmodel = jax_lm(jcfg)
    jparams = jmodel.init_params(jax.random.key(0))
    toks = rng.integers(0, cfg.vocab, (1, s)).astype(np.int32)
    if s >= 3:
        with pytest.raises(AssertionError):
            jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                           jmodel.init_cache(1, 64))
    else:
        _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                   jmodel.init_cache(1, 64))
        assert jcache[0]["conv"].shape[2] == s < cfg.mamba.d_conv - 1
    model = LM(cfg, ENG, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        model.prefill(params, {"tokens": torch.from_numpy(toks)},
                      model.init_cache(1, 64))
    with pytest.raises(ValueError):
        ServeSession(model, params, max_slots=1, max_len=64).submit(toks[0])
    if s >= 3:
        with pytest.raises(ValueError):
            model.forward(params, {"tokens": torch.from_numpy(toks)})


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_accepted_prompt_lengths(arch):
    """Up to the chunk any length (Mamba: from its conv state's 3 tokens),
    past it the multiples of the chunk."""
    cfg, _ = configs(arch)
    ok = [n for n in range(1, 70) if _accepts(cfg, n)]
    least = 3 if cfg.mamba is not None else 1
    assert ok == list(range(least, 17)) + [32, 48, 64]


def _accepts(cfg, n) -> bool:
    try:
        blocks.check_prompt_length(cfg, n)
        return True
    except ValueError:
        return False


def jax_lm(jcfg):
    from repro.models.transformer import LM as JaxLM
    return JaxLM(jcfg, JENG)
