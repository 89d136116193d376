"""The MoE and MLA modules of the port against the JAX package on the same
weights and inputs (f32 smoke widths of granite-moe-1b, llama4-scout and
minicpm3-4b), and the plain decode attention at MLA's absorbed shapes.

Router inputs are checked to hold no top-k ties: ``lax.top_k`` and
``torch.topk`` may break a tie differently.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.engine import ArcaneEngine as JaxEngine
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref
from repro.models import mla as jax_mla
from repro.models import moe as jax_moe
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.kernels.decode_attention.ref import (check_shape,
                                                      decode_attention_ref)
from repro_torch.models import mla, moe
from repro_torch.models.convert import tensor_from_numpy
from repro_torch.models.transformer import tree_map

F32 = dict(param_dtype="float32", compute_dtype="float32")
MOE_ARCHS = ("granite-moe-1b-a400m", "llama4-scout-17b-a16e")
TOL = dict(atol=1e-5, rtol=1e-4)


def configs(arch: str, capacity_factor=None):
    """(port config, JAX config) in f32, the MoE capacity factor replaced."""
    cfg = dataclasses.replace(get_smoke_config(arch), **F32)
    jcfg = dataclasses.replace(jax_smoke(arch), **F32)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
    return cfg, jcfg


def to_torch(tree):
    return tree_map(lambda x: tensor_from_numpy(x, "cpu"),
                    jax.tree.map(np.asarray, tree))


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def close(mine: torch.Tensor, ref, **tol) -> None:
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **(tol or TOL))


# ------------------------------------------------------------------- MoE
def router_gap(params, x: np.ndarray, k: int) -> float:
    """The least gap between a token's k-th and (k+1)-th router probability
    (inf for top-k of all experts)."""
    logits = x.reshape(-1, x.shape[-1]) @ np.asarray(params["router"]["w"])
    p = np.sort(np.asarray(jax.nn.softmax(jnp.asarray(logits), -1)), -1)[:, ::-1]
    return float((p[:, k - 1] - p[:, k]).min()) if k < p.shape[1] else math.inf


@pytest.mark.parametrize("capacity_factor", [16.0, 0.25])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_matches_reference(arch, capacity_factor, rng):
    """Output and aux loss; at capacity factor 0.25 slots are dropped, at
    16 none is."""
    cfg, jcfg = configs(arch, capacity_factor)
    jparams = jax_moe.moe_init(jax.random.key(3), jcfg)
    x = rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32)
    assert router_gap(jparams, x, cfg.moe.top_k) > 1e-4
    ref, jaux = jax_moe.moe(JaxEngine(backend="ref"), jparams, jcfg,
                            jnp.asarray(x))
    out, aux = moe.moe(ArcaneEngine("auto"), to_torch(jparams), cfg, t(x))
    assert out.shape == x.shape and aux.dtype == torch.float32
    close(out, ref)
    close(aux, jaux)
    full, _ = moe.moe(ArcaneEngine("auto"), to_torch(jparams),
                      configs(arch, 16.0)[0], t(x))
    dropped = not torch.allclose(out, full, atol=1e-6)
    assert dropped == (capacity_factor < 1.0)


@pytest.mark.parametrize("cap", [1, 3, 40])
@pytest.mark.parametrize("k", [1, 2])
def test_group_dispatch_matches_reference(cap, k, rng):
    """Slot positions, drops (the spare row at E*cap) and the dispatched
    rows of three groups, against the reference's dispatch per group."""
    g, s_g, d, e = 3, 10, 5, 4
    xt = rng.standard_normal((g, s_g, d)).astype(np.float32)
    ids = rng.integers(0, e, (g, s_g, k))
    gates = rng.random((g, s_g, k)).astype(np.float32)
    disp, flat, keep, sg = moe._group_dispatch(t(xt), t(ids), t(gates), e, cap)
    for i in range(g):
        jd, jf, jk, jsg = jax_moe._group_dispatch(
            jnp.asarray(xt[i]), jnp.asarray(ids[i]), jnp.asarray(gates[i]), e, cap)
        np.testing.assert_array_equal(flat[i].numpy(), np.asarray(jf))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(disp[i].numpy(), np.asarray(jd))
        np.testing.assert_array_equal(sg[i].numpy(), np.asarray(jsg))
    y = rng.standard_normal((g, e * cap, d)).astype(np.float32)
    out = moe._group_combine(t(y), flat, keep, sg, k)
    for i in range(g):
        ref = jax_moe._group_combine(jnp.asarray(y[i]), jnp.asarray(flat[i].numpy()),
                                     jnp.asarray(keep[i].numpy()),
                                     jnp.asarray(sg[i].numpy()), k)
        close(out[i], ref, atol=1e-6, rtol=1e-6)


def test_moe_groups_shrink_to_a_divisor(monkeypatch, rng):
    """More tokens than a group holds: T = 36 with 8-token groups takes 4
    groups of 9 (the largest divisor of T at most T // 8), on both sides."""
    monkeypatch.setattr(moe, "GROUP_TOKENS", 8)
    monkeypatch.setattr(jax_moe, "GROUP_TOKENS", 8)
    cfg, jcfg = configs("granite-moe-1b-a400m", 1.25)
    jparams = jax_moe.moe_init(jax.random.key(4), jcfg)
    x = rng.standard_normal((4, 9, cfg.d_model)).astype(np.float32)
    assert router_gap(jparams, x, cfg.moe.top_k) > 1e-4
    ref, jaux = jax_moe.moe(JaxEngine(backend="ref"), jparams, jcfg,
                            jnp.asarray(x))
    out, aux = moe.moe(ArcaneEngine("auto"), to_torch(jparams), cfg, t(x))
    close(out, ref)
    close(aux, jaux)


# ------------------------------------------------------------------- MLA
def mla_pair():
    cfg, jcfg = configs("minicpm3-4b")
    jparams = jax_mla.mla_init(jax.random.key(5), jcfg)
    return cfg, jcfg, jparams, to_torch(jparams)


def test_mla_forward_matches_reference(rng):
    cfg, jcfg, jparams, params = mla_pair()
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    ref = jax_mla.mla_forward(JaxEngine(backend="ref"), jparams, jcfg,
                              jnp.asarray(x), jnp.arange(12))
    out = mla.mla_forward(ArcaneEngine("auto"), params, cfg, t(x),
                          torch.arange(12))
    close(out, ref)


def test_mla_prefill_and_decode_match_reference(rng):
    """Prefill of 12 tokens into a 16-row latent cache, then one absorbed
    decode step per row at ragged positions (12 and 5: the second row
    overwrites a prefilled row, as a ring of the reference would): outputs
    and every cache row."""
    cfg, jcfg, jparams, params = mla_pair()
    m = cfg.mla
    b, s, cap = 2, 12, 16
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    jeng, eng = JaxEngine(backend="ref"), ArcaneEngine("auto")
    jc = jnp.zeros((b, cap, m.kv_lora_rank))
    jkr = jnp.zeros((b, cap, m.qk_rope_head_dim))
    c = torch.zeros((b, cap, m.kv_lora_rank))
    kr = torch.zeros((b, cap, m.qk_rope_head_dim))
    ref, jc, jkr = jax_mla.mla_prefill(jeng, jparams, jcfg, jnp.asarray(x),
                                       jnp.arange(s), jc, jkr)
    out, c, kr = mla.mla_prefill(eng, params, cfg, t(x), torch.arange(s), c, kr)
    close(out, ref)
    close(c, jc)
    close(kr, jkr)
    xd = rng.standard_normal((b, cfg.d_model)).astype(np.float32)
    pos = np.array([12, 5], np.int32)
    ref, jc, jkr = jax_mla.mla_decode(jeng, jparams, jcfg, jnp.asarray(xd),
                                      jnp.asarray(pos), jc, jkr)
    out, c2, kr2 = mla.mla_decode(eng, params, cfg, t(xd), t(pos), c, kr)
    assert c2 is c and kr2 is kr                 # written in place
    close(out, ref)
    close(c, jc)
    close(kr, jkr)


# ------------------------------------------- decode attention at MLA's shape
@pytest.mark.parametrize("g,d", [(40, 288), (4, 24), (9, 288), (40, 8)])
def test_decode_attention_ref_at_absorbed_shapes(g, d, rng):
    """minicpm3-4b's absorbed decode (one latent KV head for 40 query heads,
    D = 256 + 32), minicpm3-smoke's (G = 4, D = 16 + 8), and the edges of
    the kernel's range."""
    b, s = 3, 50
    q = rng.standard_normal((b, 1, g, d)).astype(np.float32)
    k = rng.standard_normal((b, 1, s, d)).astype(np.float32)
    v = rng.standard_normal((b, 1, s, d)).astype(np.float32)
    ln = np.array([1, 50, 23], np.int32)
    scale = 1.0 / math.sqrt(96)
    ref = jax_decode_ref(*(jnp.asarray(a) for a in (q, k, v, ln)), scale=scale)
    out = decode_attention_ref(t(q), t(k), t(v), t(ln), scale=scale)
    close(out, ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("g,d,itemsize", [(41, 288, 2), (40, 296, 2),
                                          (4, 20, 2), (4, 6, 4), (0, 64, 2)])
def test_decode_attention_shapes_outside_the_kernel_raise(g, d, itemsize):
    """The plain version and the kernel take the same shapes: G up to 40,
    D up to 288 with rows of a multiple of 16 bytes."""
    with pytest.raises(ValueError, match="what the kernel takes"):
        check_shape(g, d, itemsize)
    dt = {2: torch.bfloat16, 4: torch.float32}[itemsize]
    if g:
        with pytest.raises(ValueError):
            decode_attention_ref(torch.zeros((1, 1, g, d), dtype=dt),
                                 torch.zeros((1, 1, 4, d), dtype=dt),
                                 torch.zeros((1, 1, 4, d), dtype=dt),
                                 torch.ones((1,), dtype=torch.int32))


def test_full_width_absorbed_decode_shape():
    """minicpm3-4b's absorbed decode is the kernel's largest shape."""
    m = get_config("minicpm3-4b")
    g, d = m.n_heads, m.mla.kv_lora_rank + m.mla.qk_rope_head_dim
    assert (g, d) == (40, 288)
    check_shape(g, d, 2)
    check_shape(g, d, 4)
