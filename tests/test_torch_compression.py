"""The port's int8 gradient compression (``repro_torch.optim.compression``)
against the reference's (``repro.optim.compression``): ``quantize`` and
``dequantize`` bit for bit on the same numpy inputs (the reference's
hypothesis cases and error-feedback walk of tests/test_train_optim.py), and
``compressed_psum`` on a 4-rank gloo group against the reference's under
``shard_map`` on 4 host devices, for the same per-rank inputs."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.optim.compression import dequantize as jax_dequantize
from repro.optim.compression import quantize as jax_quantize
from repro_torch.optim.compression import dequantize, quantize

ROOT = Path(__file__).resolve().parents[1]


def port_quantize(g, err=None):
    q, scale, res = quantize(torch.from_numpy(g),
                             None if err is None else torch.from_numpy(err))
    return q.numpy(), scale.numpy(), res.numpy(), dequantize(q, scale).numpy()


def ref_quantize(g, err=None):
    q, scale, res = jax_quantize(jnp.asarray(g),
                                 None if err is None else jnp.asarray(err))
    return (np.asarray(q), np.asarray(scale), np.asarray(res),
            np.asarray(jax_dequantize(q, scale)))


def assert_bits_equal(mine, ref):
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(b).view(np.uint8))


@given(st.integers(0, 2**32 - 1))
@settings(max_examples=20, deadline=None)
def test_quantize_equals_reference_bit_for_bit(seed):
    """tests/test_train_optim.py:97's cases: the payload, the scale, the
    residual and the dequantized tensor carry the reference's bits, and
    the reference's error bound holds."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(256) * rng.uniform(0.01, 10)).astype(np.float32)
    mine = port_quantize(g)
    assert_bits_equal(mine, ref_quantize(g))
    q, scale, residual, deq = mine
    assert float(np.max(np.abs(deq - g))) <= float(scale) / 2 + 1e-6
    np.testing.assert_allclose(g, deq + residual, rtol=1e-5, atol=1e-6)


def test_error_feedback_walk_equals_reference():
    """tests/test_train_optim.py:108's walk (200 steps, the residual carried
    into the next step): every step's payload, scale and residual equal the
    reference's bit for bit, and the accumulated updates track the true
    gradient sum as there."""
    rng = np.random.default_rng(0)
    true_sum = np.zeros(64)
    applied = np.zeros(64)
    err = err_ref = None
    for _ in range(200):
        g = rng.standard_normal(64) * 0.1
        true_sum += g
        g32 = g.astype(np.float32)
        mine = port_quantize(g32, err)
        ref = ref_quantize(g32, err_ref)
        assert_bits_equal(mine, ref)
        err, err_ref = mine[2], ref[2]
        applied += mine[3]
    assert np.max(np.abs(applied + err - true_sum)) < 1e-4
    assert np.max(np.abs(applied - true_sum)) < 0.05


def test_quantize_rounds_half_to_even_and_clips():
    """Ties round to even (``jnp.round``), and the largest element maps to
    ±127 exactly; a zero tensor quantizes to zeros (the 1e-30 floor)."""
    g = np.array([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.0], np.float32)
    mine = port_quantize(g)
    assert_bits_equal(mine, ref_quantize(g))
    assert mine[0].tolist() == [127, -127, 0, 2, 2, 0, -2, 3]
    z = np.zeros(5, np.float32)
    q, scale, res, _ = port_quantize(z)
    assert not q.any() and not res.any() and float(scale) == np.float32(1e-30)


# ------------------------------------------------------------ the all-reduce
N_RANKS = 4
SIZE = 1000

JAX_PSUM = """
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.optim.compression import compressed_psum
    paths = {paths!r}
    g = np.load(paths["g"]); e = np.load(paths["e"])
    mesh = jax.make_mesh(({n},), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))

    def body(g, e):
        mean, res = compressed_psum(g[0], "data", e[0])
        mean0, res0 = compressed_psum(g[0], "data")
        return mean[None], res[None], mean0[None], res0[None]

    fn = jax.shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                       out_specs=(P("data"),) * 4, check_vma=False)
    outs = fn(jnp.asarray(g), jnp.asarray(e))
    for name, o in zip(("out_mean", "out_res", "out_mean0", "out_res0"), outs):
        np.save(paths[name], np.asarray(o))
"""

PORT_PSUM = """
    import sys, numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank = int(sys.argv[1])
    dist.init_process_group("gloo", store=dist.FileStore({store!r}, {n}),
                            rank=rank, world_size={n})
    from repro_torch.optim.compression import compressed_psum
    g = torch.from_numpy(np.load({g!r})[rank])
    e = torch.from_numpy(np.load({e!r})[rank])
    mean, res = compressed_psum(g, None, e)
    mean0, res0 = compressed_psum(g)       # no error feedback
    np.save({out!r}.format(rank), np.stack([mean.numpy(), res.numpy(),
                                            mean0.numpy(), res0.numpy()]))
    dist.destroy_process_group()
"""


def run(cmds, env, timeout=240):
    procs = [subprocess.Popen(c, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]


def test_compressed_psum_equals_reference_shard_map(tmp_path):
    """Four ranks' f32 gradients (scales three decades apart, so the MAX
    all-reduce of the scale matters) with their error residuals: each
    rank's mean and new residual equal the reference's under ``shard_map``
    on 4 host devices within f32 1e-6 relative (read: equal bits), and the
    int32 payload sums recovered from the means are equal exactly; without
    error feedback too (``err=None``, against the reference's own
    quantize)."""
    rng = np.random.default_rng(0)
    g = (rng.standard_normal((N_RANKS, SIZE))
         * np.array([0.01, 1.0, 10.0, 0.1])[:, None]).astype(np.float32)
    e = (rng.standard_normal((N_RANKS, SIZE)) * 1e-3).astype(np.float32)
    paths = {k: str(tmp_path / f"{k}.npy")
             for k in ("g", "e", "out_mean", "out_res", "out_mean0", "out_res0")}
    np.save(paths["g"], g)
    np.save(paths["e"], e)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N_RANKS}")
    out = str(tmp_path / "rank{}.npy")
    port = textwrap.dedent(PORT_PSUM).format(
        store=str(tmp_path / "store"), n=N_RANKS, g=paths["g"], e=paths["e"],
        out=out)
    ref = textwrap.dedent(JAX_PSUM).format(n=N_RANKS, paths=paths)
    run([[sys.executable, "-c", ref]]
        + [[sys.executable, "-c", port, str(r)] for r in range(N_RANKS)], env)
    ref_mean, ref_res = np.load(paths["out_mean"]), np.load(paths["out_res"])
    mine = np.stack([np.load(out.format(r)) for r in range(N_RANKS)])
    np.testing.assert_allclose(mine[:, 0], ref_mean, rtol=1e-6, atol=0)
    np.testing.assert_allclose(mine[:, 1], ref_res, rtol=1e-6, atol=1e-30)
    # the payload sums: mean * n / scale, the shared scale the ranks' max
    gf = g + e
    scale = np.float32(np.max(np.abs(gf)) / np.float32(127.0) + np.float32(1e-30))
    sums = np.rint(mine[:, 0].astype(np.float64) * N_RANKS / scale)
    np.testing.assert_array_equal(
        sums, np.rint(ref_mean.astype(np.float64) * N_RANKS / scale))
    assert np.all(np.abs(sums) <= 127 * N_RANKS)
    assert all(np.array_equal(sums[0], s) for s in sums)
    # err=None
    np.testing.assert_allclose(mine[:, 2], np.load(paths["out_mean0"]),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(mine[:, 3], np.load(paths["out_res0"]),
                               rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("n", [1, 3])
def test_tree_compressed_psum_keeps_the_tree(tmp_path, n):
    """``tree_compressed_psum`` over a nested tree (dicts and a tuple of
    stacks, the params' shape) on a gloo group of ``n`` ranks that hold the
    same gradients: the mean is each leaf's ``dequantize(quantize(g))``
    and the residuals are quantize's, leaf by leaf, in the tree's
    structure, written into the error tree it was given."""
    code = textwrap.dedent("""
        import sys, torch, torch.distributed as dist
        torch.set_num_threads(1)
        rank = int(sys.argv[1])
        dist.init_process_group("gloo", store=dist.FileStore({store!r}, {n}),
                                rank=rank, world_size={n})
        from repro_torch.optim.compression import (dequantize, quantize,
                                                   tree_compressed_psum)
        gen = torch.Generator().manual_seed(0)
        tree = {{"a": torch.randn(5, generator=gen),
                 "blocks": ({{"w": torch.randn(2, 3, generator=gen)}},)}}
        err = {{"a": torch.full((5,), 1e-3),
                "blocks": ({{"w": torch.zeros(2, 3)}},)}}
        before = {{"a": err["a"].clone(), "w": err["blocks"][0]["w"].clone()}}
        mean, new = tree_compressed_psum(tree, None, err)
        assert set(mean) == {{"a", "blocks"}} and isinstance(mean["blocks"], tuple)
        assert new["a"] is err["a"]          # the residuals written in place
        for g, e, m, r in ((tree["a"], before["a"], mean["a"], new["a"]),
                           (tree["blocks"][0]["w"], before["w"],
                            mean["blocks"][0]["w"], new["blocks"][0]["w"])):
            q, s, res = quantize(g, e)
            assert torch.equal(r, res), (r, res)
            assert torch.allclose(m, dequantize(q, s), rtol=1e-6, atol=0), (m, q, s)
        dist.destroy_process_group()
    """).format(store=str(tmp_path / "store"), n=n)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run([[sys.executable, "-c", code, str(r)] for r in range(n)], env)
