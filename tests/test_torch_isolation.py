"""The PyTorch port stands alone: it imports neither jax nor the reference
package (``torch.distributed`` included), and its own copies of configs,
encoding and the sharding rules equal the reference's."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core.encoding import ElemWidth as JaxElemWidth
from repro.core.encoding import encode_xmk as jax_encode_xmk
from repro.core.isa import fx_encode as jax_fx_encode
from repro.distributed import sharding as jax_sharding
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core.encoding import ElemWidth, encode_xmk, fx_encode
from repro_torch.distributed import sharding

SRC = Path(__file__).resolve().parents[1] / "src"


def test_port_imports_no_jax_and_no_reference():
    mods = sorted(
        ".".join(p.relative_to(SRC).with_suffix("").parts).replace(
            ".__init__", "")
        for p in (SRC / "repro_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            # what the multi-device layer imports where it is used
            "import torch.distributed.tensor, torch.distributed.device_mesh\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(mods) >= 25


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_equal_reference(arch):
    for mine, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_smoke_config(arch), jax_get_smoke_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.n_periods == ref.n_periods
        assert str(mine.pdtype).split(".")[-1] == str(ref.pdtype)
        assert mine.param_count() == ref.param_count()
        for sub in ("moe", "mla", "mamba", "rwkv"):   # typed, as the reference's
            assert type(getattr(mine, sub)).__name__ == \
                type(getattr(ref, sub)).__name__, sub


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_sub_quadratic_equals_reference(arch, smoke):
    """``ModelConfig.sub_quadratic``, the reference's formula copied: equal
    to the reference's for every arch, full width and smoke; true exactly
    for the archs with an RWKV-6 or Mamba layer."""
    mine = (get_smoke_config if smoke else get_config)(arch)
    ref = (jax_get_smoke_config if smoke else jax_get_config)(arch)
    assert mine.sub_quadratic == ref.sub_quadratic
    assert mine.sub_quadratic == (arch in ("jamba-1.5-large-398b", "rwkv6-1.6b"))


@pytest.mark.parametrize("func5", [0, 1, 2, 4, 5, 6, 30])
@pytest.mark.parametrize("width", ["W", "H", "B"])
def test_encode_xmk_words_match_reference(func5, width):
    for alpha, beta in ((1.0, 1.0), (0.5, -1.5), (-127, 127), (1.0, 0.0)):
        kw = dict(md=3, ms1=1, ms2=2, ms3=4, alpha=fx_encode(alpha),
                  beta=fx_encode(beta))
        assert fx_encode(alpha) == jax_fx_encode(alpha)
        mine = encode_xmk(func5, ElemWidth[width], **kw)
        ref = jax_encode_xmk(func5, JaxElemWidth[width], **kw)
        assert mine.word == ref.word
        assert mine.instr.mnemonic == ref.instr.mnemonic
        assert (mine.operands.rs1, mine.operands.rs2, mine.operands.rs3) == \
            (ref.operands.rs1, ref.operands.rs2, ref.operands.rs3)


def test_sharding_rules_equal_reference():
    """The port's copy of the sharding rules: ``_PARAM_RULES`` entry for
    entry (pattern and roles, in order) and ``MIN_CONSTRAIN_ELEMS``."""
    assert sharding._PARAM_RULES == jax_sharding._PARAM_RULES
    assert sharding.MIN_CONSTRAIN_ELEMS == jax_sharding.MIN_CONSTRAIN_ELEMS


def test_dse_and_dry_run_leave_jax_and_the_reference_out():
    """``repro_torch.dse`` and ``launch/{specs,dryrun}.py`` imported and
    used (a grid expanded, a point run on the CPU, the input specs of a
    cell, the fake world joined and left) without ``jax`` or ``repro``."""
    code = ("import sys\n"
            "import repro_torch.dse as dse\n"
            "from repro_torch.launch import dryrun, specs\n"
            "from repro_torch.configs import SHAPES, get_config\n"
            "from repro_torch.models.transformer import LM\n"
            "pts = dse.SweepGrid(scenarios=('cnn-small',)).expand()\n"
            "dse.run_point(pts[0].to_spec(), device='cpu')\n"
            "specs.input_specs('gemma2-9b', SHAPES['train_4k'],\n"
            "                  LM(get_config('gemma2-9b'), device='cpu'))\n"
            "with dryrun.fake_world(8): pass\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_shape_grid_equals_reference():
    """``ShapeConfig``, ``SHAPES``, ``shape_applicable`` and ``grid``: the
    reference's, field by field."""
    from repro.configs import SHAPES as JAX_SHAPES
    from repro.configs import ShapeConfig as JaxShapeConfig
    from repro.configs import grid as jax_grid
    from repro.configs import shape_applicable as jax_shape_applicable
    from repro_torch.configs import SHAPES, ShapeConfig, grid, shape_applicable
    assert [f.name for f in dataclasses.fields(ShapeConfig)] == \
        [f.name for f in dataclasses.fields(JaxShapeConfig)]
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(JAX_SHAPES[name])
    for arch in ARCHS:
        assert [dataclasses.asdict(s) for s in grid(arch)] == \
            [dataclasses.asdict(s) for s in jax_grid(arch)]
        for name in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[name]) == \
                jax_shape_applicable(jax_get_config(arch), JAX_SHAPES[name])


def test_tensor_parallel_leaves_jax_and_the_reference_out():
    """``distributed/tensor_parallel.py`` imported and used (the plan of
    gemma2-9b's production layout, and a tensor-parallel prefill of
    gemma2 smoke through ``serve_on_mesh`` in a fake world of 4) without
    ``jax`` or ``repro``."""
    code = ("import sys, torch\n"
            "from repro_torch.configs import get_config, get_smoke_config\n"
            "from repro_torch.distributed import sharding as sh\n"
            "from repro_torch.distributed import tensor_parallel as tpm\n"
            "from repro_torch.launch.dryrun import fake_world\n"
            "from repro_torch.launch.mesh import make_host_mesh\n"
            "from repro_torch.models.transformer import LM\n"
            "from repro_torch.train.step import serve_on_mesh\n"
            "cfg = get_config('gemma2-9b')\n"
            "specs = sh.param_pspecs(LM(cfg, device='cpu').param_shapes(),\n"
            "                        {'data': 16, 'model': 16})\n"
            "dims = {}\n"
            "sh.map_with_path(lambda p, s: dims.__setitem__(p, next(\n"
            "    (i for i, e in enumerate(s) if e == 'model'), None)), specs)\n"
            "assert tpm.plan(cfg, dims, tpm.ModelGroup(None, 3, 16)).blocks[0].attn.heads\n"
            "model = LM(get_smoke_config('gemma2-9b'), device='cpu')\n"
            "params = model.init_params(torch.Generator().manual_seed(0))\n"
            "cache = model.init_cache(2, 16)\n"
            "with fake_world(4):\n"
            "    mesh = make_host_mesh(model_axis=4)\n"
            "    p = sh.distribute(params, sh.to_shardings(sh.param_pspecs(params, mesh), mesh))\n"
            "    c = sh.distribute(cache, sh.to_shardings(sh.cache_pspecs(cache, mesh), mesh))\n"
            "    serve_on_mesh(model, 'prefill', p, c,\n"
            "                  {'tokens': torch.zeros((2, 8), dtype=torch.int32)}, mesh)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
