"""The port's optimizer, data stream, checkpoints and train launcher
against the reference (``repro.optim.adamw``, ``repro.data.pipeline``,
``repro.checkpoint.manager``) and against the invariants the reference's
own tests hold (tests/test_train_optim.py, tests/test_checkpoint_data.py)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.optim import adamw as jadamw
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.launch import train as launcher
from repro_torch.models.convert import tensor_from_numpy, tree_to_numpy
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm, lr_at)

ARCH = "granite-moe-1b-a400m"          # the launcher's default --arch



@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: these tests run many small ops, which
    the parallel suite's workers (several per core) slow by an order of
    magnitude when each op spreads over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ------------------------------------------------------------------ optim
def test_config_fields_equal_the_reference():
    assert dataclasses.asdict(AdamWConfig()) == dataclasses.asdict(
        jadamw.AdamWConfig())


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    assert float(lr_at(cfg, torch.tensor(0))) == 0.0
    assert abs(float(lr_at(cfg, torch.tensor(10))) - 1.0) < 1e-6
    assert abs(float(lr_at(cfg, torch.tensor(100))) - 0.1) < 1e-6
    assert 0.1 < float(lr_at(cfg, torch.tensor(55))) < 1.0


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 4), (20, 6)])
def test_lr_at_matches_reference(warmup, total):
    """Every step 0..total+2 in f32, within 2 ulps of the reference's (read:
    2 ulps at 3 of 103 steps; the cosine of XLA and of PyTorch, and the
    order of their f32 operations, round apart)."""
    kw = dict(lr=3e-4, warmup_steps=warmup, total_steps=total)
    steps = np.arange(total + 3, dtype=np.int32)
    mine = lr_at(AdamWConfig(**kw), torch.from_numpy(steps)).numpy()
    ref = np.asarray(jadamw.lr_at(jadamw.AdamWConfig(**kw), jnp.asarray(steps)))
    assert mine.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(mine, ref, rtol=2.0 ** -22, atol=0)


def test_adamw_matches_reference_math():
    """One update against a hand-computed Adam step."""
    cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                      clip_norm=1e9, warmup_steps=0, total_steps=1,
                      min_lr_ratio=1.0)
    params = {"w": torch.tensor([1.0, -2.0])}
    grads = {"w": torch.tensor([0.5, 0.25])}
    new_params, _, _ = adamw_update(cfg, grads, adamw_init(cfg, params), params)
    g = np.array([0.5, 0.25])
    upd = (0.1 * g / 0.1) / (np.sqrt(0.01 * g * g / 0.01) + 1e-8)
    np.testing.assert_allclose(new_params["w"].numpy(),
                               np.array([1.0, -2.0]) - 0.1 * upd, rtol=1e-5)


def test_grad_clipping():
    cfg = AdamWConfig(clip_norm=1.0, warmup_steps=0, total_steps=1,
                      min_lr_ratio=1.0)
    params = {"w": torch.zeros(3)}
    grads = {"w": torch.tensor([3.0, 4.0, 0.0])}   # norm 5
    _, _, metrics = adamw_update(cfg, grads, adamw_init(cfg, params), params)
    assert abs(float(metrics["grad_norm"]) - 5.0) < 1e-5


def test_global_norm_matches_reference(rng):
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": (rng.standard_normal(3).astype(np.float32),)}
    mine = global_norm(tree_map(torch.from_numpy, tree))
    np.testing.assert_allclose(float(mine), float(jadamw.global_norm(tree)),
                               rtol=1e-6)


def test_adamw_init_copies_the_params():
    """The master is a copy even for f32 params: the in-place update must
    not write the params through it."""
    params = {"w": torch.ones(4)}
    state = adamw_init(AdamWConfig(), params)
    assert state["master"]["w"].data_ptr() != params["w"].data_ptr()
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0


def test_adamw_update_matches_reference(rng):
    """Four updates of bf16 params with an f32 master, the middle two
    clipped (grads of norm about 20 against clip_norm 1): new params
    within one bf16 ulp of the reference's (bf16 rounding of a master one
    f32 ulp apart), master, m and v within 1e-6 relative, grad norm and
    lr within 1e-6."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    shapes = {"w": (16, 8), "blocks": ({"k": (3, 8)}, {"b": (5,)})}
    p0 = tree_map(lambda s: rng.standard_normal(s).astype(np.float32), shapes)
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), p0)
    params = tree_map(lambda x: torch.from_numpy(x).to(torch.bfloat16), p0)
    jstate = jadamw.adamw_init(jadamw.AdamWConfig(**cfg), jparams)
    state = adamw_init(AdamWConfig(**cfg), params)
    for i in range(4):
        scale = 10.0 if i in (1, 2) else 0.05
        g = tree_map(lambda s: (scale * rng.standard_normal(s)).astype(np.float32),
                     shapes)
        jg = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), g)
        grads = tree_map(lambda x: tensor_from_numpy(np.asarray(x), "cpu"), jg)
        jparams, jstate, jm = jadamw.adamw_update(jadamw.AdamWConfig(**cfg),
                                                  jg, jstate, jparams)
        params, state, m = adamw_update(AdamWConfig(**cfg), grads, state, params)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
        for key in ("master", "m", "v"):
            tree_map(lambda a, r: np.testing.assert_allclose(
                a, np.asarray(r), rtol=1e-6, atol=1e-12),
                tree_to_numpy(state[key]), jstate[key])
        tree_map(lambda a, r: np.testing.assert_allclose(
            a, np.asarray(r, np.float32), rtol=2.0 ** -8, atol=0),
            tree_to_numpy(params), jparams)
        assert tree_leaves(params)[0].dtype == torch.bfloat16
        assert int(state["step"]) == i + 1


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("count", [1, 2, 4])
def test_batch_at_equals_reference_bit_for_bit(count):
    kw = dict(vocab=1000, seq_len=32, global_batch=8, seed=3)
    for index in range(count):
        mine = SyntheticLM(DataConfig(**kw), process_index=index,
                           process_count=count)
        ref = JaxSyntheticLM(JaxDataConfig(**kw), process_index=index,
                             process_count=count)
        for step in (0, 1, 17, 1000):
            a, r = mine.batch_at(step)["tokens"], ref.batch_at(step)["tokens"]
            assert a.dtype == r.dtype == np.int32
            np.testing.assert_array_equal(a, r)


def test_data_determinism_and_resume():
    cfg = DataConfig(vocab=1000, seq_len=32, global_batch=4)
    a, b = SyntheticLM(cfg), SyntheticLM(cfg)
    np.testing.assert_array_equal(a.batch_at(17)["tokens"], b.batch_at(17)["tokens"])
    np.testing.assert_array_equal(next(a.iterate(start_step=17))["tokens"],
                                  b.batch_at(17)["tokens"])


def test_data_process_sharding_disjoint():
    cfg = DataConfig(vocab=1000, seq_len=16, global_batch=8)
    b0 = SyntheticLM(cfg, process_index=0, process_count=2).batch_at(3)["tokens"]
    b1 = SyntheticLM(cfg, process_index=1, process_count=2).batch_at(3)["tokens"]
    assert b0.shape == b1.shape == (4, 16)
    assert not np.array_equal(b0, b1)
    with pytest.raises(ValueError):
        SyntheticLM(DataConfig(vocab=10, seq_len=4, global_batch=3), process_count=2)


def test_data_has_learnable_structure():
    """Repetition structure → unigram entropy < log(vocab)."""
    toks = SyntheticLM(DataConfig(vocab=50, seq_len=256, global_batch=8)).batch_at(0)["tokens"]
    p = (np.bincount(toks.reshape(-1), minlength=50) + 1e-9)
    p = p / p.sum()
    assert -(p * np.log(p)).sum() < np.log(50) * 0.9


@pytest.mark.parametrize("device", [None, "cpu"])
def test_prefetcher_yields_the_stream_and_stops(device):
    """From ``start_step`` on, the stream's batches in order: numpy arrays,
    or tensors on the device asked for; ``close`` ends the worker."""
    src = SyntheticLM(DataConfig(vocab=100, seq_len=8, global_batch=2))
    pf = Prefetcher(src, start_step=5, device=device)
    for step in (5, 6, 7):
        tok = next(pf)["tokens"]
        if device is not None:
            assert isinstance(tok, torch.Tensor) and tok.device.type == device
            tok = tok.numpy()
        np.testing.assert_array_equal(tok, src.batch_at(step)["tokens"])
    pf.close()
    assert not pf._thread.is_alive()


# ------------------------------------------------------------ checkpoints
def sample_tree():
    return {"params": {"w": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4),
                       "b": torch.ones(4), "blocks": ({"k": torch.full((2,), 0.1)},)},
            "opt": {"m": torch.zeros((3, 4)),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def trees_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = sample_tree()
    mgr.save(5, tree, extra={"loss": 1.5})
    assert mgr.latest_step() == 5
    restored, extra = mgr.restore(5, tree_map(lambda t: t.to("meta"), tree),
                                  device="cpu")
    trees_equal(tree, restored)
    assert extra["loss"] == 1.5


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = sample_tree()
    mgr.save(1, tree, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1
    trees_equal(tree, mgr.restore(1, tree)[0])


def test_async_save_snapshots_before_in_place_writes(tmp_path):
    """An async save holds the values of its step: the tensors written in
    place (``fill_``, ``add_``, as the optimizer's update writes master, m
    and v) between the save and ``wait`` leave the checkpoint as it was
    (the snapshot owns its memory; f32 CPU tensors alias their numpy view).
    The 4M-element leaf keeps the writer thread busy while the writes
    land."""
    mgr = CheckpointManager(str(tmp_path))
    tree = {"big": torch.zeros(1 << 22), "small": torch.arange(4.0),
            "bf16": torch.full((3,), 0.5, dtype=torch.bfloat16),
            "step": torch.tensor(3, dtype=torch.int32)}
    before = tree_map(lambda t: t.clone(), tree)
    mgr.save(1, tree, blocking=False)
    tree["big"].fill_(7.0)
    tree["small"].add_(1.0)
    tree["bf16"].fill_(2.0)
    tree["step"].add_(1)
    mgr.wait()
    trees_equal(before, mgr.restore(1, before)[0])


def test_async_save_error_raised_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    os.rmdir(tmp_path / "ck")
    (tmp_path / "ck").write_text("not a directory")
    mgr.save(1, sample_tree(), blocking=False)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.wait()
    mgr.wait()          # raised once


def test_atomicity_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    for s in (1, 2, 3):
        mgr.save(s, sample_tree())
    assert [d for d in os.listdir(tmp_path) if d.startswith("tmp_")] == []
    assert mgr.latest_step() == 3


def test_retention_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, sample_tree())
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_000000003", "step_000000004"]


def test_restore_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros((2, 2))})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, {"w": torch.zeros((3, 3))})


def test_checkpoints_restore_across_frameworks(tmp_path):
    """The same layout and keys: the reference's checkpoint restores into
    the port's tree and the port's into the reference's, equal values (bf16
    kept exactly, through its f32 storage)."""
    tree = sample_tree()
    jtree = jax.tree.map(lambda a: jnp.asarray(a).astype(
        jnp.bfloat16 if a.dtype == np.float32 and a.shape == (3, 4) and a.max() > 1
        else a.dtype), tree_to_numpy(tree))
    JaxCheckpointManager(str(tmp_path / "jax")).save(3, jtree, extra={"x": 1})
    mine, extra = CheckpointManager(str(tmp_path / "jax")).restore(3, tree)
    trees_equal(tree, mine)
    assert extra == {"x": 1}
    assert sorted(os.listdir(tmp_path / "jax")) == ["LATEST", "step_000000003"]

    CheckpointManager(str(tmp_path / "torch")).save(4, tree, extra={"y": 2})
    jmgr = JaxCheckpointManager(str(tmp_path / "torch"))
    assert jmgr.latest_step() == 4
    ref, extra = jmgr.restore(4, jax.eval_shape(lambda: jtree))
    assert extra == {"y": 2}
    for a, r in zip(jax.tree.leaves(ref), jax.tree.leaves(jtree)):
        assert a.dtype == r.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(r, np.float32))


# --------------------------------------------------------------- launcher
def spy_on_steps(monkeypatch, stop_after=None):
    """Wraps the train step of the launcher's next run: records each step's
    batch tokens and the params it returns, and raises SIGTERM (the
    preemption path) once ``stop_after`` steps of that run are done."""
    import signal
    from repro_torch.train.step import make_train_step as real
    seen = {"tokens": [], "params": None}

    def make(*a, **kw):
        step = real(*a, **kw)

        def spied(params, opt_state, batch):
            out = step(params, opt_state, batch)
            seen["tokens"].append(batch["tokens"].numpy().copy())
            seen["params"] = out[0]
            if len(seen["tokens"]) == stop_after:
                signal.raise_signal(signal.SIGTERM)
            return out
        return spied

    monkeypatch.setattr(launcher, "make_train_step", make)
    return seen


def test_launcher_crash_and_resume(tmp_path, monkeypatch):
    """granite-smoke on the CPU: four steps straight through, against two
    steps stopped by SIGTERM (a checkpoint at the step boundary), then a
    second run that resumes from LATEST: every step takes the stream's
    batch of its step (``batch_at``), the losses and the trained params are
    equal (the CPU is deterministic), and the loss falls."""
    common = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "32",
              "--lr", "3e-3", "--steps", "4", "--microbatches", "2"]
    seen_a = spy_on_steps(monkeypatch)
    straight = launcher.run(common + ["--ckpt-dir", str(tmp_path / "a")])
    seen_b = spy_on_steps(monkeypatch, stop_after=2)
    first = launcher.run(common + ["--ckpt-dir", str(tmp_path / "b")])
    assert len(first["history"]) == 2
    assert CheckpointManager(str(tmp_path / "b")).latest_step() == 2
    seen_c = spy_on_steps(monkeypatch)
    second = launcher.run(common + ["--ckpt-dir", str(tmp_path / "b")])
    resumed = first["steps"] + second["steps"]
    assert [s["step"] for s in resumed] == [0, 1, 2, 3]
    source = SyntheticLM(DataConfig(vocab=get_smoke_config(ARCH).vocab,
                                    seq_len=32, global_batch=4))
    for tokens in (seen_a["tokens"], seen_b["tokens"] + seen_c["tokens"]):
        assert len(tokens) == 4
        for step, t in enumerate(tokens):
            np.testing.assert_array_equal(t, source.batch_at(step)["tokens"])
    for a, b in zip(straight["steps"], resumed):
        assert a["loss"] == b["loss"] and a["lr"] == b["lr"]
    trees_equal(seen_a["params"], seen_c["params"])
    assert straight["history"][-1] < straight["history"][0]
    assert CheckpointManager(str(tmp_path / "b")).latest_step() == 4


def test_launcher_trains_a_config_of_the_callers(tmp_path):
    """``train(cfg, args)`` runs the loop on the caller's config (here
    granite-smoke cut to one layer), and a resume restores that config's
    state."""
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config(ARCH), n_layers=1)
    argv = ["--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path)]
    res = launcher.train(cfg, launcher.parse_args(argv + ["--steps", "2"]))
    assert len(res["history"]) == 2
    with np.load(tmp_path / "step_000000002" / "arrays.npz") as z:
        assert z["params/blocks/0/ln1/scale"].shape == (1, cfg.d_model)
    res = launcher.train(cfg, launcher.parse_args(argv + ["--steps", "3"]))
    assert [s["step"] for s in res["steps"]] == [2]


def test_launcher_preemption_checkpoints_and_stops(tmp_path, monkeypatch):
    """SIGTERM during a run: the step boundary saves and the run stops
    (``--steps 50``, the signal raised in the first step); the process's
    own handler is back afterwards."""
    import signal
    before = signal.getsignal(signal.SIGTERM)
    real = launcher.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def step_then_signal(*args):
            signal.raise_signal(signal.SIGTERM)
            return step(*args)
        return step_then_signal

    monkeypatch.setattr(launcher, "make_train_step", make)
    res = launcher.run(["--smoke", "--device", "cpu", "--steps", "50",
                        "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert len(res["history"]) == 1
    assert CheckpointManager(str(tmp_path)).latest_step() == 1
    assert signal.getsignal(signal.SIGTERM) is before


@pytest.mark.parametrize("flag", [["--model-axis", "2"], ["--production-mesh"]])
def test_launcher_refuses_meshes(flag, monkeypatch):
    """A mesh of more than one rank needs a multi-process launch (the
    launcher on 4 gloo ranks: tests/test_torch_distributed.py); in a single
    process the launcher refuses it."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="more than one rank"):
        launcher.run(["--smoke", "--device", "cpu", "--steps", "1"] + flag)


def test_launcher_refuses_kernel_engine():
    with pytest.raises(ValueError, match="no backward"):
        launcher.run(["--smoke", "--device", "cpu", "--steps", "1",
                      "--backend", "auto"])


# --------------------------------------------------------------- examples
def test_examples_run_on_the_cpu(tmp_path):
    """The three examples end to end with ``--device cpu``: quickstart's
    loss falls over its 40 steps and it samples 12 tokens; serve_lm serves
    its 8 requests; train_lm --quick crashes at half, resumes and its loss
    goes on falling (it asserts so itself)."""
    from repro_torch.examples import quickstart, serve_lm, train_lm
    assert len(quickstart.main(["--device", "cpu"])) == 12
    assert all(len(r.out_tokens) == 16 for r in serve_lm.main(["--device", "cpu"]))
    r1, r2 = train_lm.main(["--quick", "--device", "cpu",
                            "--ckpt-dir", str(tmp_path / "ck")])
    assert r2["history"][-1] < r1["history"][0]


def test_entry_points_default_to_the_card():
    """Without ``--device`` the launcher and the examples ask for the card,
    and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    from repro_torch.examples import quickstart, serve_lm, train_lm
    for run in (lambda: launcher.run(["--smoke", "--steps", "1"]),
                lambda: quickstart.main([]), lambda: serve_lm.main([]),
                lambda: train_lm.main(["--quick"])):
        with pytest.raises(RuntimeError, match="CUDA was asked for"):
            run()
