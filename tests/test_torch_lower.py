"""The port's lowerings and trace files against the reference's.

``repro_torch.lower`` builds the reference's programs: ``to_obj`` of every
lowering (CNN at several specs, the paper's 256 x 256 anchors among them, a
decode step and an MoE burst from the config registry) equals the
reference's dict; trace files written by either package load in the other
to the same program, and malformed ones fail with the reference's errors
(line numbers included). The lowered programs run on the port's serial and
pipelined runtimes to the reference's images, and the fused CNN layer's
output equals one conv layer over the whole image (the port's plain
``conv_layer_ref`` and the JAX reference's).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro.lower as RL
import repro.sim as RS
import repro_torch.core as T
import repro_torch.lower as TL
import repro_torch.sim as TS

RT = dict(n_vpus=4, vregs_per_vpu=64, vlen_bytes=1024)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def images(run) -> dict:
    return {k: as_np(v) for k, v in run.flushed_images().items()}


def both(fn):
    """``fn(mod, lower)`` for the reference (R, RL) and the port (T, TL)."""
    return fn(R, RL), fn(T, TL)


def cnn_specs(mod):
    W = mod.ElemWidth
    return [
        ("cnn32", {}, {}),
        ("cnn-deep", dict(h=24, w=24, width=W.B, depth=2, classes=8, batch=2),
         {}),
        ("cnn-strips", dict(h=32, w=32), dict(vregs_per_vpu=16, vlen_bytes=512)),
        ("cnn-h-k5", dict(h=40, w=28, k=5, width=W.H, batch=3, seed=4), {}),
        ("fig4-b3", dict(h=256, w=256, k=3, width=W.B),
         dict(vregs_per_vpu=32, vlen_bytes=1024)),
        ("fig4-b7", dict(h=256, w=256, k=7, width=W.B),
         dict(vregs_per_vpu=32, vlen_bytes=1024)),
        ("fig4-w5", dict(h=256, w=256, k=5, width=W.W), {}),
        ("deep-b-head", dict(h=30, w=34, k=3, width=W.B, depth=1, k2=2,
                             alpha=-0.5, classes=5), dict(vregs_per_vpu=8,
                                                          vlen_bytes=256)),
    ]


def corpus(mod, lower):
    """The lowered programs: CNN specs, a decode step, an MoE burst."""
    progs = [lower.lower_cnn(lower.CNNSpec(name=n, **kw), **lw)
             for n, kw, lw in cnn_specs(mod)]
    progs.append(lower.lower_decode_step(lower.DecodeSpec(
        name="dec", d=24, ff=64, kv=16, layers=2, vocab=32)))
    progs.append(lower.lower_moe_burst(lower.MoESpec(
        name="moe", d=24, ff=64, tokens=4, experts=3)))
    return progs


REF, PORT = both(corpus)
IDS = [p.name for p in REF]


@pytest.mark.parametrize("i", range(len(REF)), ids=IDS)
def test_lowering_to_obj_equals_the_reference(i):
    assert PORT[i].to_obj() == REF[i].to_obj()
    assert TL.dumps(PORT[i]) == RL.dumps(REF[i])


def test_fig4_anchor_lowers_to_nine_strips():
    """The 256 x 256 anchors on the builtin configs' register file (32
    vregs of 1 KiB) split into 9 column strips of one output."""
    for prog in PORT[4:6]:
        assert len(prog.ops) == 9
        assert {op.dst.buf for op in prog.ops} == {"l0_out0"}
        assert sum(op.dst.cols for op in prog.ops) == \
            prog.buffer("l0_out0").cols


@pytest.mark.parametrize("arch,kw", [
    ("stablelm-3b", dict(scale=64, kv=16)),
    ("stablelm-3b", dict(scale=32, kv=32, layers=2, seed=3)),
    ("gemma2-9b", dict(scale=64, kv=16)),
    ("gemma2-9b", dict(scale=128, kv=24, layers=3, vocab_scale=512)),
])
def test_decode_step_from_config_as_the_reference(arch, kw):
    rprog, rspec = RL.decode_step_from_config(arch, **kw)
    tprog, tspec = TL.decode_step_from_config(arch, **kw)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(rspec)
    assert tprog.to_obj() == rprog.to_obj()
    assert tspec.d >= 8 and tspec.d % 4 == 0 and tprog.name == f"decode-{arch}"


@pytest.mark.parametrize("kw", [dict(scale=32), dict(scale=64, tokens=2,
                                                     experts=3, seed=1)])
def test_moe_burst_from_config_as_the_reference(kw):
    from repro_torch.configs import get_config
    rprog, rspec = RL.moe_burst_from_config("granite-moe-1b-a400m", **kw)
    tprog, tspec = TL.moe_burst_from_config("granite-moe-1b-a400m", **kw)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(rspec)
    assert tprog.to_obj() == rprog.to_obj()
    assert tspec.experts == (kw.get("experts")
                             or get_config("granite-moe-1b-a400m").moe.top_k)
    assert tprog.n_ops == 3 * tspec.experts


def _errors(mod, lower):
    out = []
    for call in (lambda: lower.lower_cnn(lower.CNNSpec(h=3, w=3, k=3)),
                 lambda: lower.lower_cnn(lower.CNNSpec(h=8, w=8, depth=2)),
                 lambda: lower.lower_decode_step(lower.DecodeSpec(d=1)),
                 lambda: lower.lower_moe_burst(lower.MoESpec(experts=0)),
                 lambda: lower.moe_burst_from_config("stablelm-3b"),
                 lambda: lower.decode_step_from_config("no-such-arch")):
        try:
            call()
            out.append("ok")
        except Exception as e:
            out.append((type(e).__name__, str(e)))
    return out


def test_degenerate_shapes_rejected_as_the_reference():
    ref, mine = both(_errors)
    assert mine == ref
    assert mine[0][0] == "ProgramError" and mine[4][0] == "ProgramError"


# ------------------------------------------------------------ trace files
@pytest.mark.parametrize("i", range(len(REF)), ids=IDS)
def test_traces_load_across_the_packages(i, tmp_path):
    """A trace written by either package loads in the other to the same
    program (and in its own, as the reference's round trip)."""
    rprog, tprog = REF[i], PORT[i]
    assert TL.loads(TL.dumps(tprog)) == tprog
    assert TL.loads(RL.dumps(rprog)) == tprog
    assert RL.loads(TL.dumps(tprog)) == rprog
    rp = RL.save_program(rprog, str(tmp_path / "r.jsonl"))
    tp = TL.save_program(tprog, str(tmp_path / "t.jsonl"))
    assert TL.load_program(rp) == tprog and RL.load_program(tp) == rprog
    with open(rp) as f, open(tp) as g:
        assert f.read() == g.read()


def _malformed(lower):
    good = lower.dumps(lower.lower_cnn(lower.CNNSpec(name="m", h=16, w=16)))
    lines = good.splitlines()
    return [
        "", "not json\n", "\n".join(lines[1:]), lines[0] + "\n" + good,
        lines[0].replace("arcane-kernel-trace", "other-trace"),
        lines[0].replace('"version": 1', '"version": 99'),
        lines[0].replace('"width": "w"', '"width": "q"'),
        lines[0] + '\n{"record": "mystery"}\n',
        lines[0] + '\n[1, 2]\n',
        lines[0] + '\n\n\n{"record": "op", "kernel": "gemm"}\n',
        lines[0] + '\n{"record": "buffer", "name": "a", "rows": "x", '
                   '"cols": 2}\n',
        "\n".join(lines[:3] + ['{"record": "buffer", "name": "z"}']
                  + lines[3:]),
        good.replace('"kernel": "conv_layer"', '"kernel": "fft"'),
        good.replace('"rows": 48', '"rows": 47', 1),
        good + '{"record": "op", "kernel": "leakyrelu", "srcs": [], '
               '"dst": {"buf": "x0", "rows": 1, "cols": 1}}\n',
    ]


@pytest.mark.parametrize("i", range(15))
def test_malformed_traces_fail_as_the_reference(i):
    """The same exception type and message (the line number included) for
    each malformed trace; a semantically invalid one fails at load time
    with the reference's ProgramError."""
    got = []
    for lower in (RL, TL):
        text = _malformed(lower)[i]
        with pytest.raises(Exception) as e:
            lower.loads(text)
        got.append((type(e.value).__name__, str(e.value)))
    assert got[0] == got[1]
    assert got[0][0] in ("TraceFormatError", "ProgramError")


def test_trace_format_error_is_a_program_error():
    assert issubclass(TL.TraceFormatError, T.ProgramError)
    with pytest.raises(TL.TraceFormatError, match="line 2"):
        TL.loads(RL.dumps(REF[0]).splitlines()[0] + "\nnope\n")


# ----------------------------------------------------- the lowered tapes run
SMALL = [0, 1, 2, 3, 7, 8, 9]          # the corpus without the 256 x 256 ones


@pytest.mark.parametrize("i", SMALL, ids=[IDS[i] for i in SMALL])
def test_lowered_programs_run_to_the_reference_images(i):
    """Serial and pipelined (tiled, reuse) on the port == the port's oracle
    == the reference's serial run, image for image; the pipelined schedule
    is the reference's."""
    rprog, tprog = REF[i], PORT[i]
    rrun = R.run_program(R.CacheRuntime(**RT), rprog)
    ref = images(rrun)
    knobs = dict(row_chunk=3, tiling=(2, 4), reuse=True)
    for run in (T.run_program(T.CacheRuntime(**RT, device="cpu"), tprog),
                T.run_program(TS.PipelinedRuntime(**RT, **knobs, device="cpu"),
                              tprog)):
        got = images(run)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    oracle = T.reference_images(tprog, device="cpu")
    for k in ref:
        np.testing.assert_array_equal(as_np(oracle[k]), ref[k], err_msg=k)
    rp = R.run_program(RS.PipelinedRuntime(**RT, **knobs), rprog)
    assert run.rt.sim_time == rp.rt.sim_time
    assert dataclasses.asdict(run.rt.report())["resource_busy"] == \
        dataclasses.asdict(rp.rt.report())["resource_busy"]


def test_cnn_front_layer_is_one_conv_layer():
    """The strip-mined fused layer's flushed output is the conv layer over
    the whole image: the port's plain conv_layer_ref and the JAX
    reference's conv_layer_ref on the program's x0 and f0."""
    import jax.numpy as jnp
    from repro.kernels.convlayer.ref import conv_layer_ref as jax_conv
    from repro_torch.examples.pipelined_cnn import conv_inputs
    from repro_torch.kernels.convlayer.ref import conv_layer_ref
    for spec, lw in ((TL.CNNSpec(name="golden", h=16, w=20, k=3),
                      dict(vregs_per_vpu=8, vlen_bytes=256)),
                     (TL.CNNSpec(name="golden-b", h=48, w=64, k=5,
                                 width=T.ElemWidth.B),
                      dict(vregs_per_vpu=8, vlen_bytes=256))):
        prog = TL.lower_cnn(spec, **lw)
        assert len(prog.ops) > 1
        run = T.run_program(TS.PipelinedRuntime(**RT, device="cpu"), prog)
        out = run.flushed_images()["l0_out0"]
        x, f = conv_inputs(prog, "x0", "f0", "cpu")
        assert torch.equal(out, conv_layer_ref(x, f)[0])
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jax_conv(jnp.asarray(x.numpy()),
                                             jnp.asarray(f.numpy())))[0])


def test_decode_residual_beta_path():
    """The decode step's residual adds run through GeMM's beta-accumulate:
    the layer output equals the MLP branch plus the attention residual."""
    prog = TL.lower_decode_step(TL.DecodeSpec(name="resid", d=16, ff=32, kv=8))
    ref = T.reference_images(prog, device="cpu")
    assert torch.equal(ref["x1"], (ref["h2_0"].to(torch.int64)
                                   + ref["xa0"]).to(ref["x1"].dtype))
    assert torch.equal(prog.buffer("ident").materialize(prog.width),
                       torch.eye(16, dtype=torch.int8))
