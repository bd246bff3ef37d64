"""The port's training launcher and its arithmetic against the JAX package,
on the CPU: ``launch.inputs`` stand-ins and ``launch.analytic`` numbers for
every config x input shape, ``train.main`` resumed from a checkpoint that
JAX's launcher wrote (losses and gradient norms within 1e-5 relative of
JAX's resumed run at the first resumed step, 1e-4 after adamw steps), and
a resume against a fresh run of the port itself
(the data stream and the FL uniforms fast-forwarded draw for draw).
"""
import re
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.launch import analytic as janalytic
from repro.launch import inputs as jinputs
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import config as jconfig
from repro import configs as jconfigs
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_util
from repro_torch.launch import analytic as tanalytic
from repro_torch.launch import inputs as tinputs
from repro_torch.launch import train as ttrain
from repro_torch.models import config as tconfig
from torch_replay import one_torch_thread  # noqa: F401 (autouse fixture)

SHAPES = list(jconfig.INPUT_SHAPES)


def _assert_spec(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    assert got.device.type == "meta"
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_input_specs_match_jax(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for shape in SHAPES:
        want = jinputs.input_specs(jcfg, jconfig.INPUT_SHAPES[shape])
        got = tinputs.input_specs(tcfg, tconfig.INPUT_SHAPES[shape])
        assert set(got) == set(want)
        if "batch" in want:
            assert set(got["batch"]) == set(want["batch"])
            for name in want["batch"]:
                _assert_spec(got["batch"][name], want["batch"][name])
            continue
        _assert_spec(got["tokens"], want["tokens"])
        assert set(got["cache"]) == set(want["cache"])
        for name, spec in want["cache"].items():
            if name == "pos":
                assert got["cache"]["pos"] == 0 and spec.shape == ()
            else:
                _assert_spec(got["cache"][name], spec)
    for s in (0, 100, 1024, 4096, 32768):
        assert tinputs.encdec_tgt_len(s) == jinputs.encdec_tgt_len(s)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_analytic_numbers_equal_jax(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for shape in SHAPES:
        js, ts = jconfig.INPUT_SHAPES[shape], tconfig.INPUT_SHAPES[shape]
        for skip in (False, True):
            assert (tanalytic.train_flops(tcfg, ts, causal_skip=skip)
                    == janalytic.train_flops(jcfg, js, causal_skip=skip))
        for fn in ("prefill_flops", "decode_flops", "train_bytes", "decode_bytes"):
            assert getattr(tanalytic, fn)(tcfg, ts) == getattr(janalytic, fn)(jcfg, js), fn
        for kind in ("train", "prefill", "decode"):
            for n_chips, dp in ((1, 1), (256, 16)):
                assert (tanalytic.analytic_record(tcfg, ts, kind, n_chips, causal_skip=True,
                                                  dp_size=dp)
                        == janalytic.analytic_record(jcfg, js, kind, n_chips, causal_skip=True,
                                                     dp_size=dp))


def test_analytic_train_flops_of_the_card_cells():
    # the full-width train cells of chip_smoke.py: train_4k cut to batch 4
    cut = tconfig.InputShape("train_4k", 4096, 4, "train")
    assert tanalytic.train_flops(tconfigs.get_config("granite_moe_1b_a400m"), cut) == \
        janalytic.train_flops(jconfigs.get_config("granite_moe_1b_a400m"),
                              jconfig.InputShape("train_4k", 4096, 4, "train"))
    assert round(tanalytic.train_flops(tconfigs.get_config("granite_moe_1b_a400m"), cut),
                 -11) == 8.26e13
    assert round(tanalytic.train_flops(tconfigs.get_config("seamless_m4t_large_v2"), cut),
                 -12) == 1.27e14


def _jax_resumed_run(arch, argv, tmp_path):
    """JAX's launcher: ``argv`` for 2 steps saving at step 2, then resumed
    to 5; returns the resumed steps' (loss, grad_norm)."""
    base = [*argv, "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    with mock.patch.object(sys, "argv", ["train", *base, "--steps", "2"]):
        jtrain.main()
    rec = []
    real = jsteps.make_train_step

    def recording(*args, **kw):
        fn, specs = real(*args, **kw)

        def step(p, o, b):
            p, o, m = fn(p, o, b)
            jax.debug.callback(lambda loss, g: rec.append((float(loss), float(g))),
                               m["loss"], m["grad_norm"], ordered=True)
            return p, o, m
        return step, specs

    with mock.patch.object(jsteps, "make_train_step", recording), \
            mock.patch.object(sys, "argv", ["train", *base, "--steps", "5", "--resume",
                                            "--ckpt-every", "100"]):
        jtrain.main()
    return rec


@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2", "internvl2_26b"])
def test_resume_from_the_jax_launchers_checkpoint(arch, tmp_path, capsys):
    argv = ["--arch", arch, "--batch", "2", "--seq", "32", "--seed", "3"]
    want = _jax_resumed_run(arch, argv, tmp_path)
    jout = capsys.readouterr().out
    run = ttrain.main([*argv, "--ckpt-dir", str(tmp_path), "--ckpt-every", "100", "--steps",
                       "5", "--resume"], device="cpu")
    out = capsys.readouterr().out
    assert run.start_step == 2 and len(want) == 3
    # the first resumed step runs on the checkpoint's parameters in both:
    # 1e-5. Each adamw step after it moves a coordinate whose gradient is
    # within a few eps of zero by up to 2 lr more or less in one framework
    # than in the other (tests/test_torch_train_step.py's Adam test), so the
    # later steps drift further: 1e-4
    np.testing.assert_allclose(run.losses[0], want[0][0], rtol=1e-5)
    np.testing.assert_allclose(run.grad_norms[0], want[0][1], rtol=1e-5)
    np.testing.assert_allclose(run.losses, [w[0] for w in want], rtol=1e-4)
    np.testing.assert_allclose(run.grad_norms, [w[1] for w in want], rtol=1e-4)
    # the same lines: the resume, and the last step's
    line = r"step    4 loss \d+\.\d{4} gnorm \d+\.\d{3} \(\d+\.\d{2}s/step\)"
    for text in (jout, out):
        assert f"resumed from step 2 ({tmp_path})" in text
        assert re.search(line, text), text


@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2", "internvl2_26b", "llama3_8b"])
def test_resume_replays_the_fresh_runs_stream(arch, tmp_path, monkeypatch, capsys):
    """A run saved at step 4 and resumed sees, from step 4 on, the batches
    and FL uniforms of a fresh run (encdec's and vlm's normal draws
    included); its first step's loss and gradient norm equal the fresh
    run's at step 4 bit for bit (same parameters, same batch; the
    optimizer is re-initialized, so later steps differ)."""
    seen = []
    real_batch, real_uniforms = ttrain._batch, ttrain._fl_uniforms

    def batch(*args):
        out = real_batch(*args)
        seen.append(("batch", {k: v.clone() for k, v in out.items()}))
        return out

    def uniforms(*args):
        out = real_uniforms(*args)
        seen.append(("fl", [u.clone() for client in out for u in client]))
        return out

    monkeypatch.setattr(ttrain, "_batch", batch)
    monkeypatch.setattr(ttrain, "_fl_uniforms", uniforms)
    argv = ["--arch", arch, "--batch", "2", "--seq", "16", "--seed", "5", "--fl-interval", "3",
            "--fl-q", "6", "--lr", "1e-2"]
    fresh = ttrain.main([*argv, "--steps", "7"], device="cpu")
    out = capsys.readouterr().out
    assert "  fl sync @ step 3: q=6 theta_max=" in out and "  fl sync @ step 6: q=6" in out
    fresh_seen = list(seen)
    ttrain.main([*argv, "--steps", "4", "--ckpt-dir", str(tmp_path), "--ckpt-every", "4"],
                device="cpu")
    seen.clear()
    resumed = ttrain.main([*argv, "--steps", "7", "--ckpt-dir", str(tmp_path), "--resume"],
                          device="cpu")
    out = capsys.readouterr().out
    assert f"resumed from step 4 ({tmp_path})" in out and "  fl sync @ step 6: q=6" in out
    # the fast-forward skips the batches of steps 0-3 and draws (and
    # discards) the uniforms of the sync after step 3
    def of(kind, events):
        return [v for k, v in events if k == kind]

    assert [k for k, _ in seen] == ["fl", "batch", "batch", "fl", "batch"]
    assert len(of("batch", fresh_seen)) == 7
    for got, ref in zip(of("batch", seen), of("batch", fresh_seen)[4:]):
        assert all(torch.equal(got[name], ref[name]) for name in ref)
    for got, ref in zip(of("fl", seen), of("fl", fresh_seen), strict=True):
        assert all(torch.equal(a, b) for a, b in zip(got, ref, strict=True))
    assert resumed.losses[0] == fresh.losses[4]
    assert resumed.grad_norms[0] == fresh.grad_norms[4]
    assert all(np.isfinite(resumed.losses))


def test_resume_past_the_end_and_without_a_checkpoint(tmp_path, capsys):
    argv = ["--arch", "llama3_8b", "--batch", "1", "--seq", "8"]
    ttrain.main([*argv, "--steps", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"],
                device="cpu")
    run = ttrain.main([*argv, "--steps", "2", "--ckpt-dir", str(tmp_path), "--resume"],
                      device="cpu")
    assert run.losses == [] and "nothing to do: resumed step 2 >= --steps 2" in \
        capsys.readouterr().out
    empty = tmp_path / "empty"
    run = ttrain.main([*argv, "--steps", "1", "--ckpt-dir", str(empty), "--resume"],
                      device="cpu")
    assert run.start_step == 0 and len(run.losses) == 1
    assert "no complete checkpoint" in capsys.readouterr().out
    assert all(t.dtype == torch.float32 for t in tree_util.leaves(run.params))


def test_ledger_timings(tmp_path):
    from repro_torch.obs import read_ledger

    path = tmp_path / "ledger.jsonl"
    ttrain.main(["--arch", "llama3_8b", "--batch", "1", "--seq", "8", "--steps", "2",
                 "--ledger", str(path)], device="cpu")
    events = read_ledger(str(path))
    assert [e["event"] for e in events] == ["run_header", "timing", "timing"]
    assert [e["phase"] for e in events[1:]] == ["first_step", "train_loop"]
    assert events[0]["name"] == "train[llama3_8b]" and events[2]["steps"] == 2


def test_xprof_traces_the_steps_after_the_first(tmp_path, capsys):
    trace_dir = tmp_path / "trace"
    ttrain.main(["--arch", "llama3_8b", "--batch", "1", "--seq", "8", "--steps", "3",
                 "--xprof", str(trace_dir)], device="cpu")
    assert "# trace written to" in capsys.readouterr().out
    assert len(list(trace_dir.glob("trace_*.json"))) == 1
