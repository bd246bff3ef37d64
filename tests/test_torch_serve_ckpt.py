"""``repro_torch.launch.serve.main --ckpt-dir`` serves a checkpoint that the
JAX package wrote (``repro.ckpt.save_checkpoint`` of a dense model's
parameters): the same restored step, greedy tokens equal to the JAX
launcher's on the same flags, and the last step's fp32 logits within the
logits tolerance of ``tests/test_torch_transformer.py`` (rtol 1e-5, atol
2e-5) of the JAX package's prefill and decode on those weights.
"""
import ast
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.ckpt import save_checkpoint
from repro.launch import serve as jserve
from repro.models import decode as jdecode
from repro.models import model as jmodel
from repro_torch.launch import serve
from torch_replay import one_torch_thread  # noqa: F401 (autouse fixture)

LOGITS = dict(rtol=1e-5, atol=2e-5)


def _tokens(out: str) -> np.ndarray:
    """The ``reqN: [...]`` lines both launchers print (numpy scalars may
    print as ``np.int32(5)``)."""
    rows = [re.sub(r"np\.\w+\((-?\d+)\)", r"\1", line.split(":", 1)[1])
            for line in out.splitlines() if re.match(r"req\d+: ", line)]
    return np.array([ast.literal_eval(r.strip()) for r in rows])


@pytest.mark.parametrize("arch", ["llama3_8b", "starcoder2_7b"])
def test_serve_main_restores_a_jax_checkpoint(arch, tmp_path, capsys, monkeypatch):
    batch, context, new, seed = 2, 20, 3, 5
    cfg = jconfigs.get_reduced(arch)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(11))
    save_checkpoint(str(tmp_path), 7, params)
    argv = ["--arch", arch, "--batch", str(batch), "--context", str(context),
            "--new-tokens", str(new), "--seed", str(seed), "--ckpt-dir", str(tmp_path)]

    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jserve.main()
    jax_out = capsys.readouterr().out
    gen = serve.main(argv, device="cpu")
    out = capsys.readouterr().out
    assert "restored step 7" in jax_out and "restored step 7" in out

    want_tokens = _tokens(jax_out)
    assert want_tokens.shape == (batch, new + 1)
    np.testing.assert_array_equal(gen.tokens.numpy(), want_tokens)
    np.testing.assert_array_equal(_tokens(out), want_tokens)

    # the JAX package's own greedy run on the checkpoint's weights
    ctx = np.random.default_rng(seed).integers(0, cfg.vocab, (batch, context))
    logits, cache = jdecode.prefill(cfg, params, {"tokens": jnp.asarray(ctx, jnp.int32)},
                                    context + new)
    for i in range(new):
        logits, cache = jdecode.decode_step(cfg, params, cache,
                                            jnp.asarray(want_tokens[:, i], jnp.int32))
    assert gen.logits.dtype == torch.float32
    np.testing.assert_allclose(gen.logits.numpy(), np.asarray(logits), **LOGITS)


def test_serve_main_reads_the_latest_complete_step(tmp_path, capsys):
    cfg = jconfigs.get_reduced("yi_6b")
    for step, key in ((3, 1), (9, 2)):
        save_checkpoint(str(tmp_path), step, jmodel.init_params(cfg, jax.random.PRNGKey(key)))
    # a save cut before its sidecar: skipped
    (tmp_path / "step_00000012.npz").write_bytes(b"partial")
    argv = ["--arch", "yi_6b", "--batch", "1", "--context", "8", "--new-tokens", "1",
            "--ckpt-dir", str(tmp_path)]
    serve.main(argv, device="cpu")
    assert "restored step 9" in capsys.readouterr().out
