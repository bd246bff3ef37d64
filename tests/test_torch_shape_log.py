"""``repro_torch.dist.shape_log``: the dry run's two gates as rules over a
log of per-rank result shapes, held against the JAX package's
``hlo_analysis`` rules on the same shapes written as HLO (the cases of
``tests/test_sharding_dryrun.py`` and ``tests/test_flash_attention.py``),
and ``ShapeLog`` on real ops: dense attention trips the S² rule, the
flash plain version does not, and a backward's ops are logged.
"""
import pytest
import torch

from torch_replay import one_torch_thread  # noqa: F401  (autouse)

_HLO_DTYPE = {"float32": "f32", "bfloat16": "bf16", "int32": "s32"}


def _entries(*specs):
    """(op, dtype, shape) triples as log entries."""
    from repro_torch.dist.shape_log import Entry

    item = {"float32": 4, "bfloat16": 2, "int32": 4}
    out = []
    for op, dtype, shape in specs:
        n = item[dtype]
        for d in shape:
            n *= d
        out.append(Entry(op, tuple(shape), dtype, n))
    return out


def _hlo(specs) -> str:
    """The same entries as the result shapes of an HLO entry computation."""
    lines = [f"  %{op} = {_HLO_DTYPE[dtype]}[{','.join(map(str, shape))}] fusion(%a), kind=kLoop"
             for op, dtype, shape in specs]
    return ("HloModule test\n\nENTRY %main (a: f32[2]) -> f32[2] {\n  %a = f32[2] parameter(0)\n"
            + "\n".join(lines) + "\n  ROOT %r = f32[2] copy(%a)\n}\n")


FULL_CASE = (("big", "bfloat16", (4, 1024, 512)), ("halved", "bfloat16", (4, 512, 512)),
             ("toks", "int32", (4, 1024)), ("cache", "bfloat16", (24, 4, 1024, 8, 64)))


@pytest.mark.parametrize("kwargs,want", [
    (dict(min_bytes=100_000), ["big"]),
    ({}, ["big"]),                                  # trailing-dim-only and rank-5 skipped
    (dict(ignore_last_dim=False), ["big", "toks"]),
])
def test_full_length_intermediates(kwargs, want):
    from repro.dist import hlo_analysis
    from repro_torch.dist.shape_log import full_length_intermediates

    got = full_length_intermediates(_entries(*FULL_CASE), 1024, **kwargs)
    ref = hlo_analysis.full_length_intermediates(_hlo(FULL_CASE), 1024, **kwargs)
    assert [o["op"] for o in got] == want
    assert [(o["op"], o["bytes"]) for o in got] == [(o["op"], o["bytes"]) for o in ref]
    assert got[0]["bytes"] == 4 * 1024 * 512 * 2 and got[0]["shape"] == "bfloat16[4,1024,512]"


S2_CASES = [
    ((("x", "float32", (1024, 2048)),), 2048, 2, ["x"]),     # (S/2, S) on a seq=2 mesh
    ((("x", "float32", (1024, 2048)),), 2048, 1, []),        # one full-length dim only
    ((("flat", "float32", (2048 * 2048,)),), 2048, 1, ["flat"]),   # a flattened score matrix
    ((("small", "float32", (2, 256, 256)),), 256, 1, []),    # under 1 MiB
    ((("scores", "bfloat16", (1, 2, 2048, 2048)), ("out", "bfloat16", (1, 2048, 2, 64))),
     2048, 1, ["scores"]),
]


@pytest.mark.parametrize("specs,length,shards,want", S2_CASES)
def test_no_s2_scores(specs, length, shards, want):
    from repro.dist import hlo_analysis
    from repro_torch.dist.shape_log import no_s2_scores

    got = no_s2_scores(_entries(*specs), length, shards=shards)
    ref = hlo_analysis.no_s2_scores(_hlo(specs), length, shards=shards)
    assert [o["op"] for o in got] == want == [o["op"] for o in ref]


def test_dense_attention_trips_the_s2_rule_and_flash_does_not():
    from repro_torch.dist.shape_log import ShapeLog, no_s2_scores
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import layers

    s = 2048
    gen = torch.Generator().manual_seed(29)
    q, k, v = (torch.randn((1, s, n, 64), generator=gen) for n in (2, 1, 1))
    with ShapeLog() as dense:
        layers.dense_attention(q, k, v, causal=True)
    with ShapeLog() as flash:
        flash_attention_plain(q, k, v, block_q=256, block_k=256, causal=True)
    assert no_s2_scores(dense.entries, s), "dense attention must trip the gate"
    assert no_s2_scores(flash.entries, s) == []


def test_log_holds_each_result_and_the_backward():
    from repro_torch.dist.shape_log import ShapeLog

    w = torch.randn((8, 3), requires_grad=True)
    x = torch.randn((5, 8))
    with ShapeLog() as log:
        y = torch.matmul(x, w)
        y.sum().backward()
    mm = [e for e in log.entries if e.op == "mm"]
    assert (5, 3) in [e.shape for e in mm]            # the forward product
    assert (8, 3) in [e.shape for e in mm]            # w's gradient, in backward
    assert all(e.bytes == 4 * e.shape[0] * e.shape[1] for e in mm)
