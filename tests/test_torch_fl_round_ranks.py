"""``launch.steps.make_fl_round`` with one client a rank on CPU ranks of a
gloo group: the client axis ``pod`` of 2 and of 4 ranks; ``pod`` 2 x
``data`` 2 (each client's model sharded over its two ranks, each rank
stepping on its row of the client's batch); ``pod`` 2 x ``model`` 2
(TP within a client; three modes); and ``pod`` 2 x ``seq`` 2 (the JAX
round's intra-client data axis: FSDP and rows over ``seq``, the sequence
whole; three modes). The reduced Llama-3-8B, clients
starting from different models, each with its own batch slice and uplink
uniforms.

Every mode is held against the stacked round (K clients in one process)
on the same uniforms: fp32 and ``wire_packed`` uplinks, each downlink
mode, with and without the screen (the screened rounds with one client's
model corrupted by a NaN: it is dropped). With one client a rank and no
other axis the round is **bit-equal**. With ``data`` or ``model`` 2 the
client's gradient and row-parallel products sum in another order, so the
loss and ranges agree at fp32's rtol 1e-5, and an output element may sit
one quantization level away (a stochastic rounding whose input moved
across its uniform by fp32 rounding): every element within one uplink
level plus two downlink levels (and 1e-5 of itself), and at most 1 % of
them off by more than 1e-5 of itself. Those runs must have issued the
FSDP gathers and gradient reduce-scatters over ``data`` (or ``seq``), or
the TP all-reduces over ``model``. The counter's bytes across the client axis
(tag ``"uplink"``) equal the formula: a client's fp32 payload is 4 Z
bytes and its range 4; the wire's u8 indexes Z, its sign planes the rows
x (last dim padded to 128) / 8 and its range 4 (Z: the elements of the
rank's shard of the client's model); their ratio is JAX's
``--wire-ratio`` record, about 0.28.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from torch_replay import one_torch_thread, spawn_gloo  # noqa: F401  (autouse)

MESHES = {"pod2": (2, 1, 1), "pod4": (4, 1, 1), "pod2_data2": (2, 2, 1), "pod2_model2": (2, 1, 2),
          "pod2_seq2": (2, 1, 2, 1)}       # (pod, data, model) or (pod, data, seq, model)
MODES = [(wire, down, screen) for wire in (False, True) for down in ("off", "quant", "delta")
         for screen in (False, True)]
TP_MODES = [(False, "off", False), (True, "off", False), (True, "quant", True)]


def _modes(name):
    return TP_MODES if name in ("pod2_model2", "pod2_seq2") else MODES


def _axes(shape) -> dict:
    """The mesh's axis sizes by name."""
    names = ("pod", "data", "model") if len(shape) == 3 else ("pod", "data", "seq", "model")
    return dict(zip(names, shape))
Q_BITS = {2: [4, 6], 4: [3, 5, 8, 12]}
WEIGHTS = {2: [0.25, 0.75], 4: [0.1, 0.2, 0.3, 0.4]}


def _mode_id(mode):
    wire, down, screen = mode
    return f"{'packed' if wire else 'fp32'}-{down}{'-screen' if screen else ''}"


def _inputs(k, corrupt: bool):
    """K clients of the reduced Llama (client i's weights scaled by 1 +
    i / 100), their batches, uplink and downlink uniforms; with ``corrupt``
    client 1's model carries a NaN."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_reduced
    from repro_torch.models import model

    cfg = get_reduced("llama3_8b")
    p = model.init_params(cfg, 0, device="cpu", param_dtype=torch.float32)
    stacked = tree_util.map(lambda t: torch.stack([t * (1 + i / 100) for i in range(k)]), p)
    if corrupt:
        stacked["final_norm"]["scale"][1, 0] = float("nan")
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (k, 2, 32)))
    batch = {"tokens": toks, "labels": toks, "mask": torch.ones((k, 2, 32))}
    gen = torch.Generator().manual_seed(5)
    leaves = tree_util.leaves(stacked)
    uni = [[torch.rand(t.shape[1:], generator=gen) for t in leaves] for _ in range(k)]
    down = [torch.rand(t.shape[1:], generator=gen) for t in leaves]
    return cfg, stacked, batch, uni, down


def _round_rank(rank, world, out_dir, name):
    from repro_torch.dist.collectives import CollectiveCounter
    from repro_torch.dist.placement import full_tree
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import make_fl_round, place_clients

    shape = MESHES[name]
    k = shape[0]
    mesh = make_production_mesh(shape=shape, device="cpu")
    res = {}
    for mode in _modes(name):
        wire, down, screen = mode
        cfg, stacked, batch, uni, dl = _inputs(k, corrupt=screen)
        fl = make_fl_round(cfg, wire_packed=wire, downlink=down, screen=screen, mesh=mesh)
        with CollectiveCounter() as counter:
            out = fl(place_clients(mesh, stacked), batch, Q_BITS[k], WEIGHTS[k], uniforms=uni,
                     downlink_uniforms=dl)
        res[mode] = ((full_tree(out[0]),) + tuple(out[1:]),
                     counter.bytes(axis="pod", tag="uplink"), counter.totals())
    with open(os.path.join(out_dir, f"{name}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.steps import make_fl_round
    from torch_replay import join_all

    out = tmp_path_factory.mktemp("fl_ranks")
    worlds = [spawn_gloo(_round_rank, int(np.prod(s)), out, str(out), n, join=False)
              for n, s in MESHES.items()]
    refs = {}
    for k in (2, 4):
        for mode in MODES:
            wire, down, screen = mode
            cfg, stacked, batch, uni, dl = _inputs(k, corrupt=screen)
            refs[k, mode] = make_fl_round(cfg, wire_packed=wire, downlink=down, screen=screen)(
                stacked, batch, Q_BITS[k], WEIGHTS[k], uniforms=uni, downlink_uniforms=dl)
    join_all(*worlds)
    ranks = {}
    for name, shape in MESHES.items():
        for r in range(int(np.prod(shape))):
            with open(out / f"{name}_rank{r}.pkl", "rb") as f:
                ranks[name, r] = pickle.load(f)
    return ranks, refs


def _same(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("mode", MODES, ids=_mode_id)
@pytest.mark.parametrize("name", ["pod2", "pod4"])
def test_bit_equal_to_the_stacked_round(runs, name, mode):
    from repro_torch import tree as tree_util

    ranks, refs = runs
    k = MESHES[name][0]
    want = refs[k, mode]
    for r in range(int(np.prod(MESHES[name]))):
        got, _, _ = ranks[name, r][mode]
        assert len(got) == len(want)
        for a, b in zip(tree_util.leaves(got[0]), tree_util.leaves(want[0])):
            _same(a, b)
        for a, b in zip(got[1:], want[1:]):
            _same(a, b)
        if mode[2]:
            assert float(got[3]) == 1.0          # the corrupted client was screened


def _steps(mode, k, theta_max, want, start):
    """One uplink level (the largest of the surviving clients' range over
    their levels: the eq.-2 weights sum to 1) and one downlink level (the
    broadcast's range over 255, read off the stacked round's output)."""
    wire, down, _ = mode
    q = torch.tensor(Q_BITS[k], dtype=torch.float32)
    levels = 2.0 ** (torch.clamp(q, max=8) if wire else q) - 1.0
    ok = torch.isfinite(theta_max)
    up = float(torch.amax(theta_max[ok] / levels[ok]))
    if down == "off":
        return up, 0.0
    if down == "quant":
        target = [w[0] for w in want]
    else:
        target = [(w - c)[0] for w, c in zip(want, start)]
    theta_d = max(float(torch.amax(torch.abs(t))) for t in target)
    return up, theta_d / 255.0


@pytest.mark.parametrize("name,mode", [("pod2_data2", m) for m in MODES]
                         + [("pod2_model2", m) for m in TP_MODES]
                         + [("pod2_seq2", m) for m in TP_MODES],
                         ids=lambda v: v if isinstance(v, str) else _mode_id(v))
def test_sharded_clients_within_one_level(runs, name, mode):
    """``pod`` 2 x ``data`` 2 (FSDP within a client), ``pod`` 2 x ``model``
    2 (TP within a client) and ``pod`` 2 x ``seq`` 2 (FSDP over ``seq``)
    against the stacked round (module docstring)."""
    from repro_torch import tree as tree_util

    ranks, refs = runs
    want = refs[2, mode]
    _cfg, start, *_ = _inputs(2, corrupt=mode[2])
    up, dl = _steps(mode, 2, want[2], tree_util.leaves(want[0]), tree_util.leaves(start))
    for r in range(4):
        got, _, coll = ranks[name, r][mode]
        if name in ("pod2_data2", "pod2_seq2"):
            data = coll["data" if name == "pod2_data2" else "seq"]
            assert data["all-gather"]["count"] > 0 and data["reduce-scatter"]["count"] > 0, coll
        else:
            assert coll["model"]["all-reduce"]["count"] > 0, coll
        for a, b in zip(got[1:3], want[1:3]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0, equal_nan=True)
        if mode[2]:
            assert float(got[3]) == float(want[3]) == 1.0
        off = total = 0
        for a, b in zip(tree_util.leaves(got[0]), tree_util.leaves(want[0])):
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            a, b = a.nan_to_num(), b.nan_to_num()
            diff, rel = torch.abs(a - b), 1e-5 * torch.abs(b)
            assert bool((diff <= up + 2 * dl + rel).all()), float(torch.amax(diff - rel))
            off += int((diff > rel).sum())
            total += b.numel()
        assert off <= 0.01 * total, (off, total)


def _payload(shard_shapes, wire: bool) -> int:
    """One client's uplink bytes (module docstring)."""
    if not wire:
        return sum(4 * int(np.prod(s)) for s in shard_shapes) + 4
    total = 4
    for s in shard_shapes:
        rows, d = int(np.prod(s[:-1])), s[-1]
        total += int(np.prod(s)) + rows * ((d + 127) // 128 * 128) // 8
    return total


@pytest.mark.parametrize("name", MESHES)
def test_client_axis_bytes_and_wire_ratio(runs, name):
    from repro_torch import tree as tree_util
    from repro_torch.dist.plan import make_plan
    from repro_torch.dist.sharding import param_specs

    ranks, _ = runs
    sizes = _axes(MESHES[name])
    k = sizes["pod"]
    _cfg, stacked, *_ = _inputs(k, corrupt=False)
    one = tree_util.map(lambda t: t[0], stacked)
    plan = make_plan(sizes, dp_override=tuple(a for a in ("data", "seq") if a in sizes))
    shards = []
    for t, spec in zip(tree_util.leaves(one), tree_util.leaves(param_specs(plan, one))):
        shards.append(tuple(n // plan.axis_size(spec[i] if i < len(spec) else None)
                            for i, n in enumerate(t.shape)))
    for r in range(int(np.prod(MESHES[name]))):
        for mode in _modes(name):
            _got, nbytes, _ = ranks[name, r][mode]
            assert nbytes == k * _payload(shards, mode[0]), (mode, nbytes)
    fp32 = ranks[name, 0][(False, "off", False)][1]
    packed = ranks[name, 0][(True, "off", False)][1]
    assert 0.27 < packed / fp32 < 0.30, packed / fp32
