"""The benchmark's files against its contract, on the CPU: what it may
import, that every cell resolves its files by name, the names and units,
and the operation and byte counts against hand-derived values."""
import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
# the paper's CIFAR-10 CNN (Sec. VI): the counts' path through dense hidden
# layers and a third pool, which no cell runs yet
CIFAR10 = {"in_hw": 32, "in_ch": 3, "conv_channels": [64, 64], "hidden": [384, 192],
           "n_classes": 10, "kernel": 5, "extra_pool": True}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports, whole."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_a_plain_reference(path):
    found = _imports(path)
    assert not found & {"jax", "jaxlib", "flax", "repro"}, found
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in found, found


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"] and (ROOT / "bench").is_dir()
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_its_files(cell):
    from bench import harness

    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
    spec = harness.cell_spec(cell["name"], ROOT)
    assert spec["config"]["name"] == cell["config"]
    assert spec["config"]["below_precision"]
    assert spec["limits"]["limits"] and "below_precision" in spec["limits"]["limits"]
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(__import__(f"bench.metrics.{m['name']}", fromlist=["read"]).read)
    # what only this kind of cell has to hold: bench/drivers/<driver>.py
    harness.load_driver(spec).check_files(spec)


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_metric_with_a_cell_list_names_cells_that_exist(cell):
    """A cell reports every metric without a ``workloads`` key and each
    whose list holds it; every listed cell exists."""
    from bench import harness

    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    spec = harness.cell_spec(cell["name"], ROOT)
    want = {m["name"] for m in SPEC["per_layer"] if cell["name"] in m.get("workloads", cells)}
    assert {m["name"] for m in spec["per_layer"]} == want


FLEET_FILE_FAULTS = {
    "traffic without a policy": lambda s: s["traffic"].pop("policy"),
    "a policy with no reference": lambda s: s["traffic"].update(policy="nowhere"),
    "a limit renamed": lambda s: s["limits"]["limits"].update(
        model_gap=s["limits"]["limits"].pop("model_err")),
    "a tolerance left out": lambda s: s["limits"]["tolerances"].pop("v_err"),
    "a parameter count off": lambda s: s["config"].update(z=s["config"]["z"] + 1),
}


@pytest.mark.parametrize("fault", sorted(FLEET_FILE_FAULTS))
def test_fleet_check_files_refuses_a_broken_file(fault):
    import copy

    from bench import harness
    from bench.drivers import fleet

    spec = copy.deepcopy(harness.cell_spec(SPEC["workloads"][0]["name"], ROOT))
    fleet.check_files(spec)
    FLEET_FILE_FAULTS[fault](spec)
    with pytest.raises(ValueError):
        fleet.check_files(spec)


def test_every_config_is_used_and_states_its_size():
    """Each configuration names its driver, whose ``check_files`` holds its
    stated size (``test_cell_resolves_its_files``)."""
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("bench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert NAME.match(cfg["driver"]) and (BENCH / "drivers" / f"{cfg['driver']}.py").is_file()


def test_names_units_and_bounds():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in SPEC["workloads"]] \
        + [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]


def test_parameter_counts_by_hand():
    from bench import inputs

    femnist = json.loads((BENCH / "configs" / "femnist_cnn.json").read_text())["model"]
    # conv 5x5x1x32 + 32, 5x5x32x64 + 64, dense 7*7*64 x 62 + 62
    assert inputs.param_count(femnist) == 832 + 51264 + 194494 == 246590
    # conv 5x5x3x64 + 64, 5x5x64x64 + 64, dense 4*4*64 x 384, 384 x 192, 192 x 10
    assert inputs.param_count(CIFAR10) == 4864 + 102464 + 393600 + 73920 + 1930 == 576778


def test_flop_and_byte_counts_by_hand():
    from bench.counts.cnn_flops import forward_flops, round_flops, train_flops
    from bench.counts.wire_bytes import aggregate_bytes
    from bench.drivers import fleet

    cfg = json.loads((BENCH / "configs" / "femnist_cnn.json").read_text())
    # 2 x (28*28*25*1*32), 2 x (14*14*25*32*64), 2 x 3136*62
    fwd = 1_254_400 + 20_070_400 + 388_864
    assert forward_flops(cfg["model"]) == fwd == 21_713_664
    assert train_flops(cfg["model"]) == 3 * fwd - 1_254_400 == 63_886_592
    traffic = {"n_channels": 128, "eval": True}
    assert round_flops(cfg, traffic) == 128 * 6 * 32 * 63_886_592 + 1024 * fwd
    assert fleet.round_flops(cfg, dict(traffic, n_channels=32)) == 32 * 6 * 32 * 63_886_592 \
        + 1024 * fwd
    assert fleet.FLOP_PEAK == "fp32_flop_per_s"
    # u8 index and sign planes of 128 clients, 128 coefficients, the fp32 model
    assert aggregate_bytes(cfg, traffic) == 128 * 246590 * 2 + 4 * 128 + 4 * 246590
    # 2 x (32*32*25*3*64), 2 x (16*16*25*64*64), 2 x (1024*384 + 384*192 + 192*10)
    assert forward_flops(CIFAR10) == 9_830_400 + 52_428_800 + 786_432 + 147_456 + 3_840


def test_below_precision_reads_kernel_names():
    from bench.trace import below_precision

    cfg = json.loads((BENCH / "configs" / "femnist_cnn.json").read_text())
    names = [
        "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize32x32x8_"
        "stage3_warpsize1x2x1_g1_ffma_aligna4_alignc4_execute_kernel__5x_cudnn",
        "void cudnn::detail::dgrad2d_alg1_1<float, 0, 5, 6, 4, 3, 4, false, true>",
        "sm80_xmma_fprop_implicit_gemm_tf32f32_tf32f32_f32_nhwckrsc_nchw_tilesize128x128x16_"
        "stage4_warpsize2x2x1_g1_tensor16x8x8_execute_kernel__5x_cudnn",
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_cublas",
        "ampere_fp16_s16816gemm_fp16_128x128_ldg8_f2f_stages_32x5_nn",
    ]
    assert below_precision(names, cfg["below_precision"]) == 3
    assert below_precision(names[:2], cfg["below_precision"]) == 0
