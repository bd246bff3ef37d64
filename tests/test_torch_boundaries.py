"""The port's boundaries: no JAX and no ``repro`` inside ``repro_torch`` or
``chip_smoke.py``, and entry points that never pick the CPU by themselves."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "repro"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("chip_smoke.py", "src/repro_torch/sim/engine.py",
                 "src/repro_torch/sim/search.py", "src/repro_torch/fl/baselines.py",
                 "src/repro_torch/fl/trainer.py",
                 "src/repro_torch/kernels/stochastic_quant.py",
                 "src/repro_torch/kernels/flash_attention.py",
                 "src/repro_torch/launch/serve.py", "src/repro_torch/sim/scenario.py",
                 "src/repro_torch/core/quantization.py", "src/repro_torch/ckpt/checkpoint.py",
                 "src/repro_torch/ckpt/__init__.py"):
        assert must in names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_repro_import(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_rule_catches_the_reference():
    assert _forbidden("jax.numpy") and _forbidden("repro.core.kkt") and _forbidden("repro")
    assert not _forbidden("repro_torch.core.kkt") and not _forbidden("torch")


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-CUDA guard cannot be exercised")
    from repro_torch.configs import get_reduced
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.models import cnn
    from repro_torch.models import model
    from repro_torch.sim import build_sim

    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_sim("tiny", n_clients=4, n_channels=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cnn.init_params(cnn.TINY_CNN, 0)
    cfg = get_reduced("llama3_8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.params_from_numpy({"final_norm": {"scale": np.ones(4, np.float32)}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.generate(cfg, {}, np.zeros((1, 4), np.int64), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--new-tokens", "1"])
    assert resolve_device("cpu") == torch.device("cpu")
