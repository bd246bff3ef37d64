"""The object runtime (``repro_torch.fl``) on the card against the CPU.

Needs a CUDA device; every test here skips without one. Run on the GPU
machine with ``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_fl.py``.
No JAX: the card's machine does not have it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import stochastic_quant as sq


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the test compares the card's run with the CPU's")
    return torch.device("cuda")


@pytest.mark.parametrize("policy", ["qccf", "channel_allocate"])
def test_object_runtime_card_equals_cpu(cuda, policy):
    """``build_experiment`` without a device runs on the card; from the same
    weights and upload uniforms (drawn on the CPU) its schedule, q and
    energy equal the CPU run's, and no kernel of the port launches (the
    object runtime quantizes with ``core.quantization.quantize_pytree``)."""
    from repro_torch import tree as tree_util
    from repro_torch.fl import build_experiment
    from repro_torch.fl.trainer import UploadEntropy
    from repro_torch.models import cnn

    class Uploads:
        def __init__(self, device):
            self.inner, self.device = UploadEntropy(3, "cpu"), device

        def upload_uniforms(self, shapes):
            return [u.to(self.device) for u in self.inner.upload_uniforms(shapes)]

    params = cnn.init_params(cnn.TINY_CNN, 3, device="cpu")
    runs = {}
    sq.reset_launches()
    for dev in (None, "cpu"):
        exp = build_experiment(policy, task="tiny", n_clients=8, n_channels=8, seed=3,
                               device=dev, init_params=params, entropy=Uploads(dev or "cuda"))
        runs[dev] = (exp, exp.run(3))
    assert all(n == 0 for n in sq.launches.values())
    (g_exp, g), (c_exp, c) = runs[None], runs["cpu"]
    assert g_exp.device.type == "cuda"
    assert all(leaf.is_cuda for leaf in tree_util.leaves(g_exp.params))
    for f in ("n_scheduled", "energy", "latency", "payload_bits"):
        assert [getattr(r, f) for r in g.records] == [getattr(r, f) for r in c.records], f
    np.testing.assert_array_equal(np.stack([r.q_levels for r in g.records]),
                                  np.stack([r.q_levels for r in c.records]))
    assert max(abs(a.accuracy - b.accuracy) for a, b in zip(g.records, c.records)) <= 1e-3
