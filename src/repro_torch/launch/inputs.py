"""Stand-ins for every model input, as tensors on the ``meta`` device
(shapes and dtypes, no storage): the port of ``repro.launch.inputs``.

Per input shape kind:
  * ``train_*``  -> a training batch (tokens/labels/mask; the modality
    stubs give frame/patch embeddings for the encdec and vlm families);
  * ``prefill_*`` -> the context batch of a cache build;
  * ``decode_*`` -> ONE new token + a KV/state cache of ``seq_len``
    (``models.decode.cache_spec``).

encdec (SeamlessM4T): the shape's ``seq_len`` is the *source* (audio-frame)
length; the target length is seq_len // 8, at least 128. vlm (InternVL2):
``n_vis_tokens`` patch embeddings come first and the text is
seq_len - n_vis_tokens long, so the whole context is the shape's length.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.decode import cache_spec


def _spec(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _tok(shape: tuple) -> torch.Tensor:
    return _spec(shape, torch.int32)


def encdec_tgt_len(seq_len: int) -> int:
    return max(seq_len // 8, 128)


def train_batch_spec(cfg: ModelConfig, shape: InputShape) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        st = encdec_tgt_len(s)
        return {
            "src_embeds": _spec((b, s, cfg.d_model), torch.bfloat16),
            "tokens": _tok((b, st)),
            "labels": _tok((b, st)),
            "mask": _spec((b, st), torch.float32),
        }
    if cfg.family == "vlm":
        st = s - cfg.n_vis_tokens
        return {
            "vis_embeds": _spec((b, cfg.n_vis_tokens, cfg.d_model), torch.bfloat16),
            "tokens": _tok((b, st)),
            "labels": _tok((b, st)),
            "mask": _spec((b, st), torch.float32),
        }
    return {
        "tokens": _tok((b, s)),
        "labels": _tok((b, s)),
        "mask": _spec((b, s), torch.float32),
    }


def decode_inputs_spec(cfg: ModelConfig, shape: InputShape) -> tuple:
    """(tokens, cache) stand-ins for one decode step."""
    b, s = shape.global_batch, shape.seq_len
    src = s if cfg.family == "encdec" else 0
    return _tok((b,)), cache_spec(cfg, b, s, src_len=src)


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Every stand-in for (arch x shape), keyed by step argument."""
    if shape.kind in ("train", "prefill"):
        return {"batch": train_batch_spec(cfg, shape)}
    tokens, cache = decode_inputs_spec(cfg, shape)
    return {"tokens": tokens, "cache": cache}
