"""The four assigned input shapes and per-(arch x shape) input specs.

The port of ``repro/launch/shapes.py``. ``train_inputs``,
``prefill_inputs`` and ``decode_inputs`` return the inputs of the step each
shape runs as empty tensors on torch's ``meta`` device (the reference's
``ShapeDtypeStruct``): shapes and dtypes, no storage.

Shape semantics:
  train_4k     seq 4096,   global_batch 256  -> decentralized train_step
  prefill_32k  seq 32768,  global_batch 32   -> prefill (forward, no grad)
  decode_32k   seq 32768,  global_batch 128  -> serve_step (1 token, 32k cache)
  long_500k    seq 524288, global_batch 1    -> serve_step, sub-quadratic only
                                               (SSM/hybrid state, or
                                               sliding-window ring cache)
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import frontends as FE
from repro_torch.models import transformer as TF

__all__ = [
    "InputShape",
    "SHAPES",
    "WHISPER_DEC_LEN",
    "WHISPER_ENC_FRAMES",
    "tokens_spec",
    "train_inputs",
    "prefill_inputs",
    "decode_cache_len",
    "decode_inputs",
    "long_context_applicable",
]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# Whisper's decoder context is 448; its encoder consumes the frame axis.
WHISPER_DEC_LEN = 448
# Whisper encoder frames for decode shapes (30 s window -> 1500 frames).
WHISPER_ENC_FRAMES = 1500


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def tokens_spec(batch: int, seq: int) -> torch.Tensor:
    return _meta((batch, seq), torch.int32)


def train_inputs(
    cfg: ArchConfig, shape: InputShape, num_nodes: int, *, microbatches: int = 1
) -> dict:
    """Microbatched node-stacked (M, N, B/M, S) token/label specs (+ stub
    frontends). The microbatch axis leads, so the per-node batch dim keeps
    its "data" sharding through gradient accumulation."""
    assert shape.kind == "train"
    if shape.global_batch % (num_nodes * microbatches):
        raise ValueError(
            f"global_batch {shape.global_batch} not divisible by "
            f"nodes*microbatches {num_nodes}*{microbatches}"
        )
    m = microbatches
    b = shape.global_batch // num_nodes // m
    s = shape.seq_len
    lead = (m, num_nodes)
    if cfg.enc_dec:
        return {
            "frames": _meta(lead + (b, s, cfg.d_model), cfg.dtype()),
            "tokens": _meta(lead + (b, WHISPER_DEC_LEN), torch.int32),
            "labels": _meta(lead + (b, WHISPER_DEC_LEN), torch.int32),
        }
    if cfg.family == "vlm":
        p = int(s * cfg.vlm_prefix_frac)
        return {
            "prefix_embeds": _meta(lead + (b, p, cfg.d_model), cfg.dtype()),
            "tokens": _meta(lead + (b, s - p), torch.int32),
            "labels": _meta(lead + (b, s), torch.int32),
        }
    return {"tokens": _meta(lead + (b, s), torch.int32),
            "labels": _meta(lead + (b, s), torch.int32)}


def prefill_inputs(cfg: ArchConfig, shape: InputShape) -> dict:
    assert shape.kind == "prefill"
    b, s = shape.global_batch, shape.seq_len
    if cfg.enc_dec:
        return {"frames": FE.audio_frames_spec(cfg, b, s), "tokens": tokens_spec(b, WHISPER_DEC_LEN)}
    if cfg.family == "vlm":
        p = int(s * cfg.vlm_prefix_frac)
        return {"prefix_embeds": FE.patch_embeddings_spec(cfg, b, p), "tokens": tokens_spec(b, s - p)}
    return {"tokens": tokens_spec(b, s)}


def decode_cache_len(cfg: ArchConfig, shape: InputShape) -> int:
    """Ring-buffer length for attention caches at this decode shape."""
    if shape.name == "long_500k":
        # Sub-quadratic requirement: dense archs use the sliding window.
        return cfg.sliding_window
    if cfg.enc_dec:
        return min(shape.seq_len, 32768)  # synthetic for whisper
    return shape.seq_len


def decode_inputs(cfg: ArchConfig, shape: InputShape) -> dict:
    assert shape.kind == "decode"
    b = shape.global_batch
    out = {
        "token": _meta((b,), torch.int32),
        "cache": TF.init_cache(cfg, b, decode_cache_len(cfg, shape), device="meta"),
    }
    if cfg.enc_dec:
        out["memory"] = FE.audio_frames_spec(cfg, b, WHISPER_ENC_FRAMES)
    return out


def long_context_applicable(cfg: ArchConfig) -> tuple[bool, str]:
    """Everything runs long_500k: SSM/hybrid natively, attention archs via
    the sliding-window variant. Whisper traces but is architecturally
    synthetic (448-token decoder)."""
    if cfg.family in ("ssm", "hybrid"):
        return True, "native sub-quadratic (recurrent state)"
    if cfg.enc_dec:
        return True, "lowered with ring cache; synthetic for a 448-ctx decoder"
    return True, f"sliding-window attention (window={cfg.sliding_window})"
