"""Batched serving: prefill and autoregressive decode over ``decode_step``,
with greedy or temperature sampling. The port of ``repro/serve/decode.py``.

Prefill has two implementations:

- ``prefill``, the fast path: one full-sequence forward
  (``transformer.prefill_forward``) that writes the whole KV cache at once,
  through the CUDA flash-attention kernel on the card;
- ``prefill_sequential``, the reference path: the prompt token by token
  through ``decode_step``, the definition of what incremental decoding gives.

Caches are updated in place (``models.layers``): the cache given is the
cache returned.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as TF

__all__ = ["cache_len_for", "flash_ok", "generate", "prefill", "prefill_sequential", "sample"]

PyTree = Any


def cache_len_for(cfg: ArchConfig, seq_len: int, *, long_context: bool) -> int:
    """Ring-buffer length: full seq for exact attention, window for SWA."""
    if long_context or cfg.always_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def flash_ok(cfg: ArchConfig) -> bool:
    """True when every mixer in the pattern can route prefill attention
    through the flash kernel (attention-only; enc/dec cross-attn excluded)."""
    return not cfg.enc_dec and all(s.mixer == "attn" for s in cfg.pattern)


def prefill(
    params: PyTree,
    cfg: ArchConfig,
    prompt: torch.Tensor,
    cache: PyTree,
    *,
    length: torch.Tensor | None = None,
    memory: torch.Tensor | None = None,
    window: int | None = None,
    flash: bool | str = "auto",
) -> tuple[torch.Tensor, PyTree]:
    """Chunked prefill: the whole prompt in one forward, cache in one shot.

    ``flash="auto"`` takes the CUDA kernel when the prompt is on the card and
    the pattern supports it (the reference's "on a TPU"); on the CPU the
    reference path is faster than the kernel's plain version.
    """
    if flash == "auto":
        flash = prompt.device.type == "cuda" and flash_ok(cfg)
    return TF.prefill_forward(
        params, cfg, prompt, cache,
        length=length, memory=memory, window=window, flash=bool(flash),
    )


def prefill_sequential(
    params: PyTree,
    cfg: ArchConfig,
    prompt: torch.Tensor,
    cache: PyTree,
    *,
    memory: torch.Tensor | None = None,
    window: int | None = None,
) -> tuple[torch.Tensor, PyTree]:
    """Feed the prompt token by token through ``decode_step`` (exactly what
    incremental decoding gives; ``prefill`` is held to it)."""
    logits = None
    for i in range(prompt.shape[1]):
        logits, cache = TF.decode_step(params, cfg, prompt[:, i], cache,
                                       memory=memory, window=window)
    return logits, cache


def sample(logits: torch.Tensor, temperature: float,
           generator: torch.Generator | None) -> torch.Tensor:
    """(B, V) f32 logits -> (B,) int32 tokens: the first maximum at
    temperature 0 (as ``jnp.argmax``), else one draw per row from
    softmax(logits / temperature) with ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


@torch.no_grad()
def generate(
    params: PyTree,
    cfg: ArchConfig,
    prompt: torch.Tensor,
    cache: PyTree,
    *,
    steps: int,
    generator: torch.Generator | None = None,
    temperature: float = 0.0,
    memory: torch.Tensor | None = None,
) -> torch.Tensor:
    """Greedy (temperature 0) or sampled generation. prompt: (B, S0) ->
    (B, steps) int32. Sampling draws from ``generator``, which must be on the
    prompt's device (default: seeded 0 there)."""
    if temperature != 0.0 and generator is None:
        generator = torch.Generator(device=prompt.device).manual_seed(0)
    logits, cache = prefill(params, cfg, prompt, cache, memory=memory)
    toks = []
    for _ in range(steps):
        tok = sample(logits, temperature, generator)
        toks.append(tok)
        logits, cache = TF.decode_step(params, cfg, tok, cache, memory=memory)
    return torch.stack(toks, dim=1)
