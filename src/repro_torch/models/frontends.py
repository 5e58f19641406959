"""Stub modality frontends. The port of ``audio_frames`` and
``patch_embeddings`` from ``repro/models/frontends.py``.

The zoo's audio and VLM entries specify the transformer backbone only: no
mel-spectrogram codec and no ViT. These give synthetic embeddings of the
frontends' output shapes, drawn from a ``torch.Generator`` on its device:

- audio (whisper): (B, T_frames, d_model) frame embeddings, what the conv
  frontend would produce, for ``transformer.encode``;
- vlm (internvl2): (B, P, d_model) projected patch embeddings, the prefix
  ``transformer.forward(prefix_embeds=)`` puts ahead of the tokens.

``audio_frames_spec`` and ``patch_embeddings_spec`` are the dry-run's
stand-ins: empty tensors of the same shapes and dtype on the ``meta``
device, the counterpart of the reference's ``ShapeDtypeStruct``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig

__all__ = ["audio_frames", "patch_embeddings", "audio_frames_spec", "patch_embeddings_spec"]


def _embeddings(gen: torch.Generator, cfg: ArchConfig, batch: int, n: int) -> torch.Tensor:
    x = torch.randn((batch, n, cfg.d_model), generator=gen, device=gen.device)
    return (x * cfg.d_model**-0.5).to(cfg.dtype())


def audio_frames(gen: torch.Generator, cfg: ArchConfig, batch: int,
                 num_frames: int) -> torch.Tensor:
    """Synthetic encoder-input frame embeddings (stub for mel + conv)."""
    return _embeddings(gen, cfg, batch, num_frames)


def patch_embeddings(gen: torch.Generator, cfg: ArchConfig, batch: int,
                     num_patches: int) -> torch.Tensor:
    """Synthetic projected vision-patch embeddings (stub for ViT + projector)."""
    return _embeddings(gen, cfg, batch, num_patches)


def _spec(cfg: ArchConfig, batch: int, n: int) -> torch.Tensor:
    return torch.empty((batch, n, cfg.d_model), dtype=cfg.dtype(), device="meta")


def audio_frames_spec(cfg: ArchConfig, batch: int, num_frames: int) -> torch.Tensor:
    """(B, T_frames, d_model) frame embeddings on ``meta``."""
    return _spec(cfg, batch, num_frames)


def patch_embeddings_spec(cfg: ArchConfig, batch: int, num_patches: int) -> torch.Tensor:
    """(B, P, d_model) patch embeddings on ``meta``."""
    return _spec(cfg, batch, num_patches)
