"""Batched serving driver: prefill a batch of prompts, decode with the KV
cache. The port of ``repro/launch/serve.py``: the same flags (it runs the
arch's ``.reduced()`` config), plus ``--device``.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --gen 32
      PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Every arch of ``configs.base.ASSIGNED_ARCHS`` serves; an enc-dec arch
(whisper-base) first encodes 32 stub frames into its decoder's memory.

Without ``--device`` it runs on the card, and raises where there is none.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import base as cfgbase
from repro_torch.device import device_name, resolve_device
from repro_torch.models import transformer as TF
from repro_torch.serve import decode as SD


def main(argv: list[str] | None = None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--long-context", action="store_true",
                    help="sliding-window ring cache instead of full cache")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = cfgbase.get(args.arch).reduced()
    params = TF.init_params(args.seed, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
                           device=dev)
    total = args.prompt_len + args.gen
    cache_len = SD.cache_len_for(cfg, total, long_context=args.long_context)
    cache = TF.init_cache(cfg, args.batch, cache_len, device=dev)

    kw = {}
    if cfg.enc_dec:
        # Stub audio: 32 frames of unit normals, encoded into the memory the
        # decoder cross-attends (the reference's frames).
        frames = torch.randn((args.batch, 32, cfg.d_model), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(2))
        with torch.no_grad():
            kw["memory"] = TF.encode(params, cfg, frames.to(cfg.dtype()))

    print(
        f"arch={cfg.arch_id} batch={args.batch} cache_len={cache_len} "
        f"({'sliding-window' if args.long_context else 'full'}) on {device_name(dev)}"
    )
    t0 = time.perf_counter()
    toks = SD.generate(
        params, cfg, prompt, cache, steps=args.gen,
        generator=torch.Generator(device=dev).manual_seed(args.seed + 2),
        temperature=args.temperature, **kw,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"generated {tuple(toks.shape)} in {dt:.1f}s = {args.batch * args.gen / dt:.1f} tok/s")
    print("first sequence:", toks[0, :16].tolist(), "...")
    return toks


if __name__ == "__main__":
    main()
