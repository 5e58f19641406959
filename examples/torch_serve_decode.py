"""Batched serving demo on the PyTorch port: prefill + autoregressive
decode with a KV cache, including the sliding-window (long-context) cache
mode, for a reduced member of each assigned family.

The port of ``examples/serve_decode.py``, on the CUDA card by default.

Run:  PYTHONPATH=src python examples/torch_serve_decode.py
      PYTHONPATH=src python examples/torch_serve_decode.py --device cpu --gen 4
"""

import argparse
import time

import torch

from repro_torch.configs import base as cfgbase
from repro_torch.device import resolve_device
from repro_torch.models import frontends as FE
from repro_torch.models import transformer as TF
from repro_torch.serve import decode as SD


def demo(arch: str, dev: torch.device, *, batch: int = 4, prompt_len: int = 8, gen: int = 24) -> None:
    cfg = cfgbase.get(arch).reduced()
    params = TF.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    draw = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=draw, device=dev)

    kw = {}
    if cfg.enc_dec:
        frames = FE.audio_frames(torch.Generator(device=dev).manual_seed(2), cfg, batch, 16)
        kw["memory"] = TF.encode(params, cfg, frames)

    cache_len = prompt_len + gen
    cache = TF.init_cache(cfg, batch, cache_len, device=dev)
    t0 = time.perf_counter()
    toks = SD.generate(params, cfg, prompt, cache, steps=gen, temperature=0.8,
                       generator=torch.Generator(device=dev).manual_seed(3), **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"{arch:18s} generated {tuple(toks.shape)} in {dt:5.2f}s "
          f"({batch * gen / dt:6.1f} tok/s, cache_len={cache_len})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gen", type=int, default=24, help="tokens to generate a row")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"== batched sampling across the model zoo (reduced configs) on {dev} ==")
    for arch in ["llama3.2-1b", "rwkv6-3b", "jamba-v0.1-52b", "whisper-base"]:
        demo(arch, dev, gen=args.gen)

    print("\n== long-context mode: sliding-window ring cache ==")
    cfg = cfgbase.get("llama3.2-1b").reduced()  # window = 16 in the reduced cfg
    params = TF.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    window = cfg.sliding_window
    cache = TF.init_cache(cfg, 2, window, device=dev)  # ring buffer of window length only
    prompt = torch.randint(0, cfg.vocab_size, (2, 4),
                           generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    toks = SD.generate(params, cfg, prompt, cache, steps=3 * window)
    print(f"generated {toks.shape[1]} tokens through a {window}-slot ring cache "
          f"(position wrapped {3 * window // window}x) - O(window) memory at any length")


if __name__ == "__main__":
    main()
