"""One-off reading behind ``chip_smoke.py`` phase 22's byte check: how far the
rise in ``torch.cuda.memory_allocated()`` lands from the dry-run's argument
bytes when llama3.2-1b's decode arguments (full width, batch 8, cache 1024)
are made on the card, with the caching allocator's default settings and
with expandable segments on. Each setting runs in a fresh process, so
neither sees the other's cached blocks.

By default a large block is not split when the rest of its segment is 1 MiB
or less, and ``memory_allocated`` then counts that rest too; with
expandable segments every block is its request rounded up to 512 bytes.

Run from the repo root: ``python3 tools/dryrun_alloc_probe.py``. Needs one
card with about 4 GB free; prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
BATCH, CACHE = 8, 1024


def measure() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import shapes as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as TF

    cfg = cfgbase.get("llama3.2-1b")
    shape = SH.InputShape("decode_probe", CACHE, BATCH, "decode")
    tr = DR.trace(cfg, make_host_mesh((1, 1), device="meta"), shape)
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    args = (TF.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev),
            torch.zeros(BATCH, dtype=torch.int32, device=dev),
            TF.init_cache(cfg, BATCH, CACHE, device=dev))
    torch.cuda.synchronize()
    rise = torch.cuda.memory_allocated() - base
    sizes = [x.numel() * x.element_size() for _p, x in DR.flat_leaves(args)]
    print(f"PYTORCH_CUDA_ALLOC_CONF={os.environ.get('PYTORCH_CUDA_ALLOC_CONF', '')!r}: "
          f"dry-run {tr.arg_bytes} bytes, allocated {rise} (+{rise - tr.arg_bytes} over "
          f"{len(sizes)} leaves; largest leaf {max(sizes)} bytes)", flush=True)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--measure":
        measure()
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for conf in ("", "expandable_segments:True"):
        env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": conf}
        res = subprocess.run([sys.executable, __file__, "--measure"], env=env, timeout=600)
        if res.returncode:
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
