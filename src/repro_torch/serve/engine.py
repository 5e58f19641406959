"""Continuous batching: a slot scheduler over a fixed-capacity KV cache. The
port of ``repro/serve/engine.py``.

The engine holds a batched per-slot cache (``init_cache(per_slot=True)``) of
``slots`` rows. Requests are admitted into free slots as they arrive (a
chunked prefill into a fresh single-row cache, copied into the slot), every
active slot decodes one token per ``Engine.step`` through one
``serve_step``, and a finished sequence retires by freeing its slot.
Inactive slots decode tokens that the scheduler ignores, and a retired
slot's cache rows are overwritten whole at the next admission.

Restrictions, as in the reference: attention-only patterns (``engine_ok``).
The ring-buffer cache is padding-safe while the padded width never exceeds
the ring length; ``submit`` rejects prompts longer than ``cache_len`` and
admission caps the pad bucket at ``cache_len``.

The engine runs on the card unless ``device`` says otherwise, and its
parameters must already be there. Prefill goes through the CUDA
flash-attention kernel on the card (``flash="auto"``).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.serve import decode as SD
from repro_torch.tree import tree_leaves

__all__ = ["Engine", "engine_ok", "serve_step"]

PyTree = Any


def engine_ok(cfg: ArchConfig) -> bool:
    """True when cfg can serve through the continuous-batching engine:
    attention-only mixers (padding-safe ring cache), no encoder."""
    return not cfg.enc_dec and all(s.mixer == "attn" for s in cfg.pattern)


@torch.no_grad()
def serve_step(
    params: PyTree,
    cfg: ArchConfig,
    tok: torch.Tensor,
    cache: PyTree,
    generator: torch.Generator | None,
    *,
    temperature: float = 0.0,
) -> tuple[torch.Tensor, PyTree]:
    """Decode one token for every slot at once. tok: (slots,) last tokens;
    cache: the per-slot batched cache (advanced in place). Returns
    (next_tok (slots,) int32, cache). Inactive slots run too; the scheduler
    discards their output."""
    logits, cache = TF.decode_step(params, cfg, tok, cache)
    return SD.sample(logits, temperature, generator), cache


def _scatter_slot(cache: PyTree, row: PyTree, slot: int) -> PyTree:
    """Copy a single-row cache (batch 1) into batch position ``slot`` of the
    batched cache, in place. Leaves are (G, B, ...) / (G, B); row leaves
    (G, 1, ...) / (G, 1)."""
    for b, r in zip(tree_leaves(cache), tree_leaves(row)):
        if b is not None:
            b[:, slot] = r[:, 0]
    return cache


def _bucket(n: int, lo: int = 8) -> int:
    """Round a prompt length up to a power of two (the reference's prefill
    compile buckets; here they keep the pad widths few)."""
    return max(lo, 1 << (n - 1).bit_length())


@dataclasses.dataclass
class _Slot:
    rid: int = -1
    remaining: int = 0
    tokens: list = dataclasses.field(default_factory=list)


class Engine:
    """Continuous-batching serving engine over one model.

    >>> eng = Engine(params, cfg, slots=4, cache_len=64)
    >>> rid = eng.submit([1, 2, 3], max_new=16)
    >>> for ev in iter(eng.step, []):  # or: out = eng.run()
    ...     ...  # ev: {"rid", "token", "done"} per active slot, stream order

    temperature=0 is greedy and token-identical to ``decode.generate`` on the
    same prompt; temperature>0 samples per slot from a ``torch.Generator``
    seeded with ``seed`` on the parameters' device.
    """

    def __init__(
        self,
        params: PyTree,
        cfg: ArchConfig,
        *,
        slots: int = 4,
        cache_len: int = 64,
        temperature: float = 0.0,
        flash: bool | str = "auto",
        seed: int = 0,
        device=None,
    ):
        if not engine_ok(cfg):
            raise ValueError(
                "continuous batching needs an attention-only pattern "
                f"(got {[s.mixer for s in cfg.pattern]}, enc_dec={cfg.enc_dec}): "
                "recurrent mixers cannot admit right-padded prompts"
            )
        dev = resolve_device(device)
        p_dev = params["embed"].device
        if p_dev.type != dev.type:
            raise ValueError(f"the engine runs on {dev} but its parameters are on {p_dev}")
        self.device = p_dev
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.cache_len = cache_len
        self.temperature = temperature
        self.flash = flash
        self.cache = TF.init_cache(cfg, slots, cache_len, per_slot=True, device=p_dev)
        self.last_tok = np.zeros(slots, np.int32)
        self._slots = [_Slot() for _ in range(slots)]
        self._free = deque(range(slots))
        self._pending: deque = deque()
        self._finished: dict[int, np.ndarray] = {}
        self._next_rid = 0
        self._gen = torch.Generator(device=p_dev).manual_seed(seed)

    # -- scheduling --------------------------------------------------------

    def submit(self, prompt, *, max_new: int) -> int:
        """Queue a prompt; returns the request id. The request is admitted
        into a slot by the next ``step`` with capacity.

        The prompt must fit the cache: admission pads it (never past
        ``cache_len``) and prefills the padded row into the ring, which is
        only padding-safe while padded width <= ring length. Generation past
        ``cache_len`` is safe but degrades to ring/window semantics.
        """
        rid = self._next_rid
        self._next_rid += 1
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.size > self.cache_len:
            raise ValueError(
                f"prompt of {prompt.size} tokens does not fit "
                f"cache_len={self.cache_len}: padded prefill into the ring "
                "would silently drop prompt tokens and attend padding as "
                "real context — raise cache_len to at least the longest "
                "prompt"
            )
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        self._pending.append((rid, prompt, max_new))
        return rid

    def _admit(self) -> list[dict]:
        events = []
        while self._pending and self._free:
            rid, prompt, max_new = self._pending.popleft()
            slot = self._free.popleft()
            n = int(prompt.size)
            # Cap the pow2 bucket at cache_len: submit() guarantees
            # n <= cache_len, but the bucket above n can overshoot a
            # non-power-of-two cache_len, and padded width must never
            # exceed the ring (prefill_forward rejects that combination).
            padded = np.zeros((1, min(_bucket(n), self.cache_len)), np.int32)
            padded[0, :n] = prompt
            row = TF.init_cache(self.cfg, 1, self.cache_len, per_slot=True, device=self.device)
            logits, row = SD.prefill(
                self.params, self.cfg, torch.from_numpy(padded).to(self.device), row,
                length=torch.tensor([n], dtype=torch.int32, device=self.device),
                flash=self.flash,
            )
            tok = int(self._sample(logits)[0])
            _scatter_slot(self.cache, row, slot)
            self.last_tok[slot] = tok
            st = self._slots[slot]
            st.rid, st.remaining, st.tokens = rid, max_new - 1, [tok]
            events.append({"rid": rid, "token": tok, "done": max_new == 1})
            if max_new == 1:
                self._retire(slot)
        return events

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        return SD.sample(logits, self.temperature, self._gen).cpu().numpy()

    def _retire(self, slot: int) -> None:
        st = self._slots[slot]
        self._finished[st.rid] = np.asarray(st.tokens, np.int32)
        self._slots[slot] = _Slot()
        self._free.append(slot)

    # -- decoding ----------------------------------------------------------

    def step(self) -> list[dict]:
        """Admit pending requests, decode one token on every active slot.
        Returns the streamed events ({"rid", "token", "done"}); [] when idle
        (nothing pending, nothing active), so ``iter(eng.step, [])`` drains.
        """
        events = self._admit()
        active = [i for i, s in enumerate(self._slots) if s.rid >= 0]
        if not active:
            return events
        nxt, self.cache = serve_step(
            self.params, self.cfg, torch.from_numpy(self.last_tok).to(self.device),
            self.cache, self._gen, temperature=self.temperature,
        )
        self.last_tok = nxt.cpu().numpy()
        for i in active:
            st = self._slots[i]
            tok = int(self.last_tok[i])
            st.tokens.append(tok)
            st.remaining -= 1
            done = st.remaining <= 0
            events.append({"rid": st.rid, "token": tok, "done": done})
            if done:
                self._retire(i)
        return events

    def run(self) -> dict[int, np.ndarray]:
        """Drive until every submitted request has finished; returns
        {rid: generated tokens (max_new,)}."""
        while self._pending or any(s.rid >= 0 for s in self._slots):
            self.step()
        out, self._finished = self._finished, {}
        return out
