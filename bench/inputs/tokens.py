"""The LM cohort's token batches, made from the run's seed.

A frozen copy of the repository's synthetic token streams (numpy only,
nothing of the program): zipf unigrams truncated to the vocabulary by
rejection resampling, with a share of each node's tokens drawn from its own
"domain" set; round ``r``'s batch of node ``i`` is a pure function of
(seed, i, r); labels are the next token.
"""

from __future__ import annotations

import numpy as np

__all__ = ["round_batch", "round_slab"]

_TRAIN, _DOMAIN = 0, 1  # stream tags of a (seed, node) lineage


def _zipf(rng: np.random.Generator, a: float, size: int, vocab: int, tries: int = 32) -> np.ndarray:
    """Zipf token ids in [0, vocab): draws past the vocabulary are drawn
    again, up to ``tries`` passes, and what is left is clamped to the last."""
    draw = rng.zipf(a, size=size).astype(np.int64)
    for _ in range(tries):
        bad = draw > vocab
        if not bad.any():
            break
        draw[bad] = rng.zipf(a, size=int(bad.sum())).astype(np.int64)
    np.minimum(draw, vocab, out=draw)
    return draw - 1


def _domain(node: int, vocab: int, seed: int, size: int) -> np.ndarray:
    return np.random.default_rng((seed, node, _DOMAIN)).integers(0, vocab, size=size)


def round_batch(nodes: int, round_: int, batch: int, seq: int, vocab: int, *, seed: int,
                zipf_a: float = 1.2, domain_frac: float = 0.3,
                domain_size: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """Round ``round_``'s (tokens, labels), each (nodes, batch, seq) int32."""
    n = batch * (seq + 1)
    toks = np.empty((nodes, batch, seq + 1), np.int32)
    for node in range(nodes):
        rng = np.random.default_rng((seed, node, _TRAIN, round_))
        draw = _zipf(rng, zipf_a, n, vocab)
        mask = rng.random(n) < domain_frac
        draw[mask] = _domain(node, vocab, seed, domain_size)[
            rng.integers(0, domain_size, size=int(mask.sum()))]
        toks[node] = draw.reshape(batch, seq + 1)
    return toks[:, :, :-1], toks[:, :, 1:]


def round_slab(nodes: int, rounds, batch: int, seq: int, vocab: int, *,
               seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``round_batch`` of each of ``rounds``, stacked: (rounds, nodes, batch,
    seq) twice."""
    ts, ls = zip(*(round_batch(nodes, int(r), batch, seq, vocab, seed=seed) for r in rounds))
    return np.stack(ts), np.stack(ls)
