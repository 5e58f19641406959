"""Synthetic LM token pipeline for the LLM-cohort trainer (numpy only).

A copy of ``repro/data/tokens.py``: the same functions, the same numpy
streams in the same order, so every array equals the reference's byte for
byte for the same arguments. That is what makes the LM parity tests exact
on data: neither package draws a token batch from its framework's RNG.

Zipf-distributed unigrams with a per-node "domain" bias: node i's stream
mixes a shared zipf background with a node-specific set of boosted tokens
(the LLM analogue of the paper's non-IID label skew). The zipf background
is truncated to the vocab by rejection resampling, so the head-heavy shape
survives. Every batch is a pure function of ``(seed, node, round)``: the
loop and fused paths draw the same tokens, a resumed run re-derives the
batches the interrupted run would have seen, and the fused path stages one
chunk of rounds at a time (``round_token_slab``). Labels are next-token.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "token_batches",
    "node_token_stream",
    "node_domain",
    "round_token_batch",
    "round_token_slab",
    "domain_eval_batch",
    "domain_query_batch",
]

# Seed-sequence stream tags: np.random.default_rng hashes the full tuple, so
# the per-round training draws, the fixed domain sets, and the held-out
# domain-eval draws are independent streams of one (seed, node) lineage.
_STREAM_TRAIN = 0
_STREAM_DOMAIN = 1
_STREAM_EVAL = 2
_STREAM_QUERY = 3


def _zipf_tokens(
    rng: np.random.Generator, a: float, size: int, vocab: int, *, max_tries: int = 32
) -> np.ndarray:
    """Truncated-zipf token ids in ``[0, vocab)``.

    Rejection-resamples draws past the vocab instead of folding them back
    with ``%``, so the head-heavy ordering (P(0) > P(1) > ...) survives
    truncation exactly. The residual tail after ``max_tries`` redraw passes
    (~0.3^32 of the mass at a=1.2, vocab=512) is clamped to the last token.
    """
    draw = rng.zipf(a, size=size).astype(np.int64)
    for _ in range(max_tries):
        bad = draw > vocab
        n_bad = int(bad.sum())
        if not n_bad:
            break
        draw[bad] = rng.zipf(a, size=n_bad).astype(np.int64)
    np.minimum(draw, vocab, out=draw)
    return draw - 1  # zipf support starts at 1


def node_domain(
    node: int, vocab: int, *, seed: int, domain_size: int = 64
) -> np.ndarray:
    """Node ``node``'s boosted "domain" token set — fixed for the whole run.

    Drawn from a dedicated stream so training batches, however many rounds
    are generated, never perturb which tokens a node's domain holds.
    """
    rng = np.random.default_rng((seed, node, _STREAM_DOMAIN))
    return rng.integers(0, vocab, size=domain_size)


def node_token_stream(
    node: int,
    length: int,
    vocab: int,
    *,
    seed: int,
    zipf_a: float = 1.2,
    domain_frac: float = 0.3,
    domain_size: int = 64,
) -> np.ndarray:
    """Token stream for one node: zipf background + node-domain boosts."""
    rng = np.random.default_rng((seed, node, _STREAM_TRAIN))
    bg = _zipf_tokens(rng, zipf_a, length, vocab)
    domain = node_domain(node, vocab, seed=seed, domain_size=domain_size)
    mask = rng.random(length) < domain_frac
    bg[mask] = domain[rng.integers(0, domain_size, size=int(mask.sum()))]
    return bg


def round_token_batch(
    num_nodes: int,
    round: int,
    batch: int,
    seq: int,
    vocab: int,
    *,
    seed: int = 0,
    zipf_a: float = 1.2,
    domain_frac: float = 0.3,
    domain_size: int = 64,
) -> tuple[np.ndarray, np.ndarray]:
    """One round's (tokens, labels), each (N, B, S) int32.

    A pure function of ``(seed, node, round)``: the per-round generator both
    run paths (and checkpoint resume) key their draws from.
    """
    chunk = batch * (seq + 1)
    toks = np.empty((num_nodes, batch, seq + 1), np.int32)
    for node in range(num_nodes):
        rng = np.random.default_rng((seed, node, _STREAM_TRAIN, round))
        bg = _zipf_tokens(rng, zipf_a, chunk, vocab)
        domain = node_domain(node, vocab, seed=seed, domain_size=domain_size)
        mask = rng.random(chunk) < domain_frac
        bg[mask] = domain[rng.integers(0, domain_size, size=int(mask.sum()))]
        toks[node] = bg.reshape(batch, seq + 1)
    return toks[:, :, :-1], toks[:, :, 1:]


def round_token_slab(
    num_nodes: int,
    rounds,
    batch: int,
    seq: int,
    vocab: int,
    *,
    seed: int = 0,
    **kw,
) -> tuple[np.ndarray, np.ndarray]:
    """Stack ``round_token_batch`` over a chunk of rounds: (L, N, B, S) x2.

    The fused path's staging unit: one slab per chunk of rounds, so memory
    holds O(chunk) rounds of tokens instead of the whole run.
    """
    ts, ls = zip(
        *(
            round_token_batch(
                num_nodes, int(r), batch, seq, vocab, seed=seed, **kw
            )
            for r in rounds
        )
    )
    return np.stack(ts), np.stack(ls)


def domain_eval_batch(
    num_nodes: int,
    batch: int,
    seq: int,
    vocab: int,
    *,
    seed: int = 0,
    domain_size: int = 64,
) -> tuple[np.ndarray, np.ndarray]:
    """Held-out per-node eval set of *other* nodes' domain tokens.

    Row i holds (B, S) sequences drawn uniformly from the concatenation of
    every domain set except node i's own — the token-task analogue of the
    mlp path's G2-spread eval (how well does node i model the data modes it
    never trained on?). Drawn from a dedicated stream, so it is disjoint
    from every training draw at any seed.
    """
    if num_nodes < 2:
        raise ValueError("domain_eval_batch needs >= 2 nodes (foreign domains)")
    domains = np.stack(
        [
            node_domain(i, vocab, seed=seed, domain_size=domain_size)
            for i in range(num_nodes)
        ]
    )
    toks = np.empty((num_nodes, batch, seq + 1), np.int32)
    for i in range(num_nodes):
        rng = np.random.default_rng((seed, i, _STREAM_EVAL))
        foreign = np.delete(domains, i, axis=0).reshape(-1)
        draw = foreign[rng.integers(0, foreign.size, size=batch * (seq + 1))]
        toks[i] = draw.reshape(batch, seq + 1)
    return toks[:, :, :-1], toks[:, :, 1:]


def domain_query_batch(
    domain_node: int,
    batch: int,
    seq: int,
    vocab: int,
    *,
    seed: int = 0,
    domain_size: int = 64,
    query_round: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Serve-time queries "about" one node's domain: (B, S) (tokens, labels)
    drawn uniformly from node ``domain_node``'s domain set.

    The router-eval analogue of ``domain_eval_batch``: a query stream whose
    token domain is known by construction, so serve accuracy can be compared
    across routing policies (does routing to the hub that *covers* this
    domain beat round-robin?). Dedicated stream tag + ``query_round`` keep
    the draws disjoint from training/eval and from each other.
    """
    dom = node_domain(domain_node, vocab, seed=seed, domain_size=domain_size)
    rng = np.random.default_rng((seed, domain_node, _STREAM_QUERY, query_round))
    draw = dom[rng.integers(0, dom.size, size=batch * (seq + 1))]
    toks = draw.reshape(batch, seq + 1).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def token_batches(
    num_nodes: int,
    batch: int,
    seq: int,
    vocab: int,
    *,
    steps: int,
    seed: int = 0,
):
    """Yield ``steps`` batches of (tokens, labels), each (N, B, S) int32.

    Thin generator over ``round_token_batch``: O(N·B·S) live memory
    regardless of ``steps``.
    """
    for s in range(steps):
        yield round_token_batch(num_nodes, s, batch, seq, vocab, seed=seed)
