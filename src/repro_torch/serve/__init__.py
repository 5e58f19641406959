"""Serving: chunked prefill, decode loops and the continuous-batching engine."""
