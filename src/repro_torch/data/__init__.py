"""Synthetic MNIST-like data and the node-batched loader."""
