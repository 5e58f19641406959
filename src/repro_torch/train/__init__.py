"""Losses, metrics and the decentralized trainer."""
