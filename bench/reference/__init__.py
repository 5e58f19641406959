"""The plain reference: DecAvg in plain PyTorch, independent of the program."""
