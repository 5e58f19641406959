"""The paper's MLP, node-batched."""
