"""SGD with momentum over node-stacked parameters."""
