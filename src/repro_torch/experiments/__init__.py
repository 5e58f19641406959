"""Experiment harness: specs, the JSONL store, the runner and the sweep CLI."""

from repro_torch.experiments.spec import ExperimentSpec, expand_grid  # noqa: F401
from repro_torch.experiments.store import ResultsStore  # noqa: F401
