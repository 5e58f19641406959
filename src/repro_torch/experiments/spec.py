"""Declarative experiment specs with grid expansion and stable run ids.

An ``ExperimentSpec`` pins everything one training run depends on: the
topology registry spec string, the data partitioner, the gossip backend and
matrix, the optimizer hyperparameters and the seed. Specs round-trip through
JSON, and ``run_id`` is a content hash of the canonical JSON — the same spec
always maps to the same id, which is what gives the results store its
skip-completed / resume semantics.

The paper's matrix is a cartesian product (topology family x split x seed);
``expand_grid`` builds it from a base dict plus per-axis value lists::

    specs = expand_grid(
        {"rounds": 40, "lr": 0.05},
        topology=["er:n=100", "ba:n=100,m=2"],
        partitioner=["hub_focused", "edge_focused"],
        seed=[0, 1, 2],
    )
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from typing import Any, Iterable

__all__ = ["ExperimentSpec", "expand_grid", "family_of", "PARTITIONERS"]


def family_of(topology: str) -> str:
    """Topology family name: the part of a spec string before ':' / '@'."""
    return topology.split("@", 1)[0].split(":", 1)[0].strip().lower()

# Names runner.py can dispatch (core/partition.py partitioners).
PARTITIONERS = ("iid", "hub_focused", "edge_focused", "community", "dirichlet")


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One fully-determined training run.

    Attributes:
      topology: registry spec string (``"ba:n=100,m=2"``; may carry an
        ``@regen=``/``@rewire=`` schedule suffix).
      partitioner: one of PARTITIONERS; graph-aware splits (hub/edge/
        community) use the realized period-0 graph.
      partitioner_params: extra kwargs for the partitioner (e.g.
        ``{"beta": 0.5}`` for dirichlet, ``{"frac": 0.2}`` for focused).
      backend: GossipEngine backend name or "auto".
      matrix: mixing matrix kind ("decavg" | "uniform" | "mh").
      rounds: communication rounds (for LM specs: train steps).
      eval_every: evaluate / stream a record every k rounds.
      data: overrides for data.synthetic.make_mnist_like (train_per_class...).
      model: model config; ``{"kind": "mlp", ...}`` (default) runs the
        paper-faithful DecentralizedTrainer (optional ``hidden=[...]`` for
        narrower members). The keys of the JAX package's other executors
        (``sparse_p_chunk``, ``fused``, ``compress`` and ``{"kind": "lm"}``)
        hash the same way here, so a spec keeps its run id across packages.
      faults: fault-injection spec string (core/faults.py grammar, e.g.
        ``"churn:p_leave=0.05,p_join=0.5@targeted=hubs"``), or None for a
        fault-free run. Expanded deterministically from ``seed``, and parsed
        here, so a malformed spec fails when it is made.
      tag: freeform grouping label — excluded from the run id.
    """

    topology: str
    partitioner: str = "iid"
    partitioner_params: dict[str, Any] = dataclasses.field(default_factory=dict)
    backend: str = "auto"
    matrix: str = "decavg"
    rounds: int = 10
    eval_every: int = 1
    lr: float = 0.05
    momentum: float = 0.9
    local_epochs: int = 1
    batch_size: int = 32
    gossip_every: int = 1
    same_init: bool = True
    seed: int = 0
    data: dict[str, Any] = dataclasses.field(default_factory=dict)
    model: dict[str, Any] = dataclasses.field(default_factory=dict)
    faults: str | None = None
    tag: str = ""

    def __post_init__(self):
        if self.partitioner not in PARTITIONERS:
            raise ValueError(
                f"unknown partitioner {self.partitioner!r}; one of {PARTITIONERS}"
            )
        if self.faults is not None:
            from repro_torch.core.faults import parse_faults

            parse_faults(self.faults)  # fail fast on a malformed spec
        if self.rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {self.rounds}")
        if self.eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got {self.eval_every}")
        kind = self.model.get("kind", "mlp")
        if kind not in ("mlp", "lm"):
            raise ValueError(f"unknown model kind {kind!r}; 'mlp' or 'lm'")

    # -- identity -----------------------------------------------------------

    # Fields added after the store format shipped: dropped from the content
    # hash while they hold their default, so every pre-existing JSONL store's
    # run ids — and their skip-completed semantics — survive the schema
    # growing. A non-default value (an actual fault spec) still hashes.
    # The JAX package's lint rule H001 holds its copy of this class to the
    # same discipline; tests/test_torch_slice.py holds the two run ids equal.
    _HASH_OPTIONAL = {"faults": None}

    # Same treatment for keys added to the ``model`` dict after the fact
    # (the dict hashes as a whole, so a new default-valued key would shift
    # every pre-existing run id). ``resume`` is always stripped: restoring a
    # checkpoint is an execution detail of the same run, not a new identity.
    _HASH_OPTIONAL_MODEL = {"compress": "auto", "fused": True}

    def canonical(self) -> dict[str, Any]:
        """Identity-bearing fields as a plain dict (tag excluded;
        later-generation fields excluded while at their default)."""
        d = dataclasses.asdict(self)
        d.pop("tag")
        for name, default in self._HASH_OPTIONAL.items():
            if d.get(name) == default:
                d.pop(name, None)
        model = dict(d.get("model") or {})
        model.pop("resume", None)
        for name, default in self._HASH_OPTIONAL_MODEL.items():
            if model.get(name, default) == default:
                model.pop(name, None)
        d["model"] = model
        return d

    @property
    def family(self) -> str:
        """Topology family name (the part before ':' / '@')."""
        return family_of(self.topology)

    @property
    def run_id(self) -> str:
        """Stable, human-scannable id: family-partitioner-s<seed>-<hash8>."""
        blob = json.dumps(self.canonical(), sort_keys=True, separators=(",", ":"))
        h = hashlib.sha256(blob.encode()).hexdigest()[:8]
        return f"{self.family}-{self.partitioner}-s{self.seed}-{h}"

    # -- JSON round-trip ----------------------------------------------------

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "ExperimentSpec":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown ExperimentSpec fields {sorted(unknown)}")
        return cls(**d)


def expand_grid(base: dict[str, Any], **axes: Iterable[Any]) -> list[ExperimentSpec]:
    """Cartesian product of ``axes`` value lists over a ``base`` spec dict.

    Each axis key must be an ExperimentSpec field; axis values win over
    ``base``. Returns specs in deterministic (itertools.product) order.
    """
    keys = sorted(axes)
    specs: list[ExperimentSpec] = []
    for combo in itertools.product(*(list(axes[k]) for k in keys)):
        d = dict(base)
        d.update(zip(keys, combo))
        specs.append(ExperimentSpec.from_json(d))
    ids = [s.run_id for s in specs]
    if len(set(ids)) != len(ids):
        raise ValueError("grid expansion produced duplicate run ids")
    return specs
