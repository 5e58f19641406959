"""Append-only JSONL results store with resume semantics.

One sweep writes one JSONL file; every line is a self-describing record:

  {"kind": "run_start", "run_id": ..., "spec": {...}, "time": ...}
  {"kind": "round", "run_id": ..., "round": 0, "mean_acc": ..., ...}
  {"kind": "run_end", "run_id": ..., "status": "completed", "final": {...}}

Append-only makes the store crash-safe: a killed run simply lacks its
``run_end`` line and is re-executed on resume (its stale ``round`` records
are superseded — readers only consider records after the *latest*
``run_start`` of each run id). A truncated trailing line (power loss mid
write) is skipped on read.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Iterable

__all__ = ["ResultsStore"]


class ResultsStore:
    def __init__(self, path: str):
        self.path = str(path)
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)

    # -- writing ------------------------------------------------------------

    def append(self, record: dict[str, Any]) -> None:
        line = json.dumps(record, sort_keys=True, separators=(",", ":"))
        with open(self.path, "a") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())

    def append_lines(self, lines: Iterable[str]) -> None:
        """Merge pre-serialized JSONL lines (multi-process shard merge)."""
        with open(self.path, "a") as f:
            for line in lines:
                line = line.strip()
                if line:
                    f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())

    def run_start(self, run_id: str, spec: dict[str, Any]) -> None:
        self.append({"kind": "run_start", "run_id": run_id, "spec": spec,
                     "time": time.time()})  # lint: allow[D002] — provenance timestamp in the store record, not part of any result

    def round(self, run_id: str, record: dict[str, Any]) -> None:
        self.append({"kind": "round", "run_id": run_id, **record})

    def run_end(self, run_id: str, status: str, **extra: Any) -> None:
        self.append({"kind": "run_end", "run_id": run_id, "status": status,
                     "time": time.time(), **extra})  # lint: allow[D002] — provenance timestamp in the store record, not part of any result

    # -- reading ------------------------------------------------------------

    def records(self) -> list[dict[str, Any]]:
        if not os.path.exists(self.path):
            return []
        out: list[dict[str, Any]] = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # truncated trailing line from a crashed writer
        return out

    def load(self) -> dict[str, dict[str, Any]]:
        """One-pass view of the store keyed by run_id, latest attempt only.

        Returns ``{run_id: {"spec": ..., "rounds": [...], "end": run_end |
        None}}``. A newer ``run_start`` supersedes everything from earlier
        attempts of the same run — including an earlier *completed*
        ``run_end`` — so all readers (resume, curves, analysis joins) agree
        on which attempt a run's data comes from.
        """
        runs: dict[str, dict[str, Any]] = {}
        for r in self.records():
            rid = r.get("run_id")
            kind = r.get("kind")
            if rid is None:
                continue
            if kind == "run_start":
                runs[rid] = {"spec": r.get("spec", {}), "rounds": [], "end": None}
            elif rid in runs:
                if kind == "round":
                    runs[rid]["rounds"].append(r)
                elif kind == "run_end":
                    runs[rid]["end"] = r
        for run in runs.values():
            run["rounds"].sort(key=lambda r: r.get("round", 0))
        return runs

    @staticmethod
    def _is_completed(run: dict[str, Any]) -> bool:
        return run["end"] is not None and run["end"].get("status") == "completed"

    def completed(self) -> set[str]:
        """Run ids whose *latest* attempt has a completed ``run_end``."""
        return {rid for rid, run in self.load().items() if self._is_completed(run)}

    def specs(self) -> dict[str, dict[str, Any]]:
        """run_id -> spec dict from the latest run_start of each run."""
        return {rid: run["spec"] for rid, run in self.load().items()}

    def curves(self, run_id: str) -> list[dict[str, Any]]:
        """Round records of ``run_id``'s latest attempt, in round order."""
        run = self.load().get(run_id)
        return run["rounds"] if run else []

    def finals(self) -> dict[str, dict[str, Any]]:
        """run_id -> the latest attempt's run_end, completed attempts only."""
        return {
            rid: run["end"]
            for rid, run in self.load().items()
            if self._is_completed(run)
        }
