"""The comparison that decides ``correct``: each number that the cell's
kind of run yields (``bench/kinds/<kind>.py``) against its limit in
``bench/limits/<cell>.json``; a number with no limit there is reported and
not compared.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np

__all__ = ["load_limits", "judge"]


def load_limits(root: Path, cell: str) -> dict[str, float]:
    path = root / "bench" / "limits" / f"{cell}.json"
    if not path.exists():
        return {}
    return {k: float(v["limit"]) for k, v in json.loads(path.read_text())["limits"].items()}


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict[str, Any]]:
    """``correct`` and each compared number beside its limit. A cell with
    no limits is never correct."""
    checked = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers if k in limits}
    ok = bool(checked) and all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
                               for v in checked.values())
    return ok, checked
