"""Knowledge-spread analytics: join graph properties with training curves.

Consumes a ResultsStore written by runner.py and produces the paper's
headline views:

- per-run summary rows (topology family, partitioner, seed, realized-graph
  properties, spectral gap, final/best accuracies, consensus trajectory);
- the hub-vs-leaf table (paper Fig. 3): for each topology family, how well
  G2 knowledge held only by hubs vs. only by leaves spreads to the nodes
  that never saw it (``g2_acc_spread``);
- the community-confusion view (paper Table 1) for runs on block graphs;
- ``BENCH_sweep.json`` — the machine-readable artifact CI uploads.

Everything is plain dict/list (no pandas in the container).
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

from repro_torch.experiments.store import ResultsStore

__all__ = [
    "summarize",
    "hub_vs_leaf_table",
    "qualitative_checks",
    "write_bench",
    "render_tables",
]


def _auc(xs: list[float]) -> float | None:
    """Mean of a curve — a rounds-robust 'how fast did it get there' scalar."""
    vals = [x for x in xs if x is not None]
    return float(np.mean(vals)) if vals else None


def summarize(store: ResultsStore) -> list[dict[str, Any]]:
    """One row per completed run: spec axes + graph properties + curve stats.

    One ``store.load()`` pass: runs whose latest attempt is incomplete or
    failed are excluded (same contract as ``ResultsStore.completed``).
    """
    from repro_torch.experiments.spec import family_of

    runs = store.load()
    rows: list[dict[str, Any]] = []
    for rid in sorted(runs):
        run = runs[rid]
        if not ResultsStore._is_completed(run):
            continue
        spec, end, curve = run["spec"], run["end"], run["rounds"]
        final = end.get("final", {})
        graph = final.get("graph", {})
        # Time-varying runs carry per-period summaries; regress against the
        # period mean, not the period-0 snapshot (which only describes the
        # first graph the schedule realized).
        gmean = final.get("graph_mean") or {}

        def gv(key: str) -> Any:
            return gmean.get(key, graph.get(key))

        row: dict[str, Any] = {
            "run_id": rid,
            "family": family_of(spec.get("topology", "?")),
            "topology": spec.get("topology"),
            "partitioner": spec.get("partitioner"),
            "backend": spec.get("backend"),
            "gossip_every": spec.get("gossip_every", 1),
            "kind": (spec.get("model") or {}).get("kind", "mlp"),
            "seed": spec.get("seed"),
            "rounds": len(curve),
            "wall_s": end.get("wall_s"),
            # graph side (period means for @regen/@rewire runs)
            "nodes": graph.get("nodes"),
            "edges": gv("edges"),
            "degree_mean": gv("degree_mean"),
            "degree_std": gv("degree_std"),
            "modularity": gv("modularity"),
            "clustering": gv("clustering"),
            "spectral_gap": gv("spectral_gap"),
            "topology_periods": final.get("graph_num_periods", 1),
            # training side (last round record)
            "final_acc": final.get("mean_acc"),
            "final_g1_acc": final.get("g1_acc"),
            "final_g2_acc": final.get("g2_acc"),
            # lm runs report spread as g2_token_spread (mean true-token
            # probability on foreign-domain tokens); the join treats the two
            # as one quantity so hub-vs-leaf tables work for both kinds.
            "final_g2_spread": final.get(
                "g2_acc_spread", final.get("g2_token_spread")
            ),
            "final_consensus": final.get("consensus_mean"),
            "final_loss": final.get("loss"),
            # curve stats
            "auc_acc": _auc([r.get("mean_acc") for r in curve]),
            "auc_g2_spread": _auc(
                [
                    r.get("g2_acc_spread", r.get("g2_token_spread"))
                    for r in curve
                ]
            ),
            # fault side (None for fault-free runs)
            "faults": spec.get("faults"),
            "alive_min": final.get("alive_min"),
            "recovery_rounds": final.get("recovery_rounds"),
        }
        if "community_confusion_offdiag" in final:
            row["community_confusion_offdiag"] = final["community_confusion_offdiag"]
        rows.append(row)
    return rows


def hub_vs_leaf_table(rows: list[dict[str, Any]]) -> dict[str, dict[str, Any]]:
    """Per topology family: G2 spread under hub_focused vs edge_focused splits,
    averaged over seeds. The paper's qualitative claim is hub > edge."""
    table: dict[str, dict[str, Any]] = {}
    for split in ("hub_focused", "edge_focused"):
        for r in rows:
            if r["partitioner"] != split or r.get("final_g2_spread") is None:
                continue
            fam = table.setdefault(r["family"], {})
            fam.setdefault(split, []).append(r["final_g2_spread"])
            fam.setdefault(f"{split}_auc", []).append(r.get("auc_g2_spread"))
    out: dict[str, dict[str, Any]] = {}
    for fam, cols in table.items():
        row = {k: _auc(v) for k, v in cols.items()}
        if row.get("hub_focused") is not None and row.get("edge_focused") is not None:
            row["hub_minus_edge"] = row["hub_focused"] - row["edge_focused"]
        out[fam] = row
    return out


def qualitative_checks(rows: list[dict[str, Any]]) -> dict[str, Any]:
    """The paper's qualitative orderings, as machine-checkable booleans.

    - hub_beats_edge: on every family with both splits, knowledge held by
      hubs spreads to non-holders better than knowledge held by leaves
      (compared on curve AUC, which is robust to both curves saturating).
    - gossip_learns_g2: under hub_focused splits, the nodes that never saw
      a G2 example end clearly above chance (1/10) on G2 — knowledge moved
      over the edges, not the data.
    - hub_kill_hurts_more: across faulted runs, killing hubs damages G2
      spread at least as much as killing leaves (hub-targeted churn's
      ``auc_g2_spread`` <= leaf-targeted churn's) — the paper's hub-vs-leaf
      centrality result, stress-tested under churn. None when the sweep has
      no targeted-churn pair.
    - lm_gossip_spreads: across lm runs, gossiped cohorts end with higher
      ``g2_token_spread`` (mean true-token probability on *other* nodes'
      domain tokens) than ``gossip_every=0`` isolation — domain knowledge
      moved over the edges, the paper's spread question on the token task.
      None when the sweep lacks either side of the comparison.
    """
    hub_edge = hub_vs_leaf_table(rows)
    per_family = {
        fam: bool(
            (cols.get("hub_focused_auc") or 0.0)
            > (cols.get("edge_focused_auc") or 0.0)
        )
        for fam, cols in hub_edge.items()
        if cols.get("hub_focused") is not None and cols.get("edge_focused") is not None
    }
    hub_spread = [
        r["final_g2_spread"]
        for r in rows
        if r.get("final_g2_spread") is not None and r["partitioner"] == "hub_focused"
    ]
    def targeted_auc(target: str) -> float | None:
        vals = [
            r.get("auc_g2_spread")
            for r in rows
            if r.get("faults") and f"targeted={target}" in r["faults"]
            and r.get("auc_g2_spread") is not None
        ]
        return float(np.mean(vals)) if vals else None

    hub_kill, leaf_kill = targeted_auc("hubs"), targeted_auc("leaves")

    def lm_spread(gossiped: bool) -> float | None:
        vals = [
            r["final_g2_spread"]
            for r in rows
            if r.get("kind") == "lm" and r.get("final_g2_spread") is not None
            and (r.get("gossip_every", 1) >= 1) == gossiped
        ]
        return float(np.mean(vals)) if vals else None

    lm_gossip, lm_isolated = lm_spread(True), lm_spread(False)
    return {
        "hub_beats_edge": all(per_family.values()) if per_family else None,
        "hub_beats_edge_by_family": per_family,
        "gossip_learns_g2": (float(np.mean(hub_spread)) > 0.13) if hub_spread else None,
        "hub_kill_hurts_more": (
            None if hub_kill is None or leaf_kill is None
            else bool(hub_kill <= leaf_kill)
        ),
        "hub_kill_auc_g2_spread": hub_kill,
        "leaf_kill_auc_g2_spread": leaf_kill,
        "lm_gossip_spreads": (
            None if lm_gossip is None or lm_isolated is None
            else bool(lm_gossip > lm_isolated)
        ),
        "lm_gossip_g2_token_spread": lm_gossip,
        "lm_isolated_g2_token_spread": lm_isolated,
    }


def write_bench(
    store: ResultsStore,
    out_path: str,
    *,
    rows: list[dict[str, Any]] | None = None,
    extra: dict | None = None,
) -> dict:
    """Write the sweep's machine-readable summary (BENCH_sweep.json).
    Pass ``rows`` to reuse an existing ``summarize(store)`` result."""
    if rows is None:
        rows = summarize(store)
    bench = {
        "bench": "topology_sweep",
        "store": store.path,
        "runs": len(rows),
        "summary": rows,
        "hub_vs_leaf": hub_vs_leaf_table(rows),
        "checks": qualitative_checks(rows),
        **(extra or {}),
    }
    with open(out_path, "w") as f:
        json.dump(bench, f, indent=2)
    return bench


def render_tables(rows: list[dict[str, Any]]) -> str:
    """Human-readable headline tables for the CLI."""
    lines: list[str] = []
    if not rows:
        return "(no completed runs)"
    lines.append("run summary:")
    hdr = ("family", "partitioner", "seed", "final_acc", "final_g2_spread",
           "final_consensus", "spectral_gap")
    lines.append("  " + "  ".join(f"{h:>16s}" for h in hdr))
    for r in rows:
        vals = []
        for h in hdr:
            v = r.get(h)
            vals.append(f"{v:16.4f}" if isinstance(v, float) else f"{str(v):>16s}")
        lines.append("  " + "  ".join(vals))
    he = hub_vs_leaf_table(rows)
    if he:
        lines.append("\nhub vs leaf G2 spread (final / AUC):")
        for fam, cols in sorted(he.items()):
            hub, edge = cols.get("hub_focused"), cols.get("edge_focused")
            ha, ea = cols.get("hub_focused_auc"), cols.get("edge_focused_auc")
            if hub is None or edge is None:
                continue
            lines.append(
                f"  {fam:>10s}: hub {hub:.4f}/{ha:.4f}  edge {edge:.4f}/{ea:.4f}  "
                f"delta {cols['hub_minus_edge']:+.4f}"
            )
    checks = qualitative_checks(rows)
    lines.append(f"\nchecks: {json.dumps(checks)}")
    return "\n".join(lines)
