"""Rewrite engine: the rules to fixpoint, each checked, with fallback.

Port of ``risingwave_tpu/frontend/opt/engine.py``: ``parse_rules``
(:46), ``parse_fusion`` (:64), ``rewrite_stream_plan`` (:116) for the
specs ``"all"``, ``"none"`` and a comma list, ``apply_rewrites`` (:192)
and the EXPLAIN body. The executor rules run round-robin in registry
order until none fires (bounded rounds), then fragment fusion; after
EVERY rule application the plan-property checker re-derives the
invariants, and a violation (or a rule crash) falls back to the last
good plan and disables the rule for the rest of the run — in strict
mode it raises instead. The per-job firing log backs
``rewrite_history_rows``; the reference's rule counters
(``rewrite_rule_fired_total``) and its compiled-kernel cost footer in
EXPLAIN belong to the observability item (``ROADMAP.md`` item 12) and
are not ported.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

from risingwave_tpu_torch.frontend.opt import checker as _checker
from risingwave_tpu_torch.frontend.opt import rules as _rules

MAX_ROUNDS = 8

# applied in registry order each round: pushdown first (filters reach
# their sources before liveness is computed), fusion + elision shrink
# the chain, pruning runs over the settled shape; fragment fusion LAST
EXECUTOR_RULES = {
    "filter_pushdown": _rules.push_filters,
    "project_fusion": _rules.fuse_projects,
    "noop_project_elision": _rules.elide_noop_projects,
    "column_pruning": _rules.prune_columns,
}
EXECUTOR_RULE_NAMES = tuple(EXECUTOR_RULES)
# the fragment rules run on the fragmenter's graph (ROADMAP.md item 10d);
# the name is accepted in a spec, as the reference accepts it
FRAGMENT_RULE_NAMES = ("exchange_elision",)
RULE_NAMES = EXECUTOR_RULE_NAMES + FRAGMENT_RULE_NAMES

# fragment fusion rides its own knob (SET stream_fusion = on|off)
FUSION_RULE_NAME = "fusion_grouping"


def parse_rules(spec: Optional[str]):
    """'all' | 'none' | 'a,b,c' → frozenset of enabled rule names.
    Raises PlanError on an unknown rule (SET-time validation)."""
    from risingwave_tpu_torch.frontend.planner import PlanError
    s = (spec or "all").strip().lower()
    if s in ("all", ""):
        return frozenset(RULE_NAMES)
    if s == "none":
        return frozenset()
    names = [p.strip() for p in s.split(",") if p.strip()]
    unknown = [n for n in names if n not in RULE_NAMES]
    if unknown:
        raise PlanError(
            f"unknown rewrite rule(s) {unknown}; known: "
            f"{', '.join(RULE_NAMES)}")
    return frozenset(names)


def parse_fusion(spec: Optional[str]) -> bool:
    """SET stream_fusion validator: 'on' | 'off' → bool."""
    from risingwave_tpu_torch.frontend.planner import PlanError
    s = (spec or "on").strip().lower()
    if s in ("on", "true", "1"):
        return True
    if s in ("off", "false", "0"):
        return False
    raise PlanError(
        f"stream_fusion must be 'on' or 'off', got {spec!r}")


class RewriteReport:
    """What one rewrite run did: per-rule fire counts + fallbacks."""

    def __init__(self, label: str = ""):
        self.label = label
        self.fired: Dict[str, int] = {}
        self.details: List[Tuple[str, str]] = []   # (rule, detail)
        self.fallbacks: List[Tuple[str, str]] = []  # (rule, reason)

    @property
    def total_fired(self) -> int:
        return sum(self.fired.values())

    def summary(self) -> str:
        if not self.fired and not self.fallbacks:
            return "no rewrites fired"
        parts = [f"{n}={c}" for n, c in sorted(self.fired.items())]
        for rule, _reason in self.fallbacks:
            parts.append(f"{rule}=FALLBACK")
        return ", ".join(parts)


# process-global firing log: (seq, job, rule, fired, detail)
_HISTORY: List[tuple] = []
_HISTORY_CAP = 4096
_SEQ = [0]


def _record_history(job: str, rule: str, fired: int,
                    detail: str) -> None:
    _SEQ[0] += 1
    _HISTORY.append((_SEQ[0], job, rule, fired, detail))
    del _HISTORY[:-_HISTORY_CAP]


def rewrite_history_rows() -> List[tuple]:
    return list(_HISTORY)


def rewrite_stream_plan(root, spec: Optional[str] = "all",
                        label: str = "",
                        record: bool = True,
                        extra_rules: Optional[dict] = None,
                        fusion: bool = False,
                        dist_parallelism: int = 1,
                        device=None) -> Tuple[object, RewriteReport]:
    """Rewrite one executor tree to fixpoint. Returns the (possibly
    identical) new root and a report; outside strict mode it never
    raises for a misbehaving rule, which is dropped instead. ``fusion``
    enables the fragment-fusion rule (frontend/opt/fusion.py) on top of
    whatever ``spec`` enables, whose standalone blocks run on
    ``device`` (None: the card); ``extra_rules`` adds rules by name (the
    checker's tests). ``dist_parallelism`` other than 1 (the fragmenter's
    distributed plan, ``ROADMAP.md`` item 10d) raises."""
    if dist_parallelism != 1:
        from risingwave_tpu_torch.frontend.planner import not_ported
        raise not_ported("a rewrite at dist_parallelism > 1", "10d")
    report = RewriteReport(label)
    enabled = parse_rules(spec) & set(EXECUTOR_RULE_NAMES)
    registry: Dict[str, object] = dict(EXECUTOR_RULES)
    if fusion:
        from risingwave_tpu_torch.frontend.opt.fusion import (
            fuse_fragments,
        )
        registry[FUSION_RULE_NAME] = functools.partial(
            fuse_fragments, dist_parallelism=dist_parallelism,
            device=device)
        enabled = enabled | {FUSION_RULE_NAME}
    if extra_rules:
        registry.update(extra_rules)
        enabled = enabled | set(extra_rules)
    if not enabled:
        return root, report
    baseline = _checker.snapshot(root)
    disabled: set = set()
    for _round in range(MAX_ROUNDS):
        progressed = False
        for name, rule in registry.items():
            if name not in enabled or name in disabled:
                continue
            try:
                new_root, fired, detail = rule(root)
                if not fired:
                    continue
                _checker.check(new_root, baseline)
            except Exception as e:          # noqa: BLE001 — fallback
                if _checker.strict_checker():
                    raise AssertionError(
                        f"rewrite rule {name!r} broke a plan "
                        f"invariant: {e}") from e
                report.fallbacks.append((name, repr(e)[:200]))
                if record:
                    _record_history(label, name, 0,
                                    f"FALLBACK: {repr(e)[:160]}")
                disabled.add(name)
                continue
            root = new_root
            progressed = True
            report.fired[name] = report.fired.get(name, 0) + fired
            report.details.append((name, detail))
        if not progressed:
            break
    if record:
        for name, count in sorted(report.fired.items()):
            detail = "; ".join(d for n, d in report.details
                               if n == name)
            _record_history(label, name, count, detail)
    return root, report


def apply_rewrites(plan, spec: Optional[str], label: str = "",
                   fusion: bool = False, dist_parallelism: int = 1,
                   device=None) -> RewriteReport:
    """Rewrite a StreamPlan's consumer in place: the one deploy-path
    seam every session path goes through."""
    plan.consumer, report = rewrite_stream_plan(
        plan.consumer, spec, label=label, fusion=fusion,
        dist_parallelism=dist_parallelism, device=device)
    return report


def explain_with_rewrite(consumer, spec: Optional[str],
                         fusion: bool = False,
                         dist_parallelism: int = 1,
                         device=None) -> List[tuple]:
    """EXPLAIN body: the pre-rewrite tree, per-rule annotations (fusion
    groups included), the post-rewrite tree, lane stats."""
    from risingwave_tpu_torch.frontend.planner import explain_tree

    def stats_line(tag, root):
        s = plan_lane_stats(root)
        return (f"-- {tag} plan stats: executors={s['executors']} "
                f"total_lanes={s['total_lanes']} "
                f"max_width={s['max_lane_width']}",)

    pre = explain_tree(consumer)
    new_consumer, report = rewrite_stream_plan(
        consumer, spec, label="__explain__", record=False,
        fusion=fusion, dist_parallelism=dist_parallelism, device=device)
    rows = [("-- streaming plan (pre-rewrite):",)]
    rows += [(line,) for line in pre]
    rows.append(stats_line("pre-rewrite", consumer))
    rows.append((f"-- rewritten plan ({report.summary()}):",))
    for rule, detail in report.details:
        rows.append((f"--   rule {rule}: {detail}",))
    for rule, reason in report.fallbacks:
        rows.append((f"--   rule {rule}: FELL BACK ({reason})",))
    rows += [(line,) for line in explain_tree(new_consumer)]
    rows.append(stats_line("post-rewrite", new_consumer))
    return rows


def plan_lane_stats(root) -> Dict[str, float]:
    """Carried-lane stats over an executor tree: how many column lanes
    the plan moves between executors."""
    from risingwave_tpu_torch.stream.executor import executor_children
    widths: List[int] = []

    def walk(ex):
        widths.append(len(ex.schema))
        for _a, _i, c in executor_children(ex):
            walk(c)

    walk(root)
    total = sum(widths)
    return {
        "executors": len(widths),
        "total_lanes": total,
        "max_lane_width": max(widths) if widths else 0,
        "avg_lane_width": round(total / len(widths), 2)
        if widths else 0.0,
    }
