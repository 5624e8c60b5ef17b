"""Rewrite engine: the rules to fixpoint, each checked, with fallback.

Port of ``rewrite_stream_plan`` (:116) of
``risingwave_tpu/frontend/opt/engine.py`` for ``spec="none"`` with the
fragment-fusion rule: after EVERY rule application the plan-property
checker re-derives the invariants; a violation (or a rule crash) falls
back to the last good plan and disables the rule for the rest of the
run — in strict mode it raises instead. The reference's executor rules
(pushdown, projection fusion, elision, pruning), its metrics and its
rewrite history are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

from risingwave_tpu_torch.frontend.opt import checker as _checker

MAX_ROUNDS = 8
FUSION_RULE_NAME = "fusion_grouping"


class RewriteReport:
    """What one rewrite run did: per-rule fire counts + fallbacks."""

    def __init__(self):
        self.fired: Dict[str, int] = {}
        self.details: List[Tuple[str, str]] = []   # (rule, detail)
        self.fallbacks: List[Tuple[str, str]] = []  # (rule, reason)


def rewrite_stream_plan(root, spec: Optional[str] = "none",
                        extra_rules: Optional[dict] = None,
                        fusion: bool = False,
                        dist_parallelism: int = 1,
                        device=None) -> Tuple[object, RewriteReport]:
    """Rewrite one executor tree to fixpoint. Returns the (possibly
    identical) new root and a report; outside strict mode it never
    raises for a misbehaving rule, which is dropped instead. ``fusion``
    enables the fragment-fusion rule (frontend/opt/fusion.py), whose
    standalone blocks run on ``device`` (None: the card);
    ``extra_rules`` adds rules by name (the checker's tests)."""
    if (spec or "none").strip().lower() != "none":
        raise NotImplementedError(
            "only spec='none' is ported: the executor rules (pushdown, "
            "projection fusion, pruning) are not")
    report = RewriteReport()
    registry: Dict[str, object] = {}
    if fusion:
        from risingwave_tpu_torch.frontend.opt.fusion import (
            fuse_fragments,
        )
        registry[FUSION_RULE_NAME] = functools.partial(
            fuse_fragments, dist_parallelism=dist_parallelism,
            device=device)
    if extra_rules:
        registry.update(extra_rules)
    if not registry:
        return root, report
    baseline = _checker.snapshot(root)
    disabled: set = set()
    for _round in range(MAX_ROUNDS):
        progressed = False
        for name, rule in registry.items():
            if name in disabled:
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
                disabled.add(name)
                continue
            root = new_root
            progressed = True
            report.fired[name] = report.fired.get(name, 0) + fired
            report.details.append((name, detail))
        if not progressed:
            break
    return root, report
