"""Plan rewrite: the executor rules, fragment fusion and the checker.

Port of ``risingwave_tpu/frontend/opt``: the executor-graph rules
(``rules.py``: filter pushdown, projection fusion, noop-project elision,
column pruning), the fusion rule (``fusion.py``), the plan-property
checker that re-derives invariants after every rule (``checker.py``) and
the engine (``engine.py``). The fragment-graph rules
(``fragment_rules.py``) come with the fragmenter (``ROADMAP.md`` item
10d).
"""

from risingwave_tpu_torch.frontend.opt.checker import (    # noqa: F401
    CheckError, set_strict_checker, strict_checker,
)
from risingwave_tpu_torch.frontend.opt.engine import (     # noqa: F401
    EXECUTOR_RULE_NAMES, FRAGMENT_RULE_NAMES, FUSION_RULE_NAME,
    RULE_NAMES, RewriteReport, apply_rewrites, explain_with_rewrite,
    parse_fusion, parse_rules, plan_lane_stats, rewrite_history_rows,
    rewrite_stream_plan,
)
