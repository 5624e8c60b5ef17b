"""Plan rewrite: the fragment-fusion slice of the reference's engine.

Port of part of ``risingwave_tpu/frontend/opt``: the fusion rule
(``fusion.py``), the plan-property checker that re-derives invariants
after it fires (``checker.py``), the expression surgery it needs
(``rules.py``) and the engine (``engine.py``). The reference's other
executor rules (pushdown, projection fusion, pruning) and the fragment
rules are not ported yet.
"""

from risingwave_tpu_torch.frontend.opt.checker import (    # noqa: F401
    CheckError, set_strict_checker, strict_checker,
)
from risingwave_tpu_torch.frontend.opt.engine import (     # noqa: F401
    FUSION_RULE_NAME, RewriteReport, rewrite_stream_plan,
)
