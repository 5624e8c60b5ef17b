"""Expression surgery and tree plumbing for plan rewrites.

Port of ``subst_expr`` (:61) and ``_swap_child`` (:90) of
``risingwave_tpu/frontend/opt/rules.py``: what fragment fusion needs to
compose projections and rebuild the paths it changes. Rules never
mutate their input plan (changed paths are shallow-copied, untouched
subtrees shared), so the checker can always fall back to the pre-rule
tree.
"""

from __future__ import annotations

import copy
from typing import List, Optional


def subst_expr(e, exprs: List):
    """Replace every InputRef(i) in `e` with exprs[i] (projection
    composition)."""
    from risingwave_tpu_torch.expr.expr import (
        BinaryOp, Case, Cast, FuncCall, InputRef, Literal, UnaryOp,
    )
    if isinstance(e, InputRef):
        return exprs[e.index]
    if isinstance(e, Literal):
        return e
    if isinstance(e, BinaryOp):
        return BinaryOp(e.op, subst_expr(e.left, exprs),
                        subst_expr(e.right, exprs))
    if isinstance(e, UnaryOp):
        return UnaryOp(e.op, subst_expr(e.child, exprs))
    if isinstance(e, Cast):
        return Cast(subst_expr(e.child, exprs), e.return_type)
    if isinstance(e, Case):
        return Case([(subst_expr(c, exprs), subst_expr(v, exprs))
                     for c, v in e.whens], subst_expr(e.else_, exprs))
    if isinstance(e, FuncCall):
        return FuncCall(e.name, [subst_expr(a, exprs) for a in e.args],
                        e.return_type)
    raise TypeError(f"unrewritable expression {type(e).__name__}")


def _swap_child(ex, attr: str, idx: Optional[int], new_child):
    """Shallow-copied parent with one child replaced (the child's schema
    is unchanged in every caller, so parent metadata holds)."""
    new = copy.copy(ex)
    if idx is None:
        setattr(new, attr, new_child)
    else:
        lst = list(getattr(ex, attr))
        lst[idx] = new_child
        setattr(new, attr, lst)
    return new
