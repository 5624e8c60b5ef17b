"""Plan-property checker: re-derive invariants after every rewrite.

Port of ``risingwave_tpu/frontend/opt/checker.py`` (the executor-tree
half). A rule's output is never trusted: after each rule application the
engine re-checks structural integrity (every expression's InputRefs bind
inside its input's arity with matching types, join keys and agg indices
stay in range, fused runs bind against the raw input feeding them and
still run on the card), the root contract (same schema and stream key)
and append-only-ness. On a violation the engine falls back to the
pre-rule plan; in strict mode the violation raises instead, so a rule
that breaks an invariant can never hide behind the fallback.
"""

from __future__ import annotations

from typing import Iterable, Set

_STRICT = False


def set_strict_checker(on: bool) -> None:
    """Assert-don't-fallback mode (the port's tests and chip_smoke.py
    arm it)."""
    global _STRICT
    _STRICT = bool(on)


def strict_checker() -> bool:
    return _STRICT


class CheckError(ValueError):
    """A rewrite broke a plan invariant."""


def expr_refs(e) -> Set[int]:
    """Input column indices an expression reads."""
    from risingwave_tpu_torch.expr.expr import (
        BinaryOp, Case, Cast, FuncCall, InputRef, Literal, UnaryOp,
    )
    if isinstance(e, InputRef):
        return {e.index}
    if isinstance(e, Literal):
        return set()
    if isinstance(e, BinaryOp):
        return expr_refs(e.left) | expr_refs(e.right)
    if isinstance(e, (UnaryOp, Cast)):
        return expr_refs(e.child)
    if isinstance(e, Case):
        out = expr_refs(e.else_)
        for c, v in e.whens:
            out |= expr_refs(c) | expr_refs(v)
        return out
    if isinstance(e, FuncCall):
        out: Set[int] = set()
        for a in e.args:
            out |= expr_refs(a)
        return out
    raise CheckError(f"unknown expression node {type(e).__name__}")


def _expr_children(e) -> Iterable:
    from risingwave_tpu_torch.expr.expr import (
        BinaryOp, Case, Cast, FuncCall, UnaryOp,
    )
    if isinstance(e, BinaryOp):
        return (e.left, e.right)
    if isinstance(e, (UnaryOp, Cast)):
        return (e.child,)
    if isinstance(e, Case):
        return tuple(x for w in e.whens for x in w) + (e.else_,)
    if isinstance(e, FuncCall):
        return tuple(e.args)
    return ()


def _check_expr(e, schema, where: str) -> None:
    """Refs in range + ref types equal to the input field types."""
    from risingwave_tpu_torch.expr.expr import InputRef
    n = len(schema)
    for i in sorted(expr_refs(e)):
        if not (0 <= i < n):
            raise CheckError(f"{where}: InputRef({i}) out of range "
                             f"(input arity {n})")

    def walk(x):
        if isinstance(x, InputRef):
            if schema[x.index].data_type != x.return_type:
                raise CheckError(
                    f"{where}: InputRef({x.index}) typed "
                    f"{x.return_type} but input column is "
                    f"{schema[x.index].data_type}")
            return
        for c in _expr_children(x):
            walk(c)

    walk(e)


def _same_schema(a, b) -> bool:
    return (len(a) == len(b)
            and all(fa.name == fb.name and fa.data_type == fb.data_type
                    for fa, fb in zip(a, b)))


def _same_types(a, b) -> bool:
    return (len(a) == len(b)
            and all(fa.data_type == fb.data_type
                    for fa, fb in zip(a, b)))


def derive_append_only(ex) -> bool:
    """Conservative append-only derivation over the executor chain: the
    planner's own ``_derive_append_only`` (as the reference's checker
    calls it), so a chained MV's hint and the temporal join count here
    exactly as they do at planning. Unknown executors are assumed to
    retract."""
    from risingwave_tpu_torch.frontend.planner import StreamPlanner
    return StreamPlanner._derive_append_only(ex)


def snapshot(root) -> dict:
    """Baseline facts about the plan the rewrite must preserve."""
    return {
        "root_type": type(root),
        "schema": [(f.name, f.data_type) for f in root.schema],
        "pk": list(root.pk_indices),
        "append_only": derive_append_only(root),
    }


def check(root, baseline: dict) -> None:
    """Full invariant sweep; raises CheckError on the first violation."""
    if type(root) is not baseline["root_type"]:
        raise CheckError(
            f"rewrite replaced the plan root: {baseline['root_type']}"
            f" -> {type(root)}")
    got = [(f.name, f.data_type) for f in root.schema]
    if got != baseline["schema"]:
        raise CheckError(f"root schema changed: {baseline['schema']} "
                         f"-> {got}")
    if list(root.pk_indices) != baseline["pk"]:
        raise CheckError(f"root stream key changed: {baseline['pk']} "
                         f"-> {list(root.pk_indices)}")
    if baseline["append_only"] and not derive_append_only(root):
        raise CheckError("rewrite weakened derived append-only-ness")
    _verify(root, seen=set())


def _verify(ex, seen: Set[int]) -> None:
    from risingwave_tpu_torch.stream.executor import executor_children
    if id(ex) in seen:
        raise CheckError(
            f"executor {ex.identity} appears twice in the plan tree "
            "(a rule shared a rebuilt subtree)")
    seen.add(id(ex))
    for _attr, _i, child in executor_children(ex):
        _verify(child, seen)
    _verify_node(ex)


def _verify_node(ex) -> None:
    from risingwave_tpu_torch.stream.executors.fused import (
        FusedFragmentExecutor,
    )
    from risingwave_tpu_torch.stream.executors.hash_agg import (
        HashAggExecutor, agg_state_schema,
    )
    from risingwave_tpu_torch.stream.executors.hash_join import (
        HashJoinExecutor,
    )
    from risingwave_tpu_torch.stream.executors.materialize import (
        MaterializeExecutor,
    )
    from risingwave_tpu_torch.stream.executors.row_id_gen import (
        RowIdGenExecutor,
    )
    from risingwave_tpu_torch.stream.executors.simple import (
        FilterExecutor, ProjectExecutor,
    )
    from risingwave_tpu_torch.common.types import DataType

    name = type(ex).__name__
    for p in ex.pk_indices:
        if not (0 <= p < len(ex.schema)):
            raise CheckError(f"{name}: pk index {p} out of range")
    if isinstance(ex, ProjectExecutor):
        if len(ex.exprs) != len(ex.schema):
            raise CheckError("Project: expr/schema arity mismatch")
        for e, f in zip(ex.exprs, ex.schema):
            _check_expr(e, ex.input.schema, "Project")
            if e.return_type != f.data_type:
                raise CheckError(
                    f"Project: column {f.name} typed {f.data_type} "
                    f"but expr returns {e.return_type}")
        n_out = len(ex.schema)
        for in_col, specs in ex.watermark_derivations.items():
            if not (0 <= in_col < len(ex.input.schema)):
                raise CheckError(
                    f"Project: watermark derivation from input col "
                    f"{in_col} out of range")
            for spec in (specs if isinstance(specs, list) else [specs]):
                out = spec[0] if isinstance(spec, tuple) else spec
                if not (0 <= out < n_out):
                    raise CheckError(
                        f"Project: watermark derivation to output "
                        f"{out} out of range")
        return
    if isinstance(ex, FilterExecutor):
        _check_expr(ex.predicate, ex.input.schema, "Filter")
        if ex.predicate.return_type != DataType.BOOLEAN:
            raise CheckError("Filter: predicate is not boolean")
        if not _same_schema(ex.schema, ex.input.schema):
            raise CheckError("Filter: schema differs from input")
        return
    if isinstance(ex, RowIdGenExecutor):
        if len(ex.schema) != len(ex.input.schema) + 1 or \
                not _same_schema(list(ex.schema)[:-1],
                                 list(ex.input.schema)):
            raise CheckError("RowIdGen: schema is not input + _row_id")
        return
    if isinstance(ex, HashJoinExecutor):
        from risingwave_tpu_torch.frontend.opt.fusion import (
            join_side_ineligible_reason,
        )
        left, right = ex.sides
        eff_arity = 0
        for idx, (side, inp, lbl) in enumerate(
                ((left, ex.left_in, "left"),
                 (right, ex.right_in, "right"))):
            # a fused input side: the side's index space is the absorbed
            # run's OUTPUT schema, and the run re-verifies against the
            # raw input actually feeding it
            if side.fused_input is not None:
                _verify_fused_stages(side.fused_input, inp.schema,
                                     f"HashJoin[{lbl} fused]")
                r = join_side_ineligible_reason(ex, idx)
                if r is not None:
                    raise CheckError(
                        f"HashJoin[{lbl} fused]: ineligible ({r})")
                eff = side.fused_input.out_schema
            else:
                eff = inp.schema
            eff_arity += len(eff)
            if not _same_types(side.schema, eff):
                raise CheckError(
                    f"HashJoin: {lbl} side schema drifted from its "
                    "input")
            for k in side.key_indices:
                if not (0 <= k < len(eff)):
                    raise CheckError(
                        f"HashJoin: {lbl} key {k} out of range")
            if not _same_types(side.table.schema, eff):
                raise CheckError(
                    f"HashJoin: {lbl} state-table schema drifted")
            for p in side.table.pk_indices:
                if not (0 <= p < len(eff)):
                    raise CheckError(
                        f"HashJoin: {lbl} state pk {p} out of range")
        lt = [left.schema[i].data_type for i in left.key_indices]
        rt = [right.schema[i].data_type for i in right.key_indices]
        if lt != rt:
            raise CheckError("HashJoin: key types differ across sides")
        if len(ex.schema) != eff_arity:
            raise CheckError("HashJoin: output arity != left + right")
        return
    if isinstance(ex, HashAggExecutor):
        if ex.fused_stages is not None:
            from risingwave_tpu_torch.frontend.opt.fusion import (
                agg_ineligible_reason,
            )
            _verify_fused_stages(ex.fused_stages, ex.input.schema,
                                 "HashAgg[fused]")
            r = agg_ineligible_reason(ex)
            if r is not None:
                raise CheckError(f"HashAgg[fused]: ineligible ({r})")
            in_schema = ex.fused_stages.out_schema
        else:
            in_schema = ex.input.schema
        n_in = len(in_schema)
        for g in ex.group_indices:
            if not (0 <= g < n_in):
                raise CheckError(f"HashAgg: group index {g} out of "
                                 "range")
        for c in ex.agg_calls:
            if c.input_idx is not None and not (0 <= c.input_idx < n_in):
                raise CheckError(
                    f"HashAgg: call input {c.input_idx} out of range")
        sch, pk = agg_state_schema(in_schema, list(ex.group_indices),
                                   list(ex.agg_calls))
        if not _same_types(sch, ex.table.schema) or \
                pk != list(ex.table.pk_indices):
            raise CheckError("HashAgg: state-table schema/pk no longer "
                             "matches the input")
        if ex.append_only and not derive_append_only(ex.input):
            raise CheckError(
                "HashAgg: planned append-only but the rewritten input "
                "is not provably append-only")
        return
    if isinstance(ex, FusedFragmentExecutor):
        _verify_fused_stages(ex.fused_stages, ex.input.schema,
                             "FusedFragment")
        if not _same_types(ex.schema, ex.fused_stages.out_schema):
            raise CheckError(
                "FusedFragment: executor schema drifted from the "
                "composed run's output schema")
        return
    if isinstance(ex, MaterializeExecutor):
        if not _same_types(ex.schema, ex.input.schema):
            raise CheckError("Materialize: input schema drifted from "
                             "the MV table schema")
        return


def _verify_fused_stages(fs, input_schema, where: str) -> None:
    """A fused run must still bind against the raw input feeding it AND
    still run on the card."""
    if not _same_types(fs.in_schema, input_schema):
        raise CheckError(
            f"{where}: fused run planned against a different input "
            "schema than the one feeding it")
    for p in fs.preds:
        _check_expr(p, fs.body_schema, f"{where} pred")
    for e in (fs.out_exprs or []):
        _check_expr(e, fs.body_schema, f"{where} expr")
    r = fs.fusable_reason()
    if r is not None:
        raise CheckError(f"{where}: run is not traceable ({r})")
