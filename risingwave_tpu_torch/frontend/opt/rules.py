"""Executor-graph rewrite rules (the rule library).

Each rule is a pure tree-to-tree function `rule(root) -> (new_root,
fired, detail)`: it never mutates the input plan (changed paths are
rebuilt, untouched subtrees are shared), so a checker violation can
always fall back to the pre-rule tree. Rules:

- filter_pushdown     WHERE filters sink below joins (kind-gated: only
                      past sides the join never null-pads) and through
                      projections of plain column refs — the planner's
                      former inline pushdown, migrated here.
- project_fusion      Project∘Project composes into one projection
                      (watermark derivations compose too); a Filter
                      over a ref-only Project evaluates before it.
- noop_project_elision identity projections (same columns, same names)
                      drop out of the chain.
- column_pruning      live lanes are computed top-down; join inputs,
                      agg feeds and source scans narrow to the columns
                      actually referenced above — joins rebuild with
                      remapped keys and same-id narrowed state tables,
                      sources grow a narrowing projection.

Port of ``risingwave_tpu/frontend/opt/rules.py``: the same four rules
and the same expression surgery over the port's executors. A rebuilt
join keeps its device (``rebuild_opts``), so a pruned plan runs where
the planner put it.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Set, Tuple

from risingwave_tpu_torch.frontend.opt.checker import expr_refs
from risingwave_tpu_torch.stream.executor import ExecutorInfo, executor_children


# -- expression surgery ---------------------------------------------------


def remap_expr(e, mapping: Dict[int, int]):
    """Rebuild `e` with every InputRef index sent through `mapping`."""
    from risingwave_tpu_torch.expr.expr import (
        BinaryOp, Case, Cast, FuncCall, InputRef, Literal, UnaryOp,
    )
    if isinstance(e, InputRef):
        return InputRef(mapping[e.index], e.return_type)
    if isinstance(e, Literal):
        return e
    if isinstance(e, BinaryOp):
        return BinaryOp(e.op, remap_expr(e.left, mapping),
                        remap_expr(e.right, mapping))
    if isinstance(e, UnaryOp):
        return UnaryOp(e.op, remap_expr(e.child, mapping))
    if isinstance(e, Cast):
        return Cast(remap_expr(e.child, mapping), e.return_type)
    if isinstance(e, Case):
        return Case([(remap_expr(c, mapping), remap_expr(v, mapping))
                     for c, v in e.whens], remap_expr(e.else_, mapping))
    if isinstance(e, FuncCall):
        return FuncCall(e.name, [remap_expr(a, mapping) for a in e.args],
                        e.return_type)
    raise TypeError(f"unrewritable expression {type(e).__name__}")


def subst_expr(e, exprs: List):
    """Replace every InputRef(i) in `e` with exprs[i] (projection
    composition / pushdown-through-project)."""
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


# -- generic tree plumbing ------------------------------------------------


def _swap_child(ex, attr: str, idx: Optional[int], new_child):
    """Shallow-copied parent with one child replaced (the child's
    schema is unchanged in every caller, so parent metadata holds)."""
    new = copy.copy(ex)
    if idx is None:
        setattr(new, attr, new_child)
    else:
        lst = list(getattr(ex, attr))
        lst[idx] = new_child
        setattr(new, attr, lst)
    return new


def _has_watermark_source(ex) -> bool:
    """Does any executor below emit watermarks? (They originate at
    WatermarkFilterExecutor only.)"""
    from risingwave_tpu_torch.stream.executors.watermark_filter import (
        WatermarkFilterExecutor,
    )
    if isinstance(ex, WatermarkFilterExecutor):
        return True
    return any(_has_watermark_source(c)
               for _a, _i, c in executor_children(ex))


def _wm_spec_list(specs) -> list:
    if specs is None:
        return []
    return specs if isinstance(specs, list) else [specs]


# -- rule: noop project elision -------------------------------------------


def _is_noop_project(p) -> bool:
    from risingwave_tpu_torch.expr.expr import InputRef
    from risingwave_tpu_torch.stream.executors.simple import ProjectExecutor
    if not isinstance(p, ProjectExecutor):
        return False
    inp = p.input
    if len(p.exprs) != len(inp.schema):
        return False
    for i, (e, f, g) in enumerate(zip(p.exprs, p.schema, inp.schema)):
        if not (isinstance(e, InputRef) and e.index == i
                and f.name == g.name and f.data_type == g.data_type):
            return False
    if p.pk_indices and list(p.pk_indices) != list(inp.pk_indices):
        return False
    # watermark contract: a projection DROPS underivable watermarks;
    # eliding one is only transparent when its derivations are the
    # full identity, or nothing below produces watermarks at all
    wd = p.watermark_derivations
    identity = all(
        any((spec if not isinstance(spec, tuple) else -1) == i
            for spec in _wm_spec_list(wd.get(i)))
        for i in range(len(inp.schema)))
    return identity or not _has_watermark_source(inp)


def elide_noop_projects(root) -> Tuple[object, int, str]:
    fired = 0

    def walk(ex):
        nonlocal fired
        new = ex
        for attr, idx, child in executor_children(ex):
            c2 = walk(child)
            while _is_noop_project(c2):
                fired += 1
                c2 = c2.input
            if c2 is not child:
                new = _swap_child(new, attr, idx, c2)
        return new

    return walk(root), fired, f"{fired} identity projection(s) elided"


# -- rule: project/filter fusion ------------------------------------------


def _compose_derivations(p1, p2) -> dict:
    """Watermark derivations of Project(p2 ∘ p1): input col → specs in
    p2's output, transforms composed."""
    out: dict = {}
    for in_col, specs1 in p1.watermark_derivations.items():
        for s1 in _wm_spec_list(specs1):
            mid, f1 = s1 if isinstance(s1, tuple) else (s1, None)
            for s2 in _wm_spec_list(
                    p2.watermark_derivations.get(mid)):
                tgt, f2 = s2 if isinstance(s2, tuple) else (s2, None)
                if f1 is None and f2 is None:
                    spec = tgt
                elif f1 is None:
                    spec = (tgt, f2)
                elif f2 is None:
                    spec = (tgt, f1)
                else:
                    spec = (tgt,
                            (lambda v, _a=f1, _b=f2: _b(_a(v))))
                out.setdefault(in_col, []).append(spec)
    return out


def _ref_counts(e, counts: Dict[int, int]) -> None:
    """InputRef occurrence counts WITH multiplicity (a single expr
    referencing one column twice counts twice)."""
    from risingwave_tpu_torch.expr.expr import InputRef
    from risingwave_tpu_torch.frontend.opt.checker import _expr_children
    if isinstance(e, InputRef):
        counts[e.index] = counts.get(e.index, 0) + 1
        return
    for c in _expr_children(e):
        _ref_counts(c, counts)


def _fusable(p1, p2) -> bool:
    """Gate: composing must not duplicate non-trivial computation —
    every p1 expr that is not a bare ref/literal may be referenced at
    most once across p2's expressions (occurrences, not exprs)."""
    from risingwave_tpu_torch.expr.expr import InputRef, Literal
    counts: Dict[int, int] = {}
    for e in p2.exprs:
        _ref_counts(e, counts)
    return all(isinstance(p1.exprs[i], (InputRef, Literal))
               for i, n in counts.items() if n > 1)


def fuse_projects(root) -> Tuple[object, int, str]:
    from risingwave_tpu_torch.stream.executors.simple import (
        FilterExecutor, ProjectExecutor,
    )
    from risingwave_tpu_torch.expr.expr import InputRef
    fired = 0

    def try_fuse(c2):
        """One local fusion step at node c2 (or None)."""
        if isinstance(c2, ProjectExecutor) and \
                isinstance(c2.input, ProjectExecutor) and \
                _fusable(c2.input, c2):
            p1, p2 = c2.input, c2
            fused = ProjectExecutor(
                p1.input,
                [subst_expr(e, p1.exprs) for e in p2.exprs],
                [f.name for f in p2.schema],
                watermark_derivations=_compose_derivations(p1, p2))
            if p2.pk_indices:
                fused._info = ExecutorInfo(fused.schema,
                                           list(p2.pk_indices),
                                           fused.identity)
            return fused
        if isinstance(c2, FilterExecutor) and \
                isinstance(c2.input, ProjectExecutor):
            p = c2.input
            if all(isinstance(p.exprs[i], InputRef)
                   for i in expr_refs(c2.predicate)):
                # Filter(Project(X)) → Project(Filter(X)): the filter
                # runs before the projection materializes new columns
                inner = FilterExecutor(p.input,
                                       subst_expr(c2.predicate,
                                                  p.exprs))
                return _swap_child(p, "input", None, inner)
        return None

    def walk(ex):
        nonlocal fired
        new = ex
        for attr, idx, child in executor_children(ex):
            c2 = walk(child)
            while True:
                f = try_fuse(c2)
                if f is None:
                    break
                fired += 1
                c2 = f
            if c2 is not child:
                new = _swap_child(new, attr, idx, c2)
        return new

    return walk(root), fired, f"{fired} projection/filter fusion(s)"


# -- rule: filter pushdown below joins ------------------------------------


def _push_into_side(side_ex, pred):
    """Insert a filter below a join input, under its coalescer if one
    wraps the side (filtering before batching keeps batches dense)."""
    from risingwave_tpu_torch.stream.coalesce import CoalesceExecutor
    from risingwave_tpu_torch.stream.executors.simple import FilterExecutor
    if isinstance(side_ex, CoalesceExecutor):
        return _swap_child(side_ex, "input", None,
                           FilterExecutor(side_ex.input, pred))
    return FilterExecutor(side_ex, pred)


def push_filters(root) -> Tuple[object, int, str]:
    from risingwave_tpu_torch.stream.executors.hash_join import (
        HashJoinExecutor, JoinType,
    )
    from risingwave_tpu_torch.stream.executors.simple import FilterExecutor
    from risingwave_tpu_torch.stream.executors.temporal_join import (
        TemporalJoinExecutor,
    )
    fired = 0

    def try_push(f):
        """Filter f moves one level down (returns the replacement)."""
        j = f.input
        if isinstance(j, HashJoinExecutor) and \
                any(s.fused_input is not None for s in j.sides):
            # the join's input executors sit in the absorbed run's RAW
            # space — a join-space conjunct cannot move below them
            return None
        if isinstance(j, HashJoinExecutor) and j.join_type in (
                JoinType.INNER, JoinType.LEFT_OUTER,
                JoinType.RIGHT_OUTER, JoinType.FULL_OUTER):
            refs = expr_refs(f.predicate)
            n_left = j.n_left
            # legality by join kind: a conjunct may move below a side
            # only if that side is NOT null-padded by this join
            if refs <= set(range(n_left)) and j.join_type in (
                    JoinType.INNER, JoinType.LEFT_OUTER):
                new_j = copy.copy(j)
                new_j.left_in = _push_into_side(j.left_in, f.predicate)
                return new_j
            if refs and min(refs) >= n_left and j.join_type in (
                    JoinType.INNER, JoinType.RIGHT_OUTER):
                pred = remap_expr(f.predicate,
                                  {i: i - n_left for i in refs})
                new_j = copy.copy(j)
                new_j.right_in = _push_into_side(j.right_in, pred)
                return new_j
            return None
        if isinstance(j, TemporalJoinExecutor):
            # left side is never null-padded (inner and LEFT forms
            # both pad the right side only)
            n_left = len(j.left_in.schema)
            if expr_refs(f.predicate) <= set(range(n_left)):
                new_j = copy.copy(j)
                new_j.left_in = _push_into_side(j.left_in, f.predicate)
                return new_j
        return None

    def walk(ex):
        nonlocal fired
        new = ex
        for attr, idx, child in executor_children(ex):
            c2 = walk(child)
            while isinstance(c2, FilterExecutor):
                pushed = try_push(c2)
                if pushed is None:
                    break
                fired += 1
                c2 = pushed
            if c2 is not child:
                new = _swap_child(new, attr, idx, c2)
        return new

    # sink to fixpoint WITHIN one application: each walk moves a
    # filter at most one join level (the pushed filter lands inside a
    # rebuilt subtree the same walk does not revisit), and deep join
    # chains must not depend on the engine's round budget
    total = 0
    while True:
        before = fired
        root = walk(root)
        total += fired - before
        if fired == before:
            break
    return root, total, f"{total} filter(s) pushed below joins"


# -- rule: column pruning -------------------------------------------------


class _PruneStats:
    def __init__(self):
        self.pruned = 0


def prune_columns(root) -> Tuple[object, int, str]:
    """Top-down live-lane analysis + bottom-up narrowing rebuild.

    `_prune(ex, live)` returns (new_ex, mapping, changed): `mapping`
    maps every surviving old column index to its new index, or None
    for identity (schema untouched). Executors the pass does not
    understand recurse with full liveness — narrowing still propagates
    through reference bottlenecks (projections, join inputs, agg
    feeds) below them, but their own schema never changes."""
    stats = _PruneStats()
    new_root, mapping, _changed = _prune(root, None, stats)
    assert mapping is None, "pruning must not change the root schema"
    return (new_root, stats.pruned,
            f"{stats.pruned} column lane(s) pruned")


def _identity_or(mapping, n: int) -> Dict[int, int]:
    return mapping if mapping is not None else {i: i for i in range(n)}


def _prune(ex, live: Optional[Set[int]], stats,
           narrow_leaf: bool = True) -> tuple:
    """live=None means every output column is required. `narrow_leaf`
    is False when the caller is itself a projection: a source below
    one needs no extra narrowing projection (the projection already
    bounds what flows up — inserting another would never converge)."""
    from risingwave_tpu_torch.stream.coalesce import CoalesceExecutor
    from risingwave_tpu_torch.stream.executors.hash_agg import HashAggExecutor
    from risingwave_tpu_torch.stream.executors.hash_join import (
        HashJoinExecutor,
    )
    from risingwave_tpu_torch.stream.executors.row_id_gen import (
        RowIdGenExecutor,
    )
    from risingwave_tpu_torch.stream.executors.simple import (
        FilterExecutor, ProjectExecutor,
    )
    from risingwave_tpu_torch.stream.executors.source import SourceExecutor
    from risingwave_tpu_torch.stream.executors.watermark_filter import (
        WatermarkFilterExecutor,
    )

    n_out = len(ex.schema)
    live_full = (set(range(n_out)) if live is None
                 else set(live) | set(ex.pk_indices))

    if isinstance(ex, ProjectExecutor):
        return _prune_project(ex, live_full, stats)
    if isinstance(ex, FilterExecutor):
        req = live_full | expr_refs(ex.predicate)
        child, cmap, changed = _prune(ex.input, req, stats)
        if cmap is None:
            if not changed:
                return ex, None, False
            return _swap_child(ex, "input", None, child), None, True
        return (FilterExecutor(child,
                               remap_expr(ex.predicate, cmap)),
                cmap, True)
    if isinstance(ex, CoalesceExecutor):
        child, cmap, changed = _prune(ex.input, live_full, stats)
        if cmap is None:
            if not changed:
                return ex, None, False
            return _swap_child(ex, "input", None, child), None, True
        return (CoalesceExecutor(child, ex.target_rows,
                                 ex.max_chunks), cmap, True)
    if isinstance(ex, WatermarkFilterExecutor):
        from risingwave_tpu_torch.common.types import Interval
        req = live_full | {ex.time_col}
        child, cmap, changed = _prune(ex.input, req, stats)
        if cmap is None:
            if not changed:
                return ex, None, False
            return _swap_child(ex, "input", None, child), None, True
        return (WatermarkFilterExecutor(
            child, cmap[ex.time_col], Interval(usecs=ex.delay),
            ex.state), cmap, True)
    if isinstance(ex, RowIdGenExecutor):
        rid = n_out - 1
        req = {i for i in live_full if i != rid}
        child, cmap, changed = _prune(ex.input, req, stats)
        if cmap is None:
            if not changed:
                return ex, None, False
            return _swap_child(ex, "input", None, child), None, True
        new = RowIdGenExecutor(child, vnode_base=ex.vnode_base)
        mapping = dict(cmap)
        mapping[rid] = len(child.schema)
        return new, mapping, True
    if isinstance(ex, HashJoinExecutor):
        return _prune_join(ex, live_full, stats)
    if isinstance(ex, HashAggExecutor):
        return _prune_agg(ex, stats)
    if isinstance(ex, SourceExecutor):
        if not narrow_leaf or len(live_full) >= n_out:
            return ex, None, False
        keep = sorted(live_full)
        from risingwave_tpu_torch.expr.expr import InputRef
        proj = ProjectExecutor(
            ex, [InputRef(i, ex.schema[i].data_type) for i in keep],
            [ex.schema[i].name for i in keep],
            watermark_derivations={o: p for p, o in enumerate(keep)})
        stats.pruned += n_out - len(keep)
        return proj, {o: p for p, o in enumerate(keep)}, True
    # opaque executor: recurse with full liveness — children may still
    # narrow below their own reference bottlenecks, but this node's
    # schema (and therefore its parent's view) is untouched
    new = ex
    changed_any = False
    for attr, idx, child in executor_children(ex):
        c2, cmap, changed = _prune(child, None, stats)
        assert cmap is None
        if changed:
            new = _swap_child(new, attr, idx, c2)
            changed_any = True
    return new, None, changed_any


def _prune_project(p, live_full: Set[int], stats) -> tuple:
    from risingwave_tpu_torch.stream.executors.simple import ProjectExecutor
    n_out = len(p.schema)
    keep = sorted(live_full)
    req: Set[int] = set()
    for i in keep:
        req |= expr_refs(p.exprs[i])
    kept_set = set(keep)
    wd_kept = {}
    for in_col, specs in p.watermark_derivations.items():
        kept_specs = [
            s for s in _wm_spec_list(specs)
            if (s[0] if isinstance(s, tuple) else s) in kept_set]
        if kept_specs:
            wd_kept[in_col] = kept_specs
            req.add(in_col)
    child, cmap, changed = _prune(p.input, req, stats,
                                  narrow_leaf=False)
    if len(keep) == n_out and cmap is None:
        if not changed:
            return p, None, False
        return _swap_child(p, "input", None, child), None, True
    cmap = _identity_or(cmap, len(p.input.schema))
    out_map = {o: i for i, o in enumerate(keep)}
    new_wd: dict = {}
    for in_col, specs in wd_kept.items():
        new_wd[cmap[in_col]] = [
            (out_map[s[0]], s[1]) if isinstance(s, tuple)
            else out_map[s] for s in specs]
    new = ProjectExecutor(
        child, [remap_expr(p.exprs[i], cmap) for i in keep],
        [p.schema[i].name for i in keep],
        watermark_derivations=new_wd)
    if p.pk_indices:
        new._info = ExecutorInfo(new.schema,
                                 [out_map[i] for i in p.pk_indices],
                                 new.identity)
    stats.pruned += n_out - len(keep)
    if len(keep) == n_out:         # only the input was remapped
        return new, None, True
    return new, out_map, True


def _prune_join(j, live_full: Set[int], stats) -> tuple:
    from risingwave_tpu_torch.state.state_table import StateTable
    from risingwave_tpu_torch.stream.executors.hash_join import (
        HashJoinExecutor, JoinType,
    )
    if j.join_type not in (JoinType.INNER, JoinType.LEFT_OUTER,
                           JoinType.RIGHT_OUTER, JoinType.FULL_OUTER):
        # semi/anti outputs one side only; leave those plans alone
        return _prune_opaque_2(j, stats)
    if any(s.fused_input is not None for s in j.sides):
        # a fused input side's index space is the absorbed run's
        # OUTPUT schema — narrowing the raw input would unbind the
        # run (and fusion runs LAST, so this only happens on later
        # fixpoint rounds; the fused shape is final)
        return _prune_opaque_2(j, stats)
    left_side, right_side = j.sides
    n_left = j.n_left
    lreq = ({i for i in live_full if i < n_left}
            | set(left_side.key_indices)
            | set(left_side.table.pk_indices))
    rreq = ({i - n_left for i in live_full if i >= n_left}
            | set(right_side.key_indices)
            | set(right_side.table.pk_indices))
    lnew, lmap, lch = _prune(j.left_in, lreq, stats)
    rnew, rmap, rch = _prune(j.right_in, rreq, stats)
    if lmap is None and rmap is None:
        if not (lch or rch):
            return j, None, False
        new = copy.copy(j)
        new.left_in, new.right_in = lnew, rnew
        return new, None, True
    lmap = _identity_or(lmap, len(j.left_in.schema))
    rmap = _identity_or(rmap, len(j.right_in.schema))

    def table_for(t, m, schema):
        return StateTable(
            t.table_id, schema, [m[p] for p in t.pk_indices], t.store,
            dist_key_indices=([m[d] for d in t.dist_key_indices]
                              if t.dist_key_indices else None))

    lt = table_for(left_side.table, lmap, lnew.schema)
    rt = table_for(right_side.table, rmap, rnew.schema)
    inv_l = {v: k for k, v in lmap.items()}
    inv_r = {v: k for k, v in rmap.items()}
    old_fields = list(j.schema)
    names = ([old_fields[inv_l[p]].name
              for p in range(len(lnew.schema))]
             + [old_fields[n_left + inv_r[p]].name
                for p in range(len(rnew.schema))])
    opts = getattr(j, "rebuild_opts", {})
    new = HashJoinExecutor(
        lnew, rnew,
        [lmap[k] for k in left_side.key_indices],
        [rmap[k] for k in right_side.key_indices],
        lt, rt, output_names=names, join_type=j.join_type,
        actor_id=opts.get("actor_id", 0), mesh=opts.get("mesh"),
        shard_opts=opts.get("shard_opts"),
        state_cap=opts.get("state_cap"),
        device_payload=opts.get("device_payload", True),
        epoch_batch=opts.get("epoch_batch"), device=opts.get("device"))
    mapping = {old: new_i for old, new_i in lmap.items()}
    n_left_new = len(lnew.schema)
    for old, new_i in rmap.items():
        mapping[n_left + old] = n_left_new + new_i
    return new, mapping, True


def _prune_opaque_2(ex, stats) -> tuple:
    new = ex
    changed_any = False
    for attr, idx, child in executor_children(ex):
        c2, cmap, changed = _prune(child, None, stats)
        assert cmap is None
        if changed:
            new = _swap_child(new, attr, idx, c2)
            changed_any = True
    return new, None, changed_any


def _prune_agg(agg, stats) -> tuple:
    """Aggs keep every output (state layout is frozen at plan time);
    their input feed narrows to group keys + call inputs. SQL plans
    put a pre-agg projection there already, so the feed mapping stays
    identity and the narrowing continues below it — a non-identity
    mapping (hand-built chains) falls back to full liveness."""
    req = set(agg.group_indices) | {
        c.input_idx for c in agg.agg_calls if c.input_idx is not None}
    saved = stats.pruned
    child, cmap, changed = _prune(agg.input, req, stats)
    if cmap is not None:
        # bail path: the discarded pass's counts must not leak into
        # the rule's fired total (a phantom count would re-fire the
        # rule every round on an unchanged tree)
        stats.pruned = saved
        child, cmap, changed = _prune(agg.input, None, stats)
        assert cmap is None
    if not changed:
        return agg, None, False
    return _swap_child(agg, "input", None, child), None, True
