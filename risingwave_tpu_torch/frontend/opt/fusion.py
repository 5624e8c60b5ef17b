"""fusion_grouping: mark maximal fusable runs, emit fused executors.

Port of ``risingwave_tpu/frontend/opt/fusion.py``. Walks the executor
tree top-down and collapses maximal filter/project runs:

- a run ending at an ELIGIBLE HashAgg is absorbed by the agg as its
  prelude: the raw chunk is uploaded and ``agg_prelude`` (ops/fused.py)
  computes the packed key/input lanes on the card ahead of K1 + K2;
- a run feeding an eligible HashJoin side is absorbed by that side: the
  side's epoch upload is the raw matrix and ``join_prelude`` builds its
  [key | payload] lanes on the card;
- any other run of two or more stages becomes a standalone
  ``FusedFragmentExecutor`` (one ``fused_chain`` launch per chunk).

Eligibility is checked BEFORE anything changes, and the engine's checker
re-derives every plan invariant after the rule fires. An agg with an
injected sharded kernel (``build_q7(mesh=...)``) absorbs its run like any
other, but for a hop expansion (the routing is sized for the uploaded
rows). Distributed parallelism above 1 is the SQL planner's cut, which is
not ported, and is refused; so is hop absorption in general: the port has
no HopWindowExecutor yet.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

from risingwave_tpu_torch.stream.executor import executor_children

# which executor kinds each absorption shape accepts (the reference's
# sets; hop_window has no executor in the port yet)
AGG_KINDS = frozenset({"filter", "project", "hop_window"})
JOIN_KINDS = frozenset({"filter", "project", "row_id_gen"})
BLOCK_KINDS = JOIN_KINDS | {"watermark_filter", "hop_window"}


def _as_stage(ex, kinds=BLOCK_KINDS):
    """Fusable executor → FusedStage (kind-gated), else None."""
    from risingwave_tpu_torch.ops.fused import FusedStage
    from risingwave_tpu_torch.stream.executors.row_id_gen import (
        RowIdGenExecutor,
    )
    from risingwave_tpu_torch.stream.executors.simple import (
        FilterExecutor, ProjectExecutor,
    )
    from risingwave_tpu_torch.stream.executors.watermark_filter import (
        WatermarkFilterExecutor,
    )
    if isinstance(ex, FilterExecutor) and "filter" in kinds:
        return FusedStage("filter", "FilterExecutor",
                          exprs=(ex.predicate,))
    if isinstance(ex, ProjectExecutor) and "project" in kinds:
        return FusedStage(
            "project", "ProjectExecutor",
            exprs=tuple(ex.exprs),
            names=tuple(f.name for f in ex.schema),
            watermark_derivations=dict(ex.watermark_derivations))
    if isinstance(ex, RowIdGenExecutor) and "row_id_gen" in kinds:
        return FusedStage("row_id_gen", "RowIdGenExecutor", runtime=ex)
    if isinstance(ex, WatermarkFilterExecutor) \
            and "watermark_filter" in kinds:
        return FusedStage("watermark_filter", "WatermarkFilterExecutor",
                          time_col=ex.time_col, delay_usecs=ex.delay,
                          runtime=ex)
    return None


def _collect_run(top, kinds=BLOCK_KINDS) -> Tuple[list, object]:
    """Maximal consecutive fusable run starting at `top` going
    downstream→upstream. Returns (stages in DATAFLOW order, base)."""
    rev: List = []
    node = top
    while True:
        st = _as_stage(node, kinds)
        if st is None:
            break
        rev.append(st)
        node = node.input
    return list(reversed(rev)), node


def agg_ineligible_reason(agg) -> Optional[str]:
    """THE agg eligibility predicate (rule, adopt guard and checker all
    call it; `fused_stages is not None` is deliberately not a
    condition). A kernel that exists already (injected, or built by
    data) must still take a prelude: only a sharded kernel that has seen
    no data does. Host-side agg state reads the post-stage chunks (the
    multisets, sketches and the tier's touch), and host-typed group keys
    would need interning on the card."""
    k = agg._kernel
    if k is not None and not getattr(k, "supports_prelude", False):
        return "injected kernel without a prelude path"
    if agg.minput or agg.distinct_tables:
        return "retractable MIN/MAX or DISTINCT (host multisets)"
    if agg._hll_calls or agg._host_calls:
        return "host-side agg state (HLL/string_agg/array_agg)"
    if agg.tier_cap is not None:
        return "cold-tier governed (per-chunk host touch)"
    if agg.key_codec.interners:
        return "host-typed group keys (interning)"
    return None


def agg_fusable_reason(agg) -> Optional[str]:
    """None iff this HashAggExecutor can absorb a stage prelude NOW."""
    if agg.fused_stages is not None:
        return "already fused"
    return agg_ineligible_reason(agg)


def join_side_ineligible_reason(join, side_idx: int) -> Optional[str]:
    """THE join-side eligibility predicate (rule, adopt guard and checker
    all call it): the fused path needs the epoch dispatches (the prelude
    runs there; the sharded kernel has them too), and host-typed keys
    would need interning on the card (the port refuses the cold tier at
    construction)."""
    side = join.sides[side_idx]
    if not join._epoch_batch:
        return "per-chunk dispatch path (epoch batching off)"
    for i in side.key_indices:
        if not side.schema[i].data_type.is_device:
            return (f"host-typed join key column "
                    f"{side.schema[i].data_type.value} (interned)")
    return None


def join_side_fusable_reason(join, side_idx: int) -> Optional[str]:
    if join.sides[side_idx].fused_input is not None:
        return "already fused"
    return join_side_ineligible_reason(join, side_idx)


def fuse_fragments(root, dist_parallelism: int = 1, device=None
                   ) -> Tuple[object, int, str]:
    """The rule entry point. Non-destructive: copy-on-write along every
    mutated path so the engine's fallback plan stays intact. Standalone
    blocks run on ``device`` (None: the card); absorbed runs run on
    their agg's or join's device."""
    if dist_parallelism != 1:
        raise NotImplementedError(
            "fusion at distributed parallelism > 1 needs the SQL "
            "planner's sharded cut, which is not ported")
    from risingwave_tpu_torch.frontend.opt.rules import _swap_child
    from risingwave_tpu_torch.ops.fused import FusedStages
    from risingwave_tpu_torch.stream.executors.fused import (
        FusedFragmentExecutor,
    )
    from risingwave_tpu_torch.stream.executors.hash_agg import (
        HashAggExecutor,
    )
    from risingwave_tpu_torch.stream.executors.hash_join import (
        HashJoinExecutor,
    )
    details: List[str] = []

    def try_fuse_agg(agg):
        if agg_fusable_reason(agg) is not None:
            return None
        stages, base = _collect_run(agg.input, AGG_KINDS)
        if not stages:
            return None
        fs = FusedStages(base.schema, stages)
        reason = fs.fusable_reason()
        if reason is not None:
            details.append(f"agg run NOT fused ({reason})")
            return None
        if fs.hop is not None and agg._kernel is not None:
            # an injected (sharded) kernel sizes its routing for the
            # uploaded rows; a hop prelude multiplies them on the card
            details.append(
                "agg run NOT fused (hop expansion needs the single-device "
                "lazy kernel — sharded routing shapes are sized "
                "pre-expansion)")
            return None
        new_agg = copy.copy(agg)
        new_agg.adopt_fused_stages(fs, base)
        new_agg._info = copy.copy(agg._info)
        new_agg._info.identity = f"{agg.identity}[fused:{fs.describe()}]"
        details.append(f"agg absorbed {fs.describe()}")
        return new_agg

    def try_fuse_standalone(top):
        stages, base = _collect_run(top, BLOCK_KINDS)
        if len(stages) < 2:
            return None
        fs = FusedStages(base.schema, stages)
        reason = fs.fusable_reason()
        if reason is not None:
            details.append(f"run NOT fused ({reason})")
            return None
        details.append(f"block {fs.describe()}")
        return FusedFragmentExecutor(base, fs, device=device)

    def try_fuse_join(join):
        new_join = None
        for s, attr in ((0, "left_in"), (1, "right_in")):
            if join_side_fusable_reason(join, s) is not None:
                continue
            node = getattr(new_join if new_join is not None else join,
                           attr)
            stages, base = _collect_run(node, JOIN_KINDS)
            if not stages:
                continue
            fs = FusedStages(base.schema, stages)
            reason = fs.fusable_reason()
            if reason is not None:
                details.append(f"join side {s} run NOT fused ({reason})")
                continue
            if new_join is None:
                new_join = copy.copy(join)
                new_join.sides = tuple(copy.copy(sd) for sd in join.sides)
                new_join._info = copy.copy(join._info)
            new_join.adopt_fused_input(s, fs, base)
            details.append(f"join side {s} absorbed {fs.describe()}")
        if new_join is not None:
            descs = "; ".join(
                ("L:" if i == 0 else "R:") + sd.fused_input.describe()
                for i, sd in enumerate(new_join.sides)
                if sd.fused_input is not None)
            new_join._info.identity = \
                f"{join.identity}[fused:{descs}→join]"
        return new_join

    def walk(ex):
        """Top-down: an eligible agg/join absorbs its run BEFORE the
        generic descent could carve a standalone block out of it."""
        nonlocal fired
        if isinstance(ex, HashAggExecutor):
            fused = try_fuse_agg(ex)
            if fused is not None:
                fired += 1
                fused.input = walk(fused.input)   # fused is a copy
                return fused
        elif isinstance(ex, HashJoinExecutor):
            fused = try_fuse_join(ex)
            if fused is not None:
                fired += 1
                ex = fused
        elif _as_stage(ex) is not None:
            fused = try_fuse_standalone(ex)
            if fused is not None:
                fired += 1
                fused.input = walk(fused.input)
                return fused
        out = ex
        for attr, idx, child in executor_children(ex):
            new_child = walk(child)
            if new_child is not child:
                out = _swap_child(out, attr, idx, new_child)
        return out

    fired = 0
    new_root = walk(root)
    return new_root, fired, "; ".join(details)
