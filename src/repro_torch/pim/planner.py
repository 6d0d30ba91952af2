"""PIM offload planner: map a model's matmuls onto crossbar tiles.

Walks a model config's GEMM inventory (attention projections, FFN/expert
matmuls, embeddings/LM head) and produces the Section-VI crossbar cost of
serving it on a memristive PIM accelerator: total crossbars, memristors,
per-token latency (cycles and microseconds), energy proxy, and the
speedup over a FloatPIM-style mapping — i.e., the paper's Table III
scaled up from an 8-element mat-vec to full LM workloads.

:func:`plan_block` is the **full-block serving planner**: it lowers
every linear of a transformer block — attention q/k/v/o, both FFN
projections (including the MoE ragged path's per-expert GEMMs) and the
LM head — into *co-scheduled crossbar groups*. Linears in one scope
share crossbar passes: each gets a number of MAC chains packed by the
physical column budget (heterogeneous-K, proportional to its streamed
work — :func:`repro_torch.compiler.coschedule.column_budget_counts`), the
group compiles once through :meth:`repro_torch.engine.Engine.compile_group`
(weight-stationary: the fused schedule and the weights' crossbar layout
are reused by every decode step, zero recompiles), and the plan reports
per-scope cycles/MAC plus a per-token cycle estimate.

The port's copy of ``repro.pim.planner``. It reads a
:class:`repro_torch.configs.ModelConfig` (``d_model``, ``d_ff``,
``layer_kinds()``, ``moe``, ...) by duck typing, as the reference does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch import obs
from repro_torch.core.costmodel import CrossbarSpec, gemm_cost
from repro_torch.device.config import DeviceCapacityError, DeviceConfig

__all__ = ["GemmShape", "PIMPlan", "plan_model", "BlockLinear",
           "LinearGroup", "BlockPlan", "block_linears", "plan_block",
           "ServeSlotPlan", "plan_serve_slots", "gemms_from_config",
           "DeviceCapacityError"]


@dataclass(frozen=True)
class GemmShape:
    """One matmul of a model step: ``m`` x ``k`` @ ``k`` x ``n``, run
    ``count`` times per step."""

    name: str
    m: int          # rows per invocation (tokens)
    k: int
    n: int
    count: int = 1  # invocations per model step (e.g. layers)


@dataclass
class PIMPlan:
    """A model's GEMM inventory mapped onto crossbars (:func:`plan_model`),
    with per-GEMM and total cycles, memristors and crossbars."""

    gemms: List[GemmShape]
    n_bits: int
    spec: CrossbarSpec
    per_gemm: List[Dict] = field(default_factory=list)
    total_cycles: int = 0
    total_cycles_floatpim: int = 0
    total_memristors: int = 0
    total_crossbars: int = 0

    @property
    def speedup_vs_floatpim(self) -> float:
        """Cycles of the FloatPIM-style mapping over this plan's."""
        return self.total_cycles_floatpim / max(1, self.total_cycles)

    @property
    def latency_us(self) -> float:
        """Total cycles at the crossbar's cycle time, in microseconds."""
        return self.total_cycles * self.spec.cycle_ns / 1e3

    def summary(self) -> str:
        """Human-readable per-GEMM table and totals."""
        lines = [f"PIM plan ({self.n_bits}-bit, crossbar "
                 f"{self.spec.rows}x{self.spec.cols}):"]
        for g, c in zip(self.gemms, self.per_gemm):
            lines.append(
                f"  {g.name:<24} {g.m}x{g.k}x{g.n} x{g.count}: "
                f"{c['cycles']:>12,} cyc  {c['crossbars']:>6} xbars")
        lines.append(
            f"  TOTAL {self.total_cycles:,} cycles ({self.latency_us:,.1f} us"
            f" @ {self.spec.cycle_ns} ns), {self.total_crossbars} crossbars,"
            f" {self.total_memristors/1e9:.2f} G-memristors")
        lines.append(
            f"  vs FloatPIM mapping: {self.speedup_vs_floatpim:.1f}x faster")
        return "\n".join(lines)


def plan_model(gemms: List[GemmShape], n_bits: int = 8,
               spec: CrossbarSpec = CrossbarSpec()) -> PIMPlan:
    """Weight-stationary Section-VI crossbar cost of every GEMM, and the
    FloatPIM-style mapping's cycles beside it."""
    plan = PIMPlan(gemms=gemms, n_bits=n_bits, spec=spec)
    for g in gemms:
        # weight-stationary mapping (Fig. 5 with the weight matrix as A):
        # output features -> crossbar rows, activations stream as the
        # duplicated vector, one mat-vec pass per token.
        c = gemm_cost(g.n, g.k, g.m, n_bits, spec=spec)
        f = gemm_cost(g.n, g.k, g.m, n_bits, spec=spec, algo="floatpim")
        d = c.as_dict()
        d["cycles"] = c.cycles * g.count
        d["crossbars"] = c.crossbars
        plan.per_gemm.append(d)
        plan.total_cycles += c.cycles * g.count
        plan.total_cycles_floatpim += f.cycles * g.count
        plan.total_memristors += c.memristors * g.count
        plan.total_crossbars += c.crossbars * g.count
    return plan


# ===================================================== block serving ====
@dataclass(frozen=True)
class BlockLinear:
    """One linear of a transformer block, as the planner sees it:
    weight-stationary on the crossbar (``out_dim`` output features ->
    rows, ``in_dim`` elements streamed as MAC steps), ``count`` parallel
    instances per model step (layers of that kind x active experts)."""

    name: str
    scope: str            # "attn" | "ffn" | "head"
    in_dim: int
    out_dim: int
    count: int = 1

    @property
    def stream(self) -> int:
        """MAC steps per token per crossbar row (in_dim x instances)."""
        return self.in_dim * self.count


def block_linears(cfg) -> List[BlockLinear]:
    """The model's full linear inventory by PIM scope.

    Attention shapes come from the attention module itself
    (:func:`repro_torch.models.attention.projection_shapes`) so the
    planner cannot drift from what the blocks compute; FFN covers dense
    blocks, the MoE ragged path's active per-expert GEMMs and the RG-LRU
    block MLP; the LM head is its own scope. The router and the
    recurrent gate projections stay digital (tiny, latency-critical).
    """
    from repro_torch.models.attention import projection_shapes
    d = cfg.d_model
    nm3 = cfg.mlp_type == "swiglu"
    kinds = cfg.layer_kinds()
    n_attn = sum(1 for k in kinds if k in ("g", "l", "m", "d"))
    n_dense = sum(1 for k in kinds if k in ("g", "l"))
    n_moe = sum(1 for k in kinds if k == "m")
    n_dmoe = sum(1 for k in kinds if k == "d")
    n_rglru = (sum(1 for k in kinds if k == "r")
               if cfg.family != "rwkv" else 0)

    # Whisper-style encoders run plain self-attention blocks through the
    # same hooks (encode() scales the config but keeps the PIM flags),
    # so their q/k/v/o and FFN projections count toward the same scopes.
    n_enc = cfg.enc_layers if cfg.family == "encdec" else 0

    out: List[BlockLinear] = []
    if n_attn or n_enc:
        for name, i, o in projection_shapes(cfg):
            # cross-attention (attn.x*) lives only in decoder blocks
            count = n_attn if name.startswith("attn.x") else n_attn + n_enc
            if count:
                out.append(BlockLinear(name, "attn", i, o, count))

    def ffn(tag: str, f: int, count: int) -> None:
        if not count:
            return
        out.append(BlockLinear(f"{tag}.w1", "ffn", d, f, count))
        if nm3:
            out.append(BlockLinear(f"{tag}.w3", "ffn", d, f, count))
        out.append(BlockLinear(f"{tag}.w2", "ffn", f, d, count))

    ffn("ffn", cfg.d_ff, n_dense + n_rglru + n_enc)
    if n_moe:
        e = cfg.moe
        ffn("moe.expert", cfg.d_ff, n_moe * (e.top_k + e.n_shared))
    if n_dmoe:
        ffn("moe.dense", cfg.moe.d_ff_dense or cfg.d_ff, n_dmoe)
    out.append(BlockLinear("lm_head", "head", d, cfg.vocab_size, 1))
    return out


@dataclass
class LinearGroup:
    """One co-scheduled crossbar group: every linear in ``linears``
    shares the group's fused passes, linear ``i`` owning ``chains[i]``
    MAC chains in its private partition/column range."""

    scope: str
    linears: List[BlockLinear]
    chains: List[int]
    pass_cycles: int
    cols_used: int
    n_bits: int
    staging_cycles: int
    # Measured cycle count of one compiled 2n-bit recombination program
    # (the merge-tree rung). 0 means "no engine pass" (deserialized
    # metrics) — fall back to the analytic 5*(2n) ripple-add budget.
    recomb_cycles: int = 0
    # The compiled GroupedExecutable behind this group (None for plans
    # built without an engine pass, e.g. deserialized metrics). Serve's
    # --trace path reads its fused program/packed tables to emit the
    # crossbar-waterfall tracks; excluded from repr to keep summaries
    # readable.
    executable: Optional[object] = field(default=None, repr=False)
    # Physical placement in a device hierarchy: the crossbar coordinate
    # a placer assigned (:class:`repro_torch.device.Coord`), or None for the
    # flat single-crossbar-per-group model.
    coord: Optional[object] = None

    @property
    def macs_per_pass(self) -> int:
        """MAC chains the group's fused pass serves."""
        return sum(self.chains)

    @property
    def cycles_per_mac(self) -> float:
        """Pass cycles amortized over the pass's MACs."""
        return self.pass_cycles / max(1, self.macs_per_pass)

    @property
    def passes_per_token(self) -> int:
        """Lockstep passes to drain the longest member stream."""
        return max(-(-l.stream // c)
                   for l, c in zip(self.linears, self.chains))

    @property
    def cycles_per_token(self) -> int:
        """Fused passes + inter-pass staging + the worst member's
        carry-save chain merge / final recombination (in-row ripple
        adds, chains sit in disjoint column ranges of the same rows)."""
        p = self.passes_per_token
        base = self.recomb_cycles or 5 * (2 * self.n_bits)
        recomb = base * (
            1 + max(math.ceil(math.log2(c)) if c > 1 else 0
                    for c in self.chains))
        return p * self.pass_cycles + (p - 1) * self.staging_cycles + recomb

    @property
    def rows(self) -> int:
        """Crossbar rows the group engages (SIMD axis = the widest
        member's output features)."""
        return max(l.out_dim for l in self.linears)

    @property
    def row_utilization(self) -> float:
        """Chain-weighted share of engaged rows doing useful work
        (members narrower than the widest leave rows idle)."""
        busy = sum(c * l.out_dim for l, c in zip(self.linears, self.chains))
        return busy / (self.rows * max(1, self.macs_per_pass))


@dataclass
class BlockPlan:
    """Full-block PIM serving plan: co-scheduled crossbar groups, one or
    more per scope. Groups of one scope occupy *separate* crossbars and
    run in parallel (weight-stationary — every crossbar keeps its
    weights resident across decode steps); scopes execute sequentially
    (attention feeds the FFN feeds the head)."""

    n_bits: int
    groups: List[LinearGroup] = field(default_factory=list)
    # Group labels the planner shed because the device ran out of
    # healthy crossbars (``plan_block(..., on_capacity="shed")``); empty
    # under the default raising policy.
    shed: List[str] = field(default_factory=list)

    def scope_groups(self, scope: str) -> List[LinearGroup]:
        """The groups of one scope."""
        return [g for g in self.groups if g.scope == scope]

    @property
    def scopes(self) -> List[str]:
        """Scopes in plan order."""
        return list(dict.fromkeys(g.scope for g in self.groups))

    @property
    def cycles_per_token(self) -> int:
        """Sequential over scopes, parallel over a scope's crossbars."""
        return sum(max(g.cycles_per_token for g in self.scope_groups(s))
                   for s in self.scopes)

    def scope_metrics(self) -> Dict[str, Dict]:
        """Per-scope accounting rows (what serve logs and BENCH track).
        A scope's parallel crossbars aggregate as one wide pass: their
        pass windows coincide (same MAC schedule), so the scope serves
        the summed MACs per pass window."""
        out: Dict[str, Dict] = {}
        for scope in self.scopes:
            gs = self.scope_groups(scope)
            macs = sum(g.macs_per_pass for g in gs)
            pass_cycles = max(g.pass_cycles for g in gs)
            out[scope] = {
                "linears": [l.name for g in gs for l in g.linears],
                "chains": [c for g in gs for c in g.chains],
                "crossbars": len(gs),
                "macs_per_pass": macs,
                "pass_cycles": pass_cycles,
                "cycles_per_mac": pass_cycles / max(1, macs),
                "passes_per_token": max(g.passes_per_token for g in gs),
                "cycles_per_token": max(g.cycles_per_token for g in gs),
                "cols_used": sum(g.cols_used for g in gs),
                "row_utilization": (
                    sum(g.row_utilization * g.macs_per_pass for g in gs)
                    / max(1, macs)),
            }
        return out

    def summary(self) -> str:
        """Human-readable per-group table and the per-token total."""
        lines = [f"block PIM plan ({self.n_bits}-bit, "
                 f"{len(self.groups)} co-scheduled groups):"]
        for g in self.groups:
            names = ",".join(l.name for l in g.linears)
            lines.append(
                f"  [{g.scope}] {names}: chains={g.chains} "
                f"({g.macs_per_pass} MACs/pass, {g.cols_used} cols), "
                f"{g.pass_cycles} cyc/pass -> {g.cycles_per_mac:.1f} "
                f"cyc/MAC, {g.passes_per_token} passes/token "
                f"({g.cycles_per_token:,} cyc)")
        if self.groups:
            lines.append(f"  TOTAL {self.cycles_per_token:,} cycles/token")
        if self.shed:
            lines.append(f"  SHED {len(self.shed)} group"
                         f"{'s' if len(self.shed) != 1 else ''} "
                         f"(device capacity): {', '.join(self.shed)}")
        return "\n".join(lines)


def plan_block(cfg, engine=None,
               scopes: Optional[Tuple[str, ...]] = None,
               placer=None, on_capacity: str = "raise") -> BlockPlan:
    """Lower a model's block linears onto co-scheduled crossbar groups.

    ``scopes`` defaults to what the config's PIM flags enable
    (``cfg.pim_scopes()``). Per scope, all
    linears share one heterogeneous group: chain counts are packed by
    the engine's physical column budget weighted by each linear's
    streamed work (``in_dim x count``), and the fused schedule compiles
    once through :meth:`Engine.compile_group` — decode steps reuse the
    memoized weight-stationary layout, so serving pays compilation
    exactly once per (scope, width).

    ``placer`` maps each group onto a physical crossbar of a device
    hierarchy: any ``placer(label, scope) -> coordinate`` callable
    (:meth:`repro_torch.device.CoordAllocator.place` is the stock one). The
    returned coordinate lands in :attr:`LinearGroup.coord`; without a
    placer groups keep the flat parallel-crossbars model
    (``coord=None``). The planner itself stays device-agnostic — it
    only calls back.

    ``on_capacity`` decides what happens when the placer raises
    :class:`repro_torch.device.DeviceCapacityError`: ``"raise"`` (default)
    propagates — a plan that does not fit the device is an error;
    ``"shed"`` degrades gracefully — the group is dropped *before* its
    compile (no wasted compilation), its label is recorded in
    :attr:`BlockPlan.shed`, and the shortfall lands on the
    ``plan.capacity_shed`` counter so operators see exactly which
    groups a degraded device stopped serving.
    """
    from repro_torch.engine import GroupSpec, get_engine
    if on_capacity not in ("raise", "shed"):
        raise ValueError(f"on_capacity {on_capacity!r} not in "
                         f"('raise', 'shed')")
    eng = engine if engine is not None else get_engine()
    scopes = cfg.pim_scopes() if scopes is None else scopes
    n = cfg.pim_linear_bits
    plan = BlockPlan(n_bits=n)
    with obs.span("plan.block", n_bits=n, scopes=",".join(scopes)) as sp:
        linears = block_linears(cfg)
        mac_cols = eng.compile("mac", n).program.layout.n_cols
        per_group = max(1, (eng.crossbar.cols or 1 << 30) // mac_cols)
        for scope in scopes:
            members = [l for l in linears if l.scope == scope]
            if not members:
                continue
            # A scope with more linears than the crossbar holds MAC
            # copies splits into several passes-sharing groups
            # (first-fit, in inventory order so a layer's w1/w3/w2 stay
            # together).
            for lo in range(0, len(members), per_group):
                part = members[lo:lo + per_group]
                label = ",".join(l.name for l in part)
                # Place before compiling so a shed group costs nothing:
                # capacity exhaustion is known from the coordinate
                # allocator alone.
                coord = None
                if placer is not None:
                    try:
                        coord = placer(label, scope)
                    except DeviceCapacityError as exc:
                        if on_capacity == "raise":
                            raise
                        plan.shed.append(label)
                        obs.counter("plan.capacity_shed").inc()
                        obs.instant("plan.shed", scope=scope,
                                    group=label, reason=str(exc))
                        continue
                base = [GroupSpec("mac", n, label=l.name) for l in part]
                chains = eng.group_counts(base,
                                          weights=[l.stream for l in part])
                gex = eng.compile_group(
                    [GroupSpec("mac", n, copies=c, label=l.name)
                     for l, c in zip(part, chains)])
                plan.groups.append(LinearGroup(
                    scope=scope, linears=part, chains=chains,
                    pass_cycles=gex.n_cycles,
                    cols_used=sum(p.n_cols for p in gex.placements),
                    n_bits=n, staging_cycles=eng.staging_cycles(n),
                    recomb_cycles=eng.recomb_cycles(2 * n),
                    executable=gex,
                    coord=coord))
        sp.set(groups=len(plan.groups), shed=len(plan.shed),
               cycles_per_token=plan.cycles_per_token)
    return plan


# ==================================================== serve slotting ====
@dataclass(frozen=True)
class ServeSlotPlan:
    """The crossbar's serving capacity for one op shape: how many live
    sequences the continuous batcher may co-schedule (``max_slots``,
    the physical column-budget cap) and which pass widths it will size
    batches to (``ladder`` — the precompiled pow2 K-rungs).
    """

    op: str
    n_bits: int
    mac_cols: int            # columns one MAC chain occupies
    crossbar_cols: int       # physical column budget
    max_slots: int           # admission cap (live sequences)
    ladder: Tuple[int, ...]  # precompiled pass widths
    n_crossbars: int = 1     # parallel crossbars backing the budget

    def summary(self) -> str:
        """One line: the slot budget and the K ladder."""
        xb = (f" x {self.n_crossbars} crossbars"
              if self.n_crossbars > 1 else "")
        return (f"serve slots ({self.op} n={self.n_bits}): "
                f"{self.max_slots} live max "
                f"({self.mac_cols} cols/chain of {self.crossbar_cols}"
                f"{xb}), K ladder {self.ladder}")


def plan_serve_slots(engine, n_bits: int = 8, *, op: str = "mac",
                     max_slots: Optional[int] = None,
                     device: Optional[DeviceConfig] = None
                     ) -> ServeSlotPlan:
    """Derive the serving slot budget from the engine's column budget.

    The admission controller's ``max_live`` and the batcher's dynamic-K
    ladder both come from here: the crossbar fits
    ``crossbar_cols // mac_cols`` co-scheduled chains, the ladder is the
    pow2 rungs up to that cap (:meth:`Engine.k_ladder`), and the slot
    budget is the top rung — so every admitted sequence always has a
    precompiled pass width to ride. ``max_slots`` clamps the budget
    (the launcher's ``--traffic-slots``).

    ``device`` scales the budget to a device hierarchy: anything with an
    ``n_crossbars`` attribute (:class:`repro_torch.device.DeviceConfig`).
    The ladder stays *per crossbar* (each fused pass still compiles for one
    crossbar), but the slot budget becomes ``top rung x n_crossbars`` —
    the batcher drains an over-wide live set as one pass per crossbar.
    """
    n_crossbars = max(1, int(getattr(device, "n_crossbars", 1)))
    per_xbar_cap = (max_slots if device is None else None)
    ladder = engine.k_ladder(op, n_bits, max_k=per_xbar_cap)
    mac_cols = engine.compile(op, n_bits).program.layout.n_cols
    budget = ladder[-1] * n_crossbars
    if max_slots is not None:
        budget = min(budget, int(max_slots))
    return ServeSlotPlan(op=op, n_bits=n_bits, mac_cols=mac_cols,
                         crossbar_cols=engine.crossbar.cols or 0,
                         max_slots=budget, ladder=ladder,
                         n_crossbars=n_crossbars)


def gemms_from_config(cfg, batch_tokens: int = 1) -> List[GemmShape]:
    """Extract the per-step GEMM inventory from a model config
    (:class:`repro_torch.configs.ModelConfig`, duck-typed). Serving-shaped:
    m = batch_tokens."""
    m = batch_tokens
    d = cfg.d_model
    nm = 3 if cfg.mlp_type == "swiglu" else 2
    g: List[GemmShape] = []
    kinds = cfg.layer_kinds()
    n_attn = sum(1 for k in kinds if k in ("g", "l", "m", "d"))
    n_rec = sum(1 for k in kinds if k == "r")
    n_moe = sum(1 for k in kinds if k == "m")
    n_densef = sum(1 for k in kinds if k in ("g", "l"))
    n_dmoe = sum(1 for k in kinds if k == "d")

    if n_attn:
        g.append(GemmShape("attn.q", m, d, cfg.q_dim, n_attn))
        g.append(GemmShape("attn.kv", m, d, 2 * cfg.kv_dim, n_attn))
        g.append(GemmShape("attn.o", m, cfg.q_dim, d, n_attn))
    if n_rec:
        if cfg.family == "rwkv":
            g.append(GemmShape("rwkv.time_mix", m, d, 5 * d, n_rec))
            g.append(GemmShape("rwkv.channel_mix", m, d,
                               cfg.d_ff + 2 * d, n_rec))
        else:
            g.append(GemmShape("rglru.proj", m, d, 4 * d + d, n_rec))
            g.append(GemmShape("rglru.ffn", m, d, nm * cfg.d_ff, n_rec))
    if n_densef:
        g.append(GemmShape("ffn", m, d, nm * cfg.d_ff, n_densef))
    if n_moe:
        e = cfg.moe
        active = e.top_k + e.n_shared
        g.append(GemmShape("moe.ffn", m, d, nm * cfg.d_ff, n_moe * active))
        g.append(GemmShape("moe.router", m, d, e.n_experts, n_moe))
    if n_dmoe:
        g.append(GemmShape("moe.dense_ffn", m, d,
                           nm * (cfg.moe.d_ff_dense or cfg.d_ff), n_dmoe))
    g.append(GemmShape("lm_head", m, d, cfg.vocab_size, 1))
    return g
