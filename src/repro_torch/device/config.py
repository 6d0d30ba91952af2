"""Device hierarchy: crossbars x banks x bank groups x channels.

Everything below :mod:`repro_torch.device` models a *single* (wide) crossbar;
a deployable PIM part is a tree — ``channels_per_device`` channels,
each holding ``groups_per_channel`` bank groups of ``banks_per_group``
banks, each bank carrying ``crossbars_per_bank`` crossbars (the
HBM-PIMulator Bank -> BankGroup -> Channel -> Device shape; see
ROADMAP direction 1). :class:`DeviceConfig` describes that tree plus
the interconnect/host parameters the hierarchical cost model charges:
per-level hop latency, host<->PIM transfer bandwidth, and
row-activation energy.

:class:`Coord` addresses one crossbar as ``(channel, group, bank,
crossbar)`` and prints/parses as ``ch0.bg1.b2.x3`` — the coordinate
syntax every command-trace record uses (`docs/trace-format.md`).
:class:`CoordAllocator` hands out coordinates in locality order
(crossbars within a bank first, then banks, groups, channels), which is
what the block planner uses as its ``placer`` hook: co-scheduled groups
of one scope land as close together as possible so intra-scope
broadcasts stay cheap.

A ``1x1x1x1`` device is the degenerate single-crossbar machine: one
coordinate, zero possible hops — the cost model then reproduces the
flat accounting exactly (property-tested in ``tests/test_device.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Tuple

from repro_torch.core.costmodel import CrossbarSpec

__all__ = ["Coord", "DeviceConfig", "DeviceCapacityError",
           "CoordAllocator"]

# Hierarchy levels, outermost first; also the order Coord compares.
LEVELS: Tuple[str, ...] = ("channel", "group", "bank", "crossbar")


class DeviceCapacityError(ValueError):
    """The device has no free crossbar left for another placement."""


@dataclass(frozen=True, order=True)
class Coord:
    """One crossbar's address in the device tree (``ch0.bg1.b2.x3``)."""

    channel: int
    group: int
    bank: int
    crossbar: int

    def __str__(self) -> str:
        return (f"ch{self.channel}.bg{self.group}"
                f".b{self.bank}.x{self.crossbar}")

    @classmethod
    def parse(cls, text: str) -> "Coord":
        """Inverse of ``str(coord)``: ``"ch0.bg1.b2.x3"`` -> Coord."""
        parts = text.strip().split(".")
        tags = ("ch", "bg", "b", "x")
        if len(parts) != 4 or not all(p.startswith(t)
                                      for p, t in zip(parts, tags)):
            raise ValueError(f"bad coordinate {text!r} (want "
                             f"'ch<c>.bg<g>.b<b>.x<x>')")
        vals = [int(p[len(t):]) for p, t in zip(parts, tags)]
        return cls(*vals)

    def hop_level(self, other: "Coord") -> str:
        """The interconnect level a transfer between the two
        coordinates crosses: the *outermost* field where they differ
        (``"channel"`` | ``"group"`` | ``"bank"`` | ``"crossbar"``), or
        ``"local"`` when they are the same crossbar."""
        for level in LEVELS:
            if getattr(self, level) != getattr(other, level):
                return level
        return "local"


@dataclass(frozen=True)
class DeviceConfig:
    """One PIM device: the hierarchy shape plus interconnect/host cost
    parameters (per-level hop latency, host link bandwidth,
    row-activation energy) layered on a per-crossbar
    :class:`~repro_torch.core.costmodel.CrossbarSpec`."""

    crossbars_per_bank: int = 4
    banks_per_group: int = 4
    groups_per_channel: int = 2
    channels_per_device: int = 2
    crossbar: CrossbarSpec = field(default_factory=CrossbarSpec)
    # Interconnect: latency of moving one operand block across the
    # *outermost* level two coordinates differ at (a transfer between
    # banks of the same group pays bank_hop_ns, between channels pays
    # channel_hop_ns — not the sum of the levels below it).
    crossbar_hop_ns: float = 5.0
    bank_hop_ns: float = 10.0
    group_hop_ns: float = 20.0
    channel_hop_ns: float = 40.0
    # Host <-> PIM link (H2D/D2H records): bandwidth-charged, not
    # hop-charged.
    host_bw_gbps: float = 16.0
    # Energy to activate one crossbar row for one pass (charged per
    # engaged row per pass on top of the per-gate energy the flat
    # ExecCost model already carries).
    row_activation_pj: float = 2.0

    def __post_init__(self):
        for name in ("crossbars_per_bank", "banks_per_group",
                     "groups_per_channel", "channels_per_device"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")

    # --------------------------------------------------------- shape ----
    @property
    def n_banks(self) -> int:
        """Total banks across the device."""
        return (self.banks_per_group * self.groups_per_channel
                * self.channels_per_device)

    @property
    def n_crossbars(self) -> int:
        """Total crossbars across the device."""
        return self.n_banks * self.crossbars_per_bank

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        """``(channels, groups, banks, crossbars)`` per level."""
        return (self.channels_per_device, self.groups_per_channel,
                self.banks_per_group, self.crossbars_per_bank)

    def __str__(self) -> str:
        return "x".join(str(s) for s in self.shape)

    @classmethod
    def parse(cls, text: str, **kw) -> "DeviceConfig":
        """``"CxGxBxX"`` (channels x groups x banks x crossbars, the
        ``--device-config`` CLI syntax) -> DeviceConfig. Extra keyword
        arguments override cost parameters."""
        parts = text.strip().lower().split("x")
        if len(parts) != 4:
            raise ValueError(f"bad device config {text!r} (want "
                             f"'CHANNELSxGROUPSxBANKSxCROSSBARS', "
                             f"e.g. '2x2x4x4')")
        c, g, b, x = (int(p) for p in parts)
        return cls(crossbars_per_bank=x, banks_per_group=b,
                   groups_per_channel=g, channels_per_device=c, **kw)

    # ---------------------------------------------------- coordinates ----
    def coords(self) -> Iterator[Coord]:
        """Every crossbar coordinate, locality order: crossbars within
        a bank first, then banks, groups, channels."""
        for ch in range(self.channels_per_device):
            for g in range(self.groups_per_channel):
                for b in range(self.banks_per_group):
                    for x in range(self.crossbars_per_bank):
                        yield Coord(ch, g, b, x)

    def coord(self, index: int) -> Coord:
        """Flat locality-order index -> :class:`Coord`."""
        if not 0 <= index < self.n_crossbars:
            raise IndexError(f"crossbar index {index} out of range "
                             f"(device has {self.n_crossbars})")
        index, x = divmod(index, self.crossbars_per_bank)
        index, b = divmod(index, self.banks_per_group)
        ch, g = divmod(index, self.groups_per_channel)
        return Coord(ch, g, b, x)

    def index(self, coord: Coord) -> int:
        """Inverse of :meth:`coord`."""
        return ((((coord.channel * self.groups_per_channel + coord.group)
                  * self.banks_per_group + coord.bank)
                 * self.crossbars_per_bank) + coord.crossbar)

    def validate(self, coord: Coord) -> Coord:
        """Raise if ``coord`` lies outside this device's shape."""
        limits = dict(zip(LEVELS, self.shape))
        for level in LEVELS:
            v = getattr(coord, level)
            if not 0 <= v < limits[level]:
                raise ValueError(f"{coord} outside device {self} "
                                 f"({level}={v} of {limits[level]})")
        return coord

    # ------------------------------------------------------------ cost ----
    def hop_ns(self, src: Coord, dst: Coord) -> float:
        """Latency of one operand-block transfer ``src -> dst``: the
        hop cost of the outermost level the coordinates differ at
        (0 for the same crossbar)."""
        level = src.hop_level(dst)
        return {
            "local": 0.0,
            "crossbar": self.crossbar_hop_ns,
            "bank": self.bank_hop_ns,
            "group": self.group_hop_ns,
            "channel": self.channel_hop_ns,
        }[level]

    def transfer_us(self, n_bytes: int) -> float:
        """Host<->PIM link time for ``n_bytes`` (H2D/D2H records)."""
        return n_bytes / (self.host_bw_gbps * 1e3)   # GB/s == bytes/ns


class CoordAllocator:
    """Hands out crossbar coordinates of one device in locality order.

    This is the device-hierarchy counterpart of the column-range
    :class:`repro_torch.compiler.coschedule.PartitionAllocator`: where that
    allocator packs co-scheduled programs into one crossbar, this one
    places whole *groups* (each a fused crossbar program) onto physical
    crossbars of the device tree. It satisfies the planner's ``placer``
    hook (:func:`repro_torch.pim.planner.plan_block`): :meth:`place` is
    called once per co-scheduled group and returns its coordinate.

    ``align="bank"`` (the default) starts every new *scope* at a bank
    boundary — :meth:`align_scope` skips to the next empty bank — so a
    scope's intra-group broadcast traffic stays bank-local whenever the
    scope fits in one bank.

    **Blocklist**: :meth:`block` marks a crossbar failed (a quarantine
    escalation, a manufacture reject) — :meth:`place` skips blocked
    coordinates and fails over to the next healthy spare, and
    :attr:`n_free` stops counting them. Capacity exhaustion still
    raises :class:`DeviceCapacityError`, now reached sooner by exactly
    the blocked count.
    """

    def __init__(self, device: DeviceConfig):
        self.device = device
        self._next = 0
        self.placed: List[Tuple[str, Coord]] = []
        self._scope = None
        self.blocked: set = set()

    @property
    def n_free(self) -> int:
        """Healthy crossbars not yet handed out."""
        return sum(1 for i in range(self._next, self.device.n_crossbars)
                   if self.device.coord(i) not in self.blocked)

    def block(self, coord) -> Coord:
        """Mark one crossbar (a :class:`Coord` or its ``ch0.bg1.b2.x3``
        string) failed: never handed out again; already-placed groups
        keep their record (re-planning is the caller's decision)."""
        c = Coord.parse(coord) if isinstance(coord, str) else coord
        self.device.validate(c)
        self.blocked.add(c)
        return c

    def align_scope(self, scope: str) -> None:
        """Advance to the next bank boundary when ``scope`` changes, so
        scopes never interleave inside one bank (no-op when already
        aligned or when the device has a single bank)."""
        if scope == self._scope:
            return
        self._scope = scope
        per_bank = self.device.crossbars_per_bank
        if self._next % per_bank and self.device.n_banks > 1:
            self._next += per_bank - self._next % per_bank

    def place(self, label: str, scope: str = "") -> Coord:
        """Allocate the next free *healthy* crossbar for group ``label``
        (the planner's ``placer`` hook), failing over past blocked
        coordinates. Raises :class:`DeviceCapacityError` when no healthy
        crossbar is left."""
        if scope:
            self.align_scope(scope)
        while (self._next < self.device.n_crossbars
               and self.device.coord(self._next) in self.blocked):
            self._next += 1
        if self._next >= self.device.n_crossbars:
            raise DeviceCapacityError(
                f"device {self.device} is full ({self.device.n_crossbars}"
                f" crossbars, {len(self.blocked)} blocked) -- cannot "
                f"place group {label!r}")
        coord = self.device.coord(self._next)
        self._next += 1
        self.placed.append((label, coord))
        return coord
