"""OpSpec: the canonical, hashable identity of a compiled PIM program.

Cache keys used to be ad-hoc ``(kind, n, flags-dict, pass-key)`` tuples.
Dict flags are order-sensitive to construct and unhashable once values
are lists/dicts, and ``sorted(flags.items())`` breaks on mixed-type
keys. :class:`OpSpec` fixes the identity once and for all:

* ``flags`` are canonicalized — keys coerced to ``str`` and sorted,
  values recursively frozen (dict -> sorted item tuple, list/set ->
  tuple) — so any two call sites describing the same compile produce
  *equal* specs regardless of construction order;
* the pass pipeline configuration rides inside the spec (``pass_key``),
  so a spec alone fully determines the compiled artifact;
* :meth:`OpSpec.content_hash` gives a stable hex digest of
  ``(spec, PIPELINE_VERSION)`` used to key the on-disk program cache
  (:mod:`.diskcache`) — bumping :data:`PIPELINE_VERSION` invalidates
  every spilled artifact at once.

Both the in-memory :class:`~repro_torch.compiler.cache.ProgramCache` and the
disk cache key exclusively on ``OpSpec``.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

from .passes import PassConfig

__all__ = ["OpSpec", "PIPELINE_VERSION", "freeze_flags"]

# Version of the whole compile pipeline (builders + passes + packer).
# Bump whenever a change makes previously-spilled disk artifacts stale.
# "3": PassConfig gained fuse/scheduler fields (pass_key shape changed).
# 4: list scheduler gained the stabbed (ALAP init batching) strategy —
# cached "list" schedules from older pipelines are no longer what the
# scheduler would produce.
PIPELINE_VERSION = "4"


def _freeze(value: Any) -> Any:
    """Recursively convert ``value`` into a hashable, order-stable form."""
    if isinstance(value, Mapping):
        return tuple(sorted(((str(k), _freeze(v)) for k, v in value.items()),
                            key=lambda kv: kv[0]))
    if isinstance(value, (set, frozenset)):
        return tuple(sorted((_freeze(v) for v in value), key=repr))
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    raise TypeError(f"flag value {value!r} ({type(value).__name__}) is not "
                    f"canonicalizable; use scalars/lists/dicts")


def freeze_flags(flags: Optional[Mapping[str, Any]]
                 ) -> Tuple[Tuple[str, Any], ...]:
    """Canonical frozen form of a builder-flag mapping (sorted, hashable)."""
    if not flags:
        return ()
    return tuple(sorted(((str(k), _freeze(v)) for k, v in flags.items()),
                        key=lambda kv: kv[0]))


def _thaw(value: Any) -> Any:
    """Inverse of :func:`_freeze` for handing flags back to builders:
    tuples of ``(str, x)`` pairs become dicts, other tuples become
    lists. (A literal list of string-keyed pairs is indistinguishable
    from a dict after canonicalization — the one lossy corner.)"""
    if isinstance(value, tuple):
        if value and all(isinstance(i, tuple) and len(i) == 2
                         and isinstance(i[0], str) for i in value):
            return {k: _thaw(v) for k, v in value}
        return [_thaw(v) for v in value]
    return value


@dataclass(frozen=True)
class OpSpec:
    """Value-complete identity of one compiled program.

    ``kind``    — builder name in the compiler registry ("multpim",
                  "multpim_mac", "rime", "hajali", "multpim_area", ...);
    ``n``       — operand bit width;
    ``flags``   — canonicalized builder kwargs (see :func:`freeze_flags`);
    ``pass_key``— :meth:`repro_torch.compiler.passes.PassConfig.key` tuple.
    """

    kind: str
    n: int
    flags: Tuple[Tuple[str, Any], ...] = ()
    pass_key: Tuple[Any, ...] = field(
        default_factory=lambda: tuple(PassConfig().key()))

    @classmethod
    def make(cls, kind: str, n: int, flags: Optional[Mapping[str, Any]] = None,
             config: Optional[PassConfig] = None) -> "OpSpec":
        """Canonical spec from a kind, width, flags and pass config."""
        cfg = config or PassConfig()
        return cls(kind=str(kind), n=int(n), flags=freeze_flags(flags),
                   pass_key=tuple(cfg.key()))

    # ------------------------------------------------------------ views ----
    def flags_dict(self) -> Dict[str, Any]:
        """Flags as a plain dict for the builder call (dict/list values
        are thawed back out of the canonical frozen form)."""
        return {k: _thaw(v) for k, v in self.flags}

    def pass_config(self) -> PassConfig:
        """The :class:`PassConfig` this spec was compiled with."""
        return PassConfig.from_key(self.pass_key)

    # ------------------------------------------------------------- hash ----
    def content_hash(self) -> str:
        """Stable digest of ``(spec, PIPELINE_VERSION)`` for disk keys."""
        payload = json.dumps(
            {"kind": self.kind, "n": self.n, "flags": self.flags,
             "pass_key": self.pass_key, "pipeline": PIPELINE_VERSION},
            sort_keys=True, default=repr)
        return hashlib.sha256(payload.encode()).hexdigest()

    def __str__(self) -> str:
        f = ",".join(f"{k}={v}" for k, v in self.flags)
        return f"{self.kind}/N={self.n}" + (f"[{f}]" if f else "")
