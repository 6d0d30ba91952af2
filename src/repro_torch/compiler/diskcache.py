"""On-disk persistence for the program cache (cold-start compile skip).

Verified compiled entries are spilled as ``<kind>_nNN_<hash>.npz`` files
under ``~/.cache/repro/torch`` (override the root with
``REPRO_CACHE_DIR``; set it to ``0``/``off``/``none`` to disable
persistence entirely). The file name
hash is :meth:`OpSpec.content_hash` — a digest of the full spec *and*
:data:`~repro_torch.compiler.spec.PIPELINE_VERSION` — so any pass-pipeline or
builder-semantics bump naturally misses every stale artifact. A cold
process therefore pays neither build, optimize, pack **nor**
differential verify for any program some earlier process already proved.

Writes are atomic (tempfile + rename); unreadable or self-check-failing
files are deleted and recompiled. Only *verified* entries are spilled.

The directory. The port reads the same ``REPRO_CACHE_DIR`` variable as
the reference package (``repro.compiler.diskcache``), with the same
disable values, but keeps its entries in a ``torch/`` subdirectory of
it, so the two packages never share files:

* a test fixture that points ``REPRO_CACHE_DIR`` at a temporary
  directory isolates both packages' caches at once;
* the reference's ``clear_disk_cache``/``purge_kind`` glob ``*.npz`` at
  the top level of its directory only, so they never touch the port's
  entries, and the port's globs below never touch the reference's.

The format is the reference's (:mod:`.serialize`): an entry written by
either package loads in the other with identical tables.

CLI::

    python -m repro_torch.compiler.diskcache stats   # dir, entries, bytes
    python -m repro_torch.compiler.diskcache clear   # delete every entry
"""
from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Optional

from .spec import OpSpec

__all__ = ["cache_dir", "disk_enabled", "load_entry", "store_entry",
           "clear_disk_cache", "disk_stats", "purge_kind"]

_ENV = "REPRO_CACHE_DIR"
_DISABLED = {"0", "off", "none", "disabled"}
_SUBDIR = "torch"


def disk_enabled() -> bool:
    """Whether persistence is on (``REPRO_CACHE_DIR`` not disabled)."""
    return cache_dir() is not None


def cache_dir(create: bool = False) -> Optional[Path]:
    """Resolved cache directory (the ``torch/`` subdirectory of the
    shared root), or ``None`` when persistence is off."""
    raw = os.environ.get(_ENV)
    if raw is not None and raw.strip().lower() in _DISABLED:
        return None
    root = Path(raw).expanduser() if raw else Path.home() / ".cache" / "repro"
    d = root / _SUBDIR
    if create:
        d.mkdir(parents=True, exist_ok=True)
    return d


def _path_for(spec: OpSpec, d: Path) -> Path:
    return d / f"{spec.kind}_n{spec.n}_{spec.content_hash()[:20]}.npz"


def load_entry(spec: OpSpec) -> Optional["CompiledEntry"]:
    """Load a previously-spilled entry; ``None`` on miss/corruption."""
    d = cache_dir()
    if d is None:
        return None
    path = _path_for(spec, d)
    if not path.is_file():
        return None
    from .serialize import entry_from_bytes
    try:
        return entry_from_bytes(path.read_bytes(), key=spec)
    except Exception:
        try:
            path.unlink()
        except OSError:
            pass
        return None


def store_entry(spec: OpSpec, entry: "CompiledEntry") -> Optional[Path]:
    """Atomically spill a verified entry; best-effort (None on failure)."""
    d = cache_dir()
    if d is None or entry.verified is None or not entry.verified.ok:
        return None
    from .serialize import entry_to_bytes
    try:
        d.mkdir(parents=True, exist_ok=True)
        path = _path_for(spec, d)
        fd, tmp = tempfile.mkstemp(dir=str(d), suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(entry_to_bytes(entry))
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return path
    except OSError:
        return None


def purge_kind(kind: str) -> int:
    """Drop disk entries for one builder kind (used on re-registration,
    when the on-disk artifact may no longer match the new builder)."""
    d = cache_dir()
    if d is None or not d.is_dir():
        return 0
    n = 0
    for p in d.glob(f"{kind}_n*.npz"):
        try:
            p.unlink()
            n += 1
        except OSError:
            pass
    return n


def clear_disk_cache() -> int:
    """Delete every spilled entry; returns the number removed."""
    d = cache_dir()
    if d is None or not d.is_dir():
        return 0
    n = 0
    for p in d.glob("*.npz"):
        try:
            p.unlink()
            n += 1
        except OSError:
            pass
    return n


def disk_stats() -> dict:
    """Directory, entry count and total bytes of the disk cache."""
    d = cache_dir()
    if d is None:
        return {"dir": None, "entries": 0, "bytes": 0}
    files = list(d.glob("*.npz")) if d.is_dir() else []
    return {"dir": str(d), "entries": len(files),
            "bytes": sum(p.stat().st_size for p in files)}


def _main() -> None:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.compiler.diskcache",
        description="Manage the on-disk compiled-program cache.")
    ap.add_argument("command", choices=["stats", "clear"])
    args = ap.parse_args()
    if args.command == "clear":
        n = clear_disk_cache()
        print(f"removed {n} entries from {cache_dir()}")
    else:
        st = disk_stats()
        print(f"dir:     {st['dir']}\nentries: {st['entries']}\n"
              f"bytes:   {st['bytes']:,}")


if __name__ == "__main__":
    _main()
