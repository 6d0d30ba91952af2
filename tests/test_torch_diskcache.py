"""repro_torch.compiler's disk cache: the port's counterparts of the
reference's disk-cache tests (cold start, disable and clear, custom
builders, corrupt and truncated artifacts, unusable directories, the
per-key compile lock), the port's ``torch/`` subdirectory kept apart
from the reference's files, and entries that cross between the two
packages with identical tables."""
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.compiler.diskcache as ref_disk  # noqa: E402
from repro.compiler.cache import ProgramCache as RefCache  # noqa: E402
from repro.compiler.serialize import (  # noqa: E402
    entry_from_bytes as ref_from_bytes, entry_to_bytes as ref_to_bytes)
from repro.compiler.spec import OpSpec as RefOpSpec  # noqa: E402
from repro.compiler.spec import PassConfig as RefPassConfig  # noqa: E402
import repro_torch.compiler.cache as cache_mod  # noqa: E402
from repro_torch.compiler import ProgramCache, register_builder  # noqa: E402
from repro_torch.compiler.diskcache import (  # noqa: E402
    cache_dir, clear_disk_cache, disk_stats, load_entry, store_entry)
from repro_torch.compiler.serialize import (  # noqa: E402
    entry_from_bytes, entry_to_bytes)
from repro_torch.compiler.spec import OpSpec, PassConfig  # noqa: E402
from repro_torch.core.bits import from_bits, to_bits  # noqa: E402
from repro_torch.core.executor import run_numpy  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402

pytestmark = pytest.mark.core

TABLES = ("gate_id", "in_cols", "out_col", "init_mask")


def _same_tables(a, b):
    for f in TABLES:
        x, y = getattr(a.packed, f), getattr(b.packed, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.program.n_cycles == b.program.n_cycles


def _spill_one(tmp_path, monkeypatch, kind="multpim", n=4):
    """Compile + verify one entry into a fresh disk cache dir; return
    (spec, path-to-spilled-file)."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "cache"))
    cache = ProgramCache(use_disk=True)
    entry = cache.get_or_compile(kind, n)
    assert entry.verified is not None and entry.verified.ok
    files = list((tmp_path / "cache" / "torch").glob("*.npz"))
    assert len(files) == 1, "verified entry should have spilled"
    return entry.key, files[0]


def _run_ok(entry, a=3, b=5):
    out = run_numpy(entry.program, {"a": to_bits(np.array([a]), entry.key.n),
                                    "b": to_bits(np.array([b]), entry.key.n)})
    assert int(from_bits(out["out"])[0]) == a * b


# --------------------------------------------------- failure paths ----
def test_truncated_cache_file_falls_back_to_recompile(tmp_path, monkeypatch):
    spec, path = _spill_one(tmp_path, monkeypatch)
    path.write_bytes(path.read_bytes()[:17])          # truncate mid-header
    assert load_entry(spec) is None                   # no crash
    assert not path.exists(), "corrupt artifact should be deleted"
    cold = ProgramCache(use_disk=True)
    entry = cold.get_or_compile(spec.kind, spec.n)
    assert cold.stats()["disk_hits"] == 0
    assert cold.stats()["compiles"] == 1
    _run_ok(entry)
    assert list(path.parent.glob("*.npz")), "recompile should re-spill"


def test_corrupt_cache_file_garbage_bytes(tmp_path, monkeypatch):
    spec, path = _spill_one(tmp_path, monkeypatch)
    path.write_bytes(b"\x00notanpz" * 64)             # wrong magic entirely
    cold = ProgramCache(use_disk=True)
    entry = cold.get_or_compile(spec.kind, spec.n)    # must not raise
    assert cold.stats()["disk_hits"] == 0
    _run_ok(entry)


def test_bitflipped_payload_fails_selfcheck_and_recompiles(tmp_path,
                                                          monkeypatch):
    """A structurally-valid npz whose payload was tampered with must be
    rejected (self-check/validate) rather than executed."""
    spec, path = _spill_one(tmp_path, monkeypatch)
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF                        # flip payload bits
    path.write_bytes(bytes(raw))
    cold = ProgramCache(use_disk=True)
    entry = cold.get_or_compile(spec.kind, spec.n)    # never raises
    _run_ok(entry)


def test_readonly_cache_dir_degrades_to_memory_only(tmp_path, monkeypatch):
    """A cache directory that cannot be written: spills are skipped,
    compiles still succeed, stats still report (simulated by failing
    the tempfile creation; chmod is a no-op for root)."""
    import tempfile
    d = tmp_path / "ro-cache"
    d.mkdir()
    monkeypatch.setenv("REPRO_CACHE_DIR", str(d))

    def deny(*a, **k):
        raise PermissionError("read-only filesystem")

    monkeypatch.setattr(tempfile, "mkstemp", deny)
    cache = ProgramCache(use_disk=True)
    entry = cache.get_or_compile("multpim", 4)        # must not raise
    assert entry.verified is not None
    _run_ok(entry)
    assert list(d.rglob("*.npz")) == []               # nothing spilled
    assert store_entry(entry.key, entry) is None
    st = disk_stats()
    assert st["dir"] == str(d / "torch") and st["entries"] == 0


def test_cache_dir_pointing_at_a_file_degrades(tmp_path, monkeypatch):
    f = tmp_path / "not-a-dir"
    f.write_text("occupied")
    monkeypatch.setenv("REPRO_CACHE_DIR", str(f))
    cache = ProgramCache(use_disk=True)
    entry = cache.get_or_compile("multpim", 4)
    _run_ok(entry)
    assert store_entry(entry.key, entry) is None
    assert load_entry(entry.key) is None


def test_disabled_cache_dir_values(monkeypatch, tmp_path):
    for value in ("0", "off", "none", "OFF ", "disabled"):
        monkeypatch.setenv("REPRO_CACHE_DIR", value)
        assert cache_dir() is None
        assert load_entry(OpSpec.make("multpim", 4, None, None)) is None
        assert disk_stats()["entries"] == 0
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    assert cache_dir() == tmp_path / "torch"
    monkeypatch.delenv("REPRO_CACHE_DIR")
    assert cache_dir().parts[-3:] == (".cache", "repro", "torch")


# -------------------------------------------------- persistence ----
def test_disk_cache_cold_start_skips_compile_and_verify(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    warm = ProgramCache()
    e1 = warm.get_or_compile("multpim", 4)
    assert warm.stats()["compiles"] == 1
    assert list((tmp_path / "torch").glob("multpim_n4_*.npz"))

    cold = ProgramCache()                       # fresh process stand-in
    e2 = cold.get_or_compile("multpim", 4)
    st = cold.stats()
    assert st["disk_hits"] == 1 and st["compiles"] == 0
    assert e2.from_disk and e2.verified is not None and e2.verified.ok
    _same_tables(e1, e2)
    eng = Engine("torch:device=cpu", cache=cold)
    exe = eng.compile("multpim", 4)
    for bk in ("torch:device=cpu,pack=true", "torch:device=cpu,pack=false",
               "numpy"):
        out = exe.run({"a": [3, 15], "b": [5, 15]}, backend=bk)
        assert [int(v) for v in out["out"]] == [15, 225], bk


def test_disk_cache_disable_and_clear(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    ProgramCache().get_or_compile("multpim", 4)
    assert disk_stats()["entries"] == 1
    assert clear_disk_cache() == 1
    assert disk_stats()["entries"] == 0
    monkeypatch.setenv("REPRO_CACHE_DIR", "off")
    assert cache_dir() is None
    c = ProgramCache()
    c.get_or_compile("multpim", 4)
    assert c.stats()["disk_hits"] == 0 and disk_stats()["entries"] == 0


def test_custom_builders_never_touch_disk(tmp_path, monkeypatch):
    """A runtime-registered builder must not spill to (or load from) the
    disk cache: its content hash would collide with the stock kind's."""
    from repro_torch.core.multpim import multpim_multiplier
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(cache_mod, "_CUSTOM_KINDS", set())
    monkeypatch.setattr(cache_mod, "BUILDERS", dict(cache_mod.BUILDERS))
    register_builder("my_variant", lambda n, **kw: multpim_multiplier(n))
    c = ProgramCache()
    c.get_or_compile("my_variant", 4)
    assert not list(tmp_path.rglob("my_variant*"))
    c2 = ProgramCache()
    c2.get_or_compile("my_variant", 4)
    assert c2.stats()["disk_hits"] == 0 and c2.stats()["compiles"] == 1


def test_reregistering_a_kind_purges_its_disk_entries(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(cache_mod, "_CUSTOM_KINDS", set())
    monkeypatch.setattr(cache_mod, "BUILDERS", dict(cache_mod.BUILDERS))
    ProgramCache().get_or_compile("rime", 4)
    ProgramCache().get_or_compile("multpim", 4)
    assert disk_stats()["entries"] == 2
    from repro_torch.core.baselines import rime_multiplier
    register_builder("rime", rime_multiplier)
    names = [p.name for p in (tmp_path / "torch").glob("*.npz")]
    assert len(names) == 1 and names[0].startswith("multpim_n4_")


def test_builders_receive_thawed_flag_values(monkeypatch):
    """Canonicalization must not leak frozen forms into the builder
    call — dict-valued flags arrive as dicts, lists as lists."""
    seen = {}

    def builder(n, windows=None, taps=None):
        seen.update(windows=windows, taps=taps)
        from repro_torch.core.multpim import multpim_multiplier
        return multpim_multiplier(n)

    monkeypatch.setattr(cache_mod, "BUILDERS", dict(cache_mod.BUILDERS))
    monkeypatch.setattr(cache_mod, "_CUSTOM_KINDS",
                        set(cache_mod._CUSTOM_KINDS))
    register_builder("flagged", builder)
    ProgramCache().get_or_compile(
        "flagged", 4, flags={"windows": {"a": 1}, "taps": [3, 1]})
    assert seen["windows"] == {"a": 1} and seen["taps"] == [3, 1]


def test_disk_cache_corrupt_file_recompiles(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    ProgramCache().get_or_compile("multpim", 4)
    path = next((tmp_path / "torch").glob("*.npz"))
    path.write_bytes(b"not an npz")
    c = ProgramCache()
    e = c.get_or_compile("multpim", 4)
    assert c.stats()["compiles"] == 1 and not e.from_disk


# ----------------------------------------------- per-key compile lock ----
def test_concurrent_compile_miss_compiles_once(monkeypatch, tmp_path):
    """Threads missing one OpSpec together produce exactly one
    compile+verify+spill: the first does the work, the rest adopt it."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "cc"))
    cache = ProgramCache(use_disk=True)
    n_threads = 8
    results = [None] * n_threads
    barrier = threading.Barrier(n_threads)

    def worker(i):
        barrier.wait()
        results[i] = cache.get_or_compile("multpim", 6)

    ts = [threading.Thread(target=worker, args=(i,))
          for i in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert all(r is results[0] for r in results)
    assert results[0].verified is not None
    st = cache.stats()
    assert st["compiles"] == 1, f"raced compiles: {st}"
    assert st["misses"] == 1 and st["hits"] == n_threads - 1
    files = [p for p in cache_dir().iterdir() if p.is_file()]
    assert len(files) == 1


def test_concurrent_distinct_keys_compile_in_parallel(monkeypatch,
                                                      tmp_path):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "cc2"))
    cache = ProgramCache(use_disk=True)
    specs = [("multpim", 4), ("multpim", 6), ("multpim_mac", 4),
             ("rime", 4)]
    results = {}
    barrier = threading.Barrier(len(specs))

    def worker(kind, n):
        barrier.wait()
        results[(kind, n)] = cache.get_or_compile(kind, n)

    ts = [threading.Thread(target=worker, args=s) for s in specs]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert len(results) == len(specs)
    assert cache.stats()["compiles"] == len(specs)
    for (kind, n), ent in results.items():
        assert ent.key.kind == kind and ent.key.n == n


# --------------------------------------------- across the packages ----
@pytest.mark.parametrize("flags,remap", [(None, True),
                                         ({"skip_last_stages": True}, True),
                                         (None, False)])
def test_content_hash_matches_reference(flags, remap):
    """OpSpec.content_hash() is the reference's, so both packages name
    an entry's file alike."""
    for kind, n in (("multpim", 8), ("multpim_area", 16), ("rime", 4)):
        got = OpSpec.make(kind, n, flags, PassConfig(remap=remap))
        want = RefOpSpec.make(kind, n, flags, RefPassConfig(remap=remap))
        assert got.content_hash() == want.content_hash()


@pytest.mark.parametrize("kind,n", [("multpim", 8), ("multpim_mac", 8),
                                    ("multpim_area", 16), ("stage", 8),
                                    ("residue", 8)])
def test_entries_cross_load_between_packages(kind, n, tmp_path,
                                             monkeypatch):
    """An entry either package's entry_to_bytes writes loads through the
    other's entry_from_bytes with identical tables; and the two
    packages' spills sit apart under one REPRO_CACHE_DIR."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    mine = ProgramCache().get_or_compile(kind, n)
    ref = RefCache().get_or_compile(kind, n)
    _same_tables(mine, ref)
    from_ref = entry_from_bytes(ref_to_bytes(ref), key=mine.key)
    from_port = ref_from_bytes(entry_to_bytes(mine), key=ref.key)
    for back in (from_ref, from_port):
        assert back.from_disk and back.verified.ok
        _same_tables(back, mine)
    assert type(from_ref.packed).__module__.startswith("repro_torch.")
    # each package's directory holds its own file only, and clearing
    # the reference's cache leaves the port's entry in place
    assert [p.name for p in (tmp_path / "torch").glob("*.npz")] == \
        [p.name for p in tmp_path.glob("*.npz")]
    assert ref_disk.clear_disk_cache() == 1
    assert disk_stats()["entries"] == 1
    cold = ProgramCache()
    _same_tables(cold.get_or_compile(kind, n), ref)
    assert cold.stats()["disk_hits"] == 1


def test_compile_counts_match_reference(tmp_path, monkeypatch):
    """A resident chain's programs compile as often as in the reference:
    all three in a cold process, none in a second one that finds them on
    disk (the port used to count compiles a disk-backed reference run
    skipped)."""
    from repro.engine import Engine as JaxEngine
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    counts = []
    for _ in range(2):
        port, ref = ProgramCache(), RefCache()
        Engine("torch:device=cpu", cache=port).resident(8, rows=70)
        JaxEngine(cache=ref).resident(8, rows=70)
        got, want = port.stats(), ref.stats()
        assert (got["compiles"], got["disk_hits"]) == (want["compiles"],
                                                       want["disk_hits"])
        counts.append((got["compiles"], got["disk_hits"]))
    assert counts == [(3, 0), (0, 3)]
