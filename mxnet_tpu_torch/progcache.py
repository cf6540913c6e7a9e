"""Persistent on-disk cache of the port's built programs.

Counterpart of ``mxnet_tpu/progcache.py``. A serving bucket's forward is
the asset here: a ``predict.Predictor`` (kind ``predictor``) or
``quant.QuantizedPredictor`` (kind ``quant``) bound at one input shape is
traced once with ``torch.export`` (its weights, aux states and bound zeros
are inputs of the program, not constants in it) and the exported program
saved as the entry's payload. A restarted process loads it with no symbol
build, no shape inference and no trace, then captures its CUDA graph as a
fresh bind does.

- **Content-addressed entries.** One file a program, ``<key>.prog``;
  ``key`` is a sha1 over the model fingerprint (the symbol JSON plus every
  parameter's name, shape, type and a CRC of its bytes, so two weight
  sets never share a key), the bound input names / shapes / type, the
  device, and the runtime facts.
- **Self-verifying entry format.** ``MXTTPROG\x01`` magic, a JSON meta
  block (torch and CUDA versions, the card's name, the package version,
  the key, the caller's own fields), a CRC32 of the payload, then the
  payload. A load checks magic, meta, version skew and CRC, then the
  caller's decode; ANY failure is a fallback to a fresh build, counted in
  ``progcache_fallbacks``, and the bad entry is removed.
- **Atomic commits.** Every write goes through :func:`_atomic_write_bytes`
  (tmp + fsync + ``os.replace``).
- **CRC-checked manifest + LRU byte budget.** ``manifest.json`` holds
  per-entry byte sizes, kinds and LRU clocks plus persisted bucket
  ladders; it is advisory (rebuilt from a directory scan when missing or
  damaged). Total bytes are bounded by ``MXNET_PROGCACHE_BYTES`` (default
  2 GiB), oldest clock first.

Enablement: off unless ``MXNET_PROGCACHE_DIR`` is set (or
``MXNET_PROGCACHE=1``, which uses ``~/.cache/mxnet_tpu_torch/progcache``);
``MXNET_PROGCACHE=0`` wins over everything. Processes may share a
directory: commits are atomic renames and manifest races lose advisory
data only.

Telemetry: ``progcache_hits`` / ``progcache_misses`` /
``progcache_fallbacks`` counters, a ``progcache_bytes`` gauge (and one a
kind, ``progcache_bytes_kind_<kind>``), and ``progcache.load`` /
``progcache.store`` spans (domain ``progcache``).
"""
from __future__ import annotations

import binascii
import hashlib
import json
import logging
import os
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from . import telemetry as _telemetry

log = logging.getLogger("mxnet_tpu_torch")

MAGIC = b"MXTTPROG\x01"
MANIFEST = "manifest.json"
MANIFEST_VERSION = 1
DEFAULT_BUDGET = 2 << 30  # 2 GiB
_U32 = struct.Struct("<I")

# Serializes manifest read-modify-write and the session stat dict; a leaf:
# nothing is acquired under it, telemetry increments happen outside it.
_lock = threading.Lock()

# Session counters (mirrored into the telemetry registry; kept here too so
# stats() works even with MXNET_TELEMETRY=0).
_stats = {"hits": 0, "misses": 0, "fallbacks": 0, "stores": 0,
          "evictions": 0}

# Bytes in use per cache dir, refreshed on every manifest load/commit —
# the progcache_bytes gauge reads this instead of hitting the disk.
_bytes_by_dir: Dict[str, int] = {}

# Same, split by entry kind (predictor / quant / "" for entries stored
# without one) — a per-kind gauge is registered lazily when a kind
# first appears so the exposition only grows for kinds actually in use.
_bytes_by_dir_kind: Dict[str, Dict[str, int]] = {}
_kind_gauges: Dict[str, object] = {}

_hits = _telemetry.registry.counter(
    "progcache_hits", "persistent program cache: successful disk loads")
_misses = _telemetry.registry.counter(
    "progcache_misses", "persistent program cache: key not present")
_fallbacks = _telemetry.registry.counter(
    "progcache_fallbacks",
    "persistent program cache: entry present but unusable "
    "(corruption/version skew/load failure) — fell back to a fresh build")
_telemetry.registry.gauge(
    "progcache_bytes", lambda: float(sum(_bytes_by_dir.values())),
    "persistent program cache: bytes on disk (all dirs used this process)")


# --- enablement -----------------------------------------------------------

def cache_dir() -> Optional[str]:
    """The active cache directory, or None when the cache is disabled.
    Read at the point of use."""
    flag = os.environ.get("MXNET_PROGCACHE", "").strip().lower()
    if flag in ("0", "off", "false", "none"):
        return None  # kill switch wins over MXNET_PROGCACHE_DIR
    d = os.environ.get("MXNET_PROGCACHE_DIR", "").strip()
    if d:
        return d
    if flag in ("1", "on", "true"):
        return os.path.join(os.path.expanduser("~"), ".cache",
                            "mxnet_tpu_torch", "progcache")
    return None


def enabled() -> bool:
    return cache_dir() is not None


def byte_budget() -> int:
    try:
        return int(os.environ.get("MXNET_PROGCACHE_BYTES", DEFAULT_BUDGET))
    except ValueError:
        return DEFAULT_BUDGET


# --- atomic commit (the resilience.checkpoint idiom) ----------------------

def _atomic_write_bytes(path: str, data: bytes):
    """tmp + fsync + os.replace: the committed name holds the old content
    or the complete new content, never a torn write. The only function of
    this module that opens files for writing."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# --- fingerprints / keys --------------------------------------------------

def _runtime_meta() -> Dict[str, str]:
    """The environment facts a saved program is only valid under: the
    torch and CUDA versions, the card's name ("cpu" without one) and the
    package's version."""
    import torch

    from . import __version__ as pkg_version
    try:
        kind = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                else "cpu")
    except Exception:
        kind = "unknown"
    return {
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "mxnet_tpu_torch": pkg_version,
        "device_kind": kind,
    }


def _tensor_bytes(arr) -> Tuple[tuple, str, bytes]:
    """(shape, type, raw bytes) of an NDArray, tensor or array."""
    import numpy as np
    import torch

    t = getattr(arr, "_data", arr)
    if isinstance(t, torch.Tensor):
        t = t.detach().contiguous().cpu()
        return (tuple(t.shape), str(t.dtype).replace("torch.", ""),
                t.view(-1).view(torch.uint8).numpy().tobytes()
                if t.numel() else b"")
    a = np.ascontiguousarray(np.asarray(t))
    return tuple(a.shape), str(a.dtype), a.tobytes()


def _param_digest(h, name: str, arr) -> None:
    """Fold one parameter into ``h``: name, shape, type and a CRC of its
    bytes, so two weight sets never share a key."""
    shape, dtype, raw = _tensor_bytes(arr)
    h.update(name.encode())
    h.update(str(shape).encode())
    h.update(dtype.encode())
    h.update(_U32.pack(binascii.crc32(raw) & 0xFFFFFFFF))


def model_fingerprint(symbol, arg_params: Dict, aux_params: Dict) -> str:
    """sha1 over the symbol graph and every parameter's name, shape, type
    and CRC: the "same model, same weights" identity that predictor keys
    and persisted ladders hang off."""
    h = hashlib.sha1()
    h.update(symbol.tojson().encode())
    for name in sorted(arg_params):
        _param_digest(h, "arg:" + name, arg_params[name])
    for name in sorted(aux_params):
        _param_digest(h, "aux:" + name, aux_params[name])
    return h.hexdigest()


def predictor_key(model_fp: str, input_names: Sequence[str],
                  input_shapes: Dict[str, tuple], dtype: str,
                  device: Optional[object] = None, extra: str = "") -> str:
    """Key of a Predictor's program: the model's identity, the bound input
    signature, ``extra`` (a quantization's settings) and the runtime
    facts — computable without building anything, so a warm hit skips the
    symbol build and the trace."""
    h = hashlib.sha1()
    h.update(b"predict\x00")
    h.update(model_fp.encode())
    for n in input_names:
        h.update(n.encode())
        h.update(str(tuple(input_shapes[n])).encode())
    h.update(str(dtype).encode())
    if device is not None:
        h.update(str(device).encode())
    if extra:
        h.update(extra.encode())
    h.update(json.dumps(_runtime_meta(), sort_keys=True).encode())
    return h.hexdigest()


# --- manifest -------------------------------------------------------------

def _entries_crc(entries: Dict, ladders: Dict, clock: int) -> int:
    blob = json.dumps([entries, ladders, clock], sort_keys=True).encode()
    return binascii.crc32(blob) & 0xFFFFFFFF


def _entry_kind(path: str) -> str:
    """The ``kind`` from an entry file's meta header (manifest rebuild
    only reads the small header, never the payload)."""
    try:
        with open(path, "rb") as f:
            head = f.read(len(MAGIC) + 4)
            if not head.startswith(MAGIC):
                return ""
            (mlen,) = _U32.unpack_from(head, len(MAGIC))
            meta = json.loads(f.read(mlen).decode())
        return str(meta.get("kind", ""))
    except Exception:
        return ""


def _load_manifest(d: str) -> Dict:
    """Read + CRC-verify the manifest; rebuild from a directory scan when
    missing or corrupt (the manifest is advisory — entries are
    content-addressed, so a rebuild loses only LRU clocks/ladders)."""
    path = os.path.join(d, MANIFEST)
    try:
        with open(path, "rb") as f:
            m = json.loads(f.read().decode())
        if (m.get("version") == MANIFEST_VERSION and
                m.get("crc") == _entries_crc(m.get("entries", {}),
                                             m.get("ladders", {}),
                                             m.get("clock", 0))):
            return m
        log.warning("progcache: manifest CRC mismatch at %s — rebuilding",
                    path)
    except FileNotFoundError:
        pass
    except Exception as e:  # corrupt JSON, unreadable, ...
        log.warning("progcache: unreadable manifest at %s (%s) — rebuilding",
                    path, e)
    entries = {}
    try:
        names = os.listdir(d)
    except OSError:
        names = []
    for fn in names:
        if fn.endswith(".prog"):
            try:
                sz = os.path.getsize(os.path.join(d, fn))
            except OSError:
                continue
            e = {"bytes": sz, "clock": 0}
            kind = _entry_kind(os.path.join(d, fn))
            if kind:
                e["kind"] = kind
            entries[fn[:-len(".prog")]] = e
    return {"version": MANIFEST_VERSION, "clock": 0, "entries": entries,
            "ladders": {}, "crc": _entries_crc(entries, {}, 0)}


def _refresh_kind_bytes(d: str, m: Dict):
    by_kind: Dict[str, int] = {}
    for e in m["entries"].values():
        k = e.get("kind", "")
        by_kind[k] = by_kind.get(k, 0) + e.get("bytes", 0)
    _bytes_by_dir_kind[d] = by_kind
    for k in by_kind:
        if k and k not in _kind_gauges:
            _kind_gauges[k] = _telemetry.registry.gauge(
                "progcache_bytes_kind_" + k,
                lambda _k=k: float(sum(
                    bk.get(_k, 0) for bk in _bytes_by_dir_kind.values())),
                "persistent program cache: bytes on disk for %r entries"
                % k)


def _commit_manifest(d: str, m: Dict):
    m["crc"] = _entries_crc(m["entries"], m.get("ladders", {}), m["clock"])
    _atomic_write_bytes(os.path.join(d, MANIFEST),
                        json.dumps(m, sort_keys=True).encode())
    _bytes_by_dir[d] = sum(e.get("bytes", 0) for e in m["entries"].values())
    _refresh_kind_bytes(d, m)


def _evict_over_budget(d: str, m: Dict, protect: str) -> List[str]:
    """Drop oldest-clock entries until total bytes fit the budget; the
    just-stored key is protected so a store is never a self-eviction."""
    budget = byte_budget()
    total = sum(e.get("bytes", 0) for e in m["entries"].values())
    victims: List[str] = []
    by_age = sorted((k for k in m["entries"] if k != protect),
                    key=lambda k: m["entries"][k].get("clock", 0))
    for k in by_age:
        if total <= budget:
            break
        total -= m["entries"][k].get("bytes", 0)
        del m["entries"][k]
        victims.append(k)
    for k in victims:
        try:
            os.remove(os.path.join(d, k + ".prog"))
        except OSError:
            pass
    return victims


# --- load / store ---------------------------------------------------------

def _entry_path(d: str, key: str) -> str:
    return os.path.join(d, key + ".prog")


def _pack_entry(meta: Dict, payload: bytes) -> bytes:
    mb = json.dumps(meta, sort_keys=True).encode()
    return b"".join([MAGIC, _U32.pack(len(mb)), mb,
                     _U32.pack(binascii.crc32(payload) & 0xFFFFFFFF),
                     payload])


def _unpack_entry(blob: bytes) -> Tuple[Dict, bytes]:
    """Parse + verify one entry file; raises ValueError on any damage."""
    if len(blob) < len(MAGIC) + 8 or not blob.startswith(MAGIC):
        raise ValueError("bad magic / truncated header")
    off = len(MAGIC)
    (mlen,) = _U32.unpack_from(blob, off)
    off += 4
    if len(blob) < off + mlen + 4:
        raise ValueError("truncated meta block")
    meta = json.loads(blob[off:off + mlen].decode())
    off += mlen
    (crc,) = _U32.unpack_from(blob, off)
    off += 4
    payload = blob[off:]
    if binascii.crc32(payload) & 0xFFFFFFFF != crc:
        raise ValueError("payload CRC mismatch")
    return meta, payload


def _check_meta(meta: Dict) -> Optional[str]:
    """None when the entry is valid in this process; else the skew."""
    want = _runtime_meta()
    for k, v in want.items():
        if meta.get(k) != v:
            return "%s %r != %r" % (k, meta.get(k), v)
    return None


def _count(which: str):
    with _lock:
        _stats[which] = _stats.get(which, 0) + 1
    if which == "hits":
        _hits.inc()
    elif which == "misses":
        _misses.inc()
    elif which == "fallbacks":
        _fallbacks.inc()


def _drop_bad_entry(d: str, key: str):
    """Best-effort removal of an entry that failed verification, so the
    fallback is paid once, not on every restart."""
    try:
        os.remove(_entry_path(d, key))
    except OSError:
        pass
    with _lock:
        m = _load_manifest(d)
        if key in m["entries"]:
            del m["entries"][key]
            try:
                _commit_manifest(d, m)
            except OSError:
                pass


def load(key: str, kind: str = "", decode=None):
    """The entry under ``key``, or None.

    Without ``decode`` the value is ``(meta, payload bytes)``; with it,
    ``decode(payload, meta)``. None means "build fresh": a clean miss
    (``progcache_misses``) or an unusable entry (damage, version skew, a
    ``decode`` that raised: ``progcache_fallbacks``, and the entry is
    removed). Never raises. ``kind`` tags the hit for the compile witness
    (a disk load on that surface)."""
    d = cache_dir()
    if d is None:
        return None
    path = _entry_path(d, key)
    with _telemetry.span("progcache.load", domain="progcache", key=key[:12]):
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            _count("misses")
            return None
        except OSError as e:
            log.warning("progcache: unreadable entry %s (%s)", path, e)
            _count("fallbacks")
            return None
        try:
            meta, payload = _unpack_entry(blob)
            skew = _check_meta(meta)
            if skew is not None:
                raise ValueError("version skew: %s" % skew)
            value = (meta, payload) if decode is None \
                else decode(payload, meta)
        except Exception as e:
            log.warning("progcache: entry %s unusable (%s) — falling back "
                        "to a fresh build", path, e)
            _drop_bad_entry(d, key)
            _count("fallbacks")
            return None
    touch(key)
    _count("hits")
    if kind:
        from .analysis import compile_witness as _witness

        _witness.record_disk_load(kind, key=key)
    return value


def store(key: str, payload: bytes, note: str = "", kind: str = "",
          meta: Optional[Dict] = None) -> bool:
    """Commit ``payload`` (bytes) under ``key`` atomically, with ``meta``'s
    fields in the entry's meta block, then update the manifest and evict
    past the byte budget. ``kind`` classifies the entry for the per-kind
    byte accounting. Best-effort: False (never raises) when the write
    fails — the caller has its program either way."""
    d = cache_dir()
    if d is None:
        return False
    with _telemetry.span("progcache.store", domain="progcache",
                         key=key[:12]):
        try:
            full = dict(meta or {})
            full.update(_runtime_meta())
            full["key"] = key
            if note:
                full["note"] = note
            if kind:
                full["kind"] = kind
            blob = _pack_entry(full, bytes(payload))
            os.makedirs(d, exist_ok=True)
            _atomic_write_bytes(_entry_path(d, key), blob)
        except Exception as e:
            log.warning("progcache: store of %s failed (%s)", key[:12], e)
            return False
        victims: List[str] = []
        with _lock:
            m = _load_manifest(d)
            m["clock"] += 1
            entry = {"bytes": len(blob), "clock": m["clock"]}
            if kind:
                entry["kind"] = kind
            m["entries"][key] = entry
            victims = _evict_over_budget(d, m, protect=key)
            try:
                _commit_manifest(d, m)
            except OSError as e:
                log.warning("progcache: manifest commit failed (%s)", e)
            _stats["stores"] += 1
            _stats["evictions"] += len(victims)
    if victims:
        log.info("progcache: evicted %d entries over the %d-byte budget",
                 len(victims), byte_budget())
    return True


def touch(key: str):
    """Bump ``key``'s LRU clock (a hit, or a ladder retune keeping its
    bucket). Best-effort — advisory data only."""
    d = cache_dir()
    if d is None:
        return
    with _lock:
        m = _load_manifest(d)
        e = m["entries"].get(key)
        if e is None:
            return
        m["clock"] += 1
        e["clock"] = m["clock"]
        try:
            _commit_manifest(d, m)
        except OSError:
            pass


# --- persisted bucket ladders --------------------------------------------

def save_ladder(model_fp: str, buckets: Sequence[int]):
    """Persist a tuned bucket ladder for ``model_fp``: a restarted server
    adopts it (and disk-loads exactly those programs)."""
    d = cache_dir()
    if d is None:
        return
    with _lock:
        m = _load_manifest(d)
        m.setdefault("ladders", {})[model_fp] = sorted(
            int(b) for b in buckets)
        try:
            os.makedirs(d, exist_ok=True)
            _commit_manifest(d, m)
        except OSError as e:
            log.warning("progcache: ladder save failed (%s)", e)


def load_ladder(model_fp: str) -> Optional[List[int]]:
    d = cache_dir()
    if d is None:
        return None
    with _lock:
        m = _load_manifest(d)
        lad = m.get("ladders", {}).get(model_fp)
    return [int(b) for b in lad] if lad else None


# --- introspection --------------------------------------------------------

def stats() -> Dict[str, int]:
    """Session counters (this process): hits/misses/fallbacks/stores/
    evictions."""
    with _lock:
        return dict(_stats)


def reset_stats():
    with _lock:
        for k in _stats:
            _stats[k] = 0


def bytes_in_use() -> int:
    """Bytes on disk in the active cache dir (from the manifest)."""
    d = cache_dir()
    if d is None:
        return 0
    with _lock:
        m = _load_manifest(d)
        total = sum(e.get("bytes", 0) for e in m["entries"].values())
        _bytes_by_dir[d] = total
        _refresh_kind_bytes(d, m)
    return total


def bytes_by_kind() -> Dict[str, int]:
    """Bytes on disk in the active cache dir split by entry ``kind``
    (``""`` collects entries stored before kinds existed)."""
    d = cache_dir()
    if d is None:
        return {}
    with _lock:
        m = _load_manifest(d)
        _refresh_kind_bytes(d, m)
        return dict(_bytes_by_dir_kind[d])
