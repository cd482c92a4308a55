"""Checkpoint IO: a JSON header + raw tensor bytes, standard library only.

Layout: ``MAGIC`` + 8-byte little-endian header length + UTF-8 JSON header
(tree paths, shapes, torch dtype names, offsets, the declared body length
and its sha256, the caller's metadata) followed by the concatenated raw
tensor bytes.  The JAX package's ``repro.checkpoint.io`` has the same
layout with a msgpack header and numpy leaves; this one has its own magic,
so a file of one package is refused by the other, never misread.

Leaves are torch tensors (any device; saved from a host copy) or ``None``;
dict / list / tuple nesting round-trips.  :func:`restore` returns CPU
tensors with the saved dtypes (bf16 included: leaves are rebuilt with
``torch.frombuffer``, not through numpy) — the caller places them.

Robustness contract (the durable serving layer builds on it):

* writes are atomic — the file is staged as ``.tmp`` and published with
  ``os.replace``, so a crashed writer never leaves a half-written file
  under the real name;
* reads are *refusals, not garbage*: a bad magic, an unreadable header, a
  torn/truncated body (shorter than the header-declared length, or an
  entry reaching past the end), or a body whose sha256 disagrees with the
  header all raise :class:`CheckpointError` — never a bare ``assert`` and
  never a silently short read.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import time
from typing import Any, Dict, Optional

import torch

MAGIC = b"RTORCHCKP1"


class CheckpointError(ValueError):
    """A checkpoint file was refused: wrong magic, truncated/torn, or its
    content checksum disagrees with the header.  Callers (e.g. snapshot
    recovery) treat this as "quarantine and fall back", never as data."""


def _flatten_with_paths(tree, prefix=""):
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out += _flatten_with_paths(v, f"{prefix}/{i}")
    else:
        out.append((prefix, tree))
    return out


def _kinds(tree):
    """Minimal structure spec so restore can rebuild tuples vs lists."""
    if isinstance(tree, dict):
        return {"t": "dict", "c": {k: _kinds(v) for k, v in tree.items()}}
    if isinstance(tree, tuple):
        return {"t": "tuple", "c": [_kinds(v) for v in tree]}
    if isinstance(tree, list):
        return {"t": "list", "c": [_kinds(v) for v in tree]}
    if tree is None:
        return {"t": "none"}
    return {"t": "leaf"}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def save(path: str, tree: Any, metadata: Optional[Dict] = None, *,
         timings: Optional[Dict[str, float]] = None) -> None:
    """Write ``tree`` (tensors and ``None`` under dicts / lists / tuples)
    with ``metadata`` to ``path``.  ``timings``, when given, accumulates
    the seconds of the wait for the device's queued work (``sync_s``),
    the device→host copy (``copy_s``), the body's sha256 (``hash_s``) and
    the file write (``write_s``)."""
    pairs = _flatten_with_paths(tree)
    t0 = time.perf_counter()
    devices = {a.device for _, a in pairs
               if isinstance(a, torch.Tensor) and a.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    header = {"meta": metadata or {}, "entries": [], "kinds": _kinds(tree)}
    chunks, off = [], 0
    for name, arr in pairs:
        if arr is None:
            header["entries"].append({"name": name, "none": True})
            continue
        if not isinstance(arr, torch.Tensor):
            raise TypeError(f"checkpoint leaf {name!r} is a "
                            f"{type(arr).__name__}, not a tensor")
        a = arr.detach().to("cpu").contiguous()
        # the raw bytes as a uint8 view: no copy past the host one
        chunks.append(a.reshape(-1).view(torch.uint8).numpy())
        header["entries"].append({
            "name": name, "shape": list(a.shape),
            "dtype": _dtype_name(a.dtype), "offset": off, "none": False})
        off += chunks[-1].nbytes
    t2 = time.perf_counter()
    # declared length + content hash: restore() detects torn writes and
    # bit-rot instead of returning silently short reads
    digest = hashlib.sha256()
    for c in chunks:
        digest.update(c)
    header["body_len"] = off
    header["body_sha256"] = digest.hexdigest()
    t3 = time.perf_counter()
    hb = json.dumps(header, separators=(",", ":")).encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(len(hb).to_bytes(8, "little"))
        f.write(hb)
        for c in chunks:
            f.write(c)
    os.replace(tmp, path)
    t4 = time.perf_counter()
    if timings is not None:
        for k, dt in (("sync_s", t1 - t0), ("copy_s", t2 - t1),
                      ("hash_s", t3 - t2), ("write_s", t4 - t3)):
            timings[k] = timings.get(k, 0.0) + dt


def _read_header(f, path: str) -> Dict:
    magic = f.read(len(MAGIC))
    if magic != MAGIC:
        raise CheckpointError(f"bad checkpoint magic in {path}")
    raw = f.read(8)
    if len(raw) < 8:
        raise CheckpointError(f"truncated checkpoint header in {path}")
    hlen = int.from_bytes(raw, "little")
    hb = f.read(hlen)
    if len(hb) < hlen:
        raise CheckpointError(f"truncated checkpoint header in {path}")
    try:
        header = json.loads(hb.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise CheckpointError(
            f"corrupt checkpoint header in {path}: "
            f"{type(e).__name__}: {e}") from e
    if not isinstance(header, dict) or "entries" not in header \
            or "kinds" not in header:
        raise CheckpointError(f"malformed checkpoint header in {path}")
    return header


def read_meta(path: str) -> Dict:
    """Read only the metadata dict — magic + header are verified, the
    (possibly large) tensor body is not touched."""
    with open(path, "rb") as f:
        header = _read_header(f, path)
    return header.get("meta", {})


def _dtype(e: Dict, path: str) -> torch.dtype:
    dt = getattr(torch, str(e.get("dtype")), None)
    if not isinstance(dt, torch.dtype):
        raise CheckpointError(
            f"checkpoint {path}: entry {e.get('name')!r} has invalid "
            f"dtype {e.get('dtype')!r}")
    return dt


def restore(path: str):
    """Returns ``(tree, metadata)`` with CPU tensors.  Refuses (with
    :class:`CheckpointError`) files whose magic/header is unreadable,
    whose body is shorter than the header declares (torn write), whose
    entries reach past the body, or whose body sha256 disagrees with the
    header (bit-rot / tamper)."""
    with open(path, "rb") as f:
        header = _read_header(f, path)
        body = bytearray(f.read())
    declared = header.get("body_len")
    if declared is not None and len(body) != int(declared):
        raise CheckpointError(
            f"torn checkpoint {path}: body is {len(body)} bytes, header "
            f"declares {declared}")
    want_sha = header.get("body_sha256")
    if want_sha is not None:
        got = hashlib.sha256(body).hexdigest()
        if got != want_sha:
            raise CheckpointError(
                f"checkpoint {path} failed its content checksum "
                f"(sha256 {got[:12]}… != declared {str(want_sha)[:12]}…)")
    leaves = {}
    for e in header["entries"]:
        if e.get("none"):
            leaves[e["name"]] = None
            continue
        dt = _dtype(e, path)
        shape = [int(s) for s in e["shape"]]
        n = math.prod(shape)
        off = int(e["offset"])
        need = off + n * dt.itemsize
        if need > len(body):
            raise CheckpointError(
                f"torn checkpoint {path}: entry {e['name']!r} needs bytes "
                f"up to {need}, body has {len(body)}")
        if n == 0:
            leaves[e["name"]] = torch.empty(shape, dtype=dt)
            continue
        a = torch.frombuffer(body, dtype=dt, count=n, offset=off)
        leaves[e["name"]] = a.clone().reshape(shape)
    tree = _rebuild(header["kinds"], leaves, "")
    return tree, header.get("meta", {})


def _rebuild(kind, leaves, prefix):
    t = kind["t"]
    if t == "dict":
        return {k: _rebuild(v, leaves, f"{prefix}/{k}")
                for k, v in kind["c"].items()}
    if t == "tuple":
        return tuple(_rebuild(v, leaves, f"{prefix}/{i}")
                     for i, v in enumerate(kind["c"]))
    if t == "list":
        return [_rebuild(v, leaves, f"{prefix}/{i}")
                for i, v in enumerate(kind["c"])]
    if t == "none":
        return None
    try:
        return leaves[prefix]
    except KeyError as e:
        raise CheckpointError(f"checkpoint entry {prefix!r} is missing "
                              "from the header") from e
