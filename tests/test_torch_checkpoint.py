"""The port's checkpoint IO (``repro_torch.checkpoint.io``) with the
body's sha256 on a second thread: the file keeps its layout byte for byte
— the header's digest is the sha256 of the body as written, its length
the body's — a restore read in small chunks round-trips bitwise and
refuses a flipped byte in its last chunk, and ``save(timings=)`` still
splits the seconds by part."""
import hashlib
import json

import pytest
import torch

from repro_torch.checkpoint import io


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.randn(1000, 37, generator=g),
            "b": [None, torch.arange(7, dtype=torch.int32),
                  (torch.randn(3, generator=g).bfloat16(),)],
            "c": torch.empty(0, 4)}


def test_the_header_declares_the_written_bodys_sha256(tmp_path):
    path = str(tmp_path / "x.ckpt")
    timings = {}
    io.save(path, _tree(), {"step": 3}, timings=timings)
    raw = open(path, "rb").read()
    assert raw.startswith(io.MAGIC)
    at = len(io.MAGIC) + 8
    hlen = int.from_bytes(raw[len(io.MAGIC):at], "little")
    header = json.loads(raw[at:at + hlen])
    body = raw[at + hlen:]
    assert header["body_len"] == len(body) == 4 * 37000 + 4 * 7 + 2 * 3
    assert header["body_sha256"] == hashlib.sha256(body).hexdigest()
    assert list(header) == ["meta", "entries", "kinds", "body_len",
                            "body_sha256"]
    assert sorted(timings) == ["copy_s", "hash_s", "sync_s", "write_s"]
    assert all(v >= 0 for v in timings.values())


def test_a_chunked_restore_round_trips_and_refuses_a_flipped_byte(
        tmp_path, monkeypatch):
    monkeypatch.setattr(io, "READ_CHUNK", 1000)
    path = str(tmp_path / "x.ckpt")
    tree = _tree()
    io.save(path, tree, {"step": 3})
    got, meta = io.restore(path)
    assert meta == {"step": 3}
    assert torch.equal(got["a"], tree["a"])
    assert got["b"][0] is None and torch.equal(got["b"][1], tree["b"][1])
    assert torch.equal(got["b"][2][0], tree["b"][2][0])
    assert tuple(got["c"].shape) == (0, 4)
    raw = bytearray(open(path, "rb").read())
    raw[-3] ^= 1
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(bytes(raw))
    with pytest.raises(io.CheckpointError, match="checksum"):
        io.restore(str(bad))
    (tmp_path / "torn.ckpt").write_bytes(bytes(raw[:-1500]))
    with pytest.raises(io.CheckpointError, match="torn"):
        io.restore(str(tmp_path / "torn.ckpt"))
