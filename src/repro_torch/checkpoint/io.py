"""Round-resumable checkpointing: a tree of tensors -> one msgpack file.

Counterpart of ``repro/checkpoint/io.py``, in its layout: a msgpack map of
``"treedef"`` (a string, ``jax.tree_util``'s form for nested dicts) and
``"leaves"``, each leaf a map of bin keys ``__nd__`` (true), ``dtype``
(numpy's ``dtype.str``), ``shape`` and ``data`` (the raw bytes), in the
port's leaf order (``utils.trees``: sorted dict keys, as ``jax.tree_util``
orders dicts).  A file written by either package loads in the other.  The
file is written to a temp file and renamed over the path.

The msgpack bytes are written and read by the small codec below (maps, str,
bin, bool, int, nil and arrays: all the layout uses), so the package needs
no ``msgpack``.  A bfloat16 leaf is written as the reference writes it,
dtype ``<V2`` with its raw bytes, and its bytes are read back as the
template leaf's bfloat16 (the reference cannot restore such a leaf).
"""

from __future__ import annotations

import os
import struct
import tempfile

import numpy as np
import torch

from repro_torch.utils.trees import tree_leaves, tree_structure, tree_unflatten

# ---------------------------------------------------------------------------
# msgpack: the subset of msgpack.packb(obj, use_bin_type=True) / unpackb
# ---------------------------------------------------------------------------


def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int, codes) -> None:
    """A length header: the fix form under ``fix_max``, else the smallest of
    ``codes`` = ((limit, first byte, struct format), ...)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for limit, code, fmt in codes:
        if n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object too large: {n}")


_STR = ((1 << 8, 0xD9, ">B"), (1 << 16, 0xDA, ">H"), (1 << 32, 0xDB, ">I"))
_BIN = ((1 << 8, 0xC4, ">B"), (1 << 16, 0xC5, ">H"), (1 << 32, 0xC6, ">I"))
_ARR = ((1 << 16, 0xDC, ">H"), (1 << 32, 0xDD, ">I"))
_MAP = ((1 << 16, 0xDE, ">H"), (1 << 32, 0xDF, ">I"))


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for limit, code, fmt in ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"),
                                 (1 << 32, 0xCE, ">I"), (1 << 64, 0xCF, ">Q")):
            if v < limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"integer out of msgpack range: {v}")
    else:
        for limit, code, fmt in ((1 << 7, 0xD0, ">b"), (1 << 15, 0xD1, ">h"),
                                 (1 << 31, 0xD2, ">i"), (1 << 63, 0xD3, ">q")):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"integer out of msgpack range: {v}")


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, _STR)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), None, 0, _BIN)
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, _ARR)
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, _MAP)
        for key, value in obj.items():
            _pack(out, key)
            _pack(out, value)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for maps, str, bin, bool,
    int, nil and lists or tuples (arrays)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos : self.pos + n]
        self.pos += n
        return chunk

    def num(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZED = {0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xDC: ("arr", ">H"), 0xDD: ("arr", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _unpack(r: _Reader):
    b = r.num(">B")
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _FIXED:
        return r.num(_FIXED[b])
    if 0xA0 <= b < 0xC0:
        kind, n = "str", b & 0x1F
    elif 0x90 <= b < 0xA0:
        kind, n = "arr", b & 0x0F
    elif 0x80 <= b < 0x90:
        kind, n = "map", b & 0x0F
    elif b in _SIZED:
        kind, fmt = _SIZED[b]
        n = r.num(fmt)
    else:
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
    if kind == "str":
        return bytes(r.take(n)).decode("utf-8")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "arr":
        return [_unpack(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        key = _unpack(r)
        out[key] = _unpack(r)
    return out


def unpackb(data: bytes):
    """Inverse of :func:`packb`: str as ``str``, bin as ``bytes``, arrays
    as lists (``msgpack.unpackb(data, raw=False, strict_map_key=False)``)."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


# ---------------------------------------------------------------------------
# trees of tensors
# ---------------------------------------------------------------------------


def _encode(leaf) -> dict:
    t = torch.as_tensor(leaf).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16: the raw 2-byte words
        dtype, data = "<V2", t.view(torch.int16).numpy().tobytes()
    else:
        arr = t.numpy()
        dtype, data = arr.dtype.str, arr.tobytes()
    return {b"__nd__": True, b"dtype": dtype, b"shape": list(t.shape), b"data": data}


def _decode(obj, template: torch.Tensor) -> torch.Tensor:
    """A leaf map -> a tensor like ``template``: its dtype, shape and
    device."""
    dtype = np.dtype(obj[b"dtype"])
    if dtype.kind == "V" and dtype.itemsize == 2:  # a bfloat16 leaf's raw words
        if template.dtype != torch.bfloat16:
            raise ValueError(f"a {dtype.str} leaf needs a bfloat16 template leaf, "
                             f"got {template.dtype}")
        t = torch.from_numpy(np.frombuffer(obj[b"data"], dtype=np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(obj[b"data"], dtype=dtype).copy())
    return t.reshape(obj[b"shape"]).to(device=template.device,
                                       dtype=template.dtype).reshape(template.shape)


def treedef_str(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for nested dicts."""
    def walk(node) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}" for k in sorted(node)) + "}"
        return "*"

    return f"PyTreeDef({walk(tree)})"


def save_pytree(path: str, tree) -> None:
    """Write ``tree``: nested dicts of tensors (or anything
    ``torch.as_tensor`` takes)."""
    payload = {
        "treedef": treedef_str(tree),
        "leaves": [_encode(leaf) for leaf in tree_leaves(tree)],
    }
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(packb(payload))
        os.replace(tmp, path)  # atomic
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_pytree(path: str, template):
    """Restore into the structure of ``template``, nested dicts of tensors
    (leaf order must match): each leaf takes the template leaf's dtype, shape
    and device."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    leaves = payload["leaves"]
    t_leaves = tree_leaves(template)
    if len(leaves) != len(t_leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, template {len(t_leaves)}")
    return tree_unflatten(tree_structure(template),
                          [_decode(l, t) for l, t in zip(leaves, t_leaves)])


def latest_checkpoint(directory: str, prefix: str = "ckpt_"):
    if not os.path.isdir(directory):
        return None
    cands = [
        f for f in os.listdir(directory) if f.startswith(prefix) and f.endswith(".msgpack")
    ]
    if not cands:
        return None

    def step_of(f):
        try:
            return int(f[len(prefix) : -len(".msgpack")])
        except ValueError:
            return -1

    return os.path.join(directory, max(cands, key=step_of))
