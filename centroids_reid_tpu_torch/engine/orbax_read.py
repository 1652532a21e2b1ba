"""Read the orbax checkpoints of the JAX package without orbax or
tensorstore (counterpart of ``restore_state`` in
``centroids_reid_tpu/engine/checkpoint.py`` and of the orbax branch of
``centroids_reid_tpu/inference/api.py::load_inference_model``).

The JAX package's ``CheckpointManager`` saves a ``TrainState`` with orbax's
``PyTreeCheckpointer``: a directory holding

* ``_METADATA``: JSON, every tree path with its key types (dict key or
  sequence index) and its value type (``jax.Array``, ``np.ndarray``,
  ``scalar``, or a ``None`` / empty container that holds no data);
* an OCDBT key-value store (tensorstore's "optionally-cooperative
  distributed B-tree"): ``manifest.ocdbt`` at the root, and one more store
  per writing process under ``ocdbt.process_<i>/``, whose B-tree nodes and
  data files live under ``d/``. The root store is the processes' stores
  merged; a directory without it is read as the union of the processes'.
* in the store, one zarr v2 array per array leaf, keyed by the tree path
  joined with ``.``: ``<name>/.zarray`` (JSON: dtype, shape, chunks, order,
  fill value, compressor) and a key per chunk (``<name>/0.0``, ...).

The OCDBT encoding (all integers little-endian varints unless stated):

* manifest and B-tree node files: magic (uint32, big-endian:
  ``0x0cdb3a2a`` manifest, ``0x0cdb20de`` node), total length (uint64),
  format version (0), compression (0 none, 1 zstd), the body (a zstd frame
  when compressed), CRC-32C of all that (uint32);
* a manifest body: the config (16-byte uuid, manifest kind, inline value
  limit, node size limit, version tree arity as log2 (uint8), compression
  method and, for zstd, its level as int32), then the newest versions of
  the version tree: a data file table, the version count and, one column
  per field, each version's generation number, root height (uint8), root
  node location (data file, offset, length), key count, tree bytes,
  indirect value bytes and commit time (uint64). Older versions sit in
  version tree nodes that a restore never reads;
* a B-tree node body: its height (uint8), a data file table, the entry
  count, the keys (the length of the prefix each shares with the entry
  before it, the suffix lengths, then the suffixes), then in a leaf each
  value's length and kind (inline or in a data file), the data file and
  offset of each value held in a file, and the inline values; in an
  interior node each subtree's common key prefix length, then each child's
  location and statistics. A child's keys omit the prefix its parent entry
  shares with the subtree;
* a data file table: the file count, path prefix lengths shared with the
  previous path, suffix lengths, base path lengths, then the suffixes. A
  path is relative to the base path of the node that names it.

Reading is lazy: opening a checkpoint reads the manifest and the B-tree
nodes (key -> where the value is); ``read_checkpoint(..., subtrees=...)``
reads and decodes only the arrays of the subtrees asked for, so
``load_inference_model`` never decodes the Adam moments. zstd frames go
through ``utils.zstd`` (the system's libzstd).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import zstd

_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
_MISSING = 2**64 - 1          # the root location of an empty version
_TMP_MARK = ".orbax-checkpoint-tmp-"
_ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")
# value types that hold no data: the reader returns them as orbax does
_EMPTY_VALUES = {"None": lambda: None, "Dict": dict, "List": list}
_DICT_KEY, _SEQUENCE_INDEX = 2, 1      # _METADATA's key types


def is_orbax_checkpoint(path: str) -> bool:
    """True for a committed orbax checkpoint directory: ``_METADATA`` and an
    OCDBT store (root or per-process). An unfinished async save
    (``*.orbax-checkpoint-tmp-*``) is none."""
    if not os.path.isdir(path):
        return False
    if _TMP_MARK in os.path.basename(os.path.normpath(path)):
        return False
    return os.path.isfile(os.path.join(path, "_METADATA")) and (
        os.path.isfile(os.path.join(path, "manifest.ocdbt"))
        or bool(_process_stores(path)))


def _process_stores(path: str) -> List[str]:
    return sorted(d for d in glob.glob(os.path.join(path, "ocdbt.process_*"))
                  if os.path.isfile(os.path.join(d, "manifest.ocdbt")))


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``; manifests and nodes are a few KB."""
    c = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Cursor:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def uint(self, n: int, signed: bool = False) -> int:
        return int.from_bytes(self.take(n), "little", signed=signed)

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} "
                             f"bytes left over")


def _unwrap(raw: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node file, its header and CRC checked."""
    if len(raw) < 18:
        raise ValueError(f"{what}: {len(raw)} bytes is no OCDBT file")
    if int.from_bytes(raw[:4], "big") != magic:
        raise ValueError(f"{what}: magic {raw[:4].hex()}, not {magic:08x}")
    if int.from_bytes(raw[4:12], "little") != len(raw):
        raise ValueError(f"{what}: length field "
                         f"{int.from_bytes(raw[4:12], 'little')} against "
                         f"{len(raw)} bytes")
    if _crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise ValueError(f"{what}: CRC-32C mismatch")
    r = _Cursor(raw[:-4], what)
    r.pos = 12
    if r.varint() != 0:
        raise ValueError(f"{what}: unknown format version")
    compression = r.varint()
    body = raw[r.pos:-4]
    if compression == 1:
        return bytes(zstd.decompress(body))
    if compression != 0:
        raise ValueError(f"{what}: unknown compression {compression}")
    return body


def _data_file_table(r: _Cursor, base: str) -> List[Tuple[str, str]]:
    """[(file path under the store root, base path of that file's own
    references)] of a node at base path ``base``."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base_len = r.varints(n)
    out, prev = [], b""
    for i in range(n):
        path = prev[:prefix[i]] + r.take(suffix[i])
        prev = path
        out.append((base + path.decode(), base + path[:base_len[i]].decode()))
    return out


def _key_lengths(r: _Cursor, n: int):
    """(shared prefix lengths, suffix lengths) of ``n`` keys."""
    return ([0] + r.varints(n - 1) if n else []), r.varints(n)


def _key_bytes(r: _Cursor, prefix, suffix) -> List[bytes]:
    out, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + r.take(s)
        out.append(prev)
    return out


class OcdbtStore:
    """The newest version of one OCDBT store: key -> value, where a value
    is inline bytes or (file, offset, length), read on ``get``. ``root``
    holds ``manifest.ocdbt``."""

    def __init__(self, root: str):
        self.root = root
        self.nodes_read = 0
        self.files: set = set()          # every file the tree was read from
        self._values: Dict[bytes, object] = {}
        what = os.path.join(root, "manifest.ocdbt")
        with open(what, "rb") as f:
            r = _Cursor(_unwrap(f.read(), _MANIFEST_MAGIC, what), what)
        r.take(16)                       # uuid
        if r.varint() != 0:
            raise ValueError(f"{what}: a numbered manifest (not what orbax "
                             f"writes) is not read")
        r.varint(), r.varint(), r.u8()   # value, node limits; arity
        if r.varint() == 1:
            r.uint(4, signed=True)       # zstd level
        files = _data_file_table(r, "")
        n = r.varint()
        if n == 0:
            return
        gens = r.varints(n)
        heights = [r.u8() for _ in range(n)]
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        newest = max(range(n), key=gens.__getitem__)
        if offsets[newest] == _MISSING:  # an empty store
            return
        path, base = files[ids[newest]]
        self._walk(path, base, offsets[newest], lengths[newest],
                   heights[newest], b"")

    def _read(self, path: str, offset: int, length: int) -> bytes:
        with open(os.path.join(self.root, path), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{path}: {length} bytes at {offset} asked, "
                             f"{len(data)} there")
        return data

    def _walk(self, path: str, base: str, offset: int, length: int,
              height: int, prefix: bytes) -> None:
        what = f"{os.path.join(self.root, path)}@{offset}"
        r = _Cursor(_unwrap(self._read(path, offset, length), _NODE_MAGIC,
                            what), what)
        self.nodes_read += 1
        self.files.add(path)
        if r.u8() != height:
            raise ValueError(f"{what}: height differs from its reference")
        files = _data_file_table(r, base)
        n = r.varint()
        pre, suf = _key_lengths(r, n)
        if height == 0:
            keys = _key_bytes(r, pre, suf)
            lengths = r.varints(n)
            kinds = r.varints(n)
            held = [i for i in range(n) if kinds[i] == 1]
            if any(k not in (0, 1) for k in kinds):
                raise ValueError(f"{what}: unknown value kind")
            ids, offs = r.varints(len(held)), r.varints(len(held))
            for i, f, o in zip(held, ids, offs):
                self._values[prefix + keys[i]] = (files[f][0], o, lengths[i])
                self.files.add(files[f][0])
            for i in range(n):
                if kinds[i] == 0:
                    self._values[prefix + keys[i]] = r.take(lengths[i])
            r.end()
            return
        common = r.varints(n)
        keys = _key_bytes(r, pre, suf)
        ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)                 # keys, tree bytes, indirect bytes
        r.end()
        for i in range(n):
            self._walk(files[ids[i]][0], files[ids[i]][1], offs[i], lens[i],
                       height - 1, prefix + keys[i][:common[i]])

    def keys(self) -> List[bytes]:
        return sorted(self._values)

    def get(self, key: str) -> Optional[bytes]:
        """The value at ``key``, or None when the store has no such key."""
        v = self._values.get(key.encode())
        if v is None or isinstance(v, bytes):
            return v
        return self._read(*v)


class _UnionStore:
    """The per-process stores of a checkpoint without a root manifest."""

    def __init__(self, stores: Sequence[OcdbtStore]):
        self.stores = list(stores)
        seen: set = set()
        for s in self.stores:
            dup = seen.intersection(s.keys())
            if dup:
                raise ValueError(f"key {sorted(dup)[0]!r} in two process "
                                 f"stores")
            seen.update(s.keys())

    def get(self, key: str) -> Optional[bytes]:
        for s in self.stores:
            v = s.get(key)
            if v is not None:
                return v
        return None


def open_store(path: str):
    """The checkpoint's key-value store: the root one, or the union of the
    per-process ones."""
    if os.path.isfile(os.path.join(path, "manifest.ocdbt")):
        return OcdbtStore(path)
    procs = _process_stores(path)
    if not procs:
        raise FileNotFoundError(f"{path}: no OCDBT manifest")
    return _UnionStore([OcdbtStore(p) for p in procs])


def _fill(value):
    if value is None:
        return 0
    if isinstance(value, str):
        return {"NaN": np.nan, "Infinity": np.inf,
                "-Infinity": -np.inf}[value]
    return value


def read_array(store, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store``, decoded."""
    raw = store.get(f"{name}/.zarray")
    if raw is None:
        raise KeyError(f"{name}: no array in the checkpoint")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2 or meta.get("filters"):
        raise ValueError(f"{name}: not a zarr v2 array without filters")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {comp.get('id')!r}; orbax "
                         f"writes zstd")
    try:
        dtype = np.dtype(meta["dtype"])
    except TypeError:
        raise ValueError(f"{name}: dtype {meta['dtype']!r} is not one numpy "
                         f"reads") from None
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    out = None
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        data = store.get(key)
        if data is None:                 # an unwritten chunk: fill value
            continue
        if comp is not None:
            data = zstd.decompress(data)
        chunk = np.frombuffer(data, dtype).reshape(chunks, order=order)
        if chunks == shape:              # one chunk: the whole array
            return chunk if chunk.flags.writeable else chunk.copy()
        if out is None:
            out = np.full(shape, _fill(meta.get("fill_value")), dtype)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    if out is None:
        out = np.full(shape, _fill(meta.get("fill_value")), dtype)
    return out


def read_checkpoint(path: str,
                    subtrees: Optional[Iterable[Sequence[str]]] = None):
    """The tree saved at ``path`` as nested dicts (dict keys) and lists
    (sequence indices) of numpy arrays (0-d for scalars), with ``None`` and
    empty containers where the tree holds them, as orbax restores it with
    ``restore_type=np.ndarray``. ``subtrees``: the tree paths to read
    (e.g. ``[("params", "model"), ("batch_stats",)]``); the rest is not
    decoded. Raises on a value type or layout the reader does not know."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(
            f"{path}: use_ocdbt={meta.get('use_ocdbt')}, use_zarr3="
            f"{meta.get('use_zarr3')}; the JAX package writes OCDBT with "
            f"zarr v2, and only that is read")
    wanted = [tuple(s) for s in subtrees] if subtrees is not None else None
    store = open_store(path)
    root: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [(str(k["key"]), int(k["key_type"]))
                for k in entry["key_metadata"]]
        names = tuple(k for k, _ in keys)
        if wanted is not None and not any(names[:len(w)] == w
                                          for w in wanted):
            continue
        dotted = ".".join(names)
        kind = entry["value_metadata"]["value_type"]
        if kind in _ARRAY_TYPES:
            value = read_array(store, dotted)
        elif kind in _EMPTY_VALUES:
            value = _EMPTY_VALUES[kind]()
        else:
            raise ValueError(f"{path}: {dotted} has value type {kind!r}, "
                             f"which the reader does not know")
        node = root
        for depth, (key, key_type) in enumerate(keys):
            if key_type not in (_DICT_KEY, _SEQUENCE_INDEX):
                raise ValueError(f"{path}: {dotted}: key type {key_type}")
            slot = int(key) if key_type == _SEQUENCE_INDEX else key
            if depth == len(keys) - 1:
                node[slot] = value
            else:
                node = node.setdefault(slot, {})
    return _lists(root)


def _lists(node):
    """Nodes keyed by sequence indices (ints) -> lists."""
    if not isinstance(node, dict) or not node:
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise ValueError(f"sequence indices {sorted(out)} have gaps")
        return [out[i] for i in range(len(out))]
    return out
