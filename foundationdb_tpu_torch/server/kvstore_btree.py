"""Copy-on-write B-tree storage engine over paged files (the port of
foundationdb_tpu/server/kvstore_btree.py, whole).

Reference: fdbserver/VersionedBTree.actor.cpp (Redwood) — a paged
copy-on-write B+tree behind IKeyValueStore: modified pages are written to
fresh page ids, parents re-point up to a new root, and a double-slot
header commits the new root atomically (IPager.h versioned pager).  This
engine keeps Redwood's crash-consistency shape without its versioning or
prefix compression, and carries the pager features that bound file growth
and record size:

  page 0/1:  alternating header slots (magic, commit_seq, root id, page
             count, crc) — recovery picks the valid slot with the higher
             seq, so a power failure mid-commit always lands on a complete
             tree (old or new, never torn).
  leaves:    sorted (key, value-or-overflow-ref) records.
  internal:  child ids + SHORTENED separator keys (child i covers keys
             < sep[i]; separators are the shortest prefix of the right
             sibling's first key that still separates — Redwood's prefix
             truncation keeps internal nodes small under large keys).
  overflow:  values larger than _OVERFLOW_BYTES live in chains of whole
             pages referenced from the leaf record (reference Redwood
             "big value" overflow pages); the ref carries the page list
             so replaced/cleared records free their chains.
  free list: pages orphaned by COW replacement are reusable from the NEXT
             commit on (a torn commit must still find the previous tree
             intact — the reference pager's delayed-free queue).  The
             list is rebuilt at recovery by a reachability walk, so it
             needs no durable format of its own.

Commit protocol: write all new pages, fsync, write the next header slot,
fsync — the reference's "commit is one header write" invariant.

The calls are synchronous over a RealFileSystem (server/real_fs.py): the
reference awaits its simulated files and drives reads through its _sync
helper, which has no counterpart here.  read_range has one form, the
reference's iterative leaf walk (STORAGE_VECTORIZED_SCAN), whose rows
equal its recursive walk's.
"""

from __future__ import annotations

import bisect
import zlib
from typing import Dict, List, Optional, Tuple, Union

from ..core.error import err
from ..core.knobs import server_knobs
from ..core.trace import Severity, TraceEvent
from ..core.wire import Reader, Writer
from .kvstore import IKeyValueStore

PAGE_SIZE = 4096
_MAGIC = 0x0FDBB7EE
# Page kinds.  _LEAF_C is the prefix-COMPRESSED leaf: one
# shared page prefix + per-entry key suffixes (the reference's Redwood
# page key compression).  Written only under BTREE_PREFIX_COMPRESSION;
# DECODED unconditionally — plain and compressed pages coexist in one
# file, so the knob can flip on a live store and COW rewrites migrate
# pages incrementally (and knobs-off readers still read everything).
_LEAF, _INTERNAL, _LEAF_C = 0, 1, 2
# Split when a serialized page exceeds this (leaving headroom for the
# page header fields).
_SPLIT_BYTES = PAGE_SIZE - 64
# Values above this spill to overflow page chains.
_OVERFLOW_BYTES = 1024
# Usable payload per overflow page (after the 8-byte len+crc frame).
_OVF_PAYLOAD = PAGE_SIZE - 8


def _frame_page(blob: bytes) -> bytes:
    """len:4 | crc:4 | blob — every data/overflow page carries a CRC
    (reference: Redwood checksums every page).  Bit-rot that still
    DECODES would otherwise be served silently; the header-slot CRC only
    protects the roots."""
    return (len(blob).to_bytes(4, "little") +
            zlib.crc32(blob).to_bytes(4, "little") + blob)


def _unframe_page(raw: bytes) -> Optional[bytes]:
    """The page payload, or None if the frame fails its CRC."""
    n = int.from_bytes(raw[:4], "little")
    blob = raw[8:8 + n]
    if len(blob) != n or \
            zlib.crc32(blob) != int.from_bytes(raw[4:8], "little"):
        return None
    return blob


class OverflowRef:
    """A leaf record's value stored out-of-line in whole pages."""

    __slots__ = ("length", "pages")

    def __init__(self, length: int, pages: List[int]) -> None:
        self.length = length
        self.pages = pages

    def ref_size(self) -> int:
        return 8 + 4 * len(self.pages)


Value = Union[bytes, OverflowRef]


def _shared_prefix_len(a: bytes, b: bytes) -> int:
    """Length of the longest common prefix of a page's first and last
    keys -- sorted within the page, so shared by EVERY key (the
    reference's core/wire.py longest_common_prefix_len): a binary search
    over C-speed slice compares."""
    n = min(len(a), len(b))
    if n == 0 or a[:1] != b[:1]:
        return 0
    if a[:n] == b[:n]:
        return n
    lo, hi = 1, n - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if a[:mid] == b[:mid]:
            lo = mid
        else:
            hi = mid - 1
    return lo


class _Node:
    __slots__ = ("kind", "keys", "values", "children")

    def __init__(self, kind: int, keys=None, values=None, children=None):
        self.kind = kind
        self.keys: List[bytes] = keys or []       # leaf: record keys;
        self.values: List[Value] = values or []   # internal: separators
        self.children: List[int] = children or []

    def _page_prefix_len(self) -> int:
        keys = self.keys
        if not keys:
            return 0
        return _shared_prefix_len(keys[0], keys[-1])

    def encode(self) -> bytes:
        if self.kind == _LEAF:
            blob = self._encode_leaf(
                bool(server_knobs().BTREE_PREFIX_COMPRESSION))
            if blob[0] == _LEAF and 8 + len(blob) > PAGE_SIZE:
                # Knob-flip safety valve: a leaf PACKED under the
                # compressed size estimate (knob was on) being COW-
                # rewritten with the knob now OFF can exceed a page in
                # plain form — and the split machinery can't always
                # recover (halves may still be oversized; clears don't
                # split at all).  Keep such pages compressed: pages
                # self-describe via their kind byte, so the store stays
                # readable either way and the flip stays live-safe.
                blob = self._encode_leaf(True)
            return blob
        w = Writer().u8(self.kind).u32(len(self.keys))
        for k in self.keys:
            w.bytes_(k)
        w.u32(len(self.children))
        for c in self.children:
            w.u32(c)
        return w.done()

    def _encode_leaf(self, compressed: bool) -> bytes:
        if compressed:
            # Compressed leaf: shared prefix once, suffixes per entry.
            p = self._page_prefix_len()
            w = Writer().u8(_LEAF_C).u32(len(self.keys))
            w.bytes_(self.keys[0][:p] if self.keys else b"")
            for k in self.keys:
                w.bytes_(k[p:])
        else:
            w = Writer().u8(_LEAF).u32(len(self.keys))
            for k in self.keys:
                w.bytes_(k)
        for v in self.values:
            if isinstance(v, OverflowRef):
                w.u8(1).u32(v.length).u32(len(v.pages))
                for p in v.pages:
                    w.u32(p)
            else:
                w.u8(0).bytes_(v)
        return w.done()

    @classmethod
    def decode(cls, blob: bytes) -> "_Node":
        r = Reader(blob)
        kind = r.u8()
        n = r.u32()
        if kind == _LEAF_C:
            # Prefix-compressed leaf: reconstruct full keys (always
            # decodable, knob or not — on-disk compat both directions).
            prefix = r.bytes_()
            keys = [prefix + r.bytes_() for _ in range(n)]
            kind = _LEAF
        else:
            keys = [r.bytes_() for _ in range(n)]
        if kind == _LEAF:
            values: List[Value] = []
            for _ in range(n):
                if r.u8():
                    length = r.u32()
                    pages = [r.u32() for _ in range(r.u32())]
                    values.append(OverflowRef(length, pages))
                else:
                    values.append(r.bytes_())
            return cls(_LEAF, keys, values)
        children = [r.u32() for _ in range(r.u32())]
        return cls(_INTERNAL, keys, None, children)

    def size(self) -> int:
        if self.kind == _LEAF:
            if server_knobs().BTREE_PREFIX_COMPRESSION:
                # Split threshold tracks the COMPRESSED encoding, so
                # dense same-prefix keyspaces genuinely pack more
                # entries per page (the estimate stays >= the encoded
                # bytes; commit() still hard-checks PAGE_SIZE).
                p = self._page_prefix_len()
                base = p + 8 + sum(len(k) - p + 8 for k in self.keys)
            else:
                base = sum(len(k) + 8 for k in self.keys)
            return base + sum(
                v.ref_size() if isinstance(v, OverflowRef) else len(v) + 1
                for v in self.values)
        base = sum(len(k) + 8 for k in self.keys)
        return base + 4 * len(self.children)


def _shorten_sep(left_last: bytes, right_first: bytes) -> bytes:
    """Shortest prefix of right_first that still exceeds left_last
    (Redwood-style separator truncation: internal nodes stay small no
    matter how large leaf keys grow)."""
    for i in range(len(right_first)):
        if i >= len(left_last) or right_first[i] != left_last[i]:
            return right_first[:i + 1]
    return right_first


class KVStoreBTree(IKeyValueStore):
    """COW B+tree engine (reference Redwood, simplified)."""

    def __init__(self, fs, prefix: str) -> None:
        self.fs = fs
        self.file = fs.open(prefix + ".btree")
        self._uncommitted: List[Tuple[int, bytes, bytes]] = []
        self._cache: Dict[int, _Node] = {}
        # page id -> _Node (tree page) or bytes (raw overflow payload)
        self._dirty: Dict[int, Union[_Node, bytes]] = {}
        self.root = 0          # 0 = empty tree
        self.page_count = 2    # slots 0,1 are headers
        self.commit_seq = 0
        # Reusable page ids (freed by PREVIOUS commits; see module doc).
        self.free: List[int] = []
        self._freed_this_commit: List[int] = []

    # -- paging --------------------------------------------------------------
    def _read_node(self, page_id: int) -> _Node:
        node = self._dirty.get(page_id) or self._cache.get(page_id)
        if node is None:
            raw = self.file.read(page_id * PAGE_SIZE, PAGE_SIZE)
            blob = _unframe_page(raw)
            try:
                if blob is None:
                    raise ValueError("page CRC mismatch")
                node = _Node.decode(blob)
            except Exception as e:
                # Rotted page (CRC) or undecodable bytes: this engine
                # must never hand garbage upward — io_error is
                # process-fatal in the storage role above.
                TraceEvent("BTreePageCorrupt", Severity.Error).detail(
                    "File", self.file.name).detail(
                    "Page", page_id).detail("Reason", repr(e)).log()
                raise err("io_error",
                          f"btree page {page_id} corrupt in "
                          f"{self.file.name}")
            self._cache[page_id] = node
        return node

    def _alloc_id(self) -> int:
        if self.free:
            return self.free.pop()
        page_id = self.page_count
        self.page_count += 1
        return page_id

    def _alloc(self, node: _Node) -> int:
        page_id = self._alloc_id()
        self._dirty[page_id] = node
        return page_id

    def _free_page(self, page_id: int) -> None:
        if page_id >= 2:
            self._freed_this_commit.append(page_id)
            self._cache.pop(page_id, None)
            self._dirty.pop(page_id, None)

    def _free_value(self, v: Value) -> None:
        if isinstance(v, OverflowRef):
            for p in v.pages:
                self._free_page(p)

    def _store_value(self, value: bytes) -> Value:
        """Inline small values; spill large ones to an overflow chain."""
        if len(value) <= _OVERFLOW_BYTES:
            return value
        pages: List[int] = []
        for off in range(0, len(value), _OVF_PAYLOAD):
            chunk = value[off:off + _OVF_PAYLOAD]
            pid = self._alloc_id()
            self._dirty[pid] = bytes(chunk)
            pages.append(pid)
        return OverflowRef(len(value), pages)

    def _load_value(self, v: Value) -> bytes:
        if not isinstance(v, OverflowRef):
            return v
        parts: List[bytes] = []
        remaining = v.length
        for pid in v.pages:
            raw = self._dirty.get(pid)
            if isinstance(raw, bytes):
                part = raw
            else:
                part = _unframe_page(
                    self.file.read(pid * PAGE_SIZE, PAGE_SIZE))
                if part is None:
                    TraceEvent("BTreePageCorrupt", Severity.Error).detail(
                        "File", self.file.name).detail("Page", pid).detail(
                        "Reason", "overflow CRC mismatch").log()
                    raise err("io_error",
                              f"btree overflow page {pid} corrupt in "
                              f"{self.file.name}")
            parts.append(part[:remaining])
            remaining -= len(parts[-1])
        return b"".join(parts)

    def _header_blob(self) -> bytes:
        w = Writer().u32(_MAGIC).i64(self.commit_seq).u32(self.root)
        w.u32(self.page_count)
        body = w.done()
        return body + zlib.crc32(body).to_bytes(4, "little")

    # -- mutation ------------------------------------------------------------
    def set(self, key: bytes, value: bytes) -> None:
        self._uncommitted.append((0, key, value))

    def clear(self, begin: bytes, end: bytes) -> None:
        self._uncommitted.append((1, begin, end))

    def _cow_set(self, page_id: int, key: bytes, value: bytes) -> int:
        """Insert/overwrite; returns the NEW page id for this subtree
        (list of ids if the node split)."""
        if page_id == 0:
            return self._alloc(_Node(_LEAF, [key], [self._store_value(value)]))
        node = self._read_node(page_id)
        if node.kind == _LEAF:
            i = bisect.bisect_left(node.keys, key)
            keys, values = list(node.keys), list(node.values)
            stored = self._store_value(value)
            if i < len(keys) and keys[i] == key:
                self._free_value(values[i])   # replaced value's chain
                values[i] = stored
            else:
                keys.insert(i, key)
                values.insert(i, stored)
            self._free_page(page_id)
            return self._finish(_Node(_LEAF, keys, values))
        ci = bisect.bisect_right(node.keys, key)
        new_child = self._cow_set(node.children[ci], key, value)
        return self._replace_child(page_id, node, ci, new_child)

    def _finish(self, node: _Node):
        """Allocate `node`, splitting when oversized; returns page id or
        (left_id, sep_key, right_id)."""
        if node.size() <= _SPLIT_BYTES or len(node.keys) < 2:
            return self._alloc(node)
        mid = len(node.keys) // 2
        if node.kind == _LEAF:
            left = _Node(_LEAF, node.keys[:mid], node.values[:mid])
            right = _Node(_LEAF, node.keys[mid:], node.values[mid:])
            sep = _shorten_sep(node.keys[mid - 1], node.keys[mid])
        else:
            # separator mid is promoted, not kept.
            left = _Node(_INTERNAL, node.keys[:mid], None,
                         node.children[:mid + 1])
            right = _Node(_INTERNAL, node.keys[mid + 1:], None,
                          node.children[mid + 1:])
            sep = node.keys[mid]
        return (self._alloc(left), sep, self._alloc(right))

    def _replace_child(self, page_id: int, node: _Node, ci: int, new_child):
        keys = list(node.keys)
        children = list(node.children)
        if isinstance(new_child, tuple):
            lid, sep, rid = new_child
            children[ci:ci + 1] = [lid, rid]
            keys.insert(ci, sep)
        else:
            children[ci] = new_child
        self._free_page(page_id)
        return self._finish(_Node(_INTERNAL, keys, None, children))

    def _cow_clear(self, page_id: int, begin: bytes,
                         end: bytes) -> int:
        if page_id == 0:
            return 0
        node = self._read_node(page_id)
        if node.kind == _LEAF:
            pairs = []
            for k, v in zip(node.keys, node.values):
                if begin <= k < end:
                    self._free_value(v)       # cleared record's chain
                else:
                    pairs.append((k, v))
            if len(pairs) == len(node.keys):
                return page_id     # nothing cleared: no COW churn
            self._free_page(page_id)
            if not pairs:
                return 0
            return self._alloc(_Node(_LEAF, [k for k, _ in pairs],
                                     [v for _, v in pairs]))
        lo = bisect.bisect_right(node.keys, begin)
        hi = bisect.bisect_left(node.keys, end) + 1
        keys: List[bytes] = []
        children: List[int] = []
        changed = False
        for ci, child in enumerate(node.children):
            if lo <= ci < hi:
                new_child = self._cow_clear(child, begin, end)
                changed = changed or new_child != child
                child = new_child
            if child != 0:
                if children:
                    # Separator between the previous kept child and this
                    # one: the original separator just left of child ci
                    # upper-bounds every earlier subtree and lower-bounds
                    # this one (ci > 0 whenever a child was already kept).
                    keys.append(node.keys[ci - 1])
                children.append(child)
        if not changed:
            return page_id         # subtree untouched: keep the old pages
        self._free_page(page_id)
        if not children:
            return 0
        if len(children) == 1:
            return children[0]
        return self._finish(_Node(_INTERNAL, keys, None, children))

    def commit(self) -> None:
        batch, self._uncommitted = self._uncommitted, []
        page_count0 = self.page_count
        free0 = list(self.free)
        root = self.root
        for op, a, b in batch:
            if op == 0:
                r = self._cow_set(root, a, b)
            else:
                r = self._cow_clear(root, a, b)
            if isinstance(r, tuple):
                lid, sep, rid = r
                r = self._alloc(_Node(_INTERNAL, [sep], None, [lid, rid]))
            root = r
        # Validate page sizes BEFORE any write so an oversized record
        # (a single KEY too large for a page — values overflow, keys do
        # not) fails cleanly with the tree untouched.
        encoded = {}
        for page_id, node in self._dirty.items():
            if isinstance(node, bytes):
                encoded[page_id] = node        # raw overflow payload
                continue
            blob = node.encode()
            if 8 + len(blob) > PAGE_SIZE:
                self._dirty = {}
                self.page_count = page_count0
                self.free = free0
                self._freed_this_commit = []
                raise err("operation_failed",
                          "btree key exceeds page capacity")
            encoded[page_id] = blob
        # Write dirty pages, fsync, then the next header slot, fsync
        # (reference: commit == one durable header write).
        for page_id, blob in encoded.items():
            self.file.write(page_id * PAGE_SIZE, _frame_page(blob))
        self.file.sync()
        for page_id, node in self._dirty.items():
            if isinstance(node, _Node):
                self._cache[page_id] = node
        self._dirty = {}
        self.root = root
        self.commit_seq += 1
        slot = self.commit_seq % 2
        self.file.write(slot * PAGE_SIZE, self._header_blob())
        self.file.sync()
        # Pages orphaned by THIS commit become reusable from the next one
        # (the previous tree stays intact under this commit's writes, so a
        # torn next-commit still recovers cleanly).
        self.free.extend(self._freed_this_commit)
        self._freed_this_commit = []

    # -- reads ---------------------------------------------------------------
    def read_value(self, key: bytes) -> Optional[bytes]:
        page_id = self.root
        while page_id != 0:
            node = self._read_node(page_id)
            if node.kind == _LEAF:
                i = bisect.bisect_left(node.keys, key)
                if i < len(node.keys) and node.keys[i] == key:
                    return self._load_value(node.values[i])
                return None
            page_id = node.children[bisect.bisect_right(node.keys, key)]
        return None

    def read_range(self, begin: bytes, end: bytes, limit: int = 1 << 30
                   ) -> List[Tuple[bytes, bytes]]:
        out: List[Tuple[bytes, bytes]] = []
        self._scan_slices(begin, end, limit, out)
        return out

    def _scan_slices(self, begin: bytes, end: bytes, limit: int,
                           out: List) -> None:
        """An iterative walk emitting each leaf's contribution as ONE
        bisected slice (zip over the page's key/value arrays) -- on a
        prefix-compressed store the slice is a near-memcpy of page
        entries."""
        if self.root == 0:
            return
        stack = [self.root]
        while stack:
            node = self._read_node(stack.pop())
            if node.kind != _LEAF:
                lo = bisect.bisect_right(node.keys, begin)
                hi = bisect.bisect_left(node.keys, end) + 1
                # Reversed push: the leftmost child pops first, so rows
                # emit in key order.
                stack.extend(reversed(node.children[lo:hi]))
                continue
            lo = bisect.bisect_left(node.keys, begin)
            hi = bisect.bisect_left(node.keys, end)
            if hi - lo > limit - len(out):
                hi = lo + (limit - len(out))
            if lo >= hi:
                continue
            vs = node.values[lo:hi]
            if any(isinstance(v, OverflowRef) for v in vs):
                for k, v in zip(node.keys[lo:hi], vs):
                    out.append((k, self._load_value(v)))
            else:
                out.extend(zip(node.keys[lo:hi], vs))
            if len(out) >= limit:
                return

    def stats(self) -> dict:
        """Engine shape for bench/status: page accounting feeds the
        compression-ratio figure (pages needed for the same keyspace,
        compressed vs plain)."""
        return {"engine": "btree", "page_count": self.page_count,
                "free_pages": len(self.free), "commit_seq": self.commit_seq}

    # -- recovery ------------------------------------------------------------
    def recover(self) -> None:
        best_seq = -1
        for slot in (0, 1):
            blob = self.file.read(slot * PAGE_SIZE, PAGE_SIZE)
            if len(blob) < 24:
                continue
            body, crc = blob[:20], blob[20:24]
            if zlib.crc32(body) != int.from_bytes(crc, "little"):
                # The double-slot protocol's whole point: a torn or rotted
                # header slot is DETECTED here and the other (older but
                # intact) slot wins — never a half-written root.
                TraceEvent("BTreeHeaderSlotCorrupt", Severity.Warn).detail(
                    "File", self.file.name).detail("Slot", slot).log()
                continue
            r = Reader(body)
            if r.u32() != _MAGIC:
                continue
            seq = r.i64()
            root = r.u32()
            count = r.u32()
            if seq > best_seq:
                best_seq, self.root, self.page_count = seq, root, count
        if best_seq >= 0:
            self.commit_seq = best_seq
        else:
            self.root, self.page_count, self.commit_seq = 0, 2, 0
        self._cache.clear()
        self._dirty = {}
        self._rebuild_free_list()
        TraceEvent("BTreeRecovered").detail("Seq", self.commit_seq).detail(
            "Root", self.root).detail("Pages", self.page_count).detail(
            "Free", len(self.free)).log()

    def _rebuild_free_list(self) -> None:
        """Reachability walk from the recovered root: every allocated page
        not referenced by the live tree (or its overflow chains) is free.
        The free list thus needs no durable format — the reference pager
        persists its free-list pages instead; a scan is the simpler
        equivalent at this engine's scale."""
        reachable = {0, 1}
        stack = [self.root] if self.root else []
        while stack:
            pid = stack.pop()
            if pid in reachable:
                continue
            reachable.add(pid)
            node = self._read_node(pid)
            if node.kind == _LEAF:
                for v in node.values:
                    if isinstance(v, OverflowRef):
                        reachable.update(v.pages)
            else:
                stack.extend(node.children)
        self.free = [p for p in range(2, self.page_count)
                     if p not in reachable]
