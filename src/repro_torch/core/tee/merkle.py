"""Merkle batch MAC over a round's sealed updates. Port of
``repro/core/tee/merkle.py`` (hashlib; the same trees, roots and paths).

Each handler reports the 32-byte digest of its sealed blob (the leaf) to
the admin; the admin builds a tree over the round's leaves in silo order
and HMACs ``batch-mac-v1 || round || n || root`` with the admin<->updater
aggregation key; the updater checks the one MAC, then each message's leaf
against its O(log n) path, so a tampered, substituted or replayed blob is
detected and attributed to its silo before the aggregate commits.

Leaves are hashed with a ``0x00`` prefix, interior nodes with ``0x01``; an
odd node is promoted unchanged, and the MAC binds the leaf count.
"""
from __future__ import annotations

import hashlib


def leaf_hash(leaf: bytes) -> bytes:
    return hashlib.sha256(b"\x00" + leaf).digest()


def node_hash(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(b"\x01" + left + right).digest()


class MerkleTree:
    """Tree over an ordered leaf list; O(n) build, O(log n) paths."""

    def __init__(self, leaves: list):
        if not leaves:
            raise ValueError("Merkle tree over zero leaves is undefined")
        level = [leaf_hash(l) for l in leaves]
        self.levels = [level]
        while len(level) > 1:
            nxt = [node_hash(level[i], level[i + 1])
                   for i in range(0, len(level) - 1, 2)]
            if len(level) % 2:
                nxt.append(level[-1])  # odd node promoted unchanged
            level = nxt
            self.levels.append(level)

    @property
    def root(self) -> bytes:
        return self.levels[-1][0]

    @property
    def n_leaves(self) -> int:
        return len(self.levels[0])

    def path(self, index: int) -> list:
        """``[(sibling, is_right), ...]`` bottom-up for leaf ``index``
        (a level where the node is promoted unpaired adds no entry)."""
        if not 0 <= index < self.n_leaves:
            raise IndexError(f"leaf {index} out of range (n={self.n_leaves})")
        out = []
        for level in self.levels[:-1]:
            sib = index ^ 1
            if sib < len(level):
                out.append((level[sib], bool(index & 1)))
            index //= 2
        return out


def verify_path(root: bytes, leaf: bytes, path: list) -> bool:
    h = leaf_hash(leaf)
    for sibling, is_right in path:
        h = node_hash(sibling, h) if is_right else node_hash(h, sibling)
    return h == root
