"""Copy-on-write radix prefix cache over the paged KV pool.

Counterpart of ``repro.launch.prefix_cache``, a copy of its pure-Python
tree (the port imports nothing of the JAX package).  A radix tree over
token-ID prefixes whose nodes hold *refcounted* KV blocks of the serving
engine's ``block_pool.BlockAllocator``, so that requests sharing a prompt
prefix (a system-prompt template, S samples of one prompt) pay its
prefill once.

Structure: tree edges are BLOCK-granular — each node owns exactly one
physical block and is keyed by the ``block_size`` token IDs written into
it (a leaf may hold a partial block, ``ntok < block_size``).  Matching
is TOKEN-granular: the walk descends whole-block exact matches and may
finish with a partial match *into* the last block (the longest common
prefix against any child's key).  That last partially-matched block is
what makes copy-on-write real: it is mapped into the new slot's table
read-only, and before the slot writes at the divergence point the engine
copies it on the device (``models.layers.copy_block``) into a fresh block
already swapped into the table.

Block lifecycle (who holds references):

  * ``BlockAllocator.alloc`` hands out a block at refcount 1 (the slot).
  * ``insert`` (called at request eviction) adopts the blocks covering
    the request's prompt into the tree: +1 ref per newly created node.
  * ``lock`` (called when admission commits to a hit) takes +1 per
    matched block for the admitted slot; slot eviction decrefs.
  * ``BlockAllocator.free`` is a decref — a block returns to the free
    list only when the last holder (slot or tree) lets go.
  * Under pool pressure the scheduler calls ``evict_lru``: leaf nodes
    whose block has no slot reference left (refcount == 1, the tree's
    own) are freed oldest-first until enough blocks come back.

The cache never touches torch: it deals purely in token IDs and block
IDs.  The engine performs the device-side CoW copy and the suffix
prefill (``launch/engine/engine.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional


@dataclasses.dataclass
class PrefixHit:
    """Result of a radix walk: ``tokens`` matched, covered by ``blocks``.

    ``tokens`` may end mid-block (``partial`` True): the final block is
    then only valid up to the divergence point and must be copied before
    the admitted slot writes into it (copy-on-write).
    """

    tokens: int = 0
    blocks: list = dataclasses.field(default_factory=list)
    partial: bool = False


class _Node:
    __slots__ = ("key", "ntok", "block", "children", "parent", "last_use")

    def __init__(self, key: tuple, ntok: int, block: int,
                 parent: "_Node", last_use: int):
        self.key = key                # the block's token IDs (len == ntok)
        self.ntok = ntok              # valid tokens in this block
        self.block = block            # physical block id in the pool
        self.children: dict = {}      # child.key -> child
        self.parent = parent
        self.last_use = last_use


def _common_prefix(a, b) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class RadixPrefixCache:
    """Host-side radix tree of cached prompt prefixes over the block pool.

    ``allocator`` is the engine's ``block_pool.BlockAllocator`` (the
    refcount authority); ``block_size`` its tokens-per-block.
    """

    def __init__(self, allocator, block_size: int):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.allocator = allocator
        self.block_size = block_size
        self._root = _Node(key=(), ntok=0, block=-1, parent=None,
                           last_use=0)
        self._clock = 0
        self.evictions = 0            # blocks LRU-evicted over lifetime

    # -- introspection ----------------------------------------------------

    def _nodes(self) -> Iterable[_Node]:
        stack = [self._root]
        while stack:
            n = stack.pop()
            if n is not self._root:
                yield n
            stack.extend(n.children.values())

    def cached_blocks(self) -> int:
        """Blocks currently held by the tree (each node owns one)."""
        return sum(1 for _ in self._nodes())

    # -- the radix walk ---------------------------------------------------

    def match(self, tokens) -> PrefixHit:
        """Longest cached prefix of ``tokens``: whole-block exact
        descents, then at most one token-granular partial match into a
        child's block.  Read-only apart from LRU stamps — the caller
        decides whether to commit (``lock``) after its block budget
        clears."""
        self._clock += 1
        bs = self.block_size
        toks = [int(t) for t in tokens]
        node, depth, blocks = self._root, 0, []
        while depth < len(toks):
            rest = toks[depth:]
            if len(rest) >= bs:
                child = node.children.get(tuple(rest[:bs]))
                if child is not None and child.ntok == bs:
                    child.last_use = self._clock
                    blocks.append(child.block)
                    depth += bs
                    node = child
                    continue
            best, blen = None, 0
            for child in node.children.values():
                n = _common_prefix(rest, child.key[:child.ntok])
                if n > blen:
                    best, blen = child, n
            if best is not None and blen > 0:
                best.last_use = self._clock
                blocks.append(best.block)
                depth += blen
            break
        return PrefixHit(tokens=depth, blocks=blocks,
                         partial=bool(depth % bs))

    def lock(self, hit: PrefixHit) -> None:
        """Commit a hit: the admitted slot takes a reference on every
        matched block (released by the slot's eviction decref)."""
        self.allocator.incref(hit.blocks)

    # -- insertion (at request eviction) ----------------------------------

    def insert(self, tokens, blocks: list) -> int:
        """Adopt the prompt ``tokens`` (covered, in logical order, by
        ``blocks`` — ``ceil(len(tokens) / block_size)`` of them) into the
        tree.  Blocks backing chunks already cached are NOT adopted (the
        existing node keeps serving them); newly adopted blocks get a
        tree reference (incref).  Returns the number adopted."""
        bs = self.block_size
        toks = [int(t) for t in tokens]
        need = -(-len(toks) // bs) if toks else 0
        if len(blocks) < need:
            raise ValueError(f"insert of {len(toks)} tokens needs {need} "
                             f"blocks, got {len(blocks)}")
        self._clock += 1
        node, depth, bi, adopted = self._root, 0, 0, 0
        while depth < len(toks):
            n = min(bs, len(toks) - depth)
            chunk = tuple(toks[depth:depth + n])
            if n == bs:
                child = node.children.get(chunk)
                if child is not None:
                    child.last_use = self._clock
                    node = child
                    depth += bs
                    bi += 1
                    continue
                child = _Node(chunk, bs, int(blocks[bi]), node,
                              self._clock)
                self.allocator.incref([child.block])
                node.children[chunk] = child
                node = child
                adopted += 1
            else:
                # partial tail: only adopt if no existing child already
                # covers this chunk (a longer or equal cached prefix)
                covered = any(
                    _common_prefix(chunk, c.key[:c.ntok]) >= n
                    for c in node.children.values())
                if not covered and chunk not in node.children:
                    child = _Node(chunk, n, int(blocks[bi]), node,
                                  self._clock)
                    self.allocator.incref([child.block])
                    node.children[chunk] = child
                    adopted += 1
            depth += n
            bi += 1
        return adopted

    # -- eviction ----------------------------------------------------------

    def _evictable(self, protect: frozenset) -> list:
        """Leaf nodes whose block only the tree still references."""
        return [n for n in self._nodes()
                if not n.children and n.block not in protect
                and self.allocator.refcount(n.block) == 1]

    def _drop(self, node: _Node) -> None:
        del node.parent.children[node.key]
        self.allocator.free([node.block])      # decref -> free list
        self.evictions += 1

    def evict_lru(self, want: int, protect: frozenset = frozenset()) -> int:
        """Free up to ``want`` cached-but-unreferenced blocks, oldest
        access first.  Interior nodes become evictable as their leaves
        go.  ``protect`` pins blocks (e.g. the hit being admitted right
        now).  Returns how many blocks were freed."""
        freed = 0
        while freed < want:
            cands = self._evictable(protect)
            if not cands:
                break
            self._drop(min(cands, key=lambda n: n.last_use))
            freed += 1
        return freed

    def clear(self) -> int:
        """Release every cached block (tree decref).  Blocks still
        referenced by live slots survive until those slots evict."""
        dropped = 0
        for node in list(self._nodes()):
            self.allocator.free([node.block])
            dropped += 1
        self._root.children.clear()
        return dropped
