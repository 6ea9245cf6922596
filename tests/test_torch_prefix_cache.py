"""The port's copy-on-write radix prefix cache against the JAX package's,
from the tree up to the serving engine.

The tree and the scheduler are pure host code: the same operations on
both packages must give the same hits, blocks, ``partial`` flags,
refcounts and block tables.  The suffix prefill must match the JAX one
within f32 tolerance and the port's own cold prefill bit for bit.  With
the cache on, the port's engine (dense, operand entropy) must replay its
cache-off stream bit for bit, in batch and chunked prefill, on full and
partial hits, and the JAX engine with the cache on (the JAX xi injected:
tokens exact, H / SE / MI within 2e-5).
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import (CPU, dense_pair, encdec_pair,  # noqa: F401
                           hybrid_pair, jax_head_noise, meshless_reference,
                           moe_pair, ssm_pair, vlm_pair)
from repro.launch.engine import Request as JRequest
from repro.launch.engine import ServeEngine as JEngine
from repro.launch.engine import SlotScheduler as JScheduler
from repro.launch.engine.block_pool import BlockAllocator as JAlloc
from repro.launch.prefix_cache import RadixPrefixCache as JTree
from repro_torch.launch.engine import Request as TRequest
from repro_torch.launch.engine import ServeEngine as TEngine
from repro_torch.launch.engine import SlotScheduler as TScheduler
from repro_torch.launch.engine.block_pool import BlockAllocator as TAlloc
from repro_torch.launch.prefix_cache import RadixPrefixCache as TTree
from repro_torch.models import registry as TM

# f32 tolerance of the reduced (f32) model against the JAX package
ATOL = 2e-5


# ---------------------------------------------------------------------------
# the radix tree
# ---------------------------------------------------------------------------

def _hit(h):
    return (h.tokens, list(h.blocks), h.partial)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_ops_match_the_reference(seed):
    """A random sequence of match / lock / insert / evict_lru / clear on
    the port's tree and the reference's, each over its own allocator:
    the same hits, blocks, partial flags, adoptions, evictions and
    refcounts after every operation."""
    rng = np.random.default_rng(seed)
    bs, nb = 4, 48
    trees = []
    for alloc_cls, tree_cls in ((TAlloc, TTree), (JAlloc, JTree)):
        a = alloc_cls(nb, bs)
        trees.append((a, tree_cls(a, bs)))
    # prompts over a small alphabet share prefixes often, and diverge
    # mid-block too
    base = rng.integers(0, 3, size=40)
    held = []                 # (alloc-side block lists) a "slot" holds
    for step in range(120):
        op = rng.choice(["match", "lock", "insert", "evict", "clear"],
                        p=[0.3, 0.2, 0.35, 0.1, 0.05])
        n = int(rng.integers(1, 30))
        cut = int(rng.integers(0, n))
        toks = np.concatenate([base[:cut], rng.integers(0, 3, size=n - cut)])
        want = int(rng.integers(1, 6))
        outs = []
        for a, t in trees:
            if op == "match":
                outs.append(_hit(t.match(toks)))
            elif op == "lock":
                h = t.match(toks)
                t.lock(h)
                outs.append(_hit(h))
            elif op == "insert":
                need = a.blocks_for(len(toks))
                if a.available() < need:
                    outs.append("full")
                    continue
                a.reserve(need)
                ids = a.alloc(need)
                outs.append((t.insert(toks, ids), ids))
                a.free(ids)           # the inserting slot lets go
            elif op == "evict":
                outs.append(t.evict_lru(want))
            else:
                outs.append(t.clear())
        assert outs[0] == outs[1], (step, op, outs)
        if op == "lock" and outs[0][1]:
            held.append(outs[0][1])
        if held and rng.random() < 0.3:
            blocks = held.pop(int(rng.integers(0, len(held))))
            for a, _ in trees:
                a.free(blocks)        # the locking slot evicts
        (ta, tt), (ja, jt) = trees
        assert [ta.refcount(i) for i in range(nb)] \
            == [ja.refcount(i) for i in range(nb)], (step, op)
        assert tt.cached_blocks() == jt.cached_blocks()
        assert tt.evictions == jt.evictions
        assert sorted(ta._free) == sorted(ja._free)


def test_tree_partial_tail_and_shared_nodes():
    """The reference's tree cases on the port's tree: a whole-block hit,
    a partial match into the tail block, shared nodes on insert, LRU
    eviction that respects refcounts and protection, and clear."""
    a = TAlloc(16, 4)
    c = TTree(a, 4)
    seq = list(range(10))
    a.reserve(3)
    blocks = a.alloc(3)
    assert c.insert(seq, blocks) == 3
    a.free(blocks)
    assert _hit(c.match(seq)) == (10, blocks, True)
    assert _hit(c.match(seq[:8])) == (8, blocks[:2], False)
    assert _hit(c.match(seq[:6] + [99, 99])) == (6, blocks[:2], True)
    assert c.match([77, 78]).tokens == 0
    a.reserve(3)
    b2 = a.alloc(3)
    assert c.insert(list(range(8)) + [60, 61], b2) == 1   # the tail only
    a.free(b2)
    assert a.in_use == 4 == c.cached_blocks()
    a.incref([b2[2]])                                     # a slot holds it
    assert c.evict_lru(1) == 1 and a.refcount(blocks[2]) == 0
    # the held tail is not evictable, and the interior nodes are no leaves
    assert c.evict_lru(5) == 0
    a.free([b2[2]])                                       # the slot evicts
    assert c.evict_lru(5, protect=frozenset([b2[2]])) == 0
    assert c.evict_lru(1) == 1 and a.refcount(b2[2]) == 0
    assert c.clear() == 2
    assert a.in_use == 0 and c.cached_blocks() == 0


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

def _sched(sched_cls, alloc_cls, tree_cls, num_slots=2, nb=16, bs=4,
           width=6):
    a = alloc_cls(nb, bs)
    tree = tree_cls(a, bs)
    return sched_cls(num_slots, allocator=a, table_width=width,
                     prefix_cache=tree), tree


def test_scheduler_hit_maps_shared_blocks_and_cow_swaps_the_tail():
    """A miss, an eviction that gives its prompt blocks to the tree, then
    a 9-token hit (2 whole blocks and 1 token into the third): the shared
    blocks are mapped, the partial tail block is swapped for a fresh CoW
    block, ``finish_cow`` drops the slot's reference on the source; the
    port's tables, records and refcounts equal the reference's at every
    step."""
    built = [_sched(TScheduler, TAlloc, TTree, ),
             _sched(JScheduler, JAlloc, JTree)]
    reqs = [(TRequest, JRequest)]
    seen = []
    for (s, tree), (req_cls) in zip(built, reqs[0]):
        log = []
        s.submit(req_cls(rid=0, prompt=np.arange(10, dtype=np.int32),
                         max_new_tokens=4))
        [(slot, _)] = s.admit()
        log.append((s.prefix_admit(slot).tokens, s.prefix_admit(slot).cow))
        first = s.block_tables[slot].tolist()
        s.evict(slot)
        log.append(tree.cached_blocks())
        s.submit(req_cls(rid=1, prompt=np.array(list(range(9)) + [70, 71],
                                                np.int32),
                         max_new_tokens=4))
        [(slot, _)] = s.admit()
        info = s.prefix_admit(slot)
        src, dst = info.cow
        row = s.block_tables[slot].tolist()
        log.append((info.tokens, src, dst, row))
        assert row[:2] == first[:2] and row[2] == dst and src == first[2]
        assert s.allocator.refcount(src) == 2      # the tree and the slot
        s.finish_cow(slot)
        assert s.allocator.refcount(src) == 1      # the tree only
        with pytest.raises(ValueError, match="no pending CoW"):
            s.finish_cow(slot)
        s.evict(slot)
        log.append((s.allocator.in_use, tree.cached_blocks(),
                    [s.allocator.refcount(i) for i in range(16)]))
        seen.append(log)
    assert seen[0] == seen[1]
    assert seen[0][1] == 3 and seen[0][2][0] == 9


def test_scheduler_rollback_frees_granted_blocks_only():
    """``rollback`` returns the decode-granted blocks above the kept depth
    and re-credits the grant budget, as the reference's does."""
    for sched_cls, alloc_cls, req_cls in ((TScheduler, TAlloc, TRequest),
                                          (JScheduler, JAlloc, JRequest)):
        a = alloc_cls(16, 4)
        s = sched_cls(1, allocator=a, table_width=4)
        s.submit(req_cls(rid=0, prompt=np.arange(6, dtype=np.int32),
                         max_new_tokens=10))
        s.admit()
        assert s.grant(0, 6 + 8) == s._slot_blocks[0][2:]
        assert s.mapped_blocks(0) == 4
        assert s.rollback(0, 6 + 2) == 2
        assert s.mapped_blocks(0) == 2 and a.in_use == 2
        assert s.block_tables[0].tolist()[:4] == s._slot_blocks[0] + [-1, -1]
        assert s.rollback(0, 6 + 2) == 0
        assert len(s.grant(0, 6 + 10)) == 2        # the budget came back
        s.evict(0)
        assert a.in_use == 0


# ---------------------------------------------------------------------------
# suffix prefill
# ---------------------------------------------------------------------------

def _prompt(n, seed=3, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab - 1, size=n) \
        .astype(np.int32)


@pytest.mark.parametrize("hit", [8, 20])
def test_suffix_prefill_matches_jax_and_the_cold_prefill(hit):
    """``prefill_suffix`` over a cached prefix (block-aligned at 8, mid-
    block at 20): the suffix K/V and the last hidden against the JAX
    package's within f32 tolerance, and the suffix K/V bit for bit
    against the port's cold prefill of the whole prompt."""
    import jax.numpy as jnp
    from repro.models import registry as JM
    jcfg, jparams, tcfg, tparams = dense_pair()
    prompt = _prompt(32)
    P = len(prompt)
    tok = torch.from_numpy(prompt.astype(np.int64))[None]
    with torch.inference_mode():
        _, cold = TM.prefill(tparams, tcfg, tok, P)
        _, pre = TM.prefill(tparams, tcfg, tok[:, :hit], 40)
        h, sub = TM.prefill_suffix(tparams, tcfg, tok[:, hit:], pre, hit)
    assert int(sub["len"][0]) == P
    for n in ("k", "v"):
        assert torch.equal(sub[n], cold[n][:, :, hit:P]), n
    _, jpre = JM.prefill(jparams, jcfg, jnp.asarray(prompt[:hit])[None], 40)
    jh, jsub = JM.prefill_suffix(jparams, jcfg,
                                 jnp.asarray(prompt[hit:])[None], jpre, hit)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(sub[n].numpy(), np.asarray(jsub[n]),
                                   atol=ATOL, err_msg=n)


def test_suffix_prefill_refuses_other_families():
    _, _, tcfg, _ = moe_pair()
    with pytest.raises(ValueError, match="cannot prefix-share"):
        TM.prefill_suffix(None, tcfg, None, None, 0)


def test_copy_block_copies_in_place():
    """``registry.copy_block`` duplicates a block in every pool without
    rebinding a pool (a captured decode graph holds its address)."""
    _, _, tcfg, _ = dense_pair()
    cache = TM.make_cache(tcfg, 2, 16, device=CPU, layout="paged",
                          kv_block=4, num_blocks=6)
    g = torch.Generator().manual_seed(0)
    for n in ("k", "v"):
        cache[n].copy_(torch.randn(cache[n].shape, generator=g))
    ptrs = {n: cache[n].data_ptr() for n in ("k", "v")}
    before = {n: cache[n].clone() for n in ("k", "v")}
    out = TM.copy_block(tcfg, cache, 1, 4)
    assert out is cache
    for n in ("k", "v"):
        assert cache[n].data_ptr() == ptrs[n]
        assert torch.equal(cache[n][:, 4], before[n][:, 1])
        keep = [i for i in range(cache[n].shape[1]) if i != 4]
        assert torch.equal(cache[n][:, keep], before[n][:, keep])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _shared_requests(cls, n=6, shared=20, tail=6, gen=6, seed=5):
    rng = np.random.default_rng(seed)
    head = rng.integers(1, 511, size=shared)
    return [cls(rid=i, prompt=np.concatenate(
        [head, rng.integers(1, 511, size=tail)]).astype(np.int32),
        max_new_tokens=gen) for i in range(n)]


def _same_stream(a, b):
    assert a.slot == b.slot, (a.rid, a.slot, b.slot)
    assert a.tokens == b.tokens, a.rid
    for name in ("H", "SE", "MI", "p_max"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)),
                                      err_msg=f"{name} of {a.rid}")
    assert (a.epistemic_flags, a.aleatoric_flags) \
        == (b.epistemic_flags, b.aleatoric_flags)


ENGINE = dict(num_slots=2, max_len=40, chunk=4, kv_layout="paged",
              kv_block=8, prefill_chunk=8, decode_attn="gather")


@pytest.mark.parametrize("prefill,shared", [("batch", 20), ("chunked", 20),
                                            ("batch", 16), ("chunked", 16)])
def test_engine_hits_replay_the_cold_stream_and_the_jax_engine(prefill,
                                                                shared):
    """Shared-prefix traffic (20 shared tokens: every hit ends mid-block
    and copies its tail block; 16: block-aligned, no copy) served by the
    port with the cache on and off, and by the JAX engine with it on:
    the port's two streams bit for bit, the JAX stream with tokens exact
    and H / SE / MI within 2e-5, the same hit accounting and the same
    per-chunk pool trace."""
    jcfg, jparams, tcfg, tparams = dense_pair()
    kw = dict(ENGINE, prefill_mode=prefill)
    mk = dict(shared=shared)
    cold = TEngine(tparams, tcfg, device="cpu", head_noise=jax_head_noise(),
                   **kw).run(_shared_requests(TRequest, **mk))
    warm = TEngine(tparams, tcfg, device="cpu", head_noise=jax_head_noise(),
                   prefix_cache=True, **kw)
    tr = warm.run(_shared_requests(TRequest, **mk))
    jr = JEngine(jparams, jcfg, prefix_cache=True, **kw).run(
        _shared_requests(JRequest, **mk))
    for a, b in zip(cold["requests"], tr["requests"]):
        _same_stream(a, b)
    for a, b in zip(tr["requests"], jr["requests"]):
        assert a.tokens == b.tokens and a.slot == b.slot, a.rid
        for name in ("H", "SE", "MI", "p_max"):
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       atol=ATOL, err_msg=name)
    pc = tr["prefix_cache"]
    assert pc == jr["prefix_cache"]
    assert pc["enabled"] and pc["hits"] == 4 and pc["misses"] == 2
    assert pc["prompt_tokens_saved"] == 4 * shared
    assert pc["cow_copies"] == (4 if shared % 8 else 0)
    assert tr["sched_trace"] == jr["sched_trace"]
    assert tr["prefill_chunks"] == jr["prefill_chunks"]
    assert cold["prefix_cache"]["enabled"] is False
    alloc, tree = warm._last_alloc, warm._last_pcache
    assert alloc.in_use == tree.cached_blocks() and not alloc._reserved


@pytest.mark.parametrize("prefill", ["batch", "chunked"])
def test_full_prompt_hits_skip_prefill(prefill):
    """Identical prompts through one slot (a hit skips prefill, which
    moves later admissions in time; one slot keeps every request in the
    same slot): the first admission misses (the tree fills at eviction),
    every later one is a whole-prompt hit that runs no prefill (26
    tokens: each copies its partial tail block), with exact accounting
    and the cold stream bit for bit."""
    _, _, tcfg, tparams = dense_pair()
    prompt = _prompt(26)
    mk = lambda: [TRequest(rid=i, prompt=prompt.copy(),  # noqa: E731
                           max_new_tokens=6) for i in range(4)]
    kw = dict(ENGINE, prefill_mode=prefill, num_slots=1, kv_blocks=10)
    cold = TEngine(tparams, tcfg, device="cpu", **kw).run(mk())
    res = TEngine(tparams, tcfg, device="cpu", prefix_cache=True,
                  **kw).run(mk())
    for a, b in zip(cold["requests"], res["requests"]):
        _same_stream(a, b)
    pc = res["prefix_cache"]
    assert (pc["hits"], pc["misses"], pc["cow_copies"]) == (3, 1, 3)
    assert pc["prompt_tokens"] == 4 * 26
    assert pc["prompt_tokens_saved"] == 3 * 26
    assert pc["saved_frac"] == pytest.approx(3 / 4)
    assert res["prefill_chunks"] == (4 if prefill == "chunked" else 0)
    assert cold["prefill_chunks"] == (16 if prefill == "chunked" else 0)


def test_lru_eviction_under_pool_pressure_keeps_streams():
    """A pool too small to keep every donated prefix: admissions
    LRU-evict unreferenced cached blocks, the pool balances, and the
    stream is still the cold one."""
    _, _, tcfg, tparams = dense_pair()
    kw = dict(ENGINE, prefill_mode="batch", kv_blocks=12)
    mk = lambda: _shared_requests(TRequest, n=6, shared=12)  # noqa: E731
    cold = TEngine(tparams, tcfg, device="cpu", **kw).run(mk())
    warm = TEngine(tparams, tcfg, device="cpu", prefix_cache=True, **kw)
    res = warm.run(mk())
    for a, b in zip(cold["requests"], res["requests"]):
        _same_stream(a, b)
    assert res["prefix_cache"]["cache_evictions"] > 0
    assert warm._last_alloc.in_use == warm._last_pcache.cached_blocks()


def test_dense_layout_refuses_the_prefix_cache():
    _, _, tcfg, tparams = dense_pair()
    with pytest.raises(ValueError, match="paged"):
        TEngine(tparams, tcfg, num_slots=2, max_len=32, kv_layout="dense",
                prefix_cache=True, device="cpu")


@pytest.mark.parametrize("pair", [moe_pair, ssm_pair, hybrid_pair,
                                  encdec_pair, vlm_pair],
                         ids=["moe", "ssm", "hybrid", "encdec", "vlm"])
def test_other_families_serve_cold(pair):
    """Prompt KV that is not a pure function of the token prefix (moe's
    capacity coupling, recurrent state, modality inputs): the engine
    turns the cache off silently and serves, as the reference does."""
    _, _, tcfg, tparams = pair()
    eng = TEngine(tparams, tcfg, num_slots=2, max_len=24, chunk=4,
                  kv_layout="paged", kv_block=4, prefix_cache=True,
                  device="cpu")
    assert eng.prefix_cache is False
    P = 12 if tcfg.family == "vlm" else 8
    reqs = [TRequest(rid=i, prompt=_prompt(P, seed=i), max_new_tokens=2)
            for i in range(2)]
    res = eng.run(reqs)
    assert res["prefix_cache"]["enabled"] is False
    assert res["prefix_cache"]["hits"] == 0
    assert all(len(r.tokens) == 2 for r in res["requests"])


def test_cache_on_keeps_the_runner_buffers():
    """The decode carry's addresses survive a prefix-cache run (CoW
    copies, suffix scatters and depth pins land in place), so a captured
    chunk graph stays valid."""
    _, _, tcfg, tparams = dense_pair()
    eng = TEngine(tparams, tcfg, device="cpu", prefix_cache=True,
                  **dict(ENGINE, prefill_mode="batch"))
    runner = eng.runner
    ptrs = {n: t.data_ptr() for n, t in runner.cache.items()}
    eng.run(_shared_requests(TRequest))
    assert {n: t.data_ptr() for n, t in runner.cache.items()} == ptrs


def test_prefix_admit_defaults_and_the_scheduler_refusal():
    """``PrefixAdmit`` defaults (no CoW) and the scheduler refuses a
    prefix cache without a block pool, as the reference does."""
    from repro_torch.launch.engine.scheduler import PrefixAdmit
    assert dataclasses.asdict(PrefixAdmit(tokens=3)) == {"tokens": 3,
                                                         "cow": None}
    a = TAlloc(4, 4)
    with pytest.raises(ValueError, match="requires a BlockAllocator"):
        TScheduler(1, prefix_cache=TTree(a, 4))
