"""The block-paged KV cache in the port, on the CPU: the cases of
tests/test_kv_blocks.py run on paddle_tpu_torch.

BlockManager units (the allocator is the port's own copy,
inference/kv_blocks.py): the trash block, refcounts, double free,
ownership, all-or-nothing allocation, prefix register and match with the
hash-chain collision guard, LRU eviction, the reserve preflight,
`rollback` (tests/test_spec_decode.py:359), `evict_all_prefixes` and
`stats`.

The served block layout, through the port's DecodingPredictor on
CPUPlace() over artifacts the port exports itself (vocab 41, 4 slots,
cache 64, d_model 16, 2 heads, 2 layers, d_ff 32, block_size 4): the
artifact's layout; greedy and beam transcripts against the slot layout's;
copy on write where beams diverge at and inside a block boundary; a
shared prefix that skips compute and storage; a prompt longer than the
largest chunk; chunk pad rows past the cache landing in the trash block; a
waiting request that matches a prefix published after it came in; and
shedding when the pool runs out (ServerOverloaded at the door,
MidStreamEvicted mid-decode).

Block and slot layouts prefill through different programs (chunk slices
against one bucketed prompt), whose f32 sums run in different orders, so
beam scores agree within SCORE_TOL = 1e-5 rather than bit for bit; the
hypotheses are equal. Left out of the mirror: the int8 pages (served in
tests/test_torch_kv_quant.py), the mp-sharded artifact and its warm
replica (ROADMAP queue 1 item 10; the port compiles nothing), and the AOT
sidecars of the layout test.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.inference import (BlockManager, BlockPoolExhausted,
                                        DecodingPredictor, MidStreamEvicted,
                                        ServerOverloaded, TRASH_BLOCK,
                                        export_decode)
from paddle_tpu_torch.inference import decoding
from paddle_tpu_torch.models.transformer import build_decode_spec

VOCAB, SLOTS, CACHE = 41, 4, 64
SCORE_TOL = 1e-5
CPU = ptt.CPUPlace()


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its programs are a few
    dozen rows wide, and torch's thread pool would only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- allocator units ---------------------------------------------------------

def test_capacity_excludes_trash_block():
    m = BlockManager(num_blocks=8, block_size=4)
    assert m.capacity() == 7
    assert m.free_blocks() == 7
    got = m.alloc(7)
    assert TRASH_BLOCK not in got
    assert sorted(got) == list(range(1, 8))
    with pytest.raises(ValueError):
        BlockManager(num_blocks=1, block_size=4)


def test_refcount_to_zero_frees():
    m = BlockManager(num_blocks=6, block_size=2)
    blocks = m.alloc(3)
    m.incref(blocks)                      # share (beam fork)
    m.decref(blocks)
    assert m.free_blocks() == 2           # still referenced once
    assert m.in_use() == 3
    m.decref(blocks)                      # refcount-to-zero
    assert m.free_blocks() == 5
    assert m.in_use() == 0
    st = m.stats()
    assert st['allocs'] == 3 and st['frees'] == 3
    assert sorted(m.alloc(5)) == sorted(range(1, 6))


def test_double_free_and_foreign_incref_raise():
    m = BlockManager(num_blocks=4, block_size=2)
    b = m.alloc(1)
    m.decref(b)
    with pytest.raises(RuntimeError, match='double free'):
        m.decref(b)
    with pytest.raises(RuntimeError, match='unallocated'):
        m.incref(b)
    # trash block refs are ignored, never counted
    m.incref([TRASH_BLOCK])
    m.decref([TRASH_BLOCK])
    assert m.refcount(TRASH_BLOCK) == 0


def test_writable_is_sole_ownership():
    m = BlockManager(num_blocks=4, block_size=2)
    b = m.alloc(1)[0]
    assert m.writable(b)
    m.incref([b])                         # shared: fork / prefix hit
    assert not m.writable(b)              # must copy on write
    m.decref([b])
    assert m.writable(b)
    assert not m.writable(TRASH_BLOCK)


def test_alloc_all_or_nothing_when_pinned():
    m = BlockManager(num_blocks=4, block_size=2)
    m.alloc(2)
    with pytest.raises(BlockPoolExhausted):
        m.alloc(2)                        # only 1 free, nothing evictable
    assert m.free_blocks() == 1           # the failed alloc leaked nothing
    assert m.alloc(1)


def test_prefix_register_match_and_refcounts():
    m = BlockManager(num_blocks=16, block_size=4)
    tokens = list(range(100, 111))        # 11 tokens = 2 full blocks + 3
    blocks = m.alloc(3)
    m.register_prefix(tokens, blocks)     # publishes 1- and 2-block entries
    assert m.prefix_entries() == 2
    m.decref(blocks)                      # prefix refs keep the full blocks
    assert m.in_use() == 2
    shared, covered = m.match_prefix(tokens)
    assert covered == 8 and shared == blocks[:2]
    st = m.stats()
    assert st['prefix_hits'] == 1 and st['prefix_tokens_reused'] == 8
    shared1, covered1 = m.match_prefix(tokens[:4] + [7, 8])
    assert covered1 == 4 and shared1 == blocks[:1]
    # a prompt the cache covers entirely still leaves its last token
    # uncovered: the admitting request must compute first-token logits
    sh, cov = m.match_prefix(tokens[:8])
    assert cov == 4 and sh == blocks[:1]
    m.decref(shared + shared1 + sh)
    assert m.in_use() == 2


def test_prefix_hash_collision_never_aliases():
    # every key in one bucket: a colliding entry whose tokens differ must
    # be a miss, never an alias onto foreign blocks
    m = BlockManager(num_blocks=16, block_size=2, hash_fn=lambda b: 'same')
    a = m.alloc(2)
    m.register_prefix([1, 2, 3, 4], a)
    b = m.alloc(2)
    m.register_prefix([9, 8, 7, 6], b)
    assert m.match_prefix([1, 2, 3, 4, 5]) == (a, 4)
    assert m.match_prefix([9, 8, 7, 6, 5]) == (b, 4)
    assert m.match_prefix([2, 1, 8, 9, 5]) == ([], 0)
    assert m.stats()['prefix_misses'] == 1


def test_lru_eviction_under_pressure():
    m = BlockManager(num_blocks=9, block_size=2)
    a, b = m.alloc(2), m.alloc(2)
    m.register_prefix([1, 2, 3, 4], a)
    m.register_prefix([5, 6, 7, 8], b)
    m.decref(a)
    m.decref(b)                           # both live only through the cache
    assert m.in_use() == 4 and m.free_blocks() == 4
    m.match_prefix([1, 2, 3, 4, 0])       # touch a: b becomes LRU
    m.decref(a)
    assert len(m.alloc(6)) == 6           # needs eviction to cover
    assert m.stats()['evictions'] >= 1
    assert m.match_prefix([5, 6, 7, 8, 0]) == ([], 0)   # b went first


def test_reserve_preflight_contract():
    m = BlockManager(num_blocks=6, block_size=2)
    a = m.alloc(2)
    m.register_prefix([1, 2, 3, 4], a)
    m.decref(a)                           # evictable
    assert m.reserve(5)                   # evicts the prefix entry
    for _ in range(5):
        m.alloc(1)                        # cannot fail after reserve
    assert not m.reserve(1)               # fully pinned now
    with pytest.raises(BlockPoolExhausted):
        m.alloc(1)


def test_evict_all_and_stats_keys():
    m = BlockManager(num_blocks=8, block_size=2)
    a = m.alloc(2)
    m.register_prefix([1, 2, 3, 4], a)
    m.decref(a)
    m.evict_all_prefixes()
    assert m.prefix_entries() == 0 and m.in_use() == 0
    st = m.stats()
    for k in ('num_blocks', 'block_size', 'blocks_in_use', 'blocks_peak',
              'blocks_free', 'allocs', 'frees', 'prefix_entries',
              'prefix_hits', 'prefix_misses', 'prefix_hit_rate',
              'prefix_tokens_reused', 'evictions'):
        assert k in st, k
    m.reset_counters()
    assert m.stats()['allocs'] == 0 and m.stats()['blocks_peak'] == 0


def test_doomed_alloc_does_not_wipe_prefix_cache():
    """An over-capacity alloc that eviction cannot cover (every entry's
    blocks also pinned by a table) fails without evicting anything."""
    m = BlockManager(num_blocks=6, block_size=2)
    a = m.alloc(3)
    m.register_prefix([1, 2, 3, 4, 5, 6], a)
    m.alloc(2)                            # pool now fully pinned
    with pytest.raises(BlockPoolExhausted):
        m.alloc(1)
    assert m.prefix_entries() == 3        # the cache survived the miss
    assert not m.reserve(1)
    assert m.prefix_entries() == 3
    m.decref(a)   # the table is gone: the entries alone hold the blocks
    got, cov = m.match_prefix([1, 2, 3, 4, 5, 6, 7])
    assert cov == 6 and got == a


def test_blockmanager_rollback_unit():
    m = BlockManager(num_blocks=9, block_size=4)
    table = m.alloc(4)
    assert m.in_use() == 4
    # 9 tokens span 3 blocks: one speculative tail block returns
    assert m.rollback(table, 9) == 1
    assert len(table) == 3 and m.in_use() == 3
    assert m.rollback(table, 12) == 0     # nothing past the keep point
    assert m.rollback(table, 0) == 3
    assert table == [] and m.in_use() == 0


# -- the served block layout -------------------------------------------------

def _build(out, **kw):
    with ptt.unique_name.guard():
        spec = build_decode_spec(
            vocab=VOCAB, d_model=16, n_head=2, n_layer=2, d_ff=32,
            max_slots=SLOTS, max_cache_len=CACHE, eos_id=1, **kw)
    scope = ptt.Scope()
    ptt.Executor(CPU).run(spec['startup'], scope=scope)
    export_decode(spec, out, scope=scope)
    return out


@pytest.fixture(scope='module')
def arts(tmp_path_factory):
    """A slot and a block artifact of the same tiny LM (the same startup,
    so the same weights)."""
    t = tmp_path_factory.mktemp('torch_kvblocks')
    return {'slot': _build(str(t / 'slot'), prompt_buckets=(4, 8)),
            'block': _build(str(t / 'block'), prompt_buckets=(4, 8),
                            block_size=4)}


def _prompts(seed, n):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, VOCAB, int(rng.randint(2, 9))) for _ in range(n)]


def _pred(art, **kw):
    return DecodingPredictor(art, place=CPU, **kw)


def _same_beams(ref, got):
    for (i1, s1), (i2, s2) in zip(ref, got):
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(s1, s2, rtol=0, atol=SCORE_TOL)


def test_block_artifact_layout(arts):
    with open(os.path.join(arts['block'], decoding._DECODE_SIGNATURE)) as f:
        sig = json.load(f)
    assert sig['layout'] == 'block' and sig['format'] == 'paddle_tpu_torch'
    blk = sig['block']
    assert blk['block_size'] == 4
    assert blk['max_blocks_per_slot'] == CACHE // 4
    assert blk['num_blocks'] == SLOTS * (CACHE // 4) + 1
    assert sig['chunk_buckets'] == [4, 8] and 'prefill' not in sig
    for e in sig['state']:
        assert e['shape'] == [blk['num_blocks'], 4, 16]
    assert sig['cache_bytes'] == len(sig['state']) * blk['num_blocks'] * 4 \
        * 16 * 4
    assert sorted(e['name'] for e in sig['step']['feeds']) == \
        ['block_tables', 'pos', 'tokens']
    for d in [decoding._STEP_DIR] + [decoding._CHUNK_DIR % c
                                     for c in sig['chunk_buckets']]:
        assert os.path.exists(os.path.join(arts['block'], d,
                                           decoding._PROGRAM_FILE))
    assert not os.path.exists(os.path.join(arts['block'],
                                           decoding._VERIFY_DIR))


def test_block_greedy_and_beam_match_slot(arts):
    prompts = _prompts(31, 8)
    with _pred(arts['slot']) as ps:
        g_ref = [ps.generate(p, max_new_tokens=10) for p in prompts]
        b_ref = [ps.generate(p, max_new_tokens=8, beam=3)
                 for p in prompts[:3]]
    with _pred(arts['block']) as pb:
        assert pb.layout == 'block' and pb.block_manager is not None
        g = [s.result(60) for s in [pb.submit(p, max_new_tokens=10)
                                    for p in prompts]]
        b = [pb.generate(p, max_new_tokens=8, beam=3) for p in prompts[:3]]
        snap = pb.stats.snapshot()
    assert g == g_ref
    _same_beams(b_ref, b)
    # beam history moved as table permutations and copied blocks
    assert snap['cow_blocks'] > 0
    assert snap['blockcopies'] <= snap['cow_blocks']


def test_beam_divergence_cow_at_block_boundary(arts):
    """A prompt whose length is a multiple of block_size (the fork point
    is a block boundary: the first divergent write extends into a fresh
    block, no copy) and one mid-block (the shared partial tail must copy
    on write); both against the slot layout."""
    rng = np.random.RandomState(33)
    at_boundary = rng.randint(2, VOCAB, 8)
    mid_block = rng.randint(2, VOCAB, 6)
    with _pred(arts['slot']) as ps:
        ref = [ps.generate(p, max_new_tokens=10, beam=3)
               for p in (at_boundary, mid_block)]
    with _pred(arts['block']) as pb:
        got = [pb.generate(at_boundary, max_new_tokens=10, beam=3)]
        boundary_cow = pb.stats.snapshot()['cow_blocks']
        got.append(pb.generate(mid_block, max_new_tokens=10, beam=3))
        snap = pb.stats.snapshot()
    _same_beams(ref, got)
    assert snap['cow_blocks'] > boundary_cow


def test_prefix_sharing_skips_compute_and_storage(arts):
    """The same prompt twice: the second request hits the prefix cache,
    takes fewer chunk slices and shares the full blocks, and its
    transcript is the same."""
    prompt = np.random.RandomState(34).randint(2, VOCAB, 9)
    with _pred(arts['block']) as pb:
        a = pb.generate(prompt, max_new_tokens=10)
        s1 = pb.stats.snapshot()
        b = pb.generate(prompt, max_new_tokens=10)
        s2 = pb.stats.snapshot()
    assert a == b
    assert s2['prefix_hits'] == s1['prefix_hits'] + 1
    assert s2['prefix_tokens_reused'] == s1['prefix_tokens_reused'] + 8
    # request 1 took 2 slices (8 + 1 tokens), request 2 only 1
    assert s2['chunk_slices'] - s1['chunk_slices'] < s1['chunk_slices']


def test_chunked_prefill_admits_beyond_largest_chunk(arts):
    """A prompt longer than the largest chunk admits in slices (the slot
    layout refuses it: no bucket fits); served twice, the transcripts
    agree, the second through the prefix cache."""
    long_prompt = np.random.RandomState(35).randint(2, VOCAB, 23)
    with _pred(arts['block']) as pb:
        one = pb.generate(long_prompt, max_new_tokens=12)
        s = pb.stats.snapshot()
        two = pb.generate(long_prompt, max_new_tokens=12)
    assert one == two
    assert s['chunk_slices'] >= 3               # 23 tokens in 8-chunks
    with _pred(arts['slot']) as ps:
        with pytest.raises(ValueError, match='exceeds'):
            ps.generate(long_prompt, max_new_tokens=4)


def test_chunk_pad_overflow_lands_in_trash_block(tmp_path):
    """A near-max-length prompt whose final chunk slice runs past
    max_cache_len with a full table: no pad row may overwrite the prompt's
    K/V. The op routes rows past the table's span to the trash block
    (tests/test_torch_decode_block_cross.py holds it against the
    reference) and the chunk program clamps only their position-encoding
    index. A big chunk (whose final slice overflows) and a small one (it
    never does) agree; served again, the final slice starts after the
    prefix the first run published, so no block is copied on write and
    only the trash block takes the overflow."""
    big = _build(str(tmp_path / 'big'), prompt_buckets=(8,), block_size=8,
                 chunk_sizes=(48,))
    small = _build(str(tmp_path / 'small'), prompt_buckets=(8,),
                   block_size=8, chunk_sizes=(8,))
    prompt = np.random.RandomState(36).randint(2, VOCAB, CACHE - 1)
    with _pred(small) as ps:
        ref = ps.generate(prompt, max_new_tokens=1)
    with _pred(big) as pb:
        # final slice: start 48, 15 tokens, chunk 48: rows 64..95 overflow
        assert pb.generate(prompt, max_new_tokens=1) == ref
        s1 = pb.stats.snapshot()
        # a prefix hit covers 56 tokens: rows 56..103, 64..103 overflow
        assert pb.generate(prompt, max_new_tokens=1) == ref
        s2 = pb.stats.snapshot()
    assert s1['chunk_slices'] == 2 and s1['cow_blocks'] == 0
    assert s2['prefix_tokens_reused'] == 56
    assert s2['chunk_slices'] == 3 and s2['cow_blocks'] == 0


def test_waiting_request_rematches_published_prefix(tmp_path):
    """A request whose first admission attempt misses the prefix cache
    (its twin ahead is still prefilling) and then waits for blocks must
    match again once it can admit: the twin published the prefix."""
    art = _build(str(tmp_path / 'rematch'), prompt_buckets=(4, 8),
                 block_size=4, num_blocks=5)    # 4 usable blocks
    prompt = np.random.RandomState(37).randint(2, VOCAB, 12)
    with _pred(art) as pb:
        sa = pb.submit(prompt, max_new_tokens=4)
        sb = pb.submit(prompt, max_new_tokens=4)
        a, b = sa.result(120), sb.result(120)
        snap = pb.stats.snapshot()
    assert a == b
    assert snap['prefix_hits'] >= 1


def test_pool_exhaustion_sheds_loudly(tmp_path):
    """A pool too small for a prompt sheds it with ServerOverloaded
    instead of deadlocking; the endpoint keeps serving."""
    small = _build(str(tmp_path / 'tiny'), prompt_buckets=(4, 8),
                   block_size=4, num_blocks=3)  # 2 usable blocks
    with _pred(small) as pb:
        ok = pb.generate(np.asarray([3, 4, 5]), max_new_tokens=4)
        assert 1 <= len(ok) <= 4
        with pytest.raises(ServerOverloaded, match='block pool'):
            # needs 3 blocks for its 12-token prompt: it can never fit
            pb.submit(np.arange(2, 14), max_new_tokens=4).result(60)
        assert pb.stats.snapshot()['shed'] == 1
        assert pb.generate(np.asarray([3, 4, 5]), max_new_tokens=4) == ok


def test_mid_stream_eviction_sheds_youngest(arts, tmp_path):
    """Three decoding requests on a 4-block pool outgrow it: the preflight
    evicts the youngest decoding stream with MidStreamEvicted (a
    ServerOverloaded) and the oldest finishes with its solo transcript;
    every stream either ends equal to its solo run or was evicted, and no
    block leaks."""
    art = _build(str(tmp_path / 'evict'), prompt_buckets=(4, 8),
                 block_size=4, num_blocks=5)
    prompts = [np.random.RandomState(38 + i).randint(2, VOCAB, 4)
               for i in range(3)]
    with _pred(arts['block']) as pb:
        solo = [pb.generate(p, max_new_tokens=8) for p in prompts]
    with _pred(art) as pb:
        streams = [pb.submit(p, max_new_tokens=8) for p in prompts]
        outs = []
        for s in streams:
            try:
                outs.append(s.result(120))
            except MidStreamEvicted as e:
                assert isinstance(e, ServerOverloaded)
                outs.append(None)
        snap = pb.stats.snapshot()
        pb.block_manager.evict_all_prefixes()
        assert pb.block_manager.in_use() == 0
    assert outs[0] == solo[0]
    assert None in outs and snap['shed'] == outs.count(None)
    for o, want in zip(outs, solo):
        assert o is None or o == want
