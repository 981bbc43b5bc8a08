"""The port's paged-KV host accounting (dllama_tpu_torch.kv) against the JAX
package's: the same operation sequences on PagePool, RadixTree and the
pool-native PagedKVManager give the same observations, state compared after
each step. The cases are tests/test_kv_pool.py's, recorded as traces."""

import random

import pytest

import dllama_tpu.kv.manager as jmanager
import dllama_tpu.kv.pool as jpool
import dllama_tpu.kv.radix as jradix
import dllama_tpu_torch.kv.manager as tmanager
import dllama_tpu_torch.kv.pool as tpool
import dllama_tpu_torch.kv.radix as tradix

PS = 4
IMPLS = {"jax": (jpool, jradix), "port": (tpool, tradix)}


def _tree_state(tree):
    return (tree.n_pages, tree.node_count(), tree.token_count(), sorted(tree.all_pages()))


def _pool_state(pool):
    st = pool.stats()
    return (st.total, st.free, st.used, st.shared, st.cow_forks, pool.free_pages,
            sorted((p, pool.refcount(p)) for p in range(pool.n_pages)))


def _call(trace, fn, *args):
    """Run fn, recording its result or the type of what it raised."""
    try:
        out = fn(*args)
    except (KeyError, ValueError, MemoryError) as e:
        out = type(e).__name__
    if hasattr(out, "n_tokens"):
        out = (out.n_tokens, list(out.pages))
    trace.append(out)
    return out


def _case_pool(pool_mod, radix_mod, trace):
    pool = pool_mod.PagePool(8, PS)
    a = _call(trace, pool.alloc, 3)
    _call(trace, pool.retain, a)
    _call(trace, pool.release, a)
    f = _call(trace, pool.fork, a[0])
    rest = _call(trace, pool.alloc, pool.free_pages)
    _call(trace, pool.alloc, 1)
    trace.append(_pool_state(pool))
    _call(trace, pool.release, a + [f] + rest)
    x = _call(trace, pool.alloc, 1)[0]
    _call(trace, pool.release, [x])
    _call(trace, pool.alloc, 1)
    for bad in (lambda: pool.release([0]), lambda: pool.retain([999]), lambda: pool.fork(0)):
        _call(trace, bad)
    pool.reset()
    trace.append(_pool_state(pool))


def _case_radix_split(pool_mod, radix_mod, trace):
    pool, tree = pool_mod.PagePool(32, PS), radix_mod.RadixTree(PS)
    A = list(range(1, 13))
    pa = pool.alloc(3)
    tree.insert(A, pa, first_slot=0)
    for q in (A, A[:6] + [99], A + [13, 14], [1, 2, 3]):
        _call(trace, tree.match, q)
    B = A[:8] + [20, 21, 22, 23]
    _call(trace, tree.match, B)
    tree.insert(B, pool.alloc(1), first_slot=2)
    for q in (A, B, A[:6] + [50, 51]):
        _call(trace, tree.match, q)
    trace.append(_tree_state(tree))


def _case_radix_lru(pool_mod, radix_mod, trace):
    pool, tree = pool_mod.PagePool(16, PS), radix_mod.RadixTree(PS)
    seqs = []
    for i in range(3):
        s = [100 * i + j for j in range(8)]
        seqs.append((s, pool.alloc(2)))
        tree.insert(s, seqs[i][1], first_slot=0)
    tree.match(seqs[0][0])
    tree.match(seqs[2][0])
    _call(trace, tree.evict, 1, pool)
    pool.retain(seqs[0][1])
    tree.match(seqs[0][0])
    _call(trace, tree.evict, 4, pool)
    trace.append((_tree_state(tree), _pool_state(pool)))
    pool.release(seqs[0][1])
    tree.clear(pool)
    trace.append(_pool_state(pool))


def _case_radix_gapped_and_collapse(pool_mod, radix_mod, trace):
    pool, tree = pool_mod.PagePool(16, PS), radix_mod.RadixTree(PS)
    A = [1, 2, 3, 4, 5, 6, 7, 8]
    pa = pool.alloc(1)
    _call(trace, tree.insert, A, pa, 1)
    tree.insert(A[:4], pa, first_slot=0)
    _call(trace, tree.insert, A + [9, 10, 11, 12], pool.alloc(1), 2)
    trace.append(_tree_state(tree))
    pool2, tree2 = pool_mod.PagePool(16, PS), radix_mod.RadixTree(PS)
    tree2.insert(A, pool2.alloc(2), first_slot=0)
    tree2.insert([1, 2, 30, 40, 50, 60, 70, 80], pool2.alloc(2), first_slot=0)
    _call(trace, tree2.evict, 4, pool2)
    trace.append(_tree_state(tree2))


@pytest.mark.parametrize("case", [_case_pool, _case_radix_split, _case_radix_lru,
                                  _case_radix_gapped_and_collapse],
                         ids=lambda f: f.__name__[6:])
def test_pool_and_tree_cases_match_jax(case):
    traces = {}
    for name, (pool_mod, radix_mod) in IMPLS.items():
        traces[name] = []
        case(pool_mod, radix_mod, traces[name])
    assert traces["port"] == traces["jax"]


@pytest.mark.parametrize("seed", range(4))
def test_random_operation_sequences_match_jax(seed):
    """Random alloc/retain/release/fork/insert/match/evict sequences over
    prefixes of a few token streams; every observation and the whole
    state after each step must agree."""
    rng = random.Random(seed)
    streams = [[rng.randrange(6) for _ in range(32)] for _ in range(4)]
    pools = {n: m[0].PagePool(24, PS) for n, m in IMPLS.items()}
    trees = {n: m[1].RadixTree(PS) for n, m in IMPLS.items()}
    held: list[list[int]] = []  # pages retained by a pretend lane
    for _ in range(60):
        op = rng.choice(["insert", "match", "evict", "retain", "release", "fork"])
        s = streams[rng.randrange(len(streams))]
        n_pg, q_len = rng.randint(1, 6), rng.randint(1, 32)
        obs = {}
        for name in IMPLS:
            pool, tree = pools[name], trees[name]
            trace: list = []
            if op == "insert":
                toks = s[: n_pg * PS]
                k = min(tree.match(toks, touch=False).n_tokens // PS, n_pg)
                if n_pg > k and pool.free_pages >= n_pg - k:
                    _call(trace, tree.insert, toks, pool.alloc(n_pg - k), k)
            elif op == "match":
                _call(trace, tree.match, s[:q_len])
            elif op == "evict":
                _call(trace, tree.evict, n_pg, pool)
            elif op == "retain":
                pages = tree.match(s, touch=False).pages
                _call(trace, pool.retain, pages)
                trace.append(pages)
            elif op == "release" and held:
                _call(trace, pool.release, held[-1])
            elif op == "fork":
                pages = tree.all_pages()
                if pages and pool.free_pages:
                    _call(trace, pool.fork, sorted(pages)[0])
            trace.append((_tree_state(tree), _pool_state(pool)))
            obs[name] = trace
        assert obs["port"] == obs["jax"], op
        if op == "retain":
            held.append(obs["port"][-2])
        elif op == "release" and held:
            held.pop()
        elif op == "fork" and isinstance(obs["port"][0], int):
            held.append([obs["port"][0]])
        pools["port"].check()


class _StubEngine:
    """The page-table surface of a pool-native engine, recorded."""

    def __init__(self, n_blocks):
        self._kv_n_blocks = n_blocks
        self.tables: dict[int, list[int]] = {}
        self.copies: list = []

    def init_kv_pool(self, page_size, n_pages, native=False):
        return n_pages

    def adopt_pages(self, lane, pages):
        self.tables[lane] = list(pages)

    def clear_lane_pages(self, lane):
        self.tables.pop(lane, None)

    def clear_all_lane_pages(self):
        self.tables.clear()

    def kv_page_copy(self, src, dst):
        self.copies.append((list(src), list(dst)))

    def reset_kv_pool(self):
        pass


def _manager_flow(kv, eng):
    """test_kv_native's manager flow on host accounting: a cold lane,
    a full-page adopt (no copy), a mid-page adopt (one fork), publishes
    with dedup."""
    prompt = [2 + (i * 7) % 250 for i in range(23)]
    gen = [300 + i for i in range(10)]
    out = [kv.match(0, prompt)]
    kv.adopt(0, out[-1][1])
    out.append(dict(eng.tables))
    out.append(kv.publish(0, (prompt + gen)[:20]))
    kv.release_lane(0)
    out.append(kv.match(1, prompt))
    kv.adopt(1, out[-1][1])
    out.append((dict(eng.tables), list(eng.copies)))
    out.append(kv.publish(1, (prompt + gen)[:24]))
    kv.release_lane(1)
    p2 = prompt[:22] + [199, 198, 197]
    out.append(kv.match(0, p2))
    kv.adopt(0, out[-1][1])
    out.append((dict(eng.tables), list(eng.copies)))
    kv.release_lane(0)
    st = kv.pool.stats()
    out.append((st.free, st.used, st.shared, st.cow_forks, kv.tree.n_pages))
    kv.check()
    return out


def test_native_manager_matches_jax():
    eng_j, eng_t = _StubEngine(16), _StubEngine(16)
    kv_j = jmanager.PagedKVManager(eng_j, page_size=PS, n_pages=64, native=True)
    kv_t = tmanager.PagedKVManager(eng_t, page_size=PS, n_pages=64, native=True)
    got, want = _manager_flow(kv_t, eng_t), _manager_flow(kv_j, eng_j)
    assert got == want
    # a full-page adopt copied nothing; the mid-page one forked one page
    assert got[4][1] == [] and len(got[7][1]) == 1
    assert kv_t.pool.stats().cow_forks == 1


def test_match_retains_pages_until_release():
    """test_kv_pool's regression on the port's manager: match pins the
    pages at once, so another lane's eviction pressure in the match ->
    adopt gap cannot free them; release_lane drops the pin."""
    eng = _StubEngine(2)
    kv = tmanager.PagedKVManager(eng, page_size=PS, n_pages=12, native=True)
    A = [10 + i for i in range(8)]
    kv.match(0, A + [1])
    kv.adopt(0, [])
    assert kv.publish(0, A) == 2
    kv.release_lane(0)
    m, pages = kv.match(1, A + [9])
    assert m == 8 and all(kv.pool.refcount(p) == 2 for p in pages)
    kv.match(2, [500 + i for i in range(9)])
    kv.adopt(2, [])  # allocation pressure: the pinned pages survive
    assert kv.tree.match(A).pages == pages
    kv.release_lane(1)
    assert all(kv.pool.refcount(p) == 1 for p in pages)
    kv.release_lane(2)
    kv.check()
