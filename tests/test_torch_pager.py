"""The port's page allocator (``repro_torch.serving.pager``) on the CPU
against ``repro.serving.pager``: seeded sequences of ``alloc_on_write``,
``alloc_range`` and ``release_rows`` leave the same free list, top,
refcounts and block tables (compared on the real pages, ``[:n_pages]``;
the port's trailing entry is its write-drop sentinel), the port's state
keeps the conservation law at every step, and the paged K/V writes leave
every real page bit-equal to JAX's pool when rows are inactive, chunks
are padded and blocks are unmapped."""
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.serving import pager as jpager  # noqa: E402
from repro_torch.serving import pager  # noqa: E402


def _t(x, dtype=torch.int32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _same_state(ps, bt, jps, jbt) -> None:
    n_pages = jps.free.shape[0]
    top = int(ps.top)
    assert top == int(jps.top)
    np.testing.assert_array_equal(ps.free[:top].numpy(),
                                  np.asarray(jps.free)[:top])
    np.testing.assert_array_equal(ps.rc[:n_pages].numpy(), np.asarray(jps.rc))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(jbt))


def _check_partition(ps, bt) -> None:
    """The free-list prefix and the mapped pages partition the real pages,
    and each mapped page's refcount is its number of table entries (the
    law of ``tests/test_pager.py``); the sentinel is never handed out."""
    n_pages = ps.free.shape[0] - 1
    top = int(ps.top)
    assert 0 <= top <= n_pages
    free_ids = ps.free[:top].tolist()
    assert len(set(free_ids)) == len(free_ids), "free list holds a dup"
    assert all(0 <= p < n_pages for p in free_ids)
    table = bt.numpy()
    assert (table < n_pages).all(), "the sentinel page was mapped"
    counts = Counter(table[table >= 0].tolist())
    rc = ps.rc.numpy()
    for p in range(n_pages):
        if p in set(free_ids):
            assert counts[p] == 0 and rc[p] == 0, f"page {p} free and mapped"
        else:
            assert rc[p] == counts[p] >= 1, f"page {p}: rc {rc[p]}"


def _walk(seed: int, *, with_jax: bool) -> None:
    """kind 0: the masked rows write one token at their position (decode);
    kind 1: release the masked rows; kind 2: the masked rows write a chunk
    of 1..C tokens (``alloc_range``)."""
    rng = np.random.default_rng(seed)
    n_pages = int(rng.integers(1, 11))
    batch = int(rng.integers(1, 5))
    max_blocks = int(rng.integers(1, 4))
    page_size = int(rng.integers(1, 5))
    chunk = int(rng.integers(2, 7))
    dev = torch.device("cpu")
    ps = pager.init_pager(n_pages, dev)
    bt = pager.init_block_table(batch, max_blocks, dev)
    jps = jpager.init_pager(n_pages)
    jbt = jpager.init_block_table(batch, max_blocks)
    pos = np.zeros((batch,), np.int32)
    for _ in range(int(rng.integers(4, 25))):
        kind = int(rng.choice([0, 0, 1, 2, 2]))
        mask = rng.random(batch) < 0.6
        if kind == 0:
            ps, bt = pager.alloc_on_write(ps, bt, _t(pos), _t(mask, torch.bool),
                                          page_size=page_size)
            if with_jax:
                jps, jbt = jpager.alloc_on_write(
                    jps, jbt, jnp.asarray(pos), jnp.asarray(mask),
                    page_size=page_size)
            pos[mask] += 1
        elif kind == 1:
            ps, bt = pager.release_rows(ps, bt, _t(mask, torch.bool))
            if with_jax:
                jps, jbt = jpager.release_rows(jps, jbt, jnp.asarray(mask))
            pos[mask] = 0
        else:
            width = rng.integers(1, chunk + 1, batch).astype(np.int32)
            end = pos + width - 1
            ps, bt = pager.alloc_range(ps, bt, _t(pos), _t(end),
                                       _t(mask, torch.bool),
                                       page_size=page_size, max_chunk=chunk)
            if with_jax:
                jps, jbt = jpager.alloc_range(
                    jps, jbt, jnp.asarray(pos), jnp.asarray(end),
                    jnp.asarray(mask), page_size=page_size, max_chunk=chunk)
            pos[mask] += width[mask]
        _check_partition(ps, bt)
        if with_jax:
            _same_state(ps, bt, jps, jbt)


@pytest.mark.parametrize("seed", range(8))
def test_pager_sequences_match_jax(seed):
    _walk(seed, with_jax=True)


@pytest.mark.parametrize("seed", range(8, 40))
def test_alloc_release_conserves_pages_seeded(seed):
    _walk(seed, with_jax=False)


def test_release_counts_every_reference():
    """Two released rows mapping one page (as prefix sharers will) drop
    its refcount twice in one call and free it once."""
    dev = torch.device("cpu")
    ps = pager.init_pager(4, dev)
    ps = ps._replace(top=torch.tensor(2, dtype=torch.int32),
                     rc=_t([0, 0, 2, 1, 0]))
    bt = _t([[2, 3], [2, -1], [-1, -1]])
    jps = jpager.PagerState(jnp.arange(4, dtype=jnp.int32),
                            jnp.asarray(2, jnp.int32),
                            jnp.asarray([0, 0, 2, 1], jnp.int32))
    mask = np.array([True, True, False])
    ps, bt2 = pager.release_rows(ps, bt, _t(mask, torch.bool))
    jps, jbt2 = jpager.release_rows(jps, jnp.asarray(bt.numpy()),
                                    jnp.asarray(mask))
    _same_state(ps, bt2, jps, jbt2)
    assert int(ps.top) == 4 and sorted(ps.free[2:4].tolist()) == [2, 3]


@pytest.mark.parametrize("total,page", [(1, 16), (2, 16), (17, 16),
                                        (18, 16), (33, 16), (7, 1), (9, 4)])
def test_pages_needed_matches_jax(total, page):
    assert pager.pages_needed(total, page) == jpager.pages_needed(total, page)


def _pool_case(seed):
    rng = np.random.default_rng(seed)
    n_pages, page, hkv, hd, b, max_blocks = 6, 4, 2, 3, 3, 3
    pool = rng.standard_normal((n_pages, page, hkv, hd)).astype(np.float32)
    # row 0 maps two pages, row 1 one page and an unmapped tail, row 2 none
    bt = np.array([[4, 1, -1], [2, -1, -1], [-1, -1, -1]], np.int32)
    return rng, pool, bt, b, max_blocks, hkv, hd


@pytest.mark.parametrize("active", [None, [True, False, True]])
def test_write_page_matches_jax(active):
    """Rows that are inactive, unmapped (row 2) or past the table's end
    (row 1 at position 12) leave every real page as JAX's pool has it."""
    rng, pool, bt, b, _, hkv, hd = _pool_case(0)
    new = rng.standard_normal((b, hkv, hd)).astype(np.float32)
    idx = np.array([5, 12, 2], np.int32)
    port = torch.from_numpy(np.concatenate([pool, np.zeros_like(pool[:1])]))
    act = None if active is None else np.asarray(active)
    pager.write_page(port, torch.from_numpy(new), _t(bt), _t(idx),
                     None if act is None else _t(act, torch.bool))
    want = jpager.write_page(jnp.asarray(pool), jnp.asarray(new),
                             jnp.asarray(bt), jnp.asarray(idx),
                             None if act is None else jnp.asarray(act))
    np.testing.assert_array_equal(port[:-1].numpy(), np.asarray(want))
    assert not np.array_equal(np.asarray(want), pool)   # row 0 wrote


@pytest.mark.parametrize("active", [None, [False, True, True]])
def test_write_page_chunk_matches_jax(active):
    """Chunk padding, inactive rows and unmapped blocks drop their writes
    (row 0's chunk crosses from page 4 into page 1; row 1's runs into its
    unmapped second block)."""
    rng, pool, bt, b, _, hkv, hd = _pool_case(1)
    c = 4
    new = rng.standard_normal((b, c, hkv, hd)).astype(np.float32)
    start = np.array([2, 1, 0], np.int32)
    width = np.array([4, 4, 2], np.int32)
    port = torch.from_numpy(np.concatenate([pool, np.zeros_like(pool[:1])]))
    act = None if active is None else np.asarray(active)
    pager.write_page_chunk(port, torch.from_numpy(new), _t(bt), _t(start),
                           _t(width),
                           None if act is None else _t(act, torch.bool))
    want = jpager.write_page_chunk(jnp.asarray(pool), jnp.asarray(new),
                                   jnp.asarray(bt), jnp.asarray(start),
                                   jnp.asarray(width),
                                   None if act is None else jnp.asarray(act))
    np.testing.assert_array_equal(port[:-1].numpy(), np.asarray(want))
