"""The port's paged-pool updates against the reference package.

``paged_write_decode``, ``paged_write_packed``, ``copy_pages_all`` and
``reset_pages_all`` only move data, so the port's pools must equal the
reference's exactly after the same update on the same pools.  The one
exception is the K/V *data* of the dump page: several padding lanes may
write it in one scatter, and a scatter with repeated indices keeps an
unspecified one of the values in either framework.  Its positions must
stay -1, which is all the dump page promises.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kv_cache as JKV
from repro_torch.core import kv_cache as KV

P, PAGE, NPAGES, H, D = 12, 8, 4, 2, 16
DUMP = P - 1


def _pool(rng):
    ppos = rng.integers(-1, 40, size=(P, PAGE)).astype(np.int32)
    ppos[DUMP] = -1
    return {"pk": rng.normal(size=(P, PAGE, H, D)).astype(np.float32),
            "pv": rng.normal(size=(P, PAGE, H, D)).astype(np.float32),
            "ppos": ppos}


def _torch(pool):
    return {k: torch.from_numpy(v.copy()) for k, v in pool.items()}


def _assert_same(ours, ref):
    ref = {k: np.asarray(v) for k, v in ref.items()}
    np.testing.assert_array_equal(ours["ppos"].numpy(), ref["ppos"])
    assert (ref["ppos"][DUMP] == -1).all()
    for k in ("pk", "pv"):
        np.testing.assert_array_equal(ours[k].numpy()[:DUMP], ref[k][:DUMP])


def _block_tables():
    # slot 0 fully mapped, slot 1 with unallocated tail entries, slot 2
    # with no pages at all
    return np.asarray([[0, 3, 5, 7], [2, 9, -1, -1], [-1, -1, -1, -1]],
                      np.int32)


@pytest.mark.parametrize("with_active", [False, True])
def test_paged_write_decode_matches_reference(with_active):
    rng = np.random.default_rng(1)
    pool, bt = _pool(rng), _block_tables()
    lens = np.asarray([13, 20, 3], np.int32)      # slot 1 -> unallocated page
    new = {k: rng.normal(size=(3, 1, H, D)).astype(np.float32)
           for k in ("k", "v")}
    active = np.asarray([True, True, False]) if with_active else None
    ours = KV.paged_write_decode(
        _torch(pool), {k: torch.from_numpy(v) for k, v in new.items()},
        torch.from_numpy(lens), torch.from_numpy(bt),
        None if active is None else torch.from_numpy(active),
        ring_len=NPAGES * PAGE)
    ref = JKV.paged_write_decode(
        {k: jnp.asarray(v) for k, v in pool.items()},
        {k: jnp.asarray(v) for k, v in new.items()}, jnp.asarray(lens),
        jnp.asarray(bt), None if active is None else jnp.asarray(active),
        ring_len=NPAGES * PAGE)
    _assert_same(ours, ref)
    # the written token is visible in slot 0's page at its position
    assert ours["ppos"][3, 13 % PAGE] == 13


def test_paged_write_packed_matches_reference():
    rng = np.random.default_rng(2)
    pool, bt = _pool(rng), _block_tables()
    T = 24
    slot_ids = np.full(T, -1, np.int32)
    positions = np.full(T, -1, np.int32)
    slot_ids[:1], positions[:1] = 0, 21                     # decode lane
    slot_ids[1:12], positions[1:12] = 1, np.arange(10, 21)  # crosses -1 page
    slot_ids[12:15], positions[12:15] = 2, np.arange(3)     # no pages
    slot_ids[15:17], positions[15:17] = 0, [31, 32]         # 32 >= ring_len
    new = {k: rng.normal(size=(1, T, H, D)).astype(np.float32)
           for k in ("k", "v")}
    ours = KV.paged_write_packed(
        _torch(pool), {k: torch.from_numpy(v) for k, v in new.items()},
        torch.from_numpy(slot_ids), torch.from_numpy(positions),
        torch.from_numpy(bt), ring_len=NPAGES * PAGE)
    ref = JKV.paged_write_packed(
        {k: jnp.asarray(v) for k, v in pool.items()},
        {k: jnp.asarray(v) for k, v in new.items()}, jnp.asarray(slot_ids),
        jnp.asarray(positions), jnp.asarray(bt), ring_len=NPAGES * PAGE)
    _assert_same(ours, ref)


def _model_pools(rng, n_layers=2):
    return [_pool(rng) for _ in range(n_layers)]


def _jax_cache(pools):
    """The reference's stacked layout: one stack, one pattern position,
    the layers as scan repeats."""
    return {"layers": ((
        {k: jnp.asarray(np.stack([p[k] for p in pools])) for k in pools[0]},
    ),)}


def _assert_model_same(ours, ref_cache):
    for i, c in enumerate(ours["layers"]):
        _assert_same(c, {k: v[i] for k, v in ref_cache["layers"][0][0].items()})


def test_copy_and_reset_pages_match_reference():
    rng = np.random.default_rng(3)
    pools = _model_pools(rng)
    # reset two fresh pages (rows padded with the dump page), then copy
    # slot 1's partial tail page 4 -> 6 keeping positions < 11; the other
    # rows are dump -> dump padding
    reset = np.asarray([[6, 8, DUMP, DUMP], [DUMP] * 4], np.int32)
    src = np.asarray([DUMP, 4, DUMP], np.int32)
    dst = np.asarray([DUMP, 6, DUMP], np.int32)
    keep = np.asarray([0, 11, 0], np.int32)
    ours = {"layers": [_torch(p) for p in pools]}
    KV.reset_pages_all(ours, torch.from_numpy(reset))
    KV.copy_pages_all(ours, torch.from_numpy(src), torch.from_numpy(dst),
                      torch.from_numpy(keep))
    ref = JKV.reset_pages_all(_jax_cache(pools), jnp.asarray(reset))
    ref = JKV.copy_pages_all(ref, jnp.asarray(src), jnp.asarray(dst),
                             jnp.asarray(keep))
    _assert_model_same(ours, ref)
    assert (ours["layers"][0]["ppos"][8] == -1).all()
    np.testing.assert_array_equal(ours["layers"][1]["pk"][6].numpy(),
                                  pools[1]["pk"][4])


def test_paged_gather_matches_reference():
    rng = np.random.default_rng(4)
    pool, bt = _pool(rng), _block_tables()
    ours = KV.paged_gather(_torch(pool), torch.from_numpy(bt))
    ref = JKV.paged_gather({k: jnp.asarray(v) for k, v in pool.items()},
                           jnp.asarray(bt))
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
