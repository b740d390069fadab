"""The port's decoder against the reference on reduced unimo-text (fp32,
2 layers, the reference's parameters converted by ``bridge``).

For one packed iteration (a decode lane, a continuing chunk and a fresh
chunk) and for one decode step, started from the same pools, the logits
of ``forward_packed`` / ``forward_decode`` must match within atol 1e-4
and the pools afterwards within atol 1e-5 (positions exactly).  The new
K/V entries are fp32 matmul outputs over d_model = 256 whose summation
order differs between XLA and PyTorch: they differ by up to ~3e-6 (about
20 ulp at their magnitude), so 1e-5 is the tightest bound that holds
with margin.  The dump page's K/V data is excluded: padding lanes all
write it and a scatter keeps an unspecified one of them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.core.precision import FP32 as J_FP32
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs.registry import get_reduced
from repro_torch.core.precision import FP32
from repro_torch.kernels import decode_attention as DA
from repro_torch.models import transformer as T

SLOTS, PAGE, MAX_LEN = 3, 8, 64
PPS = MAX_LEN // PAGE                     # pages per slot
NUM_PAGES = SLOTS * PPS
DUMP = NUM_PAGES


@pytest.fixture(scope="module")
def model():
    jcfg = j_get_reduced("unimo-text")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, J_FP32)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, get_reduced("unimo-text"), params


def _block_tables():
    bt = np.full((SLOTS, PPS), -1, np.int32)
    for s in range(SLOTS):
        bt[s, :5] = np.arange(5) * SLOTS + s      # interleaved pages
    return bt


def _stream(rng, vocab, segs, T_):
    """segs: [(slot, start, length)] -> packed stream arrays."""
    tokens = np.zeros(T_, np.int32)
    slot_ids = np.full(T_, -1, np.int32)
    positions = np.full(T_, -1, np.int32)
    starts, lens, slots, last, t = [], [], [], [], 0
    for slot, start, ln in segs:
        tokens[t:t + ln] = rng.integers(4, vocab, size=ln)
        slot_ids[t:t + ln] = slot
        positions[t:t + ln] = np.arange(start, start + ln)
        starts.append(t), lens.append(ln), slots.append(slot)
        t += ln
        last.append(t - 1)
    seg_last = np.zeros(SLOTS, np.int32)
    seg_last[:len(last)] = last
    meta = DA.packed_meta_table(starts, lens, slots, T_,
                                T_ // DA.PACKED_BLOCK_Q + SLOTS)
    return tokens, slot_ids, positions, seg_last, meta


def _jax_packed(jcfg, jparams, cache, bt, stream):
    tokens, slot_ids, positions, seg_last, meta = stream
    return JT.forward_packed(
        jparams, jcfg, jnp.asarray(tokens[None]), cache,
        jnp.asarray(slot_ids), jnp.asarray(positions), jnp.asarray(seg_last),
        policy=J_FP32, max_len=MAX_LEN,
        paged={"block_tables": jnp.asarray(bt),
               "packed_meta": jnp.asarray(meta)})


def _port_packed(cfg, params, cache, bt, stream):
    tokens, slot_ids, positions, seg_last, meta = \
        (torch.from_numpy(a) for a in stream)
    return T.forward_packed(params, cfg, tokens[None], cache, slot_ids,
                            positions, seg_last, policy=FP32,
                            max_len=MAX_LEN,
                            paged={"block_tables": torch.from_numpy(bt),
                                   "packed_meta": meta})


def _assert_pools_close(ours, ref_cache, cfg):
    ref = jax.tree.map(np.asarray, ref_cache)
    mine = bridge.pool_to_numpy(ours, cfg)
    for mc, rc in zip(mine["layers"][0], ref["layers"][0]):
        np.testing.assert_array_equal(mc["ppos"], rc["ppos"])
        assert (rc["ppos"][:, DUMP] == -1).all()
        for k in ("pk", "pv"):
            np.testing.assert_allclose(mc[k][:, :DUMP], rc[k][:, :DUMP],
                                       rtol=0, atol=1e-5)


def _history(model):
    """Both packages' pools after the same first iteration: chunks of
    14 and 10 prompt tokens for slots 0 and 1."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(0)
    bt = _block_tables()
    jcache = JT.init_paged_cache(jcfg, num_pages=NUM_PAGES, page_size=PAGE,
                                 max_slots=SLOTS, max_len=MAX_LEN,
                                 dtype=jnp.float32)
    first = _stream(rng, jcfg.vocab_size, [(0, 0, 14), (1, 0, 10)], 24)
    _, jcache = _jax_packed(jcfg, jparams, jcache, bt, first)
    cache = bridge.pool_from_numpy(jax.tree.map(np.asarray, jcache))
    return rng, bt, jcache, cache


def test_forward_packed_matches_reference(model):
    jcfg, jparams, cfg, params = model
    rng, bt, jcache, cache = _history(model)
    # decode lane (slot 0), continuing chunk (slot 1), fresh chunk
    # (slot 2), 7 padding lanes
    stream = _stream(rng, jcfg.vocab_size,
                     [(0, 14, 1), (1, 10, 7), (2, 0, 9)], 24)
    jlogits, jcache = _jax_packed(jcfg, jparams, jcache, bt, stream)
    logits, cache = _port_packed(cfg, params, cache, bt, stream)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-4)
    _assert_pools_close(cache, jcache, cfg)


def test_forward_decode_matches_reference(model):
    jcfg, jparams, cfg, params = model
    rng, bt, jcache, cache = _history(model)
    tok = rng.integers(4, jcfg.vocab_size, size=(SLOTS, 1)).astype(np.int32)
    lens = np.asarray([14, 10, 0], np.int32)
    active = np.asarray([True, True, False])       # slot 2 rides inactive
    jlogits, jcache = JT.forward_decode(
        jparams, jcfg, jnp.asarray(tok), jcache, jnp.asarray(lens),
        policy=J_FP32, max_len=MAX_LEN,
        paged={"block_tables": jnp.asarray(bt),
               "active": jnp.asarray(active)})
    logits, cache = T.forward_decode(
        params, cfg, torch.from_numpy(tok), cache, torch.from_numpy(lens),
        policy=FP32, max_len=MAX_LEN,
        paged={"block_tables": torch.from_numpy(bt),
               "active": torch.from_numpy(active)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-4)
    _assert_pools_close(cache, jcache, cfg)


def test_init_params_shapes_and_scales_match_reference(model):
    """The port's own initializer draws the reference's shapes at the
    reference's init scales (the card has no JAX to draw them)."""
    jcfg, jparams, cfg, params = model
    gen = torch.Generator().manual_seed(0)
    ours = T.init_params(gen, cfg)
    ref = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}/{i}")
        else:
            yield prefix, tree

    mine, theirs = dict(leaves(ours)), dict(leaves(ref))
    assert mine.keys() == theirs.keys()
    for k, a in mine.items():
        b = theirs[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        assert abs(a.std().item() - b.std().item()) <= 0.1 * b.std().item() \
            + 1e-6, k
        assert abs(a.mean().item() - b.mean().item()) <= 0.01, k
