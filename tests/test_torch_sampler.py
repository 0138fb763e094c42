"""Port parity: legion_tpu_torch's sampling layer against legion_tpu's.

The same seeds and the same per-hop uniforms (rebuilt from the JAX key
with the split chain of ``sample_batch``) go through both samplers; the
frontiers, counts and blocks must be exactly equal. The helpers here are
shared with the other ``test_torch_*`` files."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legion_tpu.cache.hotness import observed_caps as jax_observed_caps
from legion_tpu.sampling import seeds as jax_seeds
from legion_tpu.sampling.block import frontier_caps as jax_frontier_caps
from legion_tpu.sampling.sampler import DeviceGraph as JaxDeviceGraph
from legion_tpu.sampling.sampler import gather_features as jax_gather_features
from legion_tpu.sampling.sampler import grow_frontier as jax_grow_frontier
from legion_tpu.sampling.sampler import sample_batch as jax_sample_batch
from legion_tpu_torch.cache.hotness import observed_caps
from legion_tpu_torch.sampling import seeds
from legion_tpu_torch.sampling.block import Block, SampledBatch, frontier_caps
from legion_tpu_torch.sampling.sampler import (DeviceGraph, gather_features,
                                               grow_frontier, sample_batch)
from tests.test_torch_dedup_kernel import hop_cases

torch.set_num_threads(2)


# -- helpers shared with the other test_torch_* files ------------------------

def jax_uniforms(key, caps, fanouts):
    """The per-hop uniforms legion_tpu's sample_batch draws from ``key``
    (its split chain, sampler.py:603-605, then _draws' uniform), as numpy."""
    out = []
    for k, f in enumerate(fanouts):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (caps[k], f),
                                                 dtype=jnp.float32)))
    return out


def torch_uniforms(key, caps, fanouts):
    return [torch.from_numpy(u.copy())
            for u in jax_uniforms(key, caps, fanouts)]


def to_torch_batch(jb) -> SampledBatch:
    """A legion_tpu SampledBatch as the port's, on the CPU."""
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    blocks = tuple(Block(nbr_pos=t(b.nbr_pos), nbr_mask=t(b.nbr_mask),
                         num_src=t(b.num_src), num_dst=t(b.num_dst),
                         identity_offset=b.identity_offset)
                   for b in jb.blocks)
    return SampledBatch(seeds=t(jb.seeds), labels=t(jb.labels),
                        num_seeds=t(jb.num_seeds), frontier=t(jb.frontier),
                        num_frontier=t(jb.num_frontier), blocks=blocks)


def padded_seeds(ids, n_valid, cap):
    s = np.full(cap, -1, np.int32)
    s[:n_valid] = ids[:n_valid]
    return s


def hub_graph():
    """Five hubs of degree 700 among ~20-degree nodes: on the JAX side
    the lined layout sends the hubs through its per-edge tail path."""
    rng = np.random.default_rng(0)
    n = 3000
    deg = rng.integers(1, 40, size=n)
    deg[:5] = 700
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = rng.integers(0, n, size=indptr[-1]).astype(np.int32)
    return indptr, indices


# -- numpy copies held equal to the originals --------------------------------

def test_seeds_module_equals_original():
    rng = np.random.default_rng(3)
    ids = rng.permutation(5000).astype(np.int32)
    part = rng.integers(0, 3, 5000).astype(np.int32)
    for k in (1, 3):
        a = seeds.shard_node_set(ids, k)
        b = jax_seeds.shard_node_set(ids, k)
        assert all((x == y).all() for x, y in zip(a, b))
        a = seeds.shard_node_set(ids, 3, part)
        b = jax_seeds.shard_node_set(ids, 3, part)
        assert all((x == y).all() for x, y in zip(a, b))
    counts = ([1200, 1100, 1300], [300, 0, 250], [1, 1, 1])
    for batch in (64, 100, 1099):
        assert (dataclasses.astuple(seeds.make_seed_plan(*counts, batch, 128))
                == dataclasses.astuple(
                    jax_seeds.make_seed_plan(*counts, batch, 128)))
    for mod in (seeds, jax_seeds):
        with pytest.raises(ValueError):
            mod.make_seed_plan([10], [5], [5], 64)
    shards = seeds.shard_node_set(ids, 3)
    plan = seeds.make_seed_plan([len(s) for s in shards], [400, 401, 399],
                                [7, 8, 9], 100, 64)
    a = seeds.epoch_train_seeds(np.random.default_rng(5), shards, plan)
    b = jax_seeds.epoch_train_seeds(np.random.default_rng(5), shards, plan)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    a = seeds.epoch_eval_seeds(shards, plan.valid_steps, plan.valid_batch, 64)
    b = jax_seeds.epoch_eval_seeds(shards, plan.valid_steps, plan.valid_batch,
                                   64)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(seeds.interleave_shards(a[0]),
                                  jax_seeds.interleave_shards(a[0]))



def test_seeds_of_epoch_is_the_drivers_rule():
    """``seeds_of_epoch`` is ``epoch_train_seeds`` on a generator seeded
    ``seed * 100003 + epoch``, the rule the reference's drivers spell
    out, bit for bit for two epochs (which differ)."""
    ids = np.random.default_rng(3).permutation(5000).astype(np.int32)
    shards = seeds.shard_node_set(ids, 3)
    plan = seeds.make_seed_plan([len(s) for s in shards], [400] * 3,
                                [7] * 3, 100, 64)
    for seed in (0, 11):
        got = [seeds.seeds_of_epoch(seed, e, shards, plan) for e in (0, 1)]
        for e in (0, 1):
            want, _ = seeds.epoch_train_seeds(
                np.random.default_rng(seed * 100003 + e), shards, plan)
            np.testing.assert_array_equal(got[e], want)
        assert not np.array_equal(got[0], got[1])


@pytest.mark.parametrize("slack,align,last", [
    (1.2, 8, None), (1.03, 128, None), (1.03, 128, 10), (1.0, 1, 3)])
def test_observed_caps_equals_original(slack, align, last):
    for mx in ([64, 300, 1700], [8000, 118610, 1201000], [5, 5, 5]):
        assert (observed_caps(mx, slack, align, last)
                == jax_observed_caps(mx, slack, align, last))


def test_frontier_caps_equal():
    for b, f in ((64, (5, 3)), (8000, (25, 10)), (1, (4, 3, 2)), (70, ())):
        assert frontier_caps(b, f) == jax_frontier_caps(b, f)


# -- sampler parity -----------------------------------------------------------

_jax_sample_batch = jax.jit(jax_sample_batch, static_argnums=(5, 6),
                            static_argnames=("dedup_last",))


def _sample_both(indptr, indices, seed_ids, n_valid, fanouts, caps,
                 dedup_last, key):
    seed_cap = caps[0] - 2
    s = padded_seeds(seed_ids, n_valid, seed_cap)
    labels = np.arange(seed_cap, dtype=np.int32)
    jb = _jax_sample_batch(
        key, JaxDeviceGraph.from_host(indptr, indices), jnp.asarray(s),
        jnp.int32(n_valid), jnp.asarray(labels), fanouts, caps,
        dedup_last=dedup_last)
    tb = sample_batch(DeviceGraph.from_host(indptr, indices, "cpu"),
                      torch.from_numpy(s),
                      torch.tensor(n_valid, dtype=torch.int32),
                      torch.from_numpy(labels), fanouts, caps,
                      dedup_last=dedup_last,
                      uniforms=torch_uniforms(key, caps, fanouts))
    return jb, tb


def _assert_batches_equal(jb, tb):
    np.testing.assert_array_equal(tb.frontier.numpy(), np.asarray(jb.frontier))
    assert tb.frontier.dtype == torch.int32
    assert int(tb.num_frontier) == int(jb.num_frontier)
    assert len(tb.blocks) == len(jb.blocks)
    for bt, bj in zip(tb.blocks, jb.blocks):
        np.testing.assert_array_equal(bt.nbr_pos.numpy(),
                                      np.asarray(bj.nbr_pos))
        np.testing.assert_array_equal(bt.nbr_mask.numpy(),
                                      np.asarray(bj.nbr_mask))
        assert bt.nbr_pos.dtype == torch.int32
        assert int(bt.num_src) == int(bj.num_src)
        assert int(bt.num_dst) == int(bj.num_dst)
        assert bt.identity_offset == bj.identity_offset
        assert bt.num_src.dim() == 0 and bt.num_dst.dim() == 0


@pytest.mark.parametrize("dedup_last", [True, False])
@pytest.mark.parametrize("caps_kind", ["exact", "roomy", "overflow"])
@pytest.mark.parametrize("graph_kind", ["small", "hubs"])
def test_sample_batch_matches_jax(small_graph, graph_kind, caps_kind,
                                  dedup_last):
    """Exactly the reference's frontier, counts and blocks, for loose,
    roomier-than-needed (the total < cap padding path) and overflowing
    caps."""
    if graph_kind == "small":
        indptr, indices = small_graph.indptr, small_graph.indices
        fanouts = (5, 3)
    else:
        indptr, indices = hub_graph()
        fanouts = (9, 4)
    n = indptr.shape[0] - 1
    ids = np.r_[np.arange(5),
                np.random.default_rng(1).permutation(np.arange(5, n))]
    f_last = fanouts[-1]
    mid = {"exact": 72 * (1 + fanouts[0]), "roomy": 72 * (1 + fanouts[0]) + 96,
           "overflow": 150}[caps_kind]
    last = mid * (1 + f_last) if not dedup_last or caps_kind != "roomy" \
        else mid * (1 + f_last) + 40
    caps = (72, mid, last)
    for k in range(2):
        jb, tb = _sample_both(indptr, indices, ids, 64, fanouts, caps,
                              dedup_last, jax.random.PRNGKey(k))
        _assert_batches_equal(jb, tb)
    if caps_kind == "overflow":
        assert int(jb.blocks[0].num_src) > caps[1]


_jax_grow_frontier = jax.jit(jax_grow_frontier, static_argnums=(3,))


@pytest.mark.parametrize("name", sorted(hop_cases()))
def test_grow_frontier_matches_jax_on_its_contract_cases(name):
    """One hop of the sort dedup, whose tail runs as its plain version on
    the CPU: frontier, count and block exactly the reference's on each
    contract case of ``tests/test_torch_dedup_kernel.py`` (the card test
    there holds the kernel to the plain version on the same inputs)."""
    prev, num, nbrs, cap = hop_cases()[name]
    want = _jax_grow_frontier(jnp.asarray(prev), jnp.int32(num),
                              jnp.asarray(nbrs), cap)
    got = grow_frontier(torch.from_numpy(prev),
                        torch.tensor(num, dtype=torch.int32),
                        torch.from_numpy(nbrs), cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].dtype == torch.int32 and got[0].shape == (cap,)
    assert int(got[1]) == int(want[1]) and got[1].dtype == torch.int32
    for field in ("nbr_pos", "nbr_mask", "num_src", "num_dst"):
        np.testing.assert_array_equal(
            getattr(got[2], field).numpy(), np.asarray(getattr(want[2],
                                                               field)))
    assert got[2].nbr_pos.dtype == torch.int32
    if name.startswith("overflow"):
        assert int(got[1]) >= cap and (got[0] >= 0).all()
    if name in ("empty_hop", "all_padding"):
        assert int(got[1]) == num and (got[2].nbr_pos == 0).all()


def test_sample_batch_generator_invariants(small_graph):
    """Generator-driven sampling: prefix numbering, unique deduped
    frontier, and every valid edge is a true CSR in-neighbor."""
    g = DeviceGraph.from_host(small_graph.indptr, small_graph.indices, "cpu")
    b, fanouts = 64, (5, 3)
    caps = frontier_caps(b, fanouts)
    s = torch.from_numpy(small_graph.train_ids[:b].copy())
    gen = torch.Generator().manual_seed(0)
    batch = sample_batch(g, s, torch.tensor(b, dtype=torch.int32),
                         torch.zeros(b, dtype=torch.int32), fanouts, caps,
                         dedup_last=True, generator=gen)
    fr = batch.frontier.numpy()
    n = int(batch.num_frontier)
    assert (fr[:b] == s.numpy()).all()
    assert len(np.unique(fr[:n])) == n and (fr[n:] == -1).all()
    indptr, indices = small_graph.indptr, small_graph.indices
    for blk in batch.blocks:
        pos, m = blk.nbr_pos.numpy(), blk.nbr_mask.numpy()
        for d, j in zip(*np.nonzero(m)):
            nbrs = indices[indptr[fr[d]]:indptr[fr[d] + 1]]
            assert fr[pos[d, j]] in nbrs
    again = sample_batch(g, s, torch.tensor(b, dtype=torch.int32),
                         torch.zeros(b, dtype=torch.int32), fanouts, caps,
                         dedup_last=True,
                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.frontier, batch.frontier)


def test_sample_batch_randomness_args():
    g = DeviceGraph.from_host(np.array([0, 1, 2]), np.array([1, 0]), "cpu")
    s = torch.tensor([0, 1], dtype=torch.int32)
    n = torch.tensor(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        sample_batch(g, s, n, s, (2,))                      # neither
    with pytest.raises(ValueError):
        sample_batch(g, s, n, s, (2,), (2, 6),
                     uniforms=[torch.zeros(3, 2)])         # wrong shape


def test_device_graph_rejects_2_31_edges():
    with pytest.raises(ValueError, match="2\\^31"):
        DeviceGraph.from_host(np.array([0, 2 ** 31], np.int64),
                              np.zeros(0, np.int32), "cpu")


def test_gather_features_matches_jax(small_graph):
    feats = np.asarray(small_graph.features, np.float32)
    fr = np.r_[np.random.default_rng(2).integers(0, 2000, 300),
               [-1] * 7].astype(np.int32)
    want = np.asarray(jax_gather_features(jnp.asarray(feats),
                                          jnp.asarray(fr)))
    got = gather_features(torch.from_numpy(feats), torch.from_numpy(fr))
    np.testing.assert_array_equal(got.numpy(), want)
