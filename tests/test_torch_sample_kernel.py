"""The port's sampling kernel (``ops/sample.py``, the counterpart of K4,
``legion_tpu/ops/select_pallas.py:46``) against K4 itself.

On the JAX side K4 runs only when node ids reach 2^24 (the f32 one-hot
select is exact only below that), so the parity test builds a CSR whose
every neighbor id lies in [2^24, 2^31 - 1), routes the JAX sampler's lane
select through ``select_lanes_pallas`` in interpret mode (as
tests/test_pallas_ops.py runs it), and holds the port's plain version to
it bit for bit on the same uniforms, for each of the JAX layouts (their
tail paths included: degrees reach 300). The ``cuda`` test holds the
kernel to the plain version bit for bit on the card. JAX is imported
inside the parity tests only, so ``pytest --noconftest -m cuda`` runs
where JAX is absent."""

import numpy as np
import pytest
import torch

from legion_tpu_torch.ops.sample import (sample_neighbors,
                                         sample_neighbors_plain)
from legion_tpu_torch.sampling import sampler
from legion_tpu_torch.sampling.sampler import DeviceGraph, sample_batch

torch.set_num_threads(2)

BIG = 1 << 24


def _big_id_csr(seed=0, n=1000):
    """~1000 nodes with degrees 0..300 and neighbor ids >= 2^24."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 301, n)
    deg[:20] = 0
    deg[20:25] = 300
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = rng.integers(BIG, 2 ** 31 - 1, int(indptr[-1]),
                           dtype=np.int64).astype(np.int32)
    return indptr, indices


def _frontier(n, seed=1, pad=24):
    """Every node once (the JAX tail path assumes a deduped frontier),
    shuffled, then -1 padding."""
    rng = np.random.default_rng(seed)
    return np.r_[rng.permutation(n), [-1] * pad].astype(np.int32)


def _torch_csr(indptr, indices, device="cpu"):
    g = DeviceGraph.from_host(indptr, indices, device)
    return g.indptr, g.indices


@pytest.mark.parametrize("fanout", [10, 25])
@pytest.mark.parametrize("layout", ["windowed", "aligned", "lined"])
def test_plain_version_matches_k4_on_big_ids(monkeypatch, layout, fanout):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from legion_tpu.ops.select_pallas import select_lanes_pallas
    from legion_tpu.sampling import sampler as jax_sampler
    indptr, indices = _big_id_csr()
    g = jax_sampler.DeviceGraph.from_host(indptr, indices, layout=layout)
    assert g.lined == (layout == "lined")
    assert (g.astart is not None) == (layout == "aligned")
    assert g.big_deg_count > 0                     # the tail path runs

    calls = []

    def k4(win, off, max_id):
        # concrete inputs and a concrete result, as tests/test_pallas_ops.py
        # runs the interpreter: no other dispatch in flight around it
        win, off = np.asarray(win), np.asarray(off)
        calls.append(win.shape)
        with pltpu.force_tpu_interpret_mode():
            out = np.asarray(select_lanes_pallas(jnp.asarray(win),
                                                 jnp.asarray(off)))
        return jnp.asarray(out)

    monkeypatch.setattr(jax_sampler, "_select_lanes", k4)
    frontier = _frontier(len(indptr) - 1)
    key = jax.random.PRNGKey(fanout)
    want = np.asarray(jax_sampler.sample_neighbors(
        key, g, jnp.asarray(frontier), fanout))
    assert calls and calls[0][1] == (256 if layout == "windowed" else 128)
    u = np.array(jax.random.uniform(key, (len(frontier), fanout),
                                    dtype=jnp.float32))
    got = sample_neighbors(*_torch_csr(indptr, indices),
                           torch.from_numpy(frontier), torch.from_numpy(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[want >= 0] >= BIG).all()
    assert (want == -1).any() and (want >= BIG).sum() > 0.5 * want.size


def test_draw_rounds_in_float32():
    """u * deg rounds up to deg for u just below 1: the draw clamps to
    deg - 1; with one neighbor every slot past the first is -1."""
    indptr = torch.tensor([0, 3, 4, 4], dtype=torch.int32)
    indices = torch.tensor([7, 8, 9, 5], dtype=torch.int32)
    top = float(np.nextafter(np.float32(1), np.float32(0)))
    u = torch.tensor([[top, 0.0, 0.34], [0.5, top, 0.0], [0.1, 0.2, 0.3],
                      [0.9, 0.9, 0.9]], dtype=torch.float32)
    frontier = torch.tensor([0, 1, 2, -1], dtype=torch.int32)
    got = sample_neighbors(indptr, indices, frontier, u)
    assert got.tolist() == [[9, 7, 8], [5, -1, -1], [-1, -1, -1],
                            [-1, -1, -1]]


def test_cpu_tensors_take_the_plain_version_without_launching():
    indptr, indices = _torch_csr(*_big_id_csr())
    frontier = torch.from_numpy(_frontier(1000))
    u = torch.rand((frontier.shape[0], 7),
                   generator=torch.Generator().manual_seed(0))
    n0 = sample_neighbors.launches
    assert torch.equal(sample_neighbors(indptr, indices, frontier, u),
                       sample_neighbors_plain(indptr, indices, frontier, u))
    assert sample_neighbors.launches == n0


def test_sample_neighbors_rejects_bad_arguments():
    indptr, indices = _torch_csr(*_big_id_csr())
    frontier = torch.arange(10, dtype=torch.int32)
    u = torch.zeros((10, 3))
    with pytest.raises(ValueError, match="int32"):
        sample_neighbors(indptr.long(), indices, frontier, u)
    with pytest.raises(ValueError, match="int32"):
        sample_neighbors(indptr, indices, frontier.long(), u)
    with pytest.raises(ValueError, match="float32"):
        sample_neighbors(indptr, indices, frontier, u.double())
    with pytest.raises(ValueError, match="float32"):
        sample_neighbors(indptr, indices, frontier, u[:9])
    with pytest.raises(ValueError, match="empty"):
        sample_neighbors(indptr, indices[:0], frontier, u)


def test_sampler_routes_every_hop_through_the_wrapper(monkeypatch,
                                                      small_graph):
    calls = []

    def counted(*args):
        calls.append(args[3].shape)
        return sample_neighbors(*args)

    monkeypatch.setattr(sampler, "sample_kernel", counted)
    g = DeviceGraph.from_host(small_graph.indptr, small_graph.indices, "cpu")
    s = torch.arange(64, dtype=torch.int32)
    batch = sample_batch(g, s, torch.tensor(64, dtype=torch.int32), s,
                         (5, 3), generator=torch.Generator().manual_seed(0))
    assert calls == [(64, 5), (384, 3)]
    assert batch.frontier.shape[0] == 1536


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("fanout", [10, 25])
def test_cuda_sample_neighbors_is_bitwise_the_plain_version(fanout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    indptr, indices = _torch_csr(*_big_id_csr(), device=dev)
    frontier = torch.from_numpy(_frontier(1000)).to(dev)
    for seed in range(3):
        u = torch.rand((frontier.shape[0], fanout), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(seed))
        if seed == 2:     # draws that round up to deg and clamp
            u = torch.full_like(u, float(np.nextafter(np.float32(1),
                                                      np.float32(0))))
        n0 = sample_neighbors.launches
        got = sample_neighbors(indptr, indices, frontier, u)
        assert sample_neighbors.launches == n0 + 1
        assert torch.equal(got, sample_neighbors_plain(indptr, indices,
                                                       frontier, u))
    with pytest.raises(ValueError, match="device"):
        sample_neighbors(indptr, indices, frontier.cpu(), u)
