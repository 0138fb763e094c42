"""The activation and dropout between layers (``ops/act_dropout.py``): on
the CPU the op against ``dropout`` after ``F.relu`` or ``F.elu`` from the
same generator seed (values, gradients, the generator's state),
its refusals, and the three models calling it once at every position
between layers in a train forward and never in an eval one; on the card
the kernels against that chain, bit for bit but ELU, whose expm1 and exp
may round apart by one bf16 unit.

This file imports no JAX, so ``pytest --noconftest -m cuda`` runs it on
a card."""

from __future__ import annotations

from unittest import mock

import numpy as np
import pytest
import torch

from legion_tpu_torch.data.synthetic import random_power_law_graph
from legion_tpu_torch.models import build_model
from legion_tpu_torch.models import gat as port_gat
from legion_tpu_torch.models import gcn as port_gcn
from legion_tpu_torch.models import sage as port_sage
from legion_tpu_torch.ops.act_dropout import (ACTIVATIONS, _ActDropout,
                                              act_dropout,
                                              act_dropout_backward,
                                              act_dropout_forward,
                                              act_dropout_traffic, dropout,
                                              unpack_bits)
from legion_tpu_torch.sampling.block import frontier_caps
from legion_tpu_torch.sampling.sampler import (DeviceGraph, gather_features,
                                               sample_batch)

torch.set_num_threads(2)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FANOUTS, BATCH = (3, 3, 2), 24


def _case(shape, dtype, seed, device="cpu"):
    """h with both signs and exact zeros, and a gradient of its shape."""
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn(shape, generator=gen) * 3
    h[..., ::7] = 0.0
    g = torch.randn(shape, generator=gen)
    return h.to(dtype).to(device), g.to(dtype).to(device)


def _chain(h, act, rate, gen):
    return dropout(ACTIVATIONS[act](h), rate, gen)


def _run(fn, h, g, act, rate, seed):
    """fn(h, act, rate, generator) from a generator seeded ``seed``: the
    output, the gradient of (out * g).sum() at h, and the generator's
    state after the call."""
    gen = torch.Generator(device=h.device).manual_seed(seed)
    x = h.detach().clone().requires_grad_(True)
    out = fn(x, act, rate, gen)
    (out.float() * g.float()).sum().backward()
    return out.detach(), x.grad, gen.get_state()


def _ulps_apart(a, b):
    """Largest distance of a from b in units of b's bf16 spacing."""
    a, b = a.float(), b.float()
    spacing = torch.where(b == 0, torch.full_like(b, 2.0 ** -133),
                          2.0 ** (torch.floor(torch.log2(b.abs())) - 7))
    return float(((a - b).abs() / spacing).max())


# a 2-D layer output and a 3-D one of heads, neither a multiple of 8 long
SHAPES = [(37, 19), (5, 3, 7)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rate", [0.5, 0.25])
def test_op_is_bitwise_the_chain(rate, dtype, shape):
    h, g = _case(shape, DTYPES[dtype], seed=1)
    out, dh, state = _run(act_dropout, h, g, "relu", rate, seed=5)
    want, want_dh, want_state = _run(_chain, h, g, "relu", rate, seed=5)
    assert out.dtype == h.dtype and dh.dtype == h.dtype
    assert torch.equal(out, want) and torch.equal(dh, want_dh)
    assert torch.equal(state, want_state)
    # the draw is the same: about `rate` of the elements dropped
    assert 0 < int((out == 0).sum()) < out.numel()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rate", [0.5, 0.25])
def test_elu_within_one_bf16_unit(rate, dtype, shape):
    h, g = _case(shape, DTYPES[dtype], seed=2)
    out, dh, state = _run(act_dropout, h, g, "elu", rate, seed=7)
    want, want_dh, want_state = _run(_chain, h, g, "elu", rate, seed=7)
    assert _ulps_apart(out, want) <= 1.0 and _ulps_apart(dh, want_dh) <= 1.0
    assert torch.equal(out == 0, want == 0)
    assert torch.equal(state, want_state)


@pytest.mark.parametrize("act", list(ACTIVATIONS))
def test_rate_one_gives_zeros_and_draws_nothing(act):
    h, _ = _case((8, 5), torch.float32, seed=3)
    gen = torch.Generator().manual_seed(11)
    before = gen.get_state()
    out = act_dropout(h, act, 1.0, gen)
    assert out.shape == h.shape and not out.any()
    assert torch.equal(gen.get_state(), before)


def test_refusals():
    h, _ = _case((6, 4), torch.float32, seed=4)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="act must be one of"):
        act_dropout(h, "gelu", 0.5, gen)
    with pytest.raises(ValueError, match="takes"):
        act_dropout(h.half(), "relu", 0.5, gen)
    with pytest.raises(ValueError, match="takes"):
        act_dropout(h.double(), "elu", 0.5, gen)
    u = torch.rand(h.shape)
    with pytest.raises(ValueError, match="u must be float32"):
        act_dropout_forward(h, u[:5], 0.5, "relu")
    with pytest.raises(ValueError, match="u must be float32"):
        act_dropout_forward(h, u.double(), 0.5, "relu")
    with pytest.raises(ValueError, match="keep must lie"):
        act_dropout_forward(h, u, 0.0, "relu")
    # the kernels run on CUDA tensors only: a CPU tensor is refused
    with pytest.raises(ValueError, match="CUDA"):
        act_dropout_forward(h, u, 0.5, "relu")
    bits = torch.zeros((3,), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        act_dropout_backward(h, bits, h, 0.5, "elu")
    with pytest.raises(ValueError, match="bits must be"):
        act_dropout_backward(h, bits[:2], h, 0.5, "elu")
    with pytest.raises(ValueError, match="h must have"):
        act_dropout_backward(h, bits, h[:3], 0.5, "elu")


def test_unpack_bits_and_traffic():
    bits = torch.tensor([0b10000001, 0b00000110], dtype=torch.uint8)
    assert unpack_bits(bits, 11).tolist() == [
        True, False, False, False, False, False, False, True,
        False, True, True]
    # bf16: h, out 2 B and the f32 uniforms forward; g, dh back (ELU h)
    assert act_dropout_traffic(16, 2, "relu") == {"forward": 16 * 8 + 2,
                                                  "backward": 16 * 4 + 2}
    assert act_dropout_traffic(16, 2, "elu")["backward"] == 16 * 6 + 2


def _batch(seed=0, n=600):
    g = random_power_law_graph(num_nodes=n, avg_degree=6, feature_dim=12,
                               num_classes=5, seed=seed)
    graph = DeviceGraph.from_host(g.indptr, g.indices, torch.device("cpu"))
    ids = np.random.default_rng(seed).permutation(g.train_ids)[:BATCH]
    seeds = torch.from_numpy(ids.astype(np.int32))
    b = sample_batch(graph, seeds, torch.tensor(BATCH, dtype=torch.int32),
                     torch.zeros(BATCH, dtype=torch.int32), FANOUTS,
                     frontier_caps(BATCH, FANOUTS), dedup_last=True,
                     generator=torch.Generator().manual_seed(seed))
    feats = torch.from_numpy(np.asarray(g.features, np.float32))
    return tuple(reversed(b.blocks)), gather_features(feats, b.frontier)


@pytest.mark.parametrize("arch,module,act", [
    ("sage", port_sage, "relu"), ("gcn", port_gcn, "relu"),
    ("gat", port_gat, "elu")])
def test_models_call_the_op_between_layers_in_train_steps_only(
        monkeypatch, arch, module, act):
    """A train forward calls the op once after every layer but the last,
    on that layer's output, with the model's activation and rate and the
    step's generator; an eval forward never calls it."""
    spy = mock.Mock(wraps=act_dropout)
    monkeypatch.setattr(module, "act_dropout", spy)
    blocks, x = _batch()
    model = build_model(arch, 12, 8, 5, len(FANOUTS), 0.3,
                        num_heads=2 if arch == "gat" else 1,
                        generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    out = model(blocks, x, deterministic=False, generator=gen)
    assert out.shape[0] == blocks[-1].dst_cap
    assert spy.call_count == len(FANOUTS) - 1
    for call, blk in zip(spy.call_args_list, blocks):
        h, a, rate, g = call.args
        assert (h.shape[0], a, rate, g) == (blk.dst_cap, act, 0.3, gen)
    model(blocks, x)
    assert spy.call_count == len(FANOUTS) - 1


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _kernel_vs_cpu_chain(h, g, act, keep, start=0):
    """The kernels on ``h[start:]`` (a view ``start`` elements into h)
    against the plain chain on CPU copies of the same uniforms (the CPU
    divides by keep, as the kernels do): the output, the gradient, and
    whether the bits are the chain's."""
    u = torch.rand(h[start:].shape, device=h.device)
    leaf = h.detach().clone().requires_grad_(True)
    out = _ActDropout.apply(leaf[start:], u, keep, act)
    out.backward(g[start:])
    _, bits = act_dropout_forward(h[start:], u, keep, act)
    hc = h[start:].cpu().requires_grad_(True)
    kept = u.cpu() < keep
    want = torch.where(kept, ACTIVATIONS[act](hc) / keep,
                       torch.zeros((), dtype=h.dtype))
    want.backward(g[start:].cpu())
    want_bits = kept & (hc.detach() > 0) if act == "relu" else kept
    return ((out.detach().cpu(), want.detach()),
            (leaf.grad[start:].cpu(), hc.grad),
            torch.equal(unpack_bits(bits, u.numel()).cpu(),
                        want_bits.reshape(-1)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("keep", [0.5, 0.75])
@pytest.mark.parametrize("act", list(ACTIVATIONS))
@pytest.mark.parametrize("shape", [(1000, 256), (37, 19), (3,)])
def test_kernels_match_the_chain(cuda, shape, act, keep, dtype):
    """Whole groups, a tail group and a tensor of one partial group."""
    torch.manual_seed(0)
    h, g = _case(shape, DTYPES[dtype], seed=6, device=cuda)
    (out, want), (dh, want_dh), same_bits = _kernel_vs_cpu_chain(
        h, g, act, keep)
    assert same_bits
    if act == "elu":
        assert _ulps_apart(out, want) <= 1.0
        assert _ulps_apart(dh, want_dh) <= 1.0
    else:
        assert torch.equal(out, want) and torch.equal(dh, want_dh)


@pytest.mark.cuda
@pytest.mark.parametrize("act", list(ACTIVATIONS))
def test_kernels_off_a_16_byte_boundary(cuda, act):
    """A view that starts one element in takes element loads."""
    torch.manual_seed(1)
    h, g = _case((4097,), torch.bfloat16, seed=8, device=cuda)
    (out, want), (dh, want_dh), same_bits = _kernel_vs_cpu_chain(
        h, g, act, 0.5, start=1)
    assert same_bits and _ulps_apart(out, want) <= float(act == "elu")
    assert _ulps_apart(dh, want_dh) <= float(act == "elu")


@pytest.mark.cuda
@pytest.mark.parametrize("act", list(ACTIVATIONS))
def test_op_on_the_card_is_the_cuda_chain_at_rate_one_half(cuda, act):
    """At keep 1/2 the op gives PyTorch's own CUDA chain's bits (ELU within
    one bf16 unit), the same generator state after it, and one launch of
    each kernel."""
    h, g = _case((513, 512), torch.bfloat16, seed=9, device=cuda)
    n0 = (act_dropout.launches, act_dropout_backward.launches)
    out, dh, state = _run(act_dropout, h, g, act, 0.5, seed=3)
    assert (act_dropout.launches, act_dropout_backward.launches) == (
        n0[0] + 1, n0[1] + 1)
    want, want_dh, want_state = _run(_chain, h, g, act, 0.5, seed=3)
    assert torch.equal(state, want_state)
    limit = float(act == "elu")
    assert _ulps_apart(out, want) <= limit
    assert _ulps_apart(dh, want_dh) <= limit
