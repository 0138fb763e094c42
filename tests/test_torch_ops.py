"""Port parity: the plain PyTorch versions of the port's kernels against
legion_tpu's Pallas kernels, run as tests/test_pallas_ops.py runs them on
the CPU (interpret mode). The ``cuda``-marked tests hold each CUDA kernel
to its plain version on the card and skip where there is none; JAX is
imported inside the parity tests only, so that on a machine with a card
and no JAX ``pytest --noconftest -m cuda tests/test_torch_ops.py`` runs.

Tolerances: 2e-2 absolute and relative against the TPU kernels, which
round rows to bf16 before their summing dot
(identity_agg_pallas.py:93-95); 1e-5 between two float32 formulations of
the same sum; bitwise for the gather, a copy. K5 in bf16 sums in f32 and
rounds once, so it lies within 2 bf16 ulps of the f32 result, while the
reference's bf16 sum rounds at each of its f terms."""

from unittest import mock

import numpy as np
import pytest
import torch

from legion_tpu_torch.ops.gather import gather_rows, gather_rows_plain
from legion_tpu_torch.ops.identity_agg import (
    gathered_feature_mean, gathered_feature_mean_plain, gathered_masked_mean,
    gathered_masked_mean_backward, gathered_masked_mean_backward_plain,
    gathered_masked_mean_plain, identity_masked_mean,
    identity_masked_mean_plain)
from legion_tpu_torch.ops.segment import (fanout_gather_mean,
                                          fanout_gather_sum, segment_mean_coo)
from legion_tpu_torch.ops.spmm import (grouped_masked_sum,
                                       grouped_masked_sum_plain)
from legion_tpu_torch.sampling.block import Block

torch.set_num_threads(2)

NORMS = ("mean", "sqrt", "sum")
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LAUNCH_COUNTED = (identity_masked_mean, gathered_masked_mean,
                  gathered_masked_mean_backward, gather_rows,
                  grouped_masked_sum, gathered_feature_mean)


def _identity_case(seed, p=128, f=5, d=128, off=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((off + p * f + 3, d)).astype(np.float32)
    mask = rng.random((p, f)) > 0.4
    mask[7] = False                     # zero-in-degree dst rows
    mask[p - 1] = False
    return x, mask, off


def _gathered_case(seed, p=128, f=7, s=300, d=47):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((s, d)).astype(np.float32)
    mask = rng.random((p, f)) > 0.4
    mask[5] = False
    pos = np.where(mask, rng.integers(0, s, (p, f)), 0).astype(np.int32)
    w = rng.standard_normal((p, d)).astype(np.float32)
    return h, pos, mask, w


# -- K1 -----------------------------------------------------------------------

@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", NORMS)
def test_identity_masked_mean_plain_matches_pallas(norm, x_dtype):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from legion_tpu.ops.identity_agg_pallas import identity_masked_mean_pallas
    x, mask, off = _identity_case(4)
    xj = jnp.asarray(x, getattr(jnp, x_dtype))
    with pltpu.force_tpu_interpret_mode():
        want = identity_masked_mean_pallas(
            xj, jnp.asarray(mask), off, out_dtype=jnp.float32, norm=norm,
            interpret=True)
    xt = torch.from_numpy(x).to(TORCH_DT[x_dtype])
    got = identity_masked_mean(xt, torch.from_numpy(mask), off, norm=norm,
                               out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (128, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)
    assert (got[7] == 0).all() and (got[-1] == 0).all()
    # bf16 emission is the f32 result rounded once
    bf = identity_masked_mean(xt, torch.from_numpy(mask), off, norm=norm)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, got.to(torch.bfloat16))


# -- K2 -----------------------------------------------------------------------

@pytest.mark.parametrize("norm", NORMS)
def test_gathered_masked_mean_plain_matches_pallas(norm):
    """Forward and gradient, at a width (47) that is no multiple of 128."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from legion_tpu.ops.identity_agg_pallas import (
        gathered_masked_mean as jax_gathered_masked_mean)
    h, pos, mask, w = _gathered_case(6)

    def fused(hj):
        return jax_gathered_masked_mean(hj, jnp.asarray(pos),
                                        jnp.asarray(mask), norm=norm,
                                        interpret=True)

    hj, wj = jnp.asarray(h), jnp.asarray(w)
    with pltpu.force_tpu_interpret_mode():
        want = fused(hj)
        want_g = jax.grad(lambda a: jnp.sum(fused(a) * wj))(hj)

    ht = torch.from_numpy(h).requires_grad_(True)
    pt, mt = torch.from_numpy(pos), torch.from_numpy(mask)
    out = gathered_masked_mean(ht, pt, mt, norm=norm)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=2e-2, atol=2e-2)
    assert (out[5] == 0).all()
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_g),
                               rtol=2e-2, atol=2e-2)
    # the explicit backward (the CUDA kernel's plain twin) is that gradient
    d = gathered_masked_mean_backward(torch.from_numpy(w), pt, mt, h.shape[0],
                                      norm)
    np.testing.assert_allclose(d.numpy(), ht.grad.numpy(), rtol=1e-5,
                               atol=1e-6)


def _overflowed_block(small_graph, p=128, d=24):
    """A real hop-1 block sampled past its cap (the overflow case of
    tests/test_torch_sampler.py: hop-1 cap 150 < the realized uniques),
    padded with masked dst rows to p = 128 for the Pallas tile, and
    random src activations of the cap's 150 rows."""
    import jax

    from tests.test_torch_sampler import _sample_both
    jb, _ = _sample_both(small_graph.indptr, small_graph.indices,
                         np.arange(small_graph.num_nodes), 64, (5, 3),
                         (72, 150, 600), True, jax.random.PRNGKey(0))
    blk = jb.blocks[0]
    s = 150
    pos = np.zeros((p, 5), np.int32)
    mask = np.zeros((p, 5), bool)
    pos[:72], mask[:72] = np.asarray(blk.nbr_pos), np.asarray(blk.nbr_mask)
    assert int(blk.num_src) > s and (pos[mask] >= s).any()
    rng = np.random.default_rng(3)
    h = rng.standard_normal((s, d)).astype(np.float32)
    w = rng.standard_normal((p, d)).astype(np.float32)
    return h, pos, mask, w


def test_positions_past_the_rows_fill_nan_as_jax(small_graph):
    """After a cap overflow a valid slot can point past the src rows. JAX's
    fill-mode take makes such a dst row NaN and drops the slot from the
    gradient; the port's K2 plain version, its explicit backward and the
    plain aggregators do the same. Finite rows agree at 1e-5 (two float32
    sums) and gradients at 1e-5. The Pallas kernel (interpreted) turns
    its whole 128-row tile NaN, since its summing dot multiplies the NaN
    row by zeros; its gradient is the same."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from legion_tpu.ops.identity_agg_pallas import (
        gathered_masked_mean as jax_gathered_masked_mean)
    from legion_tpu.ops.segment import fanout_gather_mean as jax_fanout_mean
    from legion_tpu.ops.segment import segment_mean_coo as jax_segment_mean
    from legion_tpu.sampling.block import Block as JaxBlock
    h, pos, mask, w = _overflowed_block(small_graph)
    p, s = pos.shape[0], h.shape[0]
    nan_rows = ((pos >= s) & mask).any(1)
    jblk = JaxBlock(nbr_pos=jnp.asarray(pos), nbr_mask=jnp.asarray(mask),
                    num_src=jnp.int32(s), num_dst=jnp.int32(p))
    blk = Block(nbr_pos=torch.from_numpy(pos), nbr_mask=torch.from_numpy(mask),
                num_src=torch.tensor(s, dtype=torch.int32),
                num_dst=torch.tensor(p, dtype=torch.int32))
    hj, wj = jnp.asarray(h), jnp.asarray(w)

    def fused(a):
        return jax_gathered_masked_mean(a, jnp.asarray(pos),
                                        jnp.asarray(mask), interpret=True)

    with pltpu.force_tpu_interpret_mode():
        want_pallas = np.asarray(fused(hj))
        grad_pallas = np.asarray(jax.grad(
            lambda a: jnp.sum(fused(a) * wj))(hj))
    for jax_fn, port_fn in ((jax_fanout_mean, fanout_gather_mean),
                            (jax_segment_mean, segment_mean_coo),
                            (jax_fanout_mean, None)):
        want = np.asarray(jax_fn(hj, jblk))
        want_g = np.asarray(jax.grad(
            lambda a: jnp.sum(jax_fn(a, jblk) * wj))(hj))
        ht = torch.from_numpy(h).requires_grad_(True)
        got = (port_fn(ht, blk) if port_fn is not None else
               gathered_masked_mean(ht, blk.nbr_pos, blk.nbr_mask))
        np.testing.assert_array_equal(np.isnan(want).any(1), nan_rows)
        np.testing.assert_array_equal(np.isnan(got.detach().numpy()),
                                      np.isnan(want))
        np.testing.assert_allclose(got.detach().numpy()[~nan_rows],
                                   want[~nan_rows], rtol=1e-5, atol=1e-5)
        (got * torch.from_numpy(w)).sum().backward()
        assert np.isfinite(ht.grad.numpy()).all()
        np.testing.assert_allclose(ht.grad.numpy(), want_g, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(grad_pallas, want_g, rtol=1e-5,
                                   atol=1e-5)
    # the Pallas kernel's NaN tiles cover every NaN row
    assert np.isnan(want_pallas).any(1)[nan_rows].all()
    # K2's explicit backward (the CUDA kernel's plain twin) drops the slot
    # but keeps it in the mean's count, as the transpose of the fill take
    d = gathered_masked_mean_backward(torch.from_numpy(w), blk.nbr_pos,
                                      blk.nbr_mask, s)
    ht = torch.from_numpy(h).requires_grad_(True)
    out = gathered_masked_mean_plain(ht, blk.nbr_pos, blk.nbr_mask)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(d.numpy(), ht.grad.numpy(), rtol=1e-5,
                               atol=1e-6)


# -- the gathered feature mean -----------------------------------------------

def _feature_case(seed, p=96, f=10, s=400, d=128, past=(11, 50)):
    """Raw feature rows and a gathered block over them: zero-degree dst
    rows 4 and p - 1, and in the rows ``past`` one valid slot whose
    position lies past the s rows (after a cap overflow)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((s, d)).astype(np.float32)
    mask = rng.random((p, f)) > 0.3
    mask[[4, p - 1]] = False
    pos = rng.integers(0, s, (p, f)).astype(np.int32)
    for i, r in enumerate(past):
        mask[r, i % f] = True
        pos[r, i % f] = s + 3 * i
    return x, pos, mask


@pytest.mark.parametrize("f", [10, 40])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_gathered_feature_mean_plain_matches_fanout_gather_mean(x_dtype, f):
    """The plain version against the port's ``fanout_gather_mean`` in the
    input's dtype: equal at 1e-6 in float32 (two float32 sums), within 1
    bf16 ulp in bf16, where the old chain rounds the sum and then the
    quotient and the new mean rounds once. Zero rows where no slot is
    valid, NaN rows exactly where a valid slot lies past the rows, f > 32
    (more than one chunk of the kernel's slots)."""
    x, pos, mask = _feature_case(3, f=f)
    dt = TORCH_DT[x_dtype]
    xt = torch.from_numpy(x).to(dt)
    got = gathered_feature_mean(xt, torch.from_numpy(pos),
                                torch.from_numpy(mask), out_dtype=dt)
    want = fanout_gather_mean(xt, Block(
        nbr_pos=torch.from_numpy(pos), nbr_mask=torch.from_numpy(mask),
        num_src=torch.tensor(400, dtype=torch.int32),
        num_dst=torch.tensor(96, dtype=torch.int32)))
    assert got.dtype == want.dtype == dt and got.shape == (96, 128)
    nan_rows = np.zeros(96, bool)
    nan_rows[[11, 50]] = True
    np.testing.assert_array_equal(torch.isnan(got).any(1).numpy(), nan_rows)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert (got[4] == 0).all() and (got[-1] == 0).all()
    ok = torch.from_numpy(~nan_rows)
    a, b = got[ok].float(), want[ok].float()
    if x_dtype == "float32":
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    else:
        assert bool(((a - b).abs() <= BF16_ULP * b.abs() + 1e-30).all())


@pytest.mark.parametrize("f", [10, 40])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_gathered_feature_mean_plain_matches_jax(x_dtype, f):
    """Against legion_tpu's ``fanout_gather_mean`` (float32, on the same
    input values) at the plain aggregators' 1e-5; the bf16 result is the
    float32 one rounded once, and NaN fills the same rows."""
    import jax.numpy as jnp

    from legion_tpu.ops.segment import fanout_gather_mean as jax_fanout_mean
    from legion_tpu.sampling.block import Block as JaxBlock
    x, pos, mask = _feature_case(5, f=f)
    xt = torch.from_numpy(x).to(TORCH_DT[x_dtype])
    jblk = JaxBlock(nbr_pos=jnp.asarray(pos), nbr_mask=jnp.asarray(mask),
                    num_src=jnp.int32(x.shape[0]), num_dst=jnp.int32(96))
    want = np.asarray(jax_fanout_mean(jnp.asarray(xt.float().numpy()), jblk))
    pt, mt = torch.from_numpy(pos), torch.from_numpy(mask)
    got = gathered_feature_mean(xt, pt, mt, out_dtype=torch.float32)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    bf = gathered_feature_mean(xt, pt, mt)
    assert bf.dtype == torch.bfloat16
    torch.testing.assert_close(bf, got.to(torch.bfloat16), rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("case,want", [
    ("identity", "identity_masked_mean"),
    ("narrowing", "gathered_masked_mean"),
    ("widening", "gathered_feature_mean"),
    ("widening_with_gradient", "gathered_masked_mean")])
def test_sageconv_takes_the_feature_mean_on_raw_rows_it_widens(
        monkeypatch, case, want):
    """``SAGEConv`` calls ``gathered_feature_mean`` on a gathered block it
    does not narrow whose rows carry no gradient (raw features), and only
    there: an identity block takes K1, a narrowing layer K2, and a deeper
    model's activations, which carry gradient, K2 on the rows themselves.
    The output is the plain mean's, through fc_neigh, and so is the
    gradient of the rows."""
    from legion_tpu_torch.models import sage
    spies = {name: mock.Mock(wraps=getattr(sage, name)) for name in (
        "identity_masked_mean", "gathered_masked_mean",
        "gathered_feature_mean")}
    for name, spy in spies.items():
        monkeypatch.setattr(sage, name, spy)
    x, pos, mask = _feature_case(7, p=32, f=4, s=200, d=16, past=())
    off = None
    if case == "identity":
        off = 200 - 32 * 4
        pos = (off + np.arange(32 * 4).reshape(32, 4)).astype(np.int32)
    blk = Block(nbr_pos=torch.from_numpy(pos), nbr_mask=torch.from_numpy(mask),
                num_src=torch.tensor(200, dtype=torch.int32),
                num_dst=torch.tensor(32, dtype=torch.int32),
                identity_offset=off)
    conv = sage.SAGEConv(16, 8 if case == "narrowing" else 24)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    grad = case == "widening_with_gradient"
    xt = torch.from_numpy(x).requires_grad_(grad)
    out = conv(blk, xt)
    assert {k: s.call_count for k, s in spies.items()} == {
        k: int(k == want) for k in spies}
    assert out.shape == (32, 8 if case == "narrowing" else 24)
    if case.startswith("widening"):
        xp = torch.from_numpy(x).requires_grad_(grad)
        mean = gathered_feature_mean_plain(xp, blk.nbr_pos, blk.nbr_mask,
                                           torch.float32)
        want_out = conv.fc_self(xp[:32]) + conv.fc_neigh(mean)
        torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-5)
    if grad:
        w = torch.from_numpy(np.random.default_rng(8).standard_normal(
            (32, 24)).astype(np.float32))
        (out * w).sum().backward()
        (want_out * w).sum().backward()
        torch.testing.assert_close(xt.grad, xp.grad, rtol=1e-5, atol=1e-5)


# -- K3 -----------------------------------------------------------------------

@pytest.mark.parametrize("m,d", [(256, 100), (512, 128), (300, 47)])
def test_gather_rows_plain_matches_pallas(m, d):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from legion_tpu.ops.gather_pallas import gather_rows_pallas
    rng = np.random.default_rng(0)
    table = rng.standard_normal((1000, d)).astype(np.float32)
    ids = rng.integers(-1, 1000, size=m).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = gather_rows_pallas(jnp.asarray(table), jnp.asarray(ids))
    got = gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- K5 -----------------------------------------------------------------------

BF16_ULP = 2.0 ** -7        # spacing of bf16 values relative to the value


def _grouped_case(seed, p, f, d, float_mask):
    rng = np.random.default_rng(seed)
    x2 = rng.standard_normal((p * f, d)).astype(np.float32)
    mask = rng.random((p, f)) > 0.3
    mask[2] = False
    if float_mask:      # edge weights, zero where masked
        mask = (mask * rng.uniform(0.5, 2.0, (p, f))).astype(np.float32)
    w = rng.standard_normal((p, d)).astype(np.float32)
    return x2, mask, w


def _jax_grouped_sum(x2, mask, f, w, dtype="float32"):
    """legion_tpu's grouped_masked_sum and the gradient of sum(out * w),
    with the Pallas kernel forced on and interpreted as
    tests/test_pallas_ops.py runs it (it applies at 128-multiple widths;
    other shapes take the XLA formulation of the same numerics)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from legion_tpu.ops import spmm_pallas
    xj = jnp.asarray(x2, getattr(jnp, dtype))
    mj, wj = jnp.asarray(mask), jnp.asarray(w)

    def loss(a):
        out = spmm_pallas.grouped_masked_sum(a, mj, f)
        return jnp.sum(out.astype(jnp.float32) * wj)

    spmm_pallas.FORCE_PALLAS = True
    try:
        with pltpu.force_tpu_interpret_mode():
            out = spmm_pallas.grouped_masked_sum(xj, mj, f)
            grad = jax.grad(loss)(xj)
    finally:
        spmm_pallas.FORCE_PALLAS = False
    return (np.array(out.astype(jnp.float32)),
            np.array(grad.astype(jnp.float32)))


@pytest.mark.parametrize("float_mask", [False, True])
@pytest.mark.parametrize("p,f,d", [(64, 10, 128), (32, 3, 100)])
def test_grouped_masked_sum_plain_matches_pallas(p, f, d, float_mask):
    """Value and gradient in float32 at 1e-5, with a bool and a float
    mask; the mask gets no gradient."""
    x2, mask, w = _grouped_case(0, p, f, d, float_mask)
    want, want_g = _jax_grouped_sum(x2, mask, f, w)
    xt = torch.from_numpy(x2).requires_grad_(True)
    mt = torch.from_numpy(mask)
    if float_mask:
        mt.requires_grad_(True)
    out = grouped_masked_sum(xt, mt, f)
    assert out.dtype == torch.float32 and out.shape == (p, d)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    assert (out[2] == 0).all()
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=1e-5, atol=1e-5)
    assert mt.grad is None


@pytest.mark.parametrize("float_mask", [False, True])
@pytest.mark.parametrize("p,f,d", [(64, 10, 128), (32, 3, 100)])
def test_grouped_masked_sum_bf16(p, f, d, float_mask):
    """bf16 rows (and bf16-rounded weights): the port's result is the
    float32 sum rounded once, so within 2 bf16 ulps of it; the
    reference's, summed in bf16, within one ulp of the summed magnitudes
    per term. The gradient is repeat(w) * mask, one bf16 product."""
    x2, mask, w = _grouped_case(1, p, f, d, float_mask)
    xb = torch.from_numpy(x2).to(torch.bfloat16)
    mt = torch.from_numpy(mask)
    mb = mt.to(torch.bfloat16).float() if float_mask else mt.float()
    exact = (xb.float().reshape(p, f, d) * mb[..., None]).sum(1)
    mag = (xb.float().reshape(p, f, d).abs() * mb[..., None]).sum(1)
    out = grouped_masked_sum(xb.clone().requires_grad_(True), mt, f)
    assert out.dtype == torch.bfloat16
    assert bool(((out.float() - exact).abs()
                 <= 2 * BF16_ULP * exact.abs() + 1e-30).all())
    want, want_g = _jax_grouped_sum(x2, mask, f, w, "bfloat16")
    assert bool(((torch.from_numpy(want) - exact).abs()
                 <= f * BF16_ULP * mag + 1e-30).all())
    xg = xb.clone().requires_grad_(True)
    (grouped_masked_sum(xg, mt, f).float() * torch.from_numpy(w)).sum(
    ).backward()
    np.testing.assert_allclose(xg.grad.float().numpy(), want_g,
                               rtol=2 * BF16_ULP, atol=1e-6)


# -- plain aggregators --------------------------------------------------------

@pytest.mark.parametrize("identity", [False, True])
def test_segment_aggregators_match_jax(identity):
    """fanout_gather_{sum,mean} against legion_tpu's, and the scatter
    baseline segment_mean_coo against fanout_gather_mean, at 1e-5."""
    import jax.numpy as jnp

    from legion_tpu.ops.segment import fanout_gather_mean as jax_fanout_mean
    from legion_tpu.ops.segment import fanout_gather_sum as jax_fanout_sum
    from legion_tpu.sampling.block import Block as JaxBlock
    rng = np.random.default_rng(8)
    p, f, s, d = 40, 6, 400, 24
    h = rng.standard_normal((s, d)).astype(np.float32)
    mask = rng.random((p, f)) > 0.35
    mask[3] = False
    if identity:
        off = s - p * f
        pos = (off + np.arange(p * f).reshape(p, f)).astype(np.int32)
    else:
        off = None
        pos = np.where(mask, rng.integers(0, s, (p, f)), 0).astype(np.int32)
    jblk = JaxBlock(nbr_pos=jnp.asarray(pos), nbr_mask=jnp.asarray(mask),
                    num_src=jnp.int32(s), num_dst=jnp.int32(p),
                    identity_offset=off)
    blk = Block(nbr_pos=torch.from_numpy(pos), nbr_mask=torch.from_numpy(mask),
                num_src=torch.tensor(s, dtype=torch.int32),
                num_dst=torch.tensor(p, dtype=torch.int32),
                identity_offset=off)
    ht = torch.from_numpy(h)
    np.testing.assert_allclose(fanout_gather_sum(ht, blk).numpy(),
                               np.asarray(jax_fanout_sum(jnp.asarray(h),
                                                         jblk)),
                               rtol=1e-5, atol=1e-5)
    mean = fanout_gather_mean(ht, blk)
    np.testing.assert_allclose(mean.numpy(),
                               np.asarray(jax_fanout_mean(jnp.asarray(h),
                                                          jblk)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(segment_mean_coo(ht, blk).numpy(), mean.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert (mean[3] == 0).all()


# -- wrappers on the CPU ------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_without_launching():
    before = [fn.launches for fn in LAUNCH_COUNTED]
    x, mask, off = _identity_case(1)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    assert torch.equal(identity_masked_mean(xt, mt, off),
                       identity_masked_mean_plain(xt, mt, off))
    h, pos, m2, w = _gathered_case(2)
    args = (torch.from_numpy(h), torch.from_numpy(pos), torch.from_numpy(m2))
    assert torch.equal(gathered_masked_mean(*args),
                       gathered_masked_mean_plain(*args))
    assert torch.equal(
        gathered_masked_mean_backward(torch.from_numpy(w), *args[1:], 300),
        gathered_masked_mean_backward_plain(torch.from_numpy(w), *args[1:],
                                            300))
    ids = torch.tensor([3, -1, 0], dtype=torch.int32)
    assert torch.equal(gather_rows(xt, ids), gather_rows_plain(xt, ids))
    assert torch.equal(gathered_feature_mean(*args),
                       gathered_feature_mean_plain(*args))
    x2, gm, _ = _grouped_case(3, 16, 4, 24, True)
    assert torch.equal(
        grouped_masked_sum(torch.from_numpy(x2), torch.from_numpy(gm), 4),
        grouped_masked_sum_plain(torch.from_numpy(x2), torch.from_numpy(gm),
                                 4))
    assert [fn.launches for fn in LAUNCH_COUNTED] == before


def test_wrappers_reject_bad_arguments():
    x, mask, off = _identity_case(1)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    with pytest.raises(ValueError, match="norm"):
        identity_masked_mean(xt, mt, off, norm="max")
    with pytest.raises(ValueError, match="rows"):
        identity_masked_mean(xt, mt, x.shape[0])
    with pytest.raises(ValueError, match="dtype"):
        identity_masked_mean(xt.double(), mt, off)
    with pytest.raises(ValueError):
        identity_masked_mean(xt, mt.to(torch.uint8), off)
    h, pos, m2, _ = _gathered_case(2)
    with pytest.raises(ValueError, match="int32"):
        gathered_masked_mean(torch.from_numpy(h),
                             torch.from_numpy(pos).long(),
                             torch.from_numpy(m2))
    with pytest.raises(ValueError, match="int32"):
        gathered_feature_mean(torch.from_numpy(h),
                              torch.from_numpy(pos).long(),
                              torch.from_numpy(m2))
    with pytest.raises(ValueError, match="dtype"):
        gathered_feature_mean(torch.from_numpy(h).double(),
                              torch.from_numpy(pos), torch.from_numpy(m2))
    with pytest.raises(ValueError, match="int32"):
        gather_rows(xt, torch.tensor([0, 1]))
    x2 = torch.zeros(12, 8)
    with pytest.raises(ValueError, match="mask"):
        grouped_masked_sum(x2, torch.ones(4, 3, dtype=torch.bool), 4)
    with pytest.raises(ValueError, match="rows"):
        grouped_masked_sum(x2, torch.ones(5, 3, dtype=torch.bool), 3)
    with pytest.raises(ValueError, match="dtype"):
        grouped_masked_sum(x2.double(), torch.ones(4, 3, dtype=torch.bool), 3)
    with pytest.raises(ValueError, match="bool or float"):
        grouped_masked_sum(x2, torch.ones(4, 3, dtype=torch.int32), 3)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _bf16_close(got, want):
    """Within 1 bf16 ulp relative (8e-3) plus 1e-3 absolute: the kernel
    and the plain version sum in f32 in different orders, which can flip
    one bf16 rounding."""
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                               atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [128, 47])
def test_cuda_identity_masked_mean(cuda, d, x_dtype, out_dtype):
    x, mask, off = _identity_case(11, p=1000, f=10, d=d, off=77)
    xt = torch.from_numpy(x).to(cuda, TORCH_DT[x_dtype])
    mt = torch.from_numpy(mask).to(cuda)
    for norm in NORMS:
        n0 = identity_masked_mean.launches
        got = identity_masked_mean(xt, mt, off, norm, TORCH_DT[out_dtype])
        assert identity_masked_mean.launches == n0 + 1
        want = identity_masked_mean_plain(xt, mt, off, norm,
                                          TORCH_DT[out_dtype])
        _bf16_close(got, want)
        assert (got[7] == 0).all()
    with pytest.raises(ValueError, match="backward"):
        identity_masked_mean(xt.clone().requires_grad_(True), mt, off)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [47, 64])
def test_cuda_gathered_masked_mean_fwd_bwd(cuda, d, dtype):
    h, pos, mask, w = _gathered_case(12, p=1000, f=25, s=5000, d=d)
    dt = TORCH_DT[dtype]
    pt, mt = torch.from_numpy(pos).to(cuda), torch.from_numpy(mask).to(cuda)
    for norm in NORMS:
        ht = torch.from_numpy(h).to(cuda, dt).requires_grad_(True)
        n0 = (gathered_masked_mean.launches,
              gathered_masked_mean_backward.launches)
        out = gathered_masked_mean(ht, pt, mt, norm)
        (out.float() * torch.from_numpy(w).to(cuda)).sum().backward()
        assert (gathered_masked_mean.launches,
                gathered_masked_mean_backward.launches) == (n0[0] + 1,
                                                            n0[1] + 1)
        _bf16_close(out, gathered_masked_mean_plain(ht.detach(), pt, mt, norm))
        g = torch.from_numpy(w).to(cuda, dt)
        want = gathered_masked_mean_backward_plain(g, pt, mt, h.shape[0],
                                                   norm, torch.float32)
        got = gathered_masked_mean_backward(g, pt, mt, h.shape[0], norm,
                                            torch.float32)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        _bf16_close(ht.grad, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_gathered_masked_mean_fills_nan(cuda, dtype):
    """A valid slot past the rows: the kernel reads nothing there, gives
    NaN in exactly the plain version's rows, and its backward drops it."""
    h, pos, mask, w = _gathered_case(14, p=300, f=10, s=500, d=64)
    mask[[3, 77, 299], 2] = True
    pos[[3, 77, 299], 2] = [500, 10 ** 6, 2 ** 31 - 1]
    dt = TORCH_DT[dtype]
    ht = torch.from_numpy(h).to(cuda, dt)
    pt, mt = torch.from_numpy(pos).to(cuda), torch.from_numpy(mask).to(cuda)
    got = gathered_masked_mean(ht, pt, mt)
    want = gathered_masked_mean_plain(ht, pt, mt)
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert nan.any(1).nonzero().flatten().tolist() == [3, 77, 299]
    _bf16_close(got[~nan.any(1)], want[~nan.any(1)])
    g = torch.from_numpy(w).to(cuda)
    torch.testing.assert_close(
        gathered_masked_mean_backward(g, pt, mt, 500, "mean", torch.float32),
        gathered_masked_mean_backward_plain(g, pt, mt, 500, "mean",
                                            torch.float32),
        rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,f,start", [(128, 10, 0), (128, 40, 0),
                                       (47, 7, 1), (100, 3, 1)])
def test_cuda_gathered_feature_mean(cuda, d, f, start, x_dtype, out_dtype):
    """The kernel against its plain version on the card: one launch; a
    float32 result within 1e-5 of the mean of the magnitudes (another
    order of the same f32 sum), a bf16 one within one flipped rounding;
    zero rows where no slot is valid, NaN in exactly the plain version's
    rows where a valid slot lies past the rows, f > 16 (several chunks of
    slots). ``start`` 1 hands in rows that begin one row into their
    buffer: for d = 47 and 100 no 16-byte boundary, the single-element
    loads."""
    x, pos, mask = _feature_case(16, p=3000, f=f, s=20000, d=d,
                                 past=(11, 50, 2999))
    pos[[11, 50, 2999], [0, 1, 2]] = [20000, 10 ** 6, 2 ** 31 - 1]
    full = torch.from_numpy(np.concatenate([x[:1], x])).to(
        cuda, TORCH_DT[x_dtype])
    xt = full[1:] if start else full[:-1]
    pt, mt = torch.from_numpy(pos).to(cuda), torch.from_numpy(mask).to(cuda)
    odt = TORCH_DT[out_dtype]
    n0 = gathered_feature_mean.launches
    got = gathered_feature_mean(xt, pt, mt, odt)
    assert gathered_feature_mean.launches == n0 + 1
    want = gathered_feature_mean_plain(xt, pt, mt, odt)
    torch.cuda.synchronize()
    assert got.dtype == odt and got.shape == (3000, d)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert nan.any(1).nonzero().flatten().tolist() == [11, 50, 2999]
    assert (got[4] == 0).all()
    ok = ~nan.any(1)
    if odt == torch.float32:
        mag = gathered_feature_mean_plain(xt.abs(), pt, mt, torch.float32)
        assert bool(((got - want)[ok].abs() <= 1e-5 * mag[ok] + 1e-30).all())
    else:
        _bf16_close(got[ok], want[ok])
    with pytest.raises(ValueError, match="backward"):
        gathered_feature_mean(xt.clone().requires_grad_(True), pt, mt)
    with pytest.raises(ValueError, match="device"):
        gathered_feature_mean(xt, pt, mt.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("float32", 128), ("float32", 47),
                                     ("bfloat16", 47), ("bfloat16", 100)])
def test_cuda_gather_rows(cuda, dtype, d):
    rng = np.random.default_rng(13)
    table = torch.from_numpy(rng.standard_normal((5000, d)).astype(
        np.float32)).to(cuda, TORCH_DT[dtype])
    ids = torch.from_numpy(rng.integers(-1, 5000, 3001).astype(
        np.int32)).to(cuda)
    # a strided view is refused, not silently copied
    with pytest.raises(ValueError, match="contiguous"):
        gather_rows(table[:, :d // 2], ids)
    with pytest.raises(ValueError, match="device"):
        gather_rows(table, ids.cpu())
    n0 = gather_rows.launches
    if d * table.element_size() % 4:
        # the kernel moves 16- or 4-byte words
        with pytest.raises(ValueError, match="4 bytes"):
            gather_rows(table, ids)
        assert gather_rows.launches == n0
        return
    got = gather_rows(table, ids)
    assert gather_rows.launches == n0 + 1
    assert torch.equal(got, gather_rows_plain(table, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("float_mask", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,f,d", [(1000, 10, 128), (333, 7, 47),
                                   (64, 3, 100)])
def test_cuda_grouped_masked_sum(cuda, p, f, d, dtype, float_mask):
    """The kernel against its plain version, value and gradient, from a
    slice that starts at an odd row (for d = 47 in bf16 not even 4-byte
    aligned). f32 within 1e-5 of the summed magnitudes (another order of
    the same f32 sum); bf16 within one flipped rounding."""
    x2, mask, w = _grouped_case(15, p + 1, f, d, float_mask)
    dt = TORCH_DT[dtype]
    x = torch.from_numpy(x2).to(cuda, dt)[f:]         # rows f .. (p+1)*f
    mt = torch.from_numpy(mask).to(cuda)[1:]
    assert x.is_contiguous() and x.shape[0] == p * f
    n0 = grouped_masked_sum.launches
    xg = x.clone().requires_grad_(True)
    out = grouped_masked_sum(x, mt, f)
    outg = grouped_masked_sum(xg[:], mt, f)
    assert grouped_masked_sum.launches == n0 + 2
    assert torch.equal(out, outg)
    want = grouped_masked_sum_plain(x, mt, f)
    if dtype == "float32":
        mag = grouped_masked_sum_plain(x.abs(), mt.abs() if float_mask
                                       else mt, f)
        assert bool(((out - want).abs() <= 1e-5 * mag + 1e-30).all())
    else:
        _bf16_close(out, want)
    wt = torch.from_numpy(w).to(cuda)[1:]
    (outg.float() * wt).sum().backward()
    xp = x.clone().requires_grad_(True)
    (grouped_masked_sum_plain(xp, mt, f).float() * wt).sum().backward()
    torch.testing.assert_close(xg.grad.float(), xp.grad.float(), rtol=8e-3,
                               atol=1e-6)
    with pytest.raises(ValueError, match="device"):
        grouped_masked_sum(x, mt.cpu(), f)
