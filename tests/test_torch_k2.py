"""K2 (``gathered_masked_mean`` and its backward) at the shapes its CUDA
kernels branch on: widths 1, 46, 47 and 172 (a lone column, even and odd
rows that take two-element words, rows that take four-element words),
fanouts 1, 25 and 33 (one chunk of 32 slots, and a second one), a row
count that is a multiple of nothing, float32 and bf16, all three norms, a
dst row with no valid slot and a position past the src rows.

On the CPU the plain versions are held against legion_tpu's
``gathered_masked_mean`` with its Pallas kernel interpreted, as
tests/test_pallas_ops.py runs it, and against ``jax.grad`` of it. The
inputs are rounded to bf16 first, so the kernel's own rounding of its rows
to bf16 (identity_agg_pallas.py:93-95) is exact and what is compared is
the reduce. Tolerances: 2e-2 absolute and relative against the Pallas
tile, as tests/test_torch_ops.py; 1e-5 / 1e-6 between the explicit
backward and autograd (two float32 formulations of one sum); a bf16
gradient within one bf16 ulp of the summed magnitudes per term, since the
reference adds its bf16 terms one by one and the port rounds an f32 sum
once.

The ``cuda``-marked tests hold the kernels to the plain versions on the
card over the same grid, from unaligned base pointers, row-strided
inputs and staging buffers of every stride class; they skip where there
is no card. JAX is imported inside the parity tests only, so that
``pytest --noconftest -m cuda tests/test_torch_k2.py`` runs where JAX is
absent."""

import numpy as np
import pytest
import torch

from legion_tpu_torch.ops.identity_agg import (
    gathered_masked_mean, gathered_masked_mean_backward,
    gathered_masked_mean_backward_plain, gathered_masked_mean_plain,
    narrow_rows, scatter_masked_rows, staging_width)

torch.set_num_threads(2)

NORMS = ("mean", "sqrt", "sum")
WIDTHS = (1, 46, 47, 172)
FANOUTS = (1, 25, 33)
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16_ULP = 2.0 ** -7        # spacing of bf16 values relative to the value
EMPTY_ROW, PAST_ROW = 5, 11


def _bf16_round(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _case(seed, p, f, s, d):
    """h (s, d), pos and mask (p, f), w (p, d): values exact in bf16; dst
    row EMPTY_ROW has no valid slot; PAST_ROW's first slot is valid (its
    position is moved past the rows by ``_past``)."""
    rng = np.random.default_rng(seed)
    h = _bf16_round(rng.standard_normal((s, d)).astype(np.float32))
    w = _bf16_round(rng.standard_normal((p, d)).astype(np.float32))
    mask = rng.random((p, f)) > 0.4
    mask[EMPTY_ROW] = False
    mask[PAST_ROW, 0] = True
    pos = np.where(mask, rng.integers(0, s, (p, f)), 0).astype(np.int32)
    return h, pos, mask, w


def _past(pos, s):
    out = pos.copy()
    out[PAST_ROW, 0] = s + 3
    return out


def _jax_value_and_grad(h, pos, mask, w, norm, dtype):
    """legion_tpu's gathered_masked_mean (Pallas kernel interpreted) on
    the case padded with masked dst rows to the kernel's 64-row tile, and
    the gradient of sum(out * w) in h."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from legion_tpu.ops.identity_agg_pallas import (
        gathered_masked_mean as jax_gathered_masked_mean)
    p, f = pos.shape
    pp = -(-p // 64) * 64
    pos_p = np.zeros((pp, f), np.int32)
    mask_p = np.zeros((pp, f), bool)
    w_p = np.zeros((pp, h.shape[1]), np.float32)
    pos_p[:p], mask_p[:p], w_p[:p] = pos, mask, w
    hj = jnp.asarray(h, getattr(jnp, dtype))
    wj = jnp.asarray(w_p)

    def fused(a):
        return jax_gathered_masked_mean(a, jnp.asarray(pos_p),
                                        jnp.asarray(mask_p), norm=norm,
                                        interpret=True)

    with pltpu.force_tpu_interpret_mode():
        out = fused(hj)
        grad = jax.grad(lambda a: jnp.sum(
            fused(a).astype(jnp.float32) * wj))(hj)
    return (np.array(out.astype(jnp.float32))[:p],
            np.array(grad.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("f", FANOUTS)
@pytest.mark.parametrize("d", WIDTHS)
def test_k2_plain_matches_pallas_on_the_kernel_grid(d, f, norm, dtype):
    p, s = 37, 91
    h, pos, mask, w = _case(100 * d + f, p, f, s, d)
    dt = TORCH_DT[dtype]
    pt, mt, wt = (torch.from_numpy(pos), torch.from_numpy(mask),
                  torch.from_numpy(w))
    want, want_g = _jax_value_and_grad(h, pos, mask, w, norm, dtype)

    ht = torch.from_numpy(h).to(dt).requires_grad_(True)
    out = gathered_masked_mean(ht, pt, mt, norm=norm)
    assert out.dtype == dt and out.shape == (p, d)
    np.testing.assert_allclose(out.detach().float().numpy(), want, rtol=2e-2,
                               atol=2e-2)
    assert (out[EMPTY_ROW] == 0).all()
    (out.float() * wt).sum().backward()
    g = wt.to(dt)                   # what autograd hands the backward
    explicit = gathered_masked_mean_backward(g, pt, mt, s, norm)
    assert explicit.dtype == dt and explicit.shape == (s, d)
    if dtype == "float32":
        np.testing.assert_allclose(ht.grad.numpy(), want_g, rtol=2e-2,
                                   atol=2e-2)
        np.testing.assert_allclose(explicit.numpy(), ht.grad.numpy(),
                                   rtol=1e-5, atol=1e-6)
    else:
        # the reference and autograd add bf16 terms one by one; the
        # explicit backward rounds an f32 sum once
        mag = gathered_masked_mean_backward_plain(
            wt.abs(), pt, mt, s, norm, torch.float32)
        terms = int(np.bincount(pos[mask], minlength=s).max())
        tol = (terms + 2) * BF16_ULP * mag + 1e-30
        assert bool(((explicit.float() - torch.from_numpy(want_g)).abs()
                     <= tol).all())
        assert bool(((explicit.float() - ht.grad.float()).abs()
                     <= tol).all())

    # one valid slot moved past the src rows: that dst row is NaN forward,
    # every other row unchanged; backward the slot is dropped but still
    # counts in its row's denominator, as in the reference's gradient
    pt2 = torch.from_numpy(_past(pos, s))
    ht2 = torch.from_numpy(h).to(dt).requires_grad_(True)
    out2 = gathered_masked_mean(ht2, pt2, mt, norm=norm)
    nan_rows = torch.isnan(out2).all(1)
    assert nan_rows.nonzero().flatten().tolist() == [PAST_ROW]
    assert torch.equal(out2[~nan_rows], out[~nan_rows])
    _, want_g2 = _jax_value_and_grad(h, _past(pos, s), mask, w, norm, dtype)
    explicit2 = gathered_masked_mean_backward(g, pt2, mt, s, norm,
                                              torch.float32)
    assert bool(torch.isfinite(explicit2).all())
    if dtype == "float32":
        np.testing.assert_allclose(explicit2.numpy(), want_g2, rtol=1e-5,
                                   atol=1e-5)
    else:
        assert bool(((explicit2 - torch.from_numpy(want_g2)).abs()
                     <= tol).all())
    (out2.float() * wt).sum().backward()
    if dtype == "float32":
        np.testing.assert_allclose(ht2.grad.numpy(), explicit2.numpy(),
                                   rtol=1e-5, atol=1e-6)
    else:
        assert bool(((ht2.grad.float() - explicit2).abs() <= tol).all())


@pytest.mark.parametrize("d,ld", [(0, 0), (1, 4), (46, 48), (47, 48),
                                  (48, 48), (172, 172), (173, 176)])
def test_staging_width_is_the_next_multiple_of_four(d, ld):
    """Padded rows for a result that is cast afterwards; a float32 result
    is scattered into its own rows."""
    assert staging_width(d, torch.bfloat16) == ld
    assert staging_width(d, torch.float32) == d


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _close(got, want, dtype):
    """float32: two orders of one f32 sum. bf16: within 1 bf16 ulp
    relative (8e-3) plus 1e-3 absolute, as the two f32 sums can flip one
    bf16 rounding."""
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                                   atol=1e-3)


def _check_forward(ht, pt, mt, norm, dtype):
    n0 = gathered_masked_mean.launches
    got = gathered_masked_mean(ht, pt, mt, norm)
    assert gathered_masked_mean.launches == n0 + 1
    want = gathered_masked_mean_plain(ht, pt, mt, norm)
    torch.cuda.synchronize()
    assert got.is_contiguous() and got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    _close(got[~nan.any(1)], want[~nan.any(1)], dtype)
    return got


def _check_backward(g, pt, mt, s, norm):
    n0 = gathered_masked_mean_backward.launches
    got = gathered_masked_mean_backward(g, pt, mt, s, norm, torch.float32)
    assert gathered_masked_mean_backward.launches == n0 + 1
    want = gathered_masked_mean_backward_plain(g, pt, mt, s, norm,
                                               torch.float32)
    mag = gathered_masked_mean_backward_plain(g.abs(), pt, mt, s, norm,
                                              torch.float32)
    assert got.shape == want.shape and got.is_contiguous()
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= 1e-5 * mag + 1e-30).all())
    # in the caller's type: the f32 sum rounded once on both sides
    low = gathered_masked_mean_backward(g, pt, mt, s, norm)
    assert low.dtype == g.dtype and low.is_contiguous()
    assert bool(((low.float() - want).abs() <= 8e-3 * mag + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f", FANOUTS)
@pytest.mark.parametrize("d", WIDTHS)
def test_cuda_k2_kernel_grid(cuda, d, f, dtype):
    """Kernel against plain over the grid, with an empty row and a NaN
    row, and one forward and one backward launch per autograd call."""
    p, s = 1003, 777
    h, pos, mask, w = _case(7 * d + f, p, f, s, d)
    dt = TORCH_DT[dtype]
    mt = torch.from_numpy(mask).to(cuda)
    g = torch.from_numpy(w).to(cuda, dt)
    for pos_np in (pos, _past(pos, s)):
        pt = torch.from_numpy(pos_np).to(cuda)
        for norm in NORMS:
            ht = torch.from_numpy(h).to(cuda, dt)
            out = _check_forward(ht, pt, mt, norm, dtype)
            assert (out[EMPTY_ROW] == 0).all()
            _check_backward(g, pt, mt, s, norm)
            hg = ht.clone().requires_grad_(True)
            n0 = (gathered_masked_mean.launches,
                  gathered_masked_mean_backward.launches)
            (gathered_masked_mean(hg, pt, mt, norm).float()
             * g.float()).sum().backward()
            assert (gathered_masked_mean.launches,
                    gathered_masked_mean_backward.launches) == (n0[0] + 1,
                                                                n0[1] + 1)
            assert hg.grad.shape == (s, d) and hg.grad.dtype == dt


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [47, 65, 173])
def test_cuda_k2_unaligned_base_pointers(cuda, d, dtype):
    """h_t, the upstream gradient and (through the allocator) neither
    output start at an odd row of an odd-width tensor: a 2-byte (bf16) or
    4-byte (f32) aligned base, where every second row starts mid-word."""
    p, f, s = 501, 25, 400
    h, pos, mask, w = _case(d, p + 1, f, s + 1, d)
    dt = TORCH_DT[dtype]
    ht = torch.from_numpy(h).to(cuda, dt)[1:]
    g = torch.from_numpy(w).to(cuda, dt)[1:]
    assert ht.is_contiguous() and ht.data_ptr() % (2 * ht.element_size())
    pt = torch.from_numpy(pos[1:] % s).to(cuda)
    mt = torch.from_numpy(mask[1:]).to(cuda)
    for norm in NORMS:
        _check_forward(ht, pt, mt, norm, dtype)
        _check_backward(g, pt, mt, s, norm)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,ld", [(47, 48), (47, 49), (172, 176), (46, 47)])
def test_cuda_k2_row_strided_input(cuda, d, ld, dtype):
    """h_t as a column slice of a wider buffer gives the contiguous
    input's result bit for bit, and its gradient reaches the buffer; a
    tensor with a column stride is refused, not copied."""
    p, f, s = 333, 25, 500
    h, pos, mask, w = _case(d + ld, p, f, s, d)
    dt = TORCH_DT[dtype]
    pt, mt = torch.from_numpy(pos).to(cuda), torch.from_numpy(mask).to(cuda)
    ht = torch.from_numpy(h).to(cuda, dt)
    buf = torch.full((s, ld), float("nan"), dtype=dt, device=cuda)
    buf[:, :d] = ht
    view = buf[:, :d]
    assert not view.is_contiguous()
    for norm in NORMS:
        assert torch.equal(_check_forward(view, pt, mt, norm, dtype),
                           gathered_masked_mean(ht, pt, mt, norm))
    bg = torch.zeros((s, ld), dtype=dt, device=cuda).requires_grad_(True)
    wt = torch.from_numpy(w).to(cuda)
    (gathered_masked_mean(bg[:, :d], pt, mt).float() * wt).sum().backward()
    want = gathered_masked_mean_backward_plain(wt.to(dt), pt, mt, s)
    mag = gathered_masked_mean_backward_plain(wt.abs(), pt, mt, s, "mean",
                                              torch.float32)
    assert bool(((bg.grad[:, :d].float() - want.float()).abs()
                 <= 8e-3 * mag + 1e-30).all())
    assert (bg.grad[:, d:] == 0).all()
    n0 = gathered_masked_mean.launches
    with pytest.raises(ValueError, match="stride"):
        gathered_masked_mean(torch.from_numpy(h.T.copy()).to(cuda, dt).T,
                             pt, mt)
    assert gathered_masked_mean.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ld,shift", [(48, 0), (50, 0), (47, 0), (48, 1),
                                      (48, 2), (172, 0), (173, 0)])
def test_cuda_k2_scatter_and_narrow_at_every_stride(cuda, ld, shift, g_dtype):
    """The scatter kernel into staging buffers that take 16-byte atomics
    (stride a multiple of 4 floats, aligned base), 8-byte ones (stride 50,
    or a base shifted by 2 floats) and scalar ones (stride 47, or a base
    shifted by 1 float): the first D columns hold the plain version's
    float32 sums, the padding stays zero, and ``narrow_rows`` is the
    buffer's first D columns cast once."""
    d = 172 if ld >= 172 else 47 if ld >= 47 else ld
    p, f, s = 700, 25, 300
    _, pos, mask, w = _case(ld + shift, p, f, s, d)
    pt, mt = torch.from_numpy(pos).to(cuda), torch.from_numpy(mask).to(cuda)
    g = torch.from_numpy(w).to(cuda, TORCH_DT[g_dtype])
    flat = torch.zeros(s * ld + 4, dtype=torch.float32, device=cuda)
    staging = flat[shift: shift + s * ld].view(s, ld)
    for norm in NORMS:
        flat.zero_()
        n0 = gathered_masked_mean_backward.launches
        scatter_masked_rows(g, pt, mt, staging, norm)
        assert gathered_masked_mean_backward.launches == n0 + 1
        want = gathered_masked_mean_backward_plain(g, pt, mt, s, norm,
                                                   torch.float32)
        mag = gathered_masked_mean_backward_plain(g.abs(), pt, mt, s, norm,
                                                  torch.float32)
        assert bool(((staging[:, :d] - want).abs() <= 1e-5 * mag + 1e-30
                     ).all())
        assert (staging[:, d:] == 0).all()
        assert (flat[:shift] == 0).all() and (flat[shift + s * ld:] == 0).all()
        for out_dtype in TORCH_DT.values():
            got = narrow_rows(staging, d, out_dtype)
            assert got.is_contiguous() and got.shape == (s, d)
            assert torch.equal(got, staging[:, :d].to(out_dtype))
    assert narrow_rows(staging, ld, torch.float32) is staging
