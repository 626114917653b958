"""K2's arithmetic on the CPU: a plain PyTorch model of what
``csrc/ntxent.cu`` computes, held against the JAX package and the f32 formula.

The model takes the kernels' steps: Ẑ split once into tf32 hi/lo parts (low
13 mantissa bits masked, rounded to nearest with ties away from zero, as the
split kernel does), every product of Ẑ as 3×TF32 (hi·hi + hi·lo + lo·hi in
f32: products of tf32 parts are exact in f32), the column axis cut into the
chunks of ``ops.ntxent.plan`` with each chunk's (max, denominator, positive)
merged in chunk order, and the one-pass backward H = G[r, c] + G[c, r] from
one dot product per pair, split into hi/lo for the product with Ẑ, the
chunks' partials summed in chunk order. Within a chunk the model sums in
its own order, which differs from the kernel's by rounding only.

Held against ``nt_xent_pallas`` in interpret mode at the shapes and
tolerances of ``tests/test_ntxent_pallas.py`` (24x16 with 17 valid rows and
32x8 all valid: loss rtol 1e-4; 16x8 with 11 valid: gradients rtol 2e-3,
atol 1e-5), and against the port's f32 plain versions at R = 832 and 4104,
d = 128, at the limits ``chip_smoke.py`` holds the kernels to on the card
(loss, per-row loss and denominator 1e-5 relative; dẐ and each of its two
terms 1e-4 of max |ref|).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pretraining_tpu.ops import ntxent_pallas
from gnn_pretraining_tpu.ops.sddmm import nt_xent_loss
from gnn_pretraining_tpu_torch.ops import ntxent

torch.set_num_threads(1)

H100_SMS = 132
MASKED = -1e30
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4          # chip_smoke.py's NTXENT_*_TOL


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32: + half an ulp of tf32 on the bits, low 13 bits 0;
    a NaN or an infinity as it is (the kernels' tf32_round)."""
    b = x.contiguous().view(torch.int32)
    return torch.where(torch.isfinite(x), ((b + 0x1000) & ~0x1FFF).view(torch.float32), x)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a, b) -> torch.Tensor:
    """a @ b in 3×TF32 from the (hi, lo) pairs a and b, small terms first."""
    (ah, al), (bh, bl) = a, b
    return (al @ bh + ah @ bl) + ah @ bh


def chunk_columns(rows: int, sms: int):
    tiles, chunks, per = ntxent.plan(rows, sms)
    step = per * ntxent.TILE
    return [slice(c * step, min((c + 1) * step, rows)) for c in range(chunks)]


def positives(rows: int) -> torch.Tensor:
    return ntxent._positives(rows, "cpu")


def model_fwd(zhat, vv, temp, sms=H100_SMS):
    rows = zhat.shape[0]
    tau = temp[0]
    hi, lo = split(zhat)
    r = torch.arange(rows)
    pos_col = positives(rows)
    parts = []
    for cols in chunk_columns(rows, sms):
        c = r[cols]
        dot = mm3((hi, lo), (hi[cols].t(), lo[cols].t()))
        s = torch.where((r[:, None] == c[None, :]) | ~(vv[cols] > 0)[None, :],
                        torch.tensor(MASKED), dot / tau)
        mx = torch.clamp(s.max(dim=1).values, min=MASKED)
        den = torch.exp(s - mx[:, None]).sum(dim=1)
        pos = torch.where(c[None, :] == pos_col[:, None], s, 0.0).sum(dim=1)
        parts.append((mx, den, pos))
    m = parts[0][0]
    for mx, _, _ in parts[1:]:
        m = torch.maximum(m, mx)
    den, pos = torch.zeros(rows), torch.zeros(rows)
    for mx, d, p in parts:                       # chunk order
        den = den + d * torch.exp(mx - m)
        pos = pos + p
    return torch.log(den) + m - pos, m, den


def model_bwd(zhat, vv, temp, mx, den, g, sms=H100_SMS, terms=False):
    """dẐ, or with ``terms`` its row and column terms (G·Ẑ, Gᵀ·Ẑ) apart."""
    rows = zhat.shape[0]
    tau = temp[0]
    hi, lo = split(zhat)
    a, b = g / (tau * den), g / tau              # the split kernel's coefficients
    r = torch.arange(rows)
    pos_col = positives(rows)
    parts = []
    for cols in chunk_columns(rows, sms):
        c = r[cols]
        dot = mm3((hi, lo), (hi[cols].t(), lo[cols].t()))
        diag = r[:, None] == c[None, :]
        s_rc = torch.where(diag | ~(vv[cols] > 0)[None, :], torch.tensor(MASKED), dot / tau)
        s_cr = torch.where(diag | ~(vv > 0)[:, None], torch.tensor(MASKED), dot / tau)
        g_rc = (torch.exp(s_rc - mx[:, None]) * a[:, None]
                - torch.where(c[None, :] == pos_col[:, None], b[:, None], 0.0))
        g_cr = (torch.exp(s_cr - mx[cols][None, :]) * a[cols][None, :]
                - torch.where(r[:, None] == pos_col[cols][None, :], b[cols][None, :], 0.0))
        z_c = (hi[cols], lo[cols])
        blocks = (g_rc, g_cr) if terms else (g_rc + g_cr,)
        parts.append([mm3(split(h), z_c) for h in blocks])
    out = parts[0]
    for p in parts[1:]:                          # chunk order
        out = [o + q for o, q in zip(out, p)]
    return out if terms else out[0]


def inputs(seed: int, rows: int, d: int = 128, share: float = 0.7, tau: float = 0.37):
    """Ẑ, validity and τ as chip_smoke.py's ntxent_inputs makes them."""
    rng = np.random.default_rng(seed)
    n = rows // 2
    z1, z2 = (torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)) for _ in range(2))
    valid = torch.from_numpy((rng.random(n) < share).astype(np.float32))
    zhat, vv, _ = ntxent._prep(z1, z2, valid)
    return zhat, vv, torch.tensor([tau])


# ---------------------------------------------------------------------------
# The products


def test_tf32_split_keeps_22_bits():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    hi, lo = split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()
    # Ties go away from zero, as cvt.rna rounds: 1 + 2^-11 lies halfway.
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11)], dtype=torch.float32)
    assert tf32(tie).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10)]


def test_three_tf32_products_hold_f32():
    zhat, _, _ = inputs(1, 400)
    dot = mm3(split(zhat), tuple(p.t() for p in split(zhat)))
    exact = zhat.double() @ zhat.double().t()
    f32_err = float(((zhat @ zhat.t()).double() - exact).abs().max())
    one_pass = tf32(zhat).double() @ tf32(zhat).double().t()
    assert float((dot.double() - exact).abs().max()) < 2 * f32_err
    assert float((one_pass - exact).abs().max()) > 100 * f32_err    # one pass would not


@pytest.mark.parametrize("sms", [1, 4, 132])
def test_chunk_partials_merge_to_the_whole_row(sms):
    zhat, vv, temp = inputs(2, 832)
    whole = model_fwd(zhat, vv, temp, sms=10 ** 6)       # as many chunks as tiles
    got = model_fwd(zhat, vv, temp, sms=sms)
    keep = vv > 0
    for a, b in zip(got, whole):
        torch.testing.assert_close(a[keep], b[keep], rtol=1e-6, atol=0)
    dz = model_bwd(zhat, vv, temp, whole[1], whole[2], 0.8 * vv, sms=sms)
    ref = model_bwd(zhat, vv, temp, whole[1], whole[2], 0.8 * vv, sms=10 ** 6)
    assert float((dz - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


# ---------------------------------------------------------------------------
# Against the JAX package's Pallas kernels (interpret mode)


def jax_case(seed, n, d, n_valid):
    rng = np.random.default_rng(seed)
    z1 = rng.normal(size=(n, d)).astype(np.float32)
    z2 = rng.normal(size=(n, d)).astype(np.float32)
    return z1, z2, (np.arange(n) < n_valid)


@functools.lru_cache(maxsize=None)
def pallas_loss(shape, temp):
    z1, z2, valid = (jnp.array(a) for a in jax_case(*shape))
    return float(ntxent_pallas.nt_xent_pallas(z1, z2, np.float32(temp), valid)[0])


@pytest.fixture
def kernel_model(monkeypatch):
    """The K2 Function with the model in place of its plain versions."""
    monkeypatch.setattr(ntxent, "ntxent_fwd_reference", model_fwd)
    monkeypatch.setattr(ntxent, "ntxent_bwd_reference", model_bwd)
    return ntxent.nt_xent


@pytest.mark.parametrize("shape", [(0, 24, 16, 17), (1, 32, 8, 32)],
                         ids=["24x16-17valid", "32x8-allvalid"])
def test_model_loss_matches_pallas(kernel_model, shape):
    z1, z2, valid = jax_case(*shape)
    got, rows = kernel_model(torch.from_numpy(z1), torch.from_numpy(z2), torch.tensor([0.43]),
                             torch.from_numpy(valid.astype(np.float32)))
    assert float(rows) == 2 * valid.sum()
    np.testing.assert_allclose(float(got), pallas_loss(shape, 0.43), rtol=1e-4)


def test_model_gradients_match_pallas(kernel_model):
    shape, temp = (2, 16, 8, 11), 0.37
    z1, z2, valid = jax_case(*shape)

    def mean_loss(a, b):
        s, n = ntxent_pallas.nt_xent_pallas(a, b, np.float32(temp), jnp.array(valid))
        return s / jnp.maximum(n, 1.0)

    want = jax.grad(mean_loss, argnums=(0, 1))(jnp.array(z1), jnp.array(z2))
    a, b = torch.from_numpy(z1).requires_grad_(), torch.from_numpy(z2).requires_grad_()
    s, n = kernel_model(a, b, torch.tensor([temp]), torch.from_numpy(valid.astype(np.float32)))
    (s / torch.clamp(n, min=1.0)).backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want[0]), rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(want[1]), rtol=2e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# Against the f32 formula at the card's limits


@pytest.mark.parametrize("rows", [832, 4104])
def test_model_holds_the_chip_limits(rows):
    zhat, vv, temp = inputs(3, rows)
    g = 0.8 * vv
    keep = vv > 0
    loss, mx, den = model_fwd(zhat, vv, temp)
    ref_loss, ref_mx, ref_den = ntxent.ntxent_fwd_reference(zhat, vv, temp)
    total, ref_total = float((loss * vv).sum()), float((ref_loss * vv).sum())
    assert abs(total - ref_total) <= LOSS_TOL * abs(ref_total)
    row_err = float((loss - ref_loss)[keep].abs().max())
    assert row_err <= LOSS_TOL * float(ref_loss[keep].abs().max())
    assert float(((den - ref_den).abs() / ref_den)[keep].max()) <= LOSS_TOL
    assert torch.equal(mx[keep] >= -1e29, ref_mx[keep] >= -1e29)

    rows_term, cols_term = model_bwd(zhat, vv, temp, ref_mx, ref_den, g, terms=True)
    dz = model_bwd(zhat, vv, temp, ref_mx, ref_den, g)
    ref_rows = ntxent.ntxent_bwd_rows_reference(zhat, vv, temp, ref_mx, ref_den, g)
    ref_cols = ntxent.ntxent_bwd_cols_reference(zhat, vv, temp, ref_mx, ref_den, g)
    for got, ref in ((rows_term, ref_rows), (cols_term, ref_cols), (dz, ref_rows + ref_cols)):
        assert torch.isfinite(got).all()
        assert float((got - ref).abs().max()) <= GRAD_TOL * float(ref.abs().max())


# ---------------------------------------------------------------------------
# NaN where the plain version puts it

CARD_NAN = torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(torch.float32)  # the card's NaN


def nan_masks(*arrays):
    return [np.isnan(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("row", [3, 13], ids=["valid_row", "invalid_row"])
def test_nan_rows_where_jax_and_the_plain_version_put_them(row):
    """One NaN row of z1 (valid: every valid row's loss turns NaN; invalid:
    its columns are masked, so only its own row does). The port's plain
    versions give NaN in the rows, and dẐ entries, where the JAX package's
    Pallas kernels in interpret mode do (and its plain ``nt_xent_loss`` on
    the valid rows' sum), and so does the kernel model on Ẑ holding the
    card's NaN (0x7fffffff, which the split once rounded to -0)."""
    temp = 0.37
    z1, z2, valid = jax_case(4, 16, 8, 12)
    z1[row] = np.nan
    jz, jvv, _ = ntxent_pallas._prep(jnp.array(z1), jnp.array(z2), jnp.array(valid))
    j_fwd = ntxent_pallas._fwd_call(jz, jvv, np.float32(temp))
    t = torch.tensor([temp])
    zhat, vv, _ = ntxent._prep(torch.from_numpy(z1), torch.from_numpy(z2),
                               torch.from_numpy(valid.astype(np.float32)))
    fwd = ntxent.ntxent_fwd_reference(zhat, vv, t)
    card = torch.where(torch.isnan(zhat), CARD_NAN, zhat)
    model = model_fwd(card, vv, t)
    want = nan_masks(*j_fwd)
    assert [m.tolist() for m in nan_masks(*fwd)] == [m.tolist() for m in want]
    assert [m.tolist() for m in nan_masks(*model)] == [m.tolist() for m in want]
    on = np.concatenate([valid, valid])
    assert want[0][on].all() if row < 12 else not want[0][on].any()
    assert want[0][row]

    g = 0.8 * vv
    j_dz = ntxent_pallas._bwd_call(jz, jvv, np.float32(temp), j_fwd[1], j_fwd[2],
                                   jnp.array(g.numpy()))
    dz = ntxent.ntxent_bwd_reference(zhat, vv, t, *fwd[1:], g)
    assert torch.equal(torch.isnan(dz), torch.from_numpy(np.isnan(np.asarray(j_dz))))
    assert torch.equal(torch.isnan(model_bwd(card, vv, t, *model[1:], g)), torch.isnan(dz))

    a, b = torch.from_numpy(z1).requires_grad_(), torch.from_numpy(z2).requires_grad_()
    total, _ = ntxent.nt_xent(a, b, t, torch.from_numpy(valid.astype(np.float32)))
    total.backward()
    j_total = ntxent_pallas.nt_xent_pallas(jnp.array(z1), jnp.array(z2), np.float32(temp),
                                           jnp.array(valid))[0]
    j_plain = nt_xent_loss(jnp.array(z1), jnp.array(z2), np.float32(temp), jnp.array(valid))[0]
    assert np.isnan(float(total.detach())) and np.isnan(float(j_total))    # loss * vv: NaN * 0
    # JAX's plain formula drops an invalid row with a select, not a product:
    # it agrees with the valid rows' sum.
    valid_sum = float(fwd[0][torch.from_numpy(on > 0)].sum())
    if row < 12:
        assert np.isnan(float(j_plain)) and np.isnan(valid_sum)
    else:
        np.testing.assert_allclose(valid_sum, float(j_plain), rtol=1e-5)
    j_grads = jax.grad(lambda x, y: ntxent_pallas.nt_xent_pallas(
        x, y, np.float32(temp), jnp.array(valid))[0], argnums=(0, 1))(jnp.array(z1), jnp.array(z2))
    for got, want_g in zip((a.grad, b.grad), j_grads):
        assert np.array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want_g)))

