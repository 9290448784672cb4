"""The port's LM building blocks (``models/layers.py``, ``moe.py``;
``mamba2.py`` in ``tests/test_torch_lm_mamba2.py``) against the
reference's, on the CPU, on the same numpy inputs (seeded).  The
reference runs op by op (``jax.disable_jit()``).

Bounds (max abs error over max|ref|):
* f32-only paths (``rope_freqs``, RoPE and M-RoPE, the router's gates
  and load, ``rms_norm`` in f32) within rtol=atol=1e-5;
* bf16 paths (``_dot``, attention, MLPs, ``moe_mlp``) <= 1e-3 (a
  module bound of 1e-2, tightened: the port takes the f32 product of
  the bf16-rounded operands, as XLA's CPU does, so only the order of
  f32 sums differs);
* integers bitwise: ``route_topk``'s ``slot_token`` (tied logits,
  overflow past capacity).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import moe as JMoE
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMoE

BF16_TOL = 1e-3
F32 = dict(rtol=1e-5, atol=1e-5)


def rng(seed=0):
    return np.random.default_rng(seed)


def normal(r, *shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def rel_err(ref, got):
    ref, got = f32(ref), f32(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-30))


def both(jfn, tfn, *arrays, bf16=()):
    """Run the reference (op by op) and the port on the same arrays;
    positions in ``bf16`` are passed as bf16."""
    ja, ta = [], []
    for i, a in enumerate(arrays):
        j, t = jnp.asarray(a), torch.from_numpy(np.array(a))
        if i in bf16:
            j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
        ja.append(j)
        ta.append(t)
    with jax.disable_jit():
        jo = jfn(*ja)
    return jo, tfn(*ta)


# ----------------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("hd,theta", [(16, 1e4), (128, 1e6), (80, 5e5)])
def test_rope_freqs(hd, theta):
    np.testing.assert_allclose(f32(TL.rope_freqs(hd, theta)),
                               f32(JL.rope_freqs(hd, theta)), **F32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm(dtype):
    r = rng(1)
    x, s = normal(r, 2, 5, 64), normal(r, 64)
    jo, to = both(JL.rms_norm, TL.rms_norm, x, s,
                  bf16=(0,) if dtype == "bf16" else ())
    assert to.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    if dtype == "f32":
        np.testing.assert_allclose(f32(to), f32(jo), **F32)
    else:
        assert rel_err(jo, to) <= BF16_TOL


@pytest.mark.parametrize("shape", [(3, 7, 64, 40), (2, 64, 128, 16)])
def test_dot_is_f32_product_of_bf16_operands(shape):
    b, s, k, n = shape
    r = rng(2)
    x, w = normal(r, b, s, k), normal(r, k, n, scale=k ** -0.5)
    jo, to = both(JL._dot, TL._dot, x, w)
    assert to.dtype == torch.float32
    assert rel_err(jo, to) <= BF16_TOL


def test_apply_rope_and_m_rope():
    r = rng(3)
    x = normal(r, 2, 9, 4, 16)
    pos = r.integers(0, 4000, (2, 9)).astype(np.int32)
    jo, to = both(lambda a, p: JL.apply_rope(a, p, 1e6),
                  lambda a, p: TL.apply_rope(a, p, 1e6), x, pos)
    np.testing.assert_allclose(f32(to), f32(jo), **F32)
    pos3 = r.integers(0, 64, (3, 2, 9)).astype(np.int32)
    jo, to = both(lambda a, p: JL.apply_m_rope(a, p, (2, 3, 3), 1e6),
                  lambda a, p: TL.apply_m_rope(a, p, (2, 3, 3), 1e6),
                  x, pos3)
    np.testing.assert_allclose(f32(to), f32(jo), **F32)


@pytest.mark.parametrize("causal,chunk,window,sq", [
    (True, 64, None, 64),        # one chunk
    (True, 16, None, 64),        # four chunks, masked ones included
    (False, 16, None, 64),       # bidirectional (encoder)
    (True, 64, 24, 64),          # windowed, one chunk
    (True, 16, 24, 64),          # windowed across chunks (NaN rows alike)
    (True, 1024, None, 33),      # chunk clamped to the sequence
])
def test_flash_attention(causal, chunk, window, sq):
    r = rng(4)
    q, k, v = normal(r, 2, sq, 4, 16), normal(r, 2, sq, 2, 16), \
        normal(r, 2, sq, 2, 16)
    kw = dict(causal=causal, chunk=min(chunk, sq), window=window)
    jo, to = both(lambda a, b, c: JL.flash_attention(a, b, c, **kw),
                  lambda a, b, c: TL.flash_attention(a, b, c, **kw), q, k, v)
    jo, to = f32(jo), f32(to)
    np.testing.assert_array_equal(np.isnan(jo), np.isnan(to))
    ok = ~np.isnan(jo)
    assert ok.any()
    err = np.abs(jo[ok] - to[ok]).max() / np.abs(jo[ok]).max()
    assert err <= BF16_TOL, err


def test_decode_attention_partial_lengths():
    r = rng(5)
    q = normal(r, 3, 1, 8, 16)
    kc, vc = normal(r, 3, 40, 2, 16), normal(r, 3, 40, 2, 16)
    kv_len = np.array([40, 17, 1], np.int32)
    jo, to = both(JL.decode_attention, TL.decode_attention, q, kc, vc, kv_len)
    assert rel_err(jo, to) <= BF16_TOL


@pytest.mark.parametrize("qk_norm", [False, True])
def test_attention_proj(qk_norm):
    r = rng(6)
    x = normal(r, 2, 5, 64)
    ws = [normal(r, 64, n, scale=0.125) for n in (64, 32, 32)]
    norms = [normal(r, 16), normal(r, 16)] if qk_norm else []

    def run(mod, x, wq, wk, wv, *nm):
        return mod.attention_proj(x, wq, wk, wv, 4, 2, 16, *nm)
    jo, to = both(lambda *a: run(JL, *a), lambda *a: run(TL, *a), x, *ws,
                  *norms, bf16=(0,))
    for j, t in zip(jo, to):
        assert t.dtype == torch.float32
        assert rel_err(j, t) <= BF16_TOL


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlp(act):
    r = rng(7)
    x = normal(r, 2, 6, 64)
    wg, wu, wd = normal(r, 64, 128, scale=0.125), \
        normal(r, 64, 128, scale=0.125), normal(r, 128, 64, scale=0.09)
    jo, to = both(lambda *a: JL.gated_mlp(*a, act=act),
                  lambda *a: TL.gated_mlp(*a, act=act), x, wg, wu, wd,
                  bf16=(0,))
    assert to.dtype == torch.float32
    assert rel_err(jo, to) <= BF16_TOL


def test_dense_init_scale():
    g = torch.Generator().manual_seed(0)
    w = TL.dense_init(g, (512, 256))
    assert w.dtype == torch.float32
    assert abs(float(w.std()) - 1 / math.sqrt(512)) < 2e-3


# ----------------------------------------------------------------------------
# moe
# ----------------------------------------------------------------------------
def _route_case(kind):
    r = rng(8)
    t, e = 40, 6
    if kind == "ties":        # bf16-like logits: many exact ties per row
        logits = np.round(normal(r, t, e) * 2) / 2
        logits[::3, :] = 0.5
        return logits, 2, 32
    if kind == "overflow":    # one popular expert: its queue overflows
        logits = normal(r, t, e)
        logits[:, 2] += 4.0
        return logits, 2, 8
    return normal(r, t, e), 3, 64


@pytest.mark.parametrize("kind", ["ties", "overflow", "plain"])
def test_route_topk(kind):
    logits, k, cap = _route_case(kind)
    jo, to = both(lambda a: JMoE.route_topk(a, k, cap),
                  lambda a: TMoE.route_topk(a, k, cap), logits)
    np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo[0]))
    assert to[0].dtype == torch.int32
    np.testing.assert_allclose(to[1].numpy(), np.asarray(jo[1]), **F32)
    np.testing.assert_allclose(to[2].numpy(), np.asarray(jo[2]), **F32)
    if kind == "overflow":
        assert (to[0] >= 0).sum() < logits.shape[0] * k   # pairs dropped


@pytest.mark.parametrize("cf,dense_residual", [(1.25, False), (8.0, False),
                                                (0.5, True)])
def test_moe_mlp(cf, dense_residual):
    r = rng(9)
    b, s, d, e, ff = 2, 16, 64, 4, 32
    x = normal(r, b, s, d)
    router = normal(r, d, e, scale=0.125)
    wg, wu = normal(r, e, d, ff, scale=0.125), normal(r, e, d, ff, scale=0.125)
    wd = normal(r, e, ff, d, scale=0.18)
    kw = dict(top_k=2, capacity_factor=cf, act="silu")
    jo, to = both(lambda *a: JMoE.moe_mlp(*a, **kw),
                  lambda *a: TMoE.moe_mlp(*a, **kw), x, router, wg, wu, wd,
                  bf16=(0,))
    assert to[0].dtype == torch.float32
    assert rel_err(jo[0], to[0]) <= BF16_TOL
    np.testing.assert_allclose(to[1].numpy(), np.asarray(jo[1]), **F32)
