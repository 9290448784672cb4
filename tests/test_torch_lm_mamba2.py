"""The port's Mamba-2 block (``models/mamba2.py``) against the
reference's, on the CPU, on the same numpy inputs (seeded); the
reference runs op by op (``jax.disable_jit()``).

Bounds (max abs error over max|ref|): f32-only paths (``_segsum``,
``mamba2_step``, ``causal_conv1d``) within rtol=atol=1e-5; bf16 paths
(``ssd_chunked`` with ``s % chunk != 0``, ``s < chunk`` and whole
chunks, ``mamba2_block``, ``mamba2_block_decode``) <= 1e-3 (a module
bound of 1e-2, tightened).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as JM
from repro_torch.models import mamba2 as TM

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
# mamba2
# ----------------------------------------------------------------------------
def test_segsum():
    dtA = -np.abs(normal(rng(10), 2, 3, 8))
    jo, to = both(JM._segsum, TM._segsum, dtA)
    jo, to = f32(jo), f32(to)
    np.testing.assert_array_equal(np.isinf(jo), np.isinf(to))
    fin = np.isfinite(jo)
    np.testing.assert_allclose(to[fin], jo[fin], **F32)


def _ssd_inputs(r, s):
    b, h, p, n = 2, 4, 8, 16
    return (normal(r, b, s, h, p), normal(r, b, s, h),
            np.log(np.linspace(1.0, 4.0, h)).astype(np.float32),
            normal(r, b, s, n, scale=0.5), normal(r, b, s, n, scale=0.5),
            np.ones(h, np.float32))


@pytest.mark.parametrize("s,chunk", [(37, 8), (5, 8), (32, 8)])
def test_ssd_chunked(s, chunk):
    args = _ssd_inputs(rng(11), s)
    jo, to = both(lambda *a: JM.ssd_chunked(*a, chunk=chunk),
                  lambda *a: TM.ssd_chunked(*a, chunk=chunk), *args)
    assert to[0].shape == (2, s, 4, 8)
    assert rel_err(jo[0], to[0]) <= BF16_TOL
    assert rel_err(jo[1], to[1]) <= BF16_TOL


def test_mamba2_step_and_conv():
    r = rng(12)
    b, h, p, n = 2, 4, 8, 16
    x, dt = normal(r, b, h, p), normal(r, b, h)
    a_log = np.log(np.linspace(1.0, 4.0, h)).astype(np.float32)
    bt, ct, d = normal(r, b, n), normal(r, b, n), normal(r, h)
    h0 = normal(r, b, h, p, n)
    jo, to = both(lambda *a: JM.mamba2_step(a[0], JM.MambaState(a[1], None),
                                            *a[2:]),
                  lambda *a: TM.mamba2_step(a[0], TM.MambaState(a[1], None),
                                            *a[2:]),
                  x, h0, dt, a_log, bt, ct, d)
    for j, t in zip(jo, to):
        np.testing.assert_allclose(f32(t), f32(j), **F32)
    xs, w, cache = normal(r, b, 7, 24), normal(r, 4, 24), normal(r, b, 3, 24)
    jo, to = both(JM.causal_conv1d, TM.causal_conv1d, xs, w)
    for j, t in zip(jo, to):
        np.testing.assert_allclose(f32(t), f32(j), **F32)
    jo, to = both(JM.causal_conv1d, TM.causal_conv1d, xs[:, :1], w, cache)
    for j, t in zip(jo, to):
        np.testing.assert_allclose(f32(t), f32(j), **F32)


def _mamba_params(r, d=64, h=4, p=8, n=16):
    d_inner = h * p
    return {"w_in": normal(r, d, 2 * d_inner + 2 * n + h, scale=0.125),
            "conv_w": normal(r, 4, d_inner + 2 * n, scale=0.2),
            "A_log": normal(r, h), "D": normal(r, h),
            "norm": normal(r, d_inner),
            "w_out": normal(r, d_inner, d, scale=0.18)}


def test_mamba2_block_and_decode():
    r = rng(13)
    prm = _mamba_params(r)
    x = normal(r, 2, 13, 64)
    kw = dict(n_heads=4, head_dim=8, ssm_state=16)
    jp = {k: jnp.asarray(v) for k, v in prm.items()}
    tp = {k: torch.from_numpy(v) for k, v in prm.items()}
    jo, to = both(lambda a: JM.mamba2_block(jp, a, chunk=8, **kw),
                  lambda a: TM.mamba2_block(tp, a, chunk=8, **kw), x,
                  bf16=(0,))
    assert rel_err(jo[0], to[0]) <= BF16_TOL
    for j, t in zip(jo[1], to[1]):
        assert rel_err(j, t) <= BF16_TOL
    st = [normal(r, 2, 4, 8, 16), normal(r, 2, 3, 64)]
    jo, to = both(
        lambda a, h, c: JM.mamba2_block_decode(jp, a, JM.MambaState(h, c),
                                               **kw),
        lambda a, h, c: TM.mamba2_block_decode(tp, a, TM.MambaState(h, c),
                                               **kw), x[:, :1], *st,
        bf16=(0,))
    assert rel_err(jo[0], to[0]) <= BF16_TOL
    for j, t in zip(jo[1], to[1]):
        assert rel_err(j, t) <= BF16_TOL


def test_mamba2_init_shapes():
    p = TM.mamba2_init(torch.Generator().manual_seed(0), 64, 4, 8, 16)
    want = JM.mamba2_init(jax.random.PRNGKey(0), 64, 4, 8, 16)
    for k, v in want.items():
        assert tuple(p[k].shape) == v.shape and p[k].dtype == torch.float32
    np.testing.assert_allclose(p["A_log"].numpy(), np.asarray(want["A_log"]),
                               **F32)
