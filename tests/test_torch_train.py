"""The port's training gradients against the reference's, on the CPU:
the six dense, vision and audio ``reduced()`` architectures (the MoE
two are in ``tests/test_torch_train_moe.py``, the hybrid and SSM ones
in ``tests/test_torch_train_ssm.py``), ``flash_attention``'s VJP, and
the card's product backward (`_MmF32` / `_BmmF32`).  B=2, S=64; the
checks are in ``tests/train_parity.py``.

The reference runs op by op (``jax.disable_jit()``), as in
``tests/test_torch_lm_stack.py``.  Its backward rounds each operand's
gradient to bf16, as the port's autograd does on the CPU; an f32 sum
that differs by an ulp flips a bf16 rounding, and the flips add up over
the stack.

Bounds (max abs error over max|ref| of each leaf), measured on this
input first:
* whole model, ``value_and_grad(train_loss)``: loss within 1e-3
  relative (measured <= 2.2e-5; 3.3e-4 on jamba), every leaf's gradient
  <= 5e-2 (measured <= 2.65e-2, qwen3-8b's ``q_norm``; 1.8e-2 on
  gemma's ``embed``, 2.24e-2 on olmoe's expert ``w_down``); hubert's
  ``embed`` gradient exactly zero in both.  Jamba's is not held whole:
  a router near-tie flips one token's experts (its gradients then differ
  by up to 0.82 of max|ref|), so it is held sublayer by sublayer, and
  its loss against the reference's loss at the end of that walk (the
  reference's own op-by-op pass through the stack);
* every sublayer of every period teacher-forced (the reference's input
  and one random cotangent): the input's cotangent and each param's
  gradient <= 1e-2 (measured <= 7.52e-3, a bf16 input cotangent one
  ulp apart);
* remat on and off: bitwise equal gradients in the port;
* the card's product backward taken on the CPU (`_MmF32` / `_BmmF32`
  for every product: the cotangent rounded to bf16 before each backward
  product): the loss bitwise, each leaf <= 5e-2 of the CPU's autograd
  (measured <= 1.88e-2, olmoe; 2.75e-2 on jamba);
* ``flash_attention``'s VJP against the reference's at S 256, chunks 64
  and 256, causal and not, GQA: output <= 1e-2 (measured <= 6.8e-4), q /
  k / v cotangents <= 5e-3 (measured <= 1.98e-3); its forward with a
  gradient bitwise the in-place serving form;
* one `_MmF32` / `_BmmF32` backward against the CPU's autograd of the
  bf16-rounded operands: <= 1e-2 of max|ref| (measured <= 6.6e-3; one
  bf16 ulp of the largest element is 2^-8 to 2^-7 of it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as P
import train_parity as TP
from repro.models import layers as JL
from repro_torch.models import layers as TL

ARCHS = ["gemma-2b", "hubert-xlarge", "llama3-8b", "qwen2-vl-7b",
         "qwen3-1.7b", "qwen3-8b"]
FLASH_VJP_TOL = 5e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_leaf_gradient_match_reference(arch):
    TP.check_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_give_bitwise_equal_gradients(arch):
    TP.check_remat_bitwise(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_sublayer_vjp_matches_reference_teacher_forced(arch):
    TP.check_sublayer_vjps(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_card_rounding_moves_gradients_within_bound(arch, monkeypatch):
    TP.check_card_rounding(arch, monkeypatch)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [64, 256])
def test_flash_attention_vjp_matches_reference(causal, chunk):
    rng = np.random.default_rng(3)
    b, s, h, kvh, hd = 2, 256, 4, 2, 16
    q, k, v = (rng.standard_normal((b, s, n, hd)).astype(np.float32)
               for n in (h, kvh, kvh))
    ct = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    bf = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v, ct)]
    with jax.disable_jit():
        out, vjp = jax.vjp(lambda *a: JL.flash_attention(
            *a, causal=causal, chunk=chunk), *bf[:3])
        want = vjp(bf[3])
    tq, tk, tv = (P.to_torch(x).requires_grad_() for x in bf[:3])
    got_out = TL.flash_attention(tq, tk, tv, causal=causal, chunk=chunk)
    got = torch.autograd.grad(got_out, [tq, tk, tv], P.to_torch(bf[3]))
    assert P.rel_err(out, got_out.detach()) <= 1e-2
    for a, g in zip(want, got):
        assert g.dtype == torch.bfloat16
        assert P.rel_err(a, g) <= FLASH_VJP_TOL
    with torch.no_grad():
        served = TL.flash_attention(tq, tk, tv, causal=causal, chunk=chunk)
    assert torch.equal(served, got_out.detach())


@pytest.mark.parametrize("fn,ashape,bshape", [
    ("mm", (96, 64), (64, 80)),
    ("bmm", (3, 96, 16), (3, 16, 64)),
])
def test_card_product_backward_against_cpu_autograd(fn, ashape, bshape):
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(ashape, generator=g), torch.randn(bshape, generator=g)
    ct = torch.randn(ashape[:-1] + bshape[-1:], generator=g)
    a1, b1 = a.clone().requires_grad_(), b.clone().requires_grad_()
    want = torch.autograd.grad(TL._bf(a1) @ TL._bf(b1), [a1, b1], ct)
    a2, b2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    f = TL._MmF32 if fn == "mm" else TL._BmmF32
    y = f.apply(a2.to(torch.bfloat16), b2.to(torch.bfloat16))
    assert y.dtype == torch.float32
    assert torch.equal(y, TL._bf(a) @ TL._bf(b))
    got = torch.autograd.grad(y, [a2, b2], ct)
    for w, x in zip(want, got):
        assert x.dtype == torch.float32
        assert torch.equal(x, x.to(torch.bfloat16).float())   # bf16 values
        assert float((w - x).abs().max() / w.abs().max()) <= 1e-2


def test_card_product_backward_shapes_on_meta():
    """The card's branch dispatches ``torch.mm`` / ``torch.bmm`` with
    ``out_dtype``, which register no derivative: on meta tensors (that
    dispatch without a card) the Functions give every gradient its
    operand's shape and dtype."""
    a = torch.empty((6, 8), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    w = torch.empty((8, 5), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    y = TL._MmF32.apply(a, w)
    assert y.dtype == torch.float32 and y.shape == (6, 5)
    ga, gw = torch.autograd.grad(y.sum(), [a, w])
    assert (ga.shape, ga.dtype, gw.shape, gw.dtype) == (
        a.shape, a.dtype, w.shape, w.dtype)
    a3 = torch.empty((2, 6, 8), dtype=torch.bfloat16, device="meta",
                     requires_grad=True)
    b3 = torch.empty((2, 8, 5), dtype=torch.bfloat16, device="meta",
                     requires_grad=True)
    y3 = TL._BmmF32.apply(a3, b3)
    assert y3.dtype == torch.float32 and y3.shape == (2, 6, 5)
    g3 = torch.autograd.grad(y3.sum(), [a3, b3])
    assert [(t.shape, t.dtype) for t in g3] == [(a3.shape, a3.dtype),
                                                (b3.shape, b3.dtype)]
    with pytest.raises(RuntimeError, match="derivative for aten::mm"):
        torch.autograd.grad(torch.mm(a, w, out_dtype=torch.float32).sum(),
                            [a, w])
