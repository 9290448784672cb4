"""Checks shared by ``tests/test_torch_train*.py``: the port's training
gradients held against the reference's on the CPU.  The bounds are
stated in ``tests/test_torch_train.py``'s docstring.  Params and batch
come from ``tests/lm_parity.py`` (the reference's ``init_params``
carried across, B=2, S=64); the reference runs op by op
(``jax.disable_jit()``), and its results are cached per test module."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import lm_parity as P
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.tree import leaves, unflatten

LOSS_RTOL = 1e-3
GRAD_TOL = 5e-2
SUBLAYER_TOL = 1e-2
CARD_ROUNDING_TOL = 5e-2
# a router near-tie flips one token's experts: held sublayer by sublayer
ROUTER_TIE_ARCHS = ("jamba-1.5-large-398b",)

_REF = {}
_PORT = {}


def leaf_names(tree, path=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaf_names(tree[k], f"{path}/{k}")
        return out
    return [path]


def value_and_grad(tr, tp, tb, remat=True):
    """The port's loss and the gradient of every leaf (zeros where the
    loss reads none)."""
    req = [x.detach().requires_grad_() for x in leaves(tp)]
    loss = TT.train_loss(unflatten(tp, req), tr, tb, remat=remat)
    return float(loss.detach()), torch.autograd.grad(loss, req,
                                            materialize_grads=True)


def batches(nb):
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def reference(arch):
    """The reference's loss and leaf gradients, op by op (remat off: its
    gradients are bitwise those with remat on)."""
    if arch not in _REF:
        r, _, params, _, nb = P.setup(arch)
        jb, _ = batches(nb)
        with jax.disable_jit():
            loss, g = jax.value_and_grad(
                lambda p: JT.train_loss(p, r, jb, remat=False))(params)
        _REF[arch] = (float(loss), [P.f32(x) for x in jax.tree.leaves(g)])
    return _REF[arch]


def port(arch, remat=True):
    key = (arch, remat)
    if key not in _PORT:
        _, tr, _, tp, nb = P.setup(arch)
        _PORT[key] = value_and_grad(tr, tp, batches(nb)[1], remat)
    return _PORT[key]


def leaf_err(ref, got):
    m = np.abs(ref).max()
    got = P.f32(got)
    return float(np.abs(ref - got).max() / m) if m > 0 \
        else float(np.abs(got).max())


def check_grads(arch):
    """Whole-model loss and every leaf's gradient against the
    reference's; hubert's embed gets exactly zero (its frame front end
    never reads it)."""
    jl, jg = reference(arch)
    tl, tg = port(arch)
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (arch, tl, jl)
    _, tr, _, tp, _ = P.setup(arch)
    errs = {n: leaf_err(a, b) for n, a, b in zip(leaf_names(tp), jg, tg)}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (arch, worst, errs[worst])
    for n, a, b in zip(leaf_names(tp), jg, tg):
        assert np.isfinite(P.f32(b)).all(), (arch, n)
        if tr.frontend == "frame" and n == "/embed":
            assert not a.any() and not b.any(), arch


def check_loss_only(arch):
    """A router near-tie: the loss against the reference's, taken from
    the reference's own op-by-op pass through the stack that the
    sublayer walk makes (no second forward); the gradients are held per
    sublayer."""
    r, tr, params, tp, nb = P.setup(arch)
    jb, _ = batches(nb)
    h, _ = sublayer_walk(arch)
    with jax.disable_jit():
        acc = JT._chunked_ce(JL.rms_norm(h, params["final_norm"]),
                             JT._unembed_w(params, r), jb["labels"],
                             r.ce_chunk)
        jl = float(acc[0] / jnp.maximum(acc[1], 1.0))
    tl, tg = port(arch)
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (arch, tl, jl)
    assert all(torch.isfinite(g).all() for g in tg), arch


def check_remat_bitwise(arch):
    _, on = port(arch, True)
    _, off = port(arch, False)
    assert all(torch.equal(a, b) for a, b in zip(on, off)), arch


def _vjp_ref(fn, h, sub, ct):
    out, vjp = jax.vjp(fn, h, sub)
    gh, gp = vjp(ct)
    return out, [gh] + jax.tree.leaves(gp)


def _vjp_port(fn, h, sub, ct):
    hin = P.to_torch(h).requires_grad_()
    req = [x.detach().requires_grad_() for x in leaves(sub)]
    out = fn(hin, unflatten(sub, req))
    return torch.autograd.grad(out, [hin] + req, grad_outputs=P.to_torch(ct),
                               materialize_grads=True)


def sublayer_walk(arch):
    """Each sublayer of each period, teacher-forced: from the reference's
    input and one random cotangent, the error of the port's input
    cotangent and param gradients against the reference's VJP.
    -> (the reference's last hidden state, [(where, error)]), cached."""
    if ("walk", arch) in _REF:
        return _REF[("walk", arch)]
    r, tr, params, tp, nb = P.setup(arch)
    jb, tb = batches(nb)
    rng = np.random.default_rng(5)
    errs = []
    with jax.disable_jit():
        h = JT.embed_inputs(params, r, jb)
        jpos = JT._positions(r, jb, h)
        tpos = TT._positions(tr, tb, P.to_torch(h))
        for p in range(r.n_periods):
            jp = jax.tree.map(lambda a: a[p], params["blocks"])
            tpp = TT._index(tp["blocks"], p)
            for j, (mixer, mlp) in enumerate(r.slot_kinds()):
                js, ts = jp[f"s{j}"], tpp[f"s{j}"]
                if mixer == "attn":
                    subs = [(mixer, lambda hh, pp: JT._attn_sublayer(
                        r, pp, hh, jpos, "train")[0],
                        lambda hh, pp: TT._attn_sublayer(
                            tr, pp, hh, tpos, "train")[0])]
                else:
                    subs = [(mixer, lambda hh, pp: JT._ssm_sublayer(
                        r, pp, hh, "train")[0],
                        lambda hh, pp: TT._ssm_sublayer(
                            tr, pp, hh, "train")[0])]
                if mlp != "none":
                    subs.append((mlp, lambda hh, pp: JT._mlp_sublayer(
                        r, pp, hh, mlp), lambda hh, pp: TT._mlp_sublayer(
                            tr, pp, hh, mlp)))
                for what, jf, tf in subs:
                    ct = jnp.asarray(rng.standard_normal(h.shape).astype(
                        np.float32)).astype(h.dtype)
                    out, want = _vjp_ref(jf, h, js, ct)
                    got = _vjp_port(tf, h, ts, ct)
                    names = ["h"] + leaf_names(ts)
                    errs += [((p, j, what, n), leaf_err(P.f32(a), b))
                             for n, a, b in zip(names, want, got)]
                    h = out
    _REF[("walk", arch)] = (h, errs)
    return h, errs


def check_sublayer_vjps(arch):
    _, errs = sublayer_walk(arch)
    where, worst = max(errs, key=lambda e: e[1])
    assert worst <= SUBLAYER_TOL, (arch, where, worst)


def check_card_rounding(arch, monkeypatch):
    """The card's backward of every product (`_MmF32` / `_BmmF32`: the
    cotangent rounded to bf16) taken on the CPU: the same loss bit for
    bit, and each leaf's gradient within CARD_ROUNDING_TOL of the CPU's
    autograd."""
    _, tr, _, tp, nb = P.setup(arch)
    tl, tg = port(arch)
    monkeypatch.setattr(TL, "_card_grad", lambda a, b: (
        torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)))
    cl, cg = value_and_grad(tr, tp, batches(nb)[1])
    assert cl == tl, (arch, cl, tl)
    for n, a, b in zip(leaf_names(tp), tg, cg):
        assert leaf_err(a.numpy(), b) <= CARD_ROUNDING_TOL, (arch, n)
