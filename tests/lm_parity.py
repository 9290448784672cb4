"""Checks shared by ``tests/test_torch_lm_stack*.py``: the port's LM
stack held against the reference's on the CPU.  The bounds are stated in
``tests/test_torch_lm_stack.py``'s docstring."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.mamba2 import MambaState

B, S = 2, 64
LOGITS_TOL = 2e-2
SUBLAYER_TOL = 5e-3
DECODE_TOL = 1e-2
ARGMAX_MIN = 0.95
TF_ARCHS = ["qwen3-8b", "gemma-2b", "qwen2-vl-7b", "jamba-1.5-large-398b",
            "mamba2-2.7b"]


def make_batch(r, seed=0, labels=True, s=S):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, r.vocab, (B, s)).astype(np.int32)}
    if labels:
        b["labels"] = rng.integers(0, r.vocab, (B, s)).astype(np.int32)
    if r.frontend == "frame":
        b["frames"] = rng.standard_normal((B, s, r.d_model)).astype(
            np.float32)
    if r.frontend == "patch":
        b["patch_embeds"] = rng.standard_normal(
            (B, s // 4, r.patch_dim)).astype(np.float32)
    if r.m_rope:
        b["positions3"] = np.ascontiguousarray(np.broadcast_to(
            np.arange(s, dtype=np.int32)[None, None], (3, B, s)))
    return b


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def rel_err(ref, got):
    ref, got = f32(ref), f32(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-30))


def to_torch(x):
    return torch.from_numpy(np.array(f32(x))).to(
        torch.bfloat16 if jnp.asarray(x).dtype == jnp.bfloat16
        else torch.float32)


_SETUP = {}


def setup(arch):
    """Reference params, the port's copy, and one batch (cached)."""
    if arch not in _SETUP:
        r = J_ARCHS[arch].reduced()
        params = JT.init_params(jax.random.PRNGKey(0), r)
        tp = lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
        nb = make_batch(r)
        _SETUP[arch] = (r, ARCHS[arch].reduced(), params, tp, nb)
    return _SETUP[arch]


def check_prefill(arch):
    """One op-by-op reference forward gives the last-position logits
    (``prefill``'s ``_dot(h[:, -1:], W)``), every position's logits and
    the chunked loss (``train_loss``'s ``_chunked_ce``); the reference's
    ``prefill`` is traced only for its cache's shapes and dtypes."""
    r, tr, params, tp, nb = setup(arch)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    w = JT._unembed_w(params, r)
    with jax.disable_jit():
        j_h, _ = JT.forward(params, r, jb, mode="prefill")
        j_logits = JL._dot(j_h[:, -1:], w)
        j_all = JL._dot(j_h, w)
        acc = JT._chunked_ce(j_h, w, jb["labels"], r.ce_chunk)
        j_loss = float(acc[0] / jnp.maximum(acc[1], 1.0))
    j_cache = jax.eval_shape(
        lambda p: JT.prefill(p, r, jb, cache_slack=2)[1], params)
    t_loss = float(TT.train_loss(tp, tr, tb))
    t_logits, t_cache = TT.prefill(tp, tr, tb, cache_slack=2)
    t_h, _ = TT.forward(tp, tr, tb, mode="prefill")
    t_all = TL._dot(t_h, TT._unembed_w(tp, tr))

    assert t_logits.dtype == torch.float32 and t_logits.shape == (B, 1,
                                                                  r.vocab)
    assert rel_err(j_logits, t_logits) <= LOGITS_TOL, arch
    assert rel_err(t_logits, t_all[:, -1:]) <= 1e-6
    agree = (f32(j_all).argmax(-1) == f32(t_all).argmax(-1)).mean()
    assert agree >= ARGMAX_MIN, (arch, agree)
    assert abs(t_loss - j_loss) <= 1e-3 * abs(j_loss), (arch, t_loss, j_loss)
    assert 3.0 < t_loss < 12.0
    if not r.has_decode:
        assert j_cache is None and t_cache is None
        return
    assert torch.equal(t_cache["len"], torch.full((B,), S, dtype=torch.int32))
    assert j_cache["len"].shape == (B,) and j_cache["len"].dtype == jnp.int32
    for name, jc in j_cache["blocks"].items():
        tc = t_cache["blocks"][name]
        assert isinstance(tc, MambaState) == isinstance(jc, JT.MambaState)
        for ja, ta in zip(jc, tc):
            assert tuple(ta.shape) == ja.shape, (name, ta.shape, ja.shape)
            assert ta.dtype == torch.float32 and ja.dtype == jnp.float32
            if not isinstance(tc, MambaState):       # the slack rows
                assert not ta[:, :, S:].any()


def check_sublayers(arch):
    """Each sublayer of each period takes the reference's input; its
    output and its cache piece are held to the reference's."""
    r, tr, params, tp, nb = setup(arch)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    with jax.disable_jit():
        h = JT.embed_inputs(params, r, jb)
        assert rel_err(h, TT.embed_inputs(tp, tr, tb)) == 0.0
        jpos, tpos = JT._positions(r, jb, h), TT._positions(tr, tb,
                                                            to_torch(h))
        for p in range(r.n_periods):
            jp = jax.tree.map(lambda a: a[p], params["blocks"])
            tpp = TT._index(tp["blocks"], p)
            for j, (mixer, mlp) in enumerate(r.slot_kinds()):
                js, ts = jp[f"s{j}"], tpp[f"s{j}"]
                hin = to_torch(h)
                if mixer == "attn":
                    h, jc = JT._attn_sublayer(r, js, h, jpos, "prefill")
                    th, tc = TT._attn_sublayer(tr, ts, hin, tpos, "prefill")
                else:
                    h, jc = JT._ssm_sublayer(r, js, h, "prefill")
                    th, tc = TT._ssm_sublayer(tr, ts, hin, "prefill")
                where = (arch, p, j, mixer)
                assert rel_err(h, th) <= SUBLAYER_TOL, where
                for ja, ta in zip(jc, tc):
                    assert rel_err(ja, ta) <= SUBLAYER_TOL, where
                if mlp != "none":
                    hin = to_torch(h)
                    h = JT._mlp_sublayer(r, js, h, mlp)
                    th = TT._mlp_sublayer(tr, ts, hin, mlp)
                    assert rel_err(h, th) <= SUBLAYER_TOL, (arch, p, j, mlp)
        fin = JL.rms_norm(h, params["final_norm"])
        tfin = TL.rms_norm(to_torch(h), tp["final_norm"])
        assert rel_err(fin, tfin) <= SUBLAYER_TOL


def check_decode(arch):
    r, tr, params, tp, nb = setup(arch)
    jb = {k: jnp.asarray(v) for k, v in nb.items() if k != "labels"}
    tok = np.random.default_rng(1).integers(0, r.vocab, (B, 1)).astype(
        np.int32)
    _, j_cache = JT.prefill(params, r, jb, cache_slack=2)    # the input
    with jax.disable_jit():
        j_logits, j_new = JT.decode_step(params, r, j_cache, jnp.asarray(tok))
    t_cache = lm_cache_from_numpy(tr, jax.tree.map(np.asarray, j_cache),
                                  "cpu")
    t_logits, t_new = TT.decode_step(tp, tr, t_cache, torch.from_numpy(tok))
    assert rel_err(j_logits, t_logits) <= DECODE_TOL, arch
    assert torch.equal(t_new["len"], torch.from_numpy(np.array(
        j_new["len"])))
    for name, jc in j_new["blocks"].items():
        for ja, ta in zip(jc, t_new["blocks"][name]):
            assert rel_err(ja, ta) <= SUBLAYER_TOL, (arch, name)


def check_full_cache_decode():
    """A full cache overwrites its last slot (``min(len, smax-1)``)."""
    r, tr, params, tp, nb = setup("qwen3-8b")
    jb = {"tokens": jnp.asarray(nb["tokens"])}
    tok = np.array([[3], [7]], np.int32)
    _, j_cache = JT.prefill(params, r, jb)                  # no slack: full
    with jax.disable_jit():
        j_logits, j_new = JT.decode_step(params, r, j_cache, jnp.asarray(tok))
    t_cache = lm_cache_from_numpy(tr, jax.tree.map(np.asarray, j_cache),
                                  "cpu")
    t_logits, t_new = TT.decode_step(tp, tr, t_cache, torch.from_numpy(tok))
    assert rel_err(j_logits, t_logits) <= DECODE_TOL
    for ja, ta in zip(j_new["blocks"]["s0"], t_new["blocks"]["s0"]):
        assert rel_err(ja, ta) <= SUBLAYER_TOL
        assert rel_err(np.asarray(ja)[:, :, :S - 1], ta[:, :, :S - 1]) == 0.0


def check_teacher_forcing(arch):
    """The port's own decode against its teacher-forced prefill, with
    params from a torch generator (``tests/test_models.py``'s check)."""
    r = dataclasses.replace(ARCHS[arch].reduced(), capacity_factor=8.0)
    params = TT.init_params(r, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch(r, labels=False).items()}
    logits_full, _ = TT.prefill(params, r, batch)
    short = {k: (v[:, :, :S - 1] if v.ndim == 3 and v.shape[0] == 3
                 else (v[:, :S - 1] if v.shape[1] == S else v))
             for k, v in batch.items()}
    _, cache = TT.prefill(params, r, short, cache_slack=2)
    logits_dec, _ = TT.decode_step(params, r, cache,
                                   batch["tokens"][:, S - 1:S])
    a, b = logits_full[:, 0].numpy(), logits_dec[:, 0].numpy()
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-9)
    assert err < 0.05, (arch, err)
    assert (a.argmax(-1) == b.argmax(-1)).mean() > 0.9


def check_init_loss(arch):
    r = ARCHS[arch].reduced()
    params = TT.init_params(r, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(r).items()}
    loss = float(TT.train_loss(params, r, batch))
    assert 3.0 < loss < 12.0, (arch, loss)
